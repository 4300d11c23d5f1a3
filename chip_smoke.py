#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the nineteen CUDA libraries from csrc/ (into build/flashattn_tpu_torch/,
one nvcc each, all at once) and runs twenty-three phases, printing one line
per check and each phase's seconds, then the kernels line:

1. environment: torch/CUDA versions, the card's name and power limit, the
   kernels' build time (from the 15th library built on, a process
   compiles phase 2's flex_attention cases into this run's Inductor cache,
   until phase 2 ends) and their compiler report (no spills in the
   tensor-core kernels and the split-K kernel, no wgmma serialized), and
   the tensor-core instructions (HMMA/HGMMA/IMMA) in the SASS of each
   tensor-core kernel, which must be there for K1's bf16 kernel (HGMMA, at
   D 64, 128 and 256, with and without a window, segment ids and the
   soft-cap, or ALiBi with and without a window and segment ids, its 28
   D 256, soft-cap and ALiBi instantiations named; each again with
   dropout in a library of its own, the 36 named; the 48 instantiations of
   the offset read on the card, dyn_pos_offset, at D 64, 128 and 256 with
   a window, ALiBi, both, or the window and the soft-cap, with and without
   segment ids and dropout, in two libraries of their own), the
   bf16 fused, dQ and dK/dV kernels (D 64, 128 and 256, with and without
   the window, segment ids and the soft-cap, or with ALiBi in libraries of
   their own, their 63 D 256, soft-cap and ALiBi instantiations named; each
   again with dropout in libraries of their own, the 144 named; the 126 of
   the offset read on the card, every D, with and without the soft-cap and
   dropout, in libraries of their own),
   qmm8's and qmm4's M > 16 kernels (IMMA in their a8 kernels) and every
   instantiation of K2's (D 64, 128 and 256, with and without a window, with
   and without ALiBi: the ALiBi ones in a library of their own);
2. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes and at their edges (K1 at head dims
   32, 80 and 96 too, run in the 64 and 128 tiles: causal GQA, S_q < S_k,
   non-causal, a window, ALiBi, the soft-cap, the offset read on the card
   and float32; K1 also at every
   backward case, where it makes the backward's O and LSE, and timed at the
   prefill, training and D 128 shapes; at D 128, B 4, S 16384 held against
   its plain version on three slices of 256 q rows, two calls bitwise equal,
   and timed with the plain version left out; SDPA's forward kernels at the
   three shapes named by one profiler session; K2 on int8 and
   fp8 caches at T 1 and T 256; the paged K2 against the dense K2, bit for
   bit; qmm8 and qmm4 at M 1 to 1024 on LLAMA_1B's five projection shapes,
   two calls bitwise equal; their a8 mode, W8A8 and W4A8, at the same M on
   LLAMA_1B's shapes and at M 4 and 256 on LLAMA_8B's five, its path's
   launches counted alone, torch.equal to its plain version, its x_q and
   x_scale to quantize_rows_reference's, timed beside torch._int_mm), with
   the tolerance printed beside each result; kernel, plain version and the PyTorch library call (SDPA, on the
   dequantized bf16 cache for the quantized K2, with a length mask at T 1
   and a bottom-right causal mask for K2 int8 at T 256, or torch.matmul on
   the dequantized weight; timed only, never used by the port) timed on
   the card; each bound from utils/roofline.py; then the sliding window at
   MISTRAL_7B's widths (window_kernels): K1 at B 1, Hq 32, Hkv 8, D 128,
   S 4608 with windows 1, 63, 64, 65, 1000, 4096 and 8192 (past S), with
   S_q != S_k and a pos_offset, and its float32 kernel at a small shape;
   K2 at B 4, Hq 32, Hkv 8, D 128, Smax 8192, window 4096, 0 and 4 sinks,
   lengths on both sides of the window, bf16/f32/int8/fp8 caches at T 1
   and T 256, the paged K2 torch.equal to the dense K2 in each; each timed
   beside SDPA with an explicit boolean window mask, and K2 at length 8192
   held to at most 0.8 of the same call without a window; then the window
   and segment ids in the backward kernels and segment ids in K1
   (masked_kernels): K1 and B3, B4 + B5 against their plain versions with
   windows 1, 63, 64, 65 and 1000 at D 64, at MISTRAL_7B's widths (S 4608,
   window 4096), with S_q != S_k and a pos_offset, in float32; with
   packed documents whose lengths are off the tile multiples and trailing
   padding, causal and not, with a window, as a (seg_q, seg_k) pair with
   S_q != S_k, in float32, and at the packed training row (S 8192, window
   4096, documents of 6100, 1300, 517 and 211 tokens): padding rows' O and
   gradients exactly 0, the split path bitwise equal across two calls;
   the windowed kernels timed at the MISTRAL_7B prefill shape, the
   segmented ones at the packed row, each beside its plain version, SDPA
   (forward, or forward and backward) with the explicit boolean mask and
   its bound over the visible pairs; then the logit soft-cap and head dim
   256 at GEMMA2_9B's widths (softcap_kernels): K1 at B 1, Hq 16, Hkv 8,
   S 4608, D 256, cap 50 with window 4096 and without, each also on hot
   inputs whose logits reach the cap, without the cap, the cap at D 64 and
   128 (normal and hot), S_q != S_k with a pos_offset, non-causal and
   float32 at a small shape; K2 at B 2, Hq 16, Hkv 8, D 256, Smax 8192,
   cap 50, lengths on both sides of the window, window 4096 and none,
   bf16/f32/int8/fp8 caches at T 1 and T 256 (hot inputs on bf16 at T 1,
   int8 and fp8 at T 256), the paged K2 torch.equal to the dense K2 in
   each; each timed beside flex_attention with a soft-cap score_mod,
   the same function (where it compiles), and SDPA without the cap (with
   the boolean window mask on a local layer; another function, printed as
   an extra); then the
   soft-cap in the backward kernels (softcap_backward_kernels): K1 (the cap
   with segment ids), B3 and B4 + B5 against their plain versions at D 64,
   128 and 256 with the cap alone, a window, documents, both, hot inputs
   (q x 30), S_q != S_k with a pos_offset, non-causal and float32, then at
   GEMMA2_9B's packed training row (B 1, Hq 16, Hkv 8, D 256, S 8192, the
   packed row's documents, cap 50) on a global and a local layer, the
   split path bitwise equal across two calls, each timed beside its plain
   version, SDPA's backward with a boolean mask and no cap, flex_attention's
   backward with a soft-cap score_mod where it compiles, and its bound;
   then ALiBi (alibi_kernels): K1 at the serving prefill and at LLAMA_8B's
   heads over a 4,608-token prefill with and without a window, at D 256,
   S_q != S_k with a pos_offset, non-causal, one head of the steepest
   standard slope over 16,384 keys and in float32; K2 at the decode step's
   shape in all four cache modes at T 1 and T 256 and at LLAMA_8B's heads
   with a window and sinks, the paged K2 torch.equal to it, one steep head
   on an int8 cache of 2,048; each timed beside the same kernel without
   ALiBi, its plain version, its bound and flex_attention with an ALiBi
   score_mod; then K2's LSE output (decode_lse) against its plain version
   (merged from 16 slices and from one, bf16 and int8, with and without
   ALiBi, an empty slot's -inf), and the path that uses it, a
   sequence-split decode on one card (the cache cut in two, K2 with the
   LSE on each, merged by the log-sum-exp rule) against K2 on the whole
   cache, timed beside flex_attention returning the LSE; then ALiBi in the
   backward kernels and with segment ids in K1 (alibi_backward_kernels):
   K1, B3 and B4 + B5 against their plain versions at D 64, 128 and 256
   with ALiBi alone, a window, documents, both, S_q != S_k with a
   pos_offset, rows without keys, non-causal, a window of one key, one
   head of the steepest standard slope over 8,192 keys and float32, then
   at LLAMA_8B's packed training row (B 1, Hq 32, Hkv 8, D 128, S 8192,
   the packed row's documents), the split path bitwise equal across two
   calls, each timed beside its plain version, SDPA's with a boolean mask
   and no ALiBi, flex_attention's with an ALiBi score_mod and the document
   block mask where it compiles, and its bound; ALiBi's cost in B3, B4, B5
   and K1 (the same kernels without ALiBi on the same inputs) there and at
   LLAMA_8B's unpacked row of 4,096 tokens;
3. LLAMA_1B at full width (random weights from a seed): prefill of a
   150-token prompt and 4 teacher-forced decode steps through the kernels,
   against the same run with every kernel call on its plain version;
4. the same for four quantized setups (int8 weights, int4 weights, int8 KV
   cache, fp8 KV cache), and a prefix admission (pages gathered back,
   chunk_step on the suffix) against the full prompt's prefill; then the
   capture gate (phase_capture): the decode step captured in a CUDA graph
   against the eager step, 4 slots, max_len 2048, 8 steps with changing
   active rows, in five setups that run K2 in every mode, the paged K2, qmm8
   and qmm4, the logits and every cache byte compared;
5. the InferenceServer at LLAMA_1B width with 4 slots and max_len 2048 on 8
   requests of 32 new tokens, every decode step a replay of the captured
   step, counting the kernels' launches; then calibrate_device_step;
6. the quantized paged server (int8 weights, int8 KV cache, pages of 256) on
   the same traffic: dense, paged with a pool one page short (backpressure),
   and paged with a registered 512-token prefix, chunked admission and
   logprobs; the launches of the three runs counted together, every decode
   step a replay; calibrate_device_step after each run and calibrate_admit
   after the last;
7. one LLAMA_1B AdamW train step at B 4, S 2048 through the kernels (K1 and
   the fused backward), against the same step on the plain route from the
   same weights: loss, grad_norm and every parameter's gradient;
8. train.train for 6 AdamW steps on one repeated batch with the
   deterministic split backward selected by FLASHATTN_BWD_IMPL=split, the
   loss falling; ms, tokens/s and peak memory per step;
9. MISTRAL_7B at full width (32 layers, GQA 32/8, D 128, window 4096;
   random weights from the seed, about 14.5 GB in bf16): a 4,608-token
   prefill and 4 teacher-forced decode steps through the windowed kernels
   against the plain route under phase 3's logits rule; the bf16
   InferenceServer with 2 slots, max_len 8192 and captured decode on 4
   requests of 4,200-6,000 prompt tokens and 32 new tokens; the same
   traffic on the int8-KV paged server (pages of 256, admit_chunk 256, a
   registered 1,024-token prefix before two prompts); tokens/s,
   device_step_ms and the windowed launch counts, which must be > 0;
10. packed, windowed training (phase_packed): MISTRAL_7B at full width cut to
   4 layers (32 layers with AdamW state do not fit one card), one row of
   8,193 tokens a step from PackedDataset over four documents of 6,100,
   1,300, 517 and 211 tokens (every row holds a document past the window,
   boundaries off the tile multiples and trailing padding); one AdamW step
   through the kernels (K1 with the window and segment ids, the fused
   backward) against the same step on the plain route (which computes
   attention one kv-head group at a time) under phase 7's gates, then
   train.train for 5 steps through prefetch with the split backward, the
   loss falling; ms, tokens/s and peak memory a step, and the windowed and
   segmented launches of K1, B3, B4 and B5, which must be > 0;
11. GEMMA2_9B at full width and depth (phase_gemma: 42 layers, hidden 3584,
   GQA 16/8, D 256, a 4096-token window on even layers, soft-caps 50 and
   30, post-norms; random weights from the seed, about 18.5 GB in bf16): a
   4,608-token prefill and 4 teacher-forced decode steps through the
   soft-capped kernels against the plain route under phase 3's logits
   rule; the bf16 server (2 slots, max_len 8192, captured decode) and the
   int8-KV paged server (pages of 256, admit_chunk 256, a 1,024-token
   prefix before two prompts) on phase 9's traffic; tokens/s,
   device_step_ms, peak memory and the soft-capped launches of K1, K2 and
   the paged K2, which must be > 0;
12. packed Gemma-2 training (phase_gemma_packed): GEMMA2_9B at full width cut
   to 4 layers (layers 0 and 2 local, 1 and 3 global; about 1.71 B
   parameters), phase 10's packed row, an AdamW step through the kernels
   against the plain route under phase 7's gates, then 5 train.train steps
   with the split backward, the loss falling; ms, tokens/s and peak memory
   a step, and the soft-capped and segmented launches of K1, B3, B4 and B5,
   which must be > 0;
13. rematerialisation and the measured backward (phase_remat): (a)
   LLAMA_1B at B 4, S 2048, one loss_fn backward a remat policy (False,
   True, "dots", "attn") and backward path from the same weights, the loss
   bit for bit equal to no remat's, the gradients too with the split
   backward and under phase 7's gates with the fused one, K1 launched once
   a layer (twice under True and "dots"); then sgd_train_step for each
   policy and path (ms/step, tokens/s, peak memory, the bytes a layer holds
   after the forward, device busy and idle share; utils/profile_train.py)
   and B 8 with "attn"; (d) autotune at that training shape in the run's
   own cache file, then impl="auto" launching the winner's kernels and
   FLASHATTN_BWD_IMPL overriding it; (b) GEMMA2_9B cut to 4 layers on phase
   12's packed row under the split gates of (a) for False, "attn" and True;
   (c) GEMMA2_9B at its full 42 layers, B 1, S 4096, 5 sgd_train_steps
   with remat="attn", the loss falling, and the peak without remat
   reckoned from (b)'s bytes a layer;
14. Hugging Face model families at full width (phase_families), their
   depth cut for the run's time limit: QWEN3_8B at FAMILY_QWEN_LAYERS of
   its 36 layers (q/k RMSNorm) and then LLAMA31_8B at
   FAMILY_LLAMA31_LAYERS of its 32 (the llama3 RoPE remap), each from random bf16
   weights under the Hugging Face names and layouts through
   models/convert.py::params_from_hf, freed before the next: a 2,000-token
   prefill and 4 teacher-forced decode steps through the kernels against
   the plain route under phase 3's logits rule; the bf16 server and the
   int8-KV paged server on phase 9's traffic (max_len 8192); LLAMA31_8B
   also a 16,384-token prompt, its last position's logits from 512-token
   chunks (K2) against prefill (K1), then served with admit_chunk 512 and
   32 new tokens; K1 at that prompt's attention against its plain version
   in 1024-row slices and timed;
15. speculative decoding (phase_speculate): target LLAMA_1B, drafts
   LLAMA_1B itself and LLAMA_150M, k 4, a 128-token prompt, 64 new
   tokens, greedy, dense and paged, in float32 and in bf16: the tokens
   equal generate.generate's (in bf16 up to a tie at bf16's rounding,
   where generate's own logits hold both tokens within phase 3's logits
   tolerance), the
   float32 self-draft's acceptance 1.0, the K1 and K2 launches those the
   models' calls make; a sampled bf16 run twice from one seed the same;
   acceptance and tokens/s against generate; K2 bf16 at T 5 (the
   verification) against its plain version and timed;
16. mixture-of-experts models (phase_moe), every FFN the grouped dispatch
   (parallel/moe.py::moe_ffn_grouped; the masked-dense loop is the plain
   route), their configs the public config.json files through
   config_from_hf: Qwen3-30B-A3B at full width, its depth cut to
   MOE_LAYERS of its 48 layers for the run's time limit (GQA 32/4 at D
   128, q/k RMSNorm, 128 experts of 768, top 8; random bf16 parameters):
   the FFN of layer 0 on a 2,000-token prompt's hidden
   states, grouped against masked-dense at T 2 and 2,000, both timed beside
   the bound of the experts the routing touches; a 2,000-token prefill and
   4 teacher-forced decode steps through the kernels, the routing of every
   (token, layer) recorded: the free-running plain route's flips printed
   with their margins, then the plain route with its routing
   teacher-forced to the kernel run's picks under phase 3's logits rule,
   every layer's router logits under the rule too, and every pick it would
   have made otherwise explained, pair by pair, by the two runs' router
   logits (r_p - r_f <= |a_p - r_p| + |a_f - r_f|, float32 slack; the
   worst ratio of each layer printed; the count within TIE_ULPS bf16 steps
   printed for information); one eager decode_step
   and one chunk_step under set_sync_debug_mode("error"); phase 4's
   capture gate, bitwise; the bf16 server, a bf16 paged server (its tokens
   equal to the dense server's) and the int8-KV paged server (admit_chunk
   512, a 1,024-token prefix) on phase 9's traffic at max_len 8192, with
   device_step_ms beside the step's weights' read; then its widths cut to
   4 layers in float32, free-running, under the logits rule with no
   excuse; then
   Qwen1.5-MoE-A2.7B (16/16 heads, q/k/v biases, 60 experts of 1408, top 4
   with full-softmax gates, a sigmoid-gated shared expert) cut to
   MOE_HF_LAYERS of its 24 layers (the run's time limit, or
   fewer where the disk cannot hold them; printed), written under the
   Hugging Face names as a sharded safetensors directory and read by
   load_hf_dir: the logits gate, the sync gate, the bf16 and int8-KV paged
   servers;
17. an ALiBi model (phase_alibi): LLAMA_8B with use_alibi at full width and
   depth (32 layers, hidden 4,096, GQA 32/8 at D 128: the attention shape
   of MPT-7B and BLOOM-7B1; RoPE off; 8.0 B random bf16 parameters): a
   2,000-token prefill and 4 teacher-forced decode steps through the ALiBi
   kernels against the plain route under phase 3's logits rule, on a bf16
   and an int8 KV cache; one eager decode_step and one chunk_step under
   set_sync_debug_mode("error"); phase 4's capture gate, bitwise; the bf16
   server, the bf16 paged server (its tokens equal to the dense server's)
   and the int8-KV paged server (admit_chunk 512, a 1,024-token prefix) on
   phase 9's traffic at max_len 8192, device_step_ms beside the step's
   weights' read; every launch of theirs an ALiBi launch;
18. ALiBi training (phase_alibi_train): LLAMA_8B with use_alibi at full
   width, (a) cut to 4 layers on phase 10's packed row of 8,192 tokens, one
   AdamW step through the kernels (K1 with ALiBi and segment ids, B3 with
   ALiBi) against the plain route under phase 7's gates (every gradient's
   cosine printed), then 5 train.train steps on the split backward (B4, B5
   with ALiBi), the loss falling; (b) all 32 layers at B 1, S 4096,
   unpacked, remat="attn", 5 sgd_train_steps, finite and falling losses,
   ms a step, tokens/s and peak memory printed;
19. flash attention with dropout (phase_dropout): (a) each kernel's keep
   mask read out of its outputs (utils/dropout_readout.py: q = 0 makes P
   uniform, one-hot V, K or dO) against the plain dropout_keep_mask on the
   card, zero mismatches, in bf16 and float32, D 64, 128 and 256, GQA
   32/4, rates 0.1 and 0.5, seeds -7, 0 and 2^31 - 1, 1,024 keys; K1's
   keep fraction on a 4096 x 4096 tile within 5e-3 of 1 - rate; (b) K1, B3
   and B4 + B5 with dropout 0.1 against their plain versions on the same
   mask at LLAMA_1B's training attention (B 4, Hq 32, Hkv 4, S 2048, D 64,
   causal) and on the packed rows of MISTRAL_7B (window 4096, segment
   ids), GEMMA2_9B (D 256, cap 50) and LLAMA_8B with ALiBi; (c) rate 0
   equal to the call without dropout bit for bit, the LSE with dropout
   the LSE without it, a seed tensor on the card the int seed's bits; the
   main path, flash_attention(..., dropout_rate=0.1, dropout_seed=seed)
   and its gradients at the source's headline shape (B 4, H 8, S 16384,
   D 128, causal, bf16) on the fused and the split backward, the seed a
   CUDA tensor stepped as a trainer would: K1's O and the split and fused
   dQ against the plain forward and backward on three 256-row slices of
   every head, K1's O and the split and fused dQ, dK and dV of batch 0,
   head 0 (all 16,384 rows and keys) against the plain versions, the
   fused gradients against the split ones, one seed's O and split
   gradients bitwise equal twice, the next seed's O another; every launch
   counted; (d) K1, B3, B4 and B5 with dropout timed at the training
   attention and the headline shape beside the same kernels without
   dropout, the plain route (training shape), SDPA with dropout_p
   (Philox's mask: timed only) and the bound;
20. context parallelism (phase_context_parallel): two ranks,
   processes started with spawn (CUDA cannot be forked) after phase 1
   built every library, sharing cuda:0 through a gloo process group (each
   exchange staged through host memory, "gloo-host", printed), joined by
   the parent within CP_JOIN_S seconds; a rank that raises or hangs fails
   the run. (a) sharded_ring_attention at B 1, Hq 32, Hkv 8, S 16,384,
   D 128, bf16 (8,192 positions a rank: LLAMA31_8B's attention at phase
   14's prompt length) in the ring, zigzag, zigzag with window 4,096 and
   ALiBi (the dyn_pos_offset kernels; the fused and then the split
   backward, selected by FLASHATTN_BWD_IMPL) and Ulysses modes, causal, its O and gradients held by rank 0
   against K1 and the backward on the whole sequence in its one process
   (the bf16 gates); then, each on the fused and then the split backward,
   GEMMA2_9B's local layer (B 1, Hq 16, Hkv 8, S 8,192, D 256, window
   4,096, cap 50: two 2,048-row chunks a rank, the window's left edge
   cutting the (hi, lo) pairs at offsets read on the card) held the same
   way, LLAMA_1B's attention with ALiBi and dropout 0.1 (B 1, Hq 32, Hkv 4,
   S 4,096, D 64) held against the same ranks on the plain route (the
   same folded seeds, so the same masks), and float32 with window 1,024
   (B 1, Hq 4, Hkv 2, S 2,048, D 64) under phase 7's float32 gates; (b)
   LLAMA_1B at full width and depth (22 layers), sp
   2, B 1, S 4,096: 3 AdamW steps of train.train under the mesh against the
   same steps in one process on the same tokens (phase 7's gates: each
   step's loss and grad norm, the last step's summed gradients' cosines;
   finite losses, the last below the first); phase 2 holds K1, B3, B4 and B5 with
   dyn_pos_offset against their plain versions at (a)'s zigzag chunk pair
   and times them (dynoff_kernels), then with the soft-cap at D 256 on
   Gemma's pair, with dropout (each kernel's mask read out bit for bit
   first) and in float32 (dynoff_variants);
21. tensor, pipeline and expert parallelism (phase_parallel): two ranks
   started and joined as phase 20's, sharing cuda:0 over gloo-host. (a)
   LLAMA_1B at full width and depth, B 4, S 2,048, bf16: the collective
   probe; 3 steps of train.train under {"model": 2} (each rank its
   shard_params shard: half the heads, the MLP's width and the vocabulary;
   the fused backward), its checkpoint (the whole model and its AdamW
   state, gathered) restored into one process; 3 AdamW steps through
   pipeline_loss_fn under {"pp": 2} (11 layers a stage, 4 microbatches,
   the split backward); both held by rank 0 against the same steps in one
   process under phase 7's gates. (b) LLAMA31_8B's decode attention (B 4,
   Hq 32, Hkv 8, D 128) on a cache of 32,768 positions: bf16, int8 and
   fp8 caches split over sp 2 (one sequence ends in rank 0's half) merged
   by the LSE rule, against one process's K2 over the whole cache; the bf16
   cache dense and paged split over model 2, each rank's heads bit for bit
   one process's K2 on them. (c) Qwen3-30B-A3B's MoE FFN at layer 0's
   widths, T 2,000, over ep 2: moe_ffn and moe_ffn_a2a against
   moe_ffn_grouped in one process; its widths cut to 2 layers in float32,
   B 1, S 2,048: one AdamW train_step under {"ep": 2}, its forward's logits
   against one process's step's under the logits rule, the step itself
   phase 22 (d). (d) resilient_train on LLAMA_1B's widths cut to 2 layers,
   a NaN loss injected once: one recovery, the step count reached. Each
   sub-phase prints its seconds; the times of ranks that share one card
   are wall time, never a speed;
22. mixture-of-experts training (phase_moe_train): torch._grouped_mm's
   forward and backward against a per-expert torch.matmul loop at
   Qwen3-30B-A3B's expert widths on a routing's offsets and on counts off
   8 and 16 rows (bf16 gates, float32 atol 1e-5, rtol 1e-4), no padding;
   moe_ffn_grouped's forward and backward twice at T 4,096, every result
   torch.equal (the gather's fixed-order backward), timed beside its
   bounds and the masked-dense loop; (a) one AdamW train_step of
   Qwen3-30B-A3B's widths cut to 4 layers, bf16, B 1, S 2,048, through K1,
   the backward autotune picks and the grouped dispatch against the plain
   route (plain attention, the masked-dense loop) with the plain route's
   routing teacher-forced to the kernel run's picks (each changed pick
   held to pick_margins), under phase 7's gates on every gradient; (b) the
   same in float32, free-running, at 2 layers of Qwen3-30B-A3B's and of
   Qwen1.5-MoE-A2.7B's widths; (c) train.train, 6 AdamW steps of
   Qwen3-30B-A3B's widths at 8 layers (or the deepest cut that fits,
   printed), B 1, S 4,096: finite losses, the last below the first; ms,
   tokens/s and peak memory a step; (d), in phase 21's ranks: one AdamW
   train_step of phase 21 (c)'s float32 2-layer cut under {"ep": 2} (the
   a2a dispatch, no pair dropped) against one process's step under phase
   7's gates: the loss, the grad norm, every gradient's and every update's
   cosine on each rank's blocks;
23. head dims 32, 80 and 96 (phase_head_dims), which the kernels take at
   run time inside their compiled 64 and 128 tiles: at each dim B3 and B4 +
   B5 against the plain backward (causal GQA, S_q < S_k, non-causal, a
   window, ALiBi, the soft-cap, dropout, the offset read on the card,
   float32), K2 on bf16, f32, int8 and fp8 caches at T 1 and 4 with an
   empty row, the paged K2 torch.equal to the dense K2; then at
   H2O-Danube2-1.8B's attention widths (B 4, Hq 32, Hkv 8, S 2,048, causal,
   bf16; K2 over a cache of 2,048) K1, B3, B4 + B5, K2 (bf16, int8, fp8) and
   the paged K2 against their plain versions and timed beside them, their
   bounds at the true d and SDPA; (a) the JAX package's quality gate
   (tests/test_quant_ppl.py's config at D 32 in float32, 60 AdamW steps
   through K1 and the fused backward, perplexity through prefill and 63
   decode steps on float32, fp8 and int8 caches, int8 and int4 weights,
   the weights cast to bf16 on bf16, fp8 and int8 caches, each on the
   kernel route and the plain one, every perplexity and delta on a line of
   its own, the JAX test's gates; generate with int8 weights and an int8
   cache); (b) TINY served on the bf16, int8-KV and int8-KV paged servers
   (the paged tokens equal the dense int8-KV tokens); (c) one TINY AdamW
   step through the fused and through the split backward against the plain
   route under phase 7's gates; the entry points' path at D 80 and 96
   (flash_attention's forward and gradients, fused then split; the dense
   K2 on three cache modes and the paged K2), launches counted;
24. the `kernels` JSON line: every kernel with its launches on the path that
   runs it, its error against its plain version, its time, bound, plain and
   library times (the windowed K1, K2 and paged K2 from phases 2 and 9, the
   windowed and segmented K1, B3, B4 and B5 from phases 2 and 10, the
   soft-capped K1, K2 and paged K2 from phases 2 and 11, the soft-capped
   B3, B4 and B5 from phases 2 and 12, timed at GEMMA2_9B's packed row on a
   global layer; K1 at LLAMA31_8B's 16,384-token prompt from phase 14 and
   K2 at T 5 from phase 15, rows of their own; the launches of K1, K2 and
   the paged K2 in phase 16's servers added to their rows; the ALiBi K1, K2
   (bf16 and int8) and paged K2 from phases 2 and 17; K2 with the LSE from
   phase 2, its launches those of the sequence-split decode; K1 with ALiBi
   and segment ids and B3, B4 and B5 with ALiBi from phases 2 and 18, timed
   at LLAMA_8B's packed row; K1, B3, B4 and B5 with dropout from phase 19,
   timed at LLAMA_1B's training attention, their launches the headline
   path's; K1, B3, B4 and B5 with dyn_pos_offset from phases 2 and 20,
   their launches those of phase 20 (a)'s window + ALiBi zigzag on both
   ranks, and rows of their own with the soft-cap, dropout and float32,
   their launches those of (a)'s Gemma, dropout and float32 cases; phase 21's launches of K1, B3, B4, B5, K2 (bf16, int8, fp8), K2
   with the LSE and the paged K2 added to their rows, phase 22's of K1 and
   the backward to theirs; K1, B3, B4, B5, K2 (bf16, int8, fp8) and the
   paged K2 at head dims 32, 80 and 96 from phase 23, rows of their own,
   D 32's launches those of (a)-(c), D 80's and 96's those of their
   path). Phase 22 prints the MoE FFN backward's row
   (torch._grouped_mm: PyTorch's, no kernel of ours) on a line of its own.

Any failed check raises: the script then exits nonzero and does not print
its last line. It needs a CUDA device and never falls back to the CPU. The
JAX package is not imported.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from flashattn_tpu_torch.models import convert, data, generate, llama, train
from flashattn_tpu_torch.models.config import (GEMMA2_9B, LLAMA31_8B, LLAMA_1B, LLAMA_8B,
                                               LLAMA_150M, MISTRAL_7B, QWEN3_8B, TINY,
                                               ModelConfig)
from flashattn_tpu_torch.models.llama import init_params
from flashattn_tpu_torch.models.sampling import SamplingParams
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.models.speculate import speculative_generate
from flashattn_tpu_torch.ops import (_build, autotune, decode, flash_bwd, flash_bwd_fused,
                                     flash_fwd, kvcache, paged, quant_matmul, reference,
                                     varlen)
from flashattn_tpu_torch.ops import launches as launch_counters
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.ops.common import round_up
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.ops.reference import visible
from flashattn_tpu_torch.parallel import moe, ring, serving
from flashattn_tpu_torch.utils import (dropout_readout, grad_oracle, perplexity, profile_train,
                                      roofline, sass)
from flashattn_tpu_torch.utils.timing import cuda_time_ms
from flashattn_tpu_torch.utils.verify import verify_results

SEED = 0
LIBRARIES = ("flash_fwd", "decode", "decode_d256", "decode_alibi", "decode_alibi_d256",
             "flash_bwd", "flash_bwd_alibi", "flash_bwd_fused", "flash_bwd_fused_alibi",
             "quant_matmul", "flash_fwd_dropout", "flash_bwd_dropout", "flash_bwd_fused_dropout",
             "flash_fwd_dynoff", "flash_bwd_dynoff", "flash_bwd_fused_dynoff",
             "flash_fwd_dynoff_dropout", "flash_bwd_dynoff_dropout",
             "flash_bwd_fused_dynoff_dropout")
O_ATOL = 2e-2  # bf16 outputs against the fp32 plain version
LSE_ATOL = 1e-2
GRAD_TOL = {  # gradients against the plain version on the same inputs
    torch.bfloat16: dict(rtol=2e-2, atol=5e-2),  # the repo's bf16-gradient gate
    # fp32 sums over up to 8 q heads in another order, and the fused
    # kernel's dQ atomics in an order that changes between runs
    torch.float32: dict(rtol=1e-4, atol=2e-4),
}
LOGIT_COS = 0.999
LOGIT_REL = 0.05  # max |logit delta| <= LOGIT_REL * max |reference logit|
# Train step, kernels against the plain route: bf16 activations through 22
# layers, the two routes rounding at other places.
LOSS_ATOL = 1e-2
GRAD_COS = 0.99
GRAD_NORM_REL = 0.02
TRAIN_B, TRAIN_S = 4, 2048  # benchmarks/train_bench.py's default shape
# Quantized decode against its plain version: the JAX package's
# quantized-decode gate (tests/test_decode.py), plus cos > 0.999.
QUANT_DECODE_TOL = dict(rtol=2e-2, atol=2e-2)
QMM_TOL = dict(atol=2e-2, rtol=1e-2)  # bf16 outputs, fp32 sums in another order
# LLAMA_1B's projection shapes (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, lm_head.
QMM_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
QMM_TIMED = (2048, 5632)  # the gate/up projection: the JSON line's time
PAGE = 256


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_environment() -> str:
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the GPU only")
    print(card())
    name = torch.cuda.get_device_name(0)
    print(f"[env] device {name} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()

    def built_and_read(lib: str) -> dict[str, dict[str, int]]:
        # one nvcc each, and each library's SASS read (one cuobjdump) while
        # the slower ones still compile
        _build.build(lib)
        read = time.perf_counter()
        counts = tensor_core_instructions(lib)
        sass_s[lib] = round(time.perf_counter() - read, 1)
        return counts

    sass_s: dict[str, float] = {}
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        counted = list(pool.map(built_and_read, LIBRARIES))
    for lib in LIBRARIES:
        _build.load(lib)
    print(f"[env] kernels built/loaded and their SASS read in {time.perf_counter() - t0:.2f} s "
          f"(compile s: {_build.BUILD_SECONDS}; SASS read s: {sass_s})")
    for lib in LIBRARIES:
        log = _build.library_path(lib).with_suffix(".log")
        if not log.exists():  # loaded from an earlier build of another run
            continue
        kernel = "?"
        for line in log.read_text().splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            # ptxas serializes the wgmma of a function it cannot give the
            # registers for: a kernel that runs, slowly.
            check("wgmma.mma_async instructions are serialized" not in line,
                  f"{lib}: {line.strip()}")
            if entry:
                kernel = sass.kernel_label(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[env] ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
                if "spill" in line and ("mma_kernel" in kernel
                                        or kernel.startswith("qmm_splitk")):
                    check("0 bytes spill stores, 0 bytes spill loads" in line,
                          f"{kernel} spills: {line.strip()}")
    mma = {}
    for counts in counted:
        for kernel, n in counts.items():
            if "mma_kernel" in kernel:
                print(f"[env] SASS {kernel}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA, "
                      f"{n['IMMA']} IMMA")
                mma[kernel] = n
    families = {"flash_fwd_wgmma_kernel": 72, "flash_fwd_dyn_wgmma_kernel": 48, "flash_bwd": 288,
                "qmm_mma_kernel": 4, "qmm_a8_mma_kernel": 4, "decode_mma_kernel": 120}
    counted = {f: sum(k.startswith(f) for k in mma) for f in families}
    check(counted == families and all(sum(n.values()) for n in mma.values()),
          "K1's bf16 kernel (D 64, 128 and 256, with and without a window, segment ids and "
          "the soft-cap, or ALiBi with and without a window and segment ids; each with and "
          "without dropout; the offset read on the card: a window, ALiBi, both, or the window "
          "and the soft-cap, with and without segment ids and dropout), the bf16 fused, "
          "dQ and dK/dV kernels (D 64, 128 and 256; no mask, "
          "the window, segment ids; with and without the soft-cap, or with ALiBi; each with "
          "and without dropout; the offset read on the card), qmm8's and qmm4's "
          "M > 16 kernels (bf16 and float32 y; with and without the a8 mode) and every K2 "
          "tensor-core instantiation (bf16, int8 and fp8 caches, D 64, 128 and 256, both row "
          f"layouts, with and without a window, and ALiBi's) must run on the tensor cores: {mma}")
    check(all(n["HGMMA"] for k, n in mma.items()
              if k.startswith(("flash_fwd_wgmma_kernel", "flash_fwd_dyn_wgmma_kernel"))),
          f"K1's bf16 kernel must run on wgmma (HGMMA): {mma}")
    a8 = {k: n["IMMA"] for k, n in mma.items() if k.startswith("qmm_a8_mma_kernel")}
    check(all(a8.values()), f"qmm8's and qmm4's M > 16 a8 kernels must run on the int8 tensor "
                            f"cores (IMMA): {a8}")
    print(f"[env] qmm8's and qmm4's a8 kernels run on the int8 tensor cores (IMMA), no spill: {a8}")
    # K1's template arguments: D, consumers, window, segment ids, soft-cap,
    # ALiBi, dropout; the kernel of the offset read on the card: D,
    # consumers, window, segment ids, ALiBi, soft-cap, dropout.
    k1 = {k: k[k.index("<") + 1:-1].split(", ") for k in mma
          if k.startswith("flash_fwd_wgmma_kernel")}
    new = [k for k, args in k1.items()
           if args[6] == "false" and (args[0] == "256" or "true" in args[4:6])]
    drop = [k for k, args in k1.items() if args[6] == "true"]
    dyn = [k for k in mma if k.startswith("flash_fwd_dyn_wgmma_kernel")]
    check(len(new) == 28, f"K1's D 256, soft-cap and ALiBi instantiations: {new}")
    check(len(drop) == 36, f"K1's dropout instantiations: {drop}")
    # 3 D x (window, ALiBi, both, the window with the cap) x segment ids x dropout
    check(len(dyn) == 48 and len({k[k.index("<") + 1:].split(",")[0] for k in dyn}) == 3,
          f"K1's instantiations of the offset on the card: {dyn}")
    print(f"[env] K1's D 256, soft-cap, ALiBi, dropout and card-offset instantiations run on "
          f"wgmma (HGMMA), no spill: { {k: mma[k]['HGMMA'] for k in new + drop + dyn} }")
    # The backward's template arguments: D, mask kind, soft-cap, ALiBi,
    # dropout, the offset read on the card.
    bwd = {k: k[k.index("<") + 1:-1].split(", ") for k in mma if k.startswith("flash_bwd")}
    new = [k for k, args in bwd.items() if args[4] == args[5] == "false"
           and (args[0] == "256" or "true" in args[2:4])]
    alibi = [k for k, args in bwd.items() if args[3] == "true" and args[4] == args[5] == "false"]
    drop = [k for k, args in bwd.items() if args[4] == "true"]
    dyn = [k for k, args in bwd.items() if args[5] == "true"]
    check(len(new) == 63 and len(alibi) == 27 and not any(bwd[k][2] == "true" for k in alibi),
          f"the backward's D 256, soft-cap and ALiBi instantiations: {new}")
    check(len(drop) == 144, f"the backward's dropout instantiations: {drop}")
    # 3 D x (ALiBi's 3 mask kinds, the window or segment ids with and without the
    # cap) x dropout, in the fused, dQ and dK/dV kernels
    check(len(dyn) == 126 and {bwd[k][0] for k in dyn} == {"64", "128", "256"},
          f"the backward's instantiations of the offset on the card: {dyn}")
    print(f"[env] the backward's D 256, soft-cap, ALiBi, dropout and card-offset "
          f"instantiations run on mma.sync (HMMA), no spill: "
          f"{ {k: mma[k]['HMMA'] for k in new + drop + dyn} }")
    return name


def tensor_core_instructions(lib: str) -> dict[str, dict[str, int]]:
    """Tensor-core instructions (HMMA, HGMMA, IMMA) by kind in the SASS of
    each kernel of a built library (utils/sass.py)."""
    return sass.tensor_core_counts(sass.dump(_build.library_path(lib)))


def _gate(name: str, ref, out, atol: float, rtol: float = 1e-2) -> float:
    rep = verify_results(ref, out, atol=atol, rtol=rtol)
    print(f"[kernels] {name}: {rep} (atol={atol}, rtol={rtol}, cos>0.999)")
    check(rep.passed, f"{name} disagrees with its plain version: {rep}")
    return rep.max_abs_err


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(report: roofline.RooflineReport) -> dict:
    """The JSON line's bound fields from utils/roofline.py: the least time
    the card could take, the larger of the bytes over its memory rate and
    the operations over its peak rate for the inputs' type (the card's data
    sheet, roofline.detect_chip)."""
    return dict(bound_ms=report.bound_ms, bound_by=report.bound_by)


def event_time_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Milliseconds per eager call between CUDA events, for calls a CUDA
    graph cannot capture (an autograd backward); the host's launch cost is
    included, which is small beside the multi-millisecond calls timed so."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def grad_gate(name: str, ref, out, dtype: torch.dtype) -> float:
    tol = GRAD_TOL[dtype]
    rep = verify_results(ref, out, **tol)
    print(f"[kernels] {name}: {rep} ({tol}, cos>0.999)")
    check(rep.passed, f"{name} disagrees with its plain version: {rep}")
    return rep.max_abs_err


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    clock = PhaseClock()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = "cuda"
    bf16 = dict(dtype=torch.bfloat16, device=dev)

    # K1 at the prefill shapes (B=1, Hq=32, Hkv=4, D=64, causal), plus D=128
    # non-causal and S_q < S_k (bottom-right alignment).
    k1_err = 0.0
    cases = [(1, 32, 4, s, s, 64, True) for s in (128, 256, 200)]
    cases += [(2, 8, 2, 256, 256, 128, False), (1, 32, 4, 64, 256, 64, True)]
    for b, hq, hkv, s_q, s_k, d, causal in cases:
        q = torch.randn((b, hq, s_q, d), generator=gen, **bf16)
        k = torch.randn((b, hkv, s_k, d), generator=gen, **bf16)
        v = torch.randn((b, hkv, s_k, d), generator=gen, **bf16)
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal)
        o, lse = flash_fwd.flash_attention_forward(q, k, v, causal)
        o2, none = flash_fwd.flash_attention_forward(q, k, v, causal, need_lse=False)
        torch.cuda.synchronize()
        tag = f"K1 B={b} Hq={hq} Hkv={hkv} Sq={s_q} Sk={s_k} D={d} causal={causal}"
        k1_err = max(k1_err, _gate(tag + " O", o_ref, o, O_ATOL))
        _gate(tag + " LSE", lse_ref, lse, LSE_ATOL)
        check(none is None and torch.equal(o, o2), f"{tag}: need_lse=False changed O")
    # Head dims 32, 80 and 96, run in the 64 and 128 tiles (phase 23 takes
    # the errors into its rows).
    hd_k1_err = head_dim_k1_gates(gen)

    # K2 on a bf16 cache with NaN past every length.
    b, hq, hkv, d, s_max = 4, 32, 4, 64, 2048
    lengths = [1, 77, 1500, 2048]
    cache = KVCache(
        k=torch.randn((b, hkv, s_max, d), generator=gen, **bf16),
        v=torch.randn((b, hkv, s_max, d), generator=gen, **bf16),
        length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    for i, n in enumerate(lengths):
        cache.k[i, :, n:] = float("nan")
        cache.v[i, :, n:] = float("nan")
    k2_err = 0.0
    for t in (1, 4):
        q = torch.randn((b, hq, t, d), generator=gen, **bf16)
        o_ref = decode.decode_attention_reference(q, cache)
        o = (decode.decode_attention(q[:, :, 0].contiguous(), cache)[:, :, None]
             if t == 1 else decode.decode_attention_chunk(q, cache))
        torch.cuda.synchronize()
        tag = f"K2 B={b} Hq={hq} Hkv={hkv} D={d} Smax={s_max} T={t} lengths={lengths}"
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
        k2_err = max(k2_err, _gate(tag, o_ref, o, O_ATOL))

    # Times at the serving path's shapes: a 256-token prefill bucket, and
    # one decode step of the 4-slot batch.
    s = 256
    q = torch.randn((1, 32, s, 64), generator=gen, **bf16)
    k = torch.randn((1, 4, s, 64), generator=gen, **bf16)
    v = torch.randn((1, 4, s, 64), generator=gen, **bf16)
    k1_row = time_k1("prefill", q, k, v, need_lse=False)
    k1_d128_err = d128_forward(gen)
    qd = torch.randn((b, hq, d), generator=gen, **bf16)
    k2_ms = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
    k2_plain = cuda_time_ms(lambda: decode.decode_attention_reference(qd[:, :, None], cache))
    live_bytes = 2 * hkv * d * 2 * sum(lengths)
    print(f"[kernels] K2 B={b} Hq={hq} Hkv={hkv} D={d} Smax={s_max} T=1 lengths={lengths}: "
          f"kernel {k2_ms:.4f} ms ({live_bytes / (k2_ms * 1e-3) / 1e9:.1f} GB/s of live "
          f"cache), plain {k2_plain:.4f} ms")
    # SDPA with a boolean length mask over the whole cache (rows past a
    # length hold NaN, so its output is not looked at: it is timed only).
    mask = (torch.arange(s_max, device=dev)[None] < cache.length[:, None])[:, None, None]
    k2_lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], cache.k, cache.v, attn_mask=mask, enable_gqa=True))
    k2_bound = bound(roofline.decode_roofline(b, hq, hkv, d, lengths,
                                              cache_dtype=torch.bfloat16))
    print(f"[kernels] K2 bound {k2_bound}, SDPA with a length mask {k2_lib:.4f} ms")
    clock.done("2 K1 and K2")
    backward, k1_bwd_err = backward_kernels(gen)
    sdpa_forward_kernels(gen)
    clock.done("2 backward")
    timed = {
        "flash_fwd": dict(max_abs_err=max(k1_err, k1_d128_err, k1_bwd_err), **k1_row),
        "decode": dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                       library_ms=k2_lib, **k2_bound),
        "head_dim_k1_err": hd_k1_err,  # popped by run() for phase 23
    }
    timed.update(backward)
    for part in (quantized_decode_kernels, paged_decode_kernel, quant_matmul_kernels,
                 window_kernels, masked_kernels, softcap_kernels, alibi_kernels,
                 dynoff_kernels):
        timed.update(part(gen))
        clock.done(f"2 {part.__name__}")
    return timed


# K1's three timed shapes (B, Hq, Hkv, S, D), all causal: the serving
# prefill, the LLAMA_1B training forward, and D 128 at 16k tokens.
K1_SHAPES = {"prefill": (1, 32, 4, 256, 64), "D=128 headline": (4, 8, 8, 16384, 128),
             "training shape": (4, 32, 4, 2048, 64)}


def sdpa_forward_kernels(gen: torch.Generator) -> None:
    """Names the kernels SDPA's forward runs at each of K1's timed shapes:
    one torch.profiler session (a second session in one process may record
    no device event) over the three calls twice, device events in launch
    order from the second pass on (the first device activities of a session
    may go unrecorded); fails if a call shows no compute kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    inputs = {tag: [randn((b, h, s, d), gen) for h in (hq, hkv, hkv)]
              for tag, (b, hq, hkv, s, d) in K1_SHAPES.items()}

    def run():
        for q, k, v in inputs.values():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()

    run()
    mark = "sdpa forward, second pass"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        with record_function(mark):
            run()
    start = min(e.time_range.start for e in prof.events()
                if e.name == mark and e.device_type == DeviceType.CPU)
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                     and e.time_range.start >= start),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    print(f"[kernels] SDPA forward kernels at K1's shapes ({', '.join(K1_SHAPES)}, in "
          f"launch order; one profiler session): {names}")
    check(sum("memset" not in n.lower() for n in names) >= len(K1_SHAPES),
          f"the profiler shows no compute kernel for some SDPA forward call: {names}")


def time_k1(tag: str, q, k, v, need_lse: bool, plain: bool = True, few=None) -> dict:
    """K1 (causal, S_q = S_k) timed on the card beside its bound, its plain
    version (unless `plain` is False) and SDPA's forward; the JSON line's
    fields."""
    few = few or {}
    b, hq, s, d = q.shape
    ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, True,
                                                                need_lse=need_lse), **few)
    plain_ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
        q, k, v, True, need_lse=need_lse), warmup=1, iters=2, reps=3) if plain else None

    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), **few)
    report = roofline.attention_fwd_roofline(b, hq, k.shape[1], s, s, d, True,
                                             dtype_bytes=q.element_size(), need_lse=need_lse)
    flops, lim = report.flops, bound(report)
    print(f"[kernels] K1 {tag} B={b} Hq={hq} Hkv={k.shape[1]} S={s} D={d} causal "
          f"{'with' if need_lse else 'without'} LSE: kernel {ms:.4f} ms "
          f"({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {lim['bound_ms']:.5f} ms by "
          f"{lim['bound_by']}, plain "
          + (f"{plain_ms:.4f} ms" if plain else "left out (its score matrix would take "
             f"{4.0 * b * hq * s * s / 1e9:.0f} GB)")
          + f", SDPA forward {lib_ms:.4f} ms ({flops / (lib_ms * 1e-3) / 1e12:.2f} TFLOP/s)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **lim)


def d128_forward(gen: torch.Generator) -> float:
    """K1 at D 128, B 4, Hq = Hkv = 8, S 16384, causal, with the LSE (the
    source repository's headline forward shape): three slices of 256 q rows
    (the first, the middle and the last, whose kv loops turn the K/V ring
    most) against the plain version on the same keys, the rows' global
    position passed as pos_offset; the whole output finite, two calls
    bitwise equal, and timed with the plain version left out (its score
    matrix would not fit). Returns the largest O error."""
    b, h, hkv, s, d = K1_SHAPES["D=128 headline"]
    q, k, v = (randn((b, n, s, d), gen) for n in (h, hkv, hkv))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    o2, lse2 = flash_fwd.flash_attention_forward(q, k, v, True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
          "K1 D=128 S=16384: non-finite output")
    check(torch.equal(o, o2) and torch.equal(lse, lse2), "K1 D=128 S=16384: two calls differ")
    print("[kernels] K1 D=128 S=16384: O and LSE finite, two calls bitwise equal")
    err, rows = 0.0, 256
    for r0 in (0, s // 2 - rows // 2, s - rows):
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
            q[:, :, r0:r0 + rows], k, v, True, pos_offset=r0)
        tag = f"K1 B={b} Hq={h} Hkv={hkv} S={s} D={d} causal, q rows [{r0}, {r0 + rows})"
        err = max(err, _gate(tag + " O", o_ref, o[:, :, r0:r0 + rows], O_ATOL))
        _gate(tag + " LSE", lse_ref, lse[:, :, r0:r0 + rows], LSE_ATOL)
        del o_ref, lse_ref
    del o, o2, lse, lse2
    time_k1("D=128 headline", q, k, v, need_lse=True, plain=False,
            few=dict(warmup=1, iters=3, reps=3))
    return err


def randn(shape, gen, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device="cuda")


DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_SMAX = 4, 32, 4, 64, 2048
DEC_LENGTHS = [1, 77, 1500, 2048]


def filled_cache(mode: str, gen: torch.Generator, b: int = DEC_B, hkv: int = DEC_HKV,
                 d: int = DEC_D, lengths=DEC_LENGTHS) -> KVCache:
    """A cache (bf16, f32, int8 or fp8; Smax DEC_SMAX; the decode step's
    by default) filled with random tokens to `lengths`, with NaN past
    every length (quantized: fp8 code 0x7f and NaN scales), as a recycled
    slot may hold."""
    quant = mode if mode in ("int8", "fp8") else None
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    cache = kvcache.init_cache(b, hkv, DEC_SMAX, d, dtype=dtype, quant=quant)
    shape = (b, hkv, DEC_SMAX, d)
    kvcache.update_cache(cache, randn(shape, gen, dtype), randn(shape, gen, dtype),
                         assume_fits=True)
    cache.length.copy_(torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        if quant is None:
            cache.k[i, :, n:] = float("nan")
            cache.v[i, :, n:] = float("nan")
            continue
        if quant == "fp8":
            cache.k.view(torch.uint8)[i, :, n:] = 0x7F
            cache.v.view(torch.uint8)[i, :, n:] = 0x7F
        cache.k_scale[i, :, :, n:] = float("nan")
        cache.v_scale[i, :, :, n:] = float("nan")
    return cache


def decode_bound(cache_dtype: torch.dtype, qd: torch.Tensor) -> dict:
    """One decode step over the live cache: K and V once (one byte a value
    when quantized, plus two f32 scales a token and kv head), q and O once."""
    return bound(roofline.decode_roofline(DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_LENGTHS,
                                          cache_dtype=cache_dtype,
                                          q_dtype_bytes=qd.element_size()))


def quantized_decode_kernels(gen: torch.Generator) -> dict[str, dict]:
    """K2's int8 and fp8 modes against their plain version (int8 P
    requantized per 64-position tile, as the kernel does), at the decode
    step's shape with T 1 and T 256 (2048 query rows: the row tiling), then
    timed at T 1, and the int8 mode at T 256 (time_int8_chunk)."""
    out = {}
    for quant in ("int8", "fp8"):
        cache = filled_cache(quant, gen)
        err = 0.0
        for t in (1, 256):
            q = randn((DEC_B, DEC_HQ, t, DEC_D), gen)
            ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV)
            o = (decode.decode_attention(q[:, :, 0].contiguous(), cache)[:, :, None]
                 if t == 1 else decode.decode_attention_chunk(q, cache))
            torch.cuda.synchronize()
            tag = (f"K2 {quant} B={DEC_B} Hq={DEC_HQ} Hkv={DEC_HKV} D={DEC_D} "
                   f"Smax={DEC_SMAX} T={t} lengths={DEC_LENGTHS} (NaN past each length)")
            check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
            err = max(err, _gate(tag, ref, o, **QUANT_DECODE_TOL))
            if quant == "int8":  # not a gate: the JAX kernel's requantization block
                jax_ref = decode.decode_attention_reference(q, cache)
                print(f"[kernels] {tag}, for information, against the plain version "
                      f"requantizing P over the JAX kernel's block "
                      f"({decode.jax_int8_block(DEC_SMAX)} positions, not 64): "
                      f"{verify_results(jax_ref, o, **QUANT_DECODE_TOL)}")
        qd = randn((DEC_B, DEC_HQ, DEC_D), gen)
        ms = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
        plain = cuda_time_ms(lambda: decode.decode_attention_reference(
            qd[:, :, None], cache, requant_block=decode.BLOCK_KV))
        lim = decode_bound(cache.k.dtype, qd)
        lib = masked_sdpa_ms(qd, cache)
        print(f"[kernels] K2 {quant} T=1 decode step: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {lim['bound_ms']:.4f} ms by {lim['bound_by']}, SDPA with a length mask "
              f"on the dequantized bf16 cache {lib:.4f} ms")
        out[f"decode_{quant}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                      **lim)
        if quant == "int8":
            time_int8_chunk(cache, gen)
    return out


CHUNK_T = 256  # phase 6 (c)'s admission chunk


def time_int8_chunk(cache: KVCache, gen: torch.Generator) -> None:
    """K2 int8 at T 256 on the decode step's cache (2048 query rows a kv
    head, as a chunked admission runs it): kernel, plain version, bound,
    and SDPA on the dequantized bf16 cache with an explicit bottom-right
    causal mask (row t of a sequence of length n sees positions
    <= n - T + t; timed only: rows of the length-1 sequence see no key)."""
    t = CHUNK_T
    q = randn((DEC_B, DEC_HQ, t, DEC_D), gen)
    ms = cuda_time_ms(lambda: decode.decode_attention_chunk(q, cache))
    plain = cuda_time_ms(lambda: decode.decode_attention_reference(
        q, cache, requant_block=decode.BLOCK_KV), warmup=1, iters=2, reps=3)
    k = kvcache.dequantize(cache.k, cache.k_scale)
    v = kvcache.dequantize(cache.v, cache.v_scale)
    pos = torch.arange(DEC_SMAX, device="cuda")
    row_pos = cache.length[:, None] - t + torch.arange(t, device="cuda")[None]  # [B, T]
    mask = (pos[None, None, :] <= row_pos[:, :, None])[:, None]  # [B, 1, T, Smax]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    # Row t of a sequence of length n sees min(n, n - T + t + 1) positions.
    report = roofline.decode_roofline(DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_LENGTHS, t=t,
                                      cache_dtype=torch.int8)
    lim = bound(report)
    print(f"[kernels] K2 int8 T={t} chunk B={DEC_B} Hq={DEC_HQ} Hkv={DEC_HKV} D={DEC_D} "
          f"Smax={DEC_SMAX} lengths={DEC_LENGTHS}: kernel {ms:.4f} ms "
          f"({report.flops / (ms * 1e-3) / 1e12:.2f} TOP/s), plain "
          f"{plain:.4f} ms, bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}, SDPA with a "
          f"bottom-right causal mask on the dequantized bf16 cache {lib:.4f} ms")


def masked_sdpa_ms(qd: torch.Tensor, cache: KVCache) -> float:
    """Device ms of SDPA over a quantized cache dequantized to bf16 (outside
    the timed region, as the qmm rows time torch.matmul on the dequantized
    weight), with a boolean length mask; timed only (rows past a length hold
    NaN, so its output is not looked at)."""
    k = kvcache.dequantize(cache.k, cache.k_scale)
    v = kvcache.dequantize(cache.v, cache.v_scale)
    mask = (torch.arange(k.shape[2], device="cuda")[None] < cache.length[:, None])[:, None, None]
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], k, v, attn_mask=mask, enable_gqa=True))


def paged_copy(cache: KVCache, gen: torch.Generator) -> paged.PagedKVCache:
    """The dense cache's content in a pool of PAGE-token pages in scrambled
    order; table entries past each sequence's pages hold the sentinel."""
    b, hkv, s_max, d = cache.k.shape
    maxp = s_max // PAGE
    quant = None if not cache.quantized else (
        "int8" if cache.k.dtype == torch.int8 else "fp8")
    pool = paged.init_paged_cache(b, hkv, b * maxp + 3, PAGE, d, maxp,
                                  dtype=cache.k.dtype if quant is None else torch.bfloat16,
                                  quant=quant)
    perm = torch.randperm(b * maxp + 3, generator=torch.Generator().manual_seed(SEED)).tolist()
    for i in range(b):
        n = int(cache.length[i])
        live = paged.pages_needed(n, PAGE)
        table = perm[i * maxp:i * maxp + live] + [pool.num_pages] * (maxp - live)
        row = KVCache(k=cache.k[i:i + 1], v=cache.v[i:i + 1], length=cache.length[i:i + 1],
                      k_scale=None if quant is None else cache.k_scale[i:i + 1],
                      v_scale=None if quant is None else cache.v_scale[i:i + 1])
        paged.write_pages(pool, row, table)
        paged.set_block_table(pool, i, table, n)
    return pool


def paged_decode_kernel(gen: torch.Generator) -> dict[str, dict]:
    """The paged K2 (B7) on bf16 and int8 pools of 256-token pages in
    scrambled order: torch.equal against the dense K2 on the same content at
    T 1 and T 256, and its plain version; timed at T 1 on the int8 pool."""
    bf16_cache = KVCache(k=randn((DEC_B, DEC_HKV, DEC_SMAX, DEC_D), gen),
                         v=randn((DEC_B, DEC_HKV, DEC_SMAX, DEC_D), gen),
                         length=torch.tensor(DEC_LENGTHS, dtype=torch.int32, device="cuda"))
    err = 0.0
    for cache in (bf16_cache, filled_cache("int8", gen)):
        pool = paged_copy(cache, gen)
        mode = "int8" if cache.quantized else "bf16"
        for t in (1, 256):
            q = randn((DEC_B, DEC_HQ, t, DEC_D), gen)
            o = paged.paged_decode_attention_chunk(q, pool)
            dense = decode.decode_attention_chunk(q, cache)
            torch.cuda.synchronize()
            tag = f"paged K2 {mode} page={PAGE} scrambled T={t} lengths={DEC_LENGTHS}"
            check(torch.equal(o, dense), f"{tag}: differs from the dense K2")
            print(f"[kernels] {tag}: torch.equal to the dense K2 on the same content")
            ref = paged.paged_decode_reference(q, pool, requant_block=decode.BLOCK_KV)
            tol = QUANT_DECODE_TOL if cache.quantized else dict(atol=O_ATOL)
            err = max(err, _gate(tag, ref, o, **tol))
    qd = randn((DEC_B, DEC_HQ, DEC_D), gen)
    ms = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool))
    plain = cuda_time_ms(lambda: paged.paged_decode_reference(
        qd[:, :, None], pool, requant_block=decode.BLOCK_KV))
    lim = decode_bound(torch.int8, qd)
    lib = masked_sdpa_ms(qd, cache)  # the pool's content, as the dense int8 cache holds it
    print(f"[kernels] paged K2 int8 T=1 decode step: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {lim['bound_ms']:.4f} ms by {lim['bound_by']}, SDPA with a length mask on "
          f"the dequantized bf16 cache {lib:.4f} ms")
    return {"paged_decode": dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                 **lim)}


# The sliding window at MISTRAL_7B's widths (phase 2's window gates).
WIN = MISTRAL_7B.attn_window  # 4096
K1W_SHAPE = (1, 32, 8, 4608, 128)  # B, Hq, Hkv, S, D: the phase-9 prefill
K1W_WINDOWS = (1, 63, 64, 65, 1000, WIN, 2 * WIN)  # the last one past S
K2W_B, K2W_HQ, K2W_HKV, K2W_D, K2W_SMAX = 4, 32, 8, 128, MISTRAL_7B.max_seq_len
K2W_LENGTHS = [1, WIN - 96, WIN + 1, K2W_SMAX]  # on both sides of the window
K2W_SINKS = (0, 4)
F32_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 sums in another order, exp2 against exp
WINDOW_GAIN = 0.8  # K2 at length 8192, window 4096: at most this share of the unwindowed call


def window_kernels(gen: torch.Generator) -> dict[str, dict]:
    """K1, K2 and the paged K2 with a sliding window (and sinks) against
    their plain versions, then timed (window_k1, window_k2)."""
    out = {"flash_fwd_window": window_k1(gen)}
    out.update(window_k2(gen))
    return out


def window_mask(s_q: int, s_k: int, window: int) -> torch.Tensor:
    """SDPA's boolean [S_q, S_k] mask of a bottom-right causal window."""
    r = torch.arange(s_q, device="cuda")[:, None] + (s_k - s_q)
    c = torch.arange(s_k, device="cuda")[None, :]
    return (c <= r) & (c > r - window)


def window_k1(gen: torch.Generator) -> dict:
    """K1 with a window at the Mistral prefill shape, every window of
    K1W_WINDOWS (O and LSE), then S_q 1024 against S_k 4608 with
    pos_offset 3000 and window 1000, then the float32 kernel at a small
    shape; timed at window 4096 without the LSE, as the prefill calls it."""
    b, hq, hkv, s, d = K1W_SHAPE
    q, k, v = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv))
    err = 0.0
    cases = [(w, q, None) for w in K1W_WINDOWS] + [(1000, q[:, :, :1024].contiguous(), 3000)]
    for w, qc, off in cases:
        o, lse = flash_fwd.flash_attention_forward(qc, k, v, True, pos_offset=off, window=w)
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(qc, k, v, True,
                                                                     pos_offset=off, window=w)
        torch.cuda.synchronize()
        tag = (f"K1 window={w} B={b} Hq={hq} Hkv={hkv} Sq={qc.shape[2]} Sk={s} D={d} "
               f"pos_offset={off}")
        err = max(err, _gate(tag + " O", o_ref, o, O_ATOL))
        _gate(tag + " LSE", lse_ref, lse, LSE_ATOL)
        del o, lse, o_ref, lse_ref
    qf, kf, vf = (randn((1, h, 300, 64), gen, torch.float32) for h in (4, 2, 2))
    o, lse = flash_fwd.flash_attention_forward(qf, kf, vf, True, window=65)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(qf, kf, vf, True, window=65)
    torch.cuda.synchronize()
    tag = "K1 float32 window=65 B=1 Hq=4 Hkv=2 S=300 D=64"
    _gate(tag + " O", o_ref, o, **F32_TOL)
    _gate(tag + " LSE", lse_ref, lse, LSE_ATOL)

    ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, True, need_lse=False,
                                                                window=WIN))
    # The plain version by events around eager calls: a graph of its calls
    # would hold several of its 2.7 GB score matrices in its pool.
    gc.collect()
    torch.cuda.empty_cache()
    plain = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
        q, k, v, True, need_lse=False, window=WIN), warmup=1, iters=2)
    mask = window_mask(s, s, WIN)
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              enable_gqa=True),
                       warmup=1, iters=3, reps=3)
    report = roofline.attention_fwd_roofline(b, hq, hkv, s, s, d, True, need_lse=False,
                                             window=WIN)
    lim = bound(report)
    print(f"[kernels] K1 window={WIN} B={b} Hq={hq} Hkv={hkv} S={s} D={d} without LSE: kernel "
          f"{ms:.4f} ms ({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the window's "
          f"pairs), bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}, plain {plain:.4f} ms, "
          f"SDPA with a boolean window mask {lib:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **lim)


def window_cache(mode: str, gen: torch.Generator, lengths: list[int],
                 shape=(K2W_B, K2W_HKV, K2W_SMAX, K2W_D)) -> KVCache:
    """A cache of `shape` (B, Hkv, Smax, D; K2W's by default) in `mode`
    (bf16, f32, int8, fp8) holding `lengths` tokens, NaN past each length
    (fp8 code 0x7f and NaN scales when quantized)."""
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if mode in ("bf16", "f32"):
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        cache = KVCache(k=randn(shape, gen, dtype), v=randn(shape, gen, dtype), length=length)
    else:
        cache = kvcache.init_cache(*shape, quant=mode)
        kvcache.update_cache(cache, randn(shape, gen), randn(shape, gen), assume_fits=True)
        cache.length.copy_(length)
    for i, n in enumerate(lengths):
        if mode == "fp8":
            cache.k.view(torch.uint8)[i, :, n:] = 0x7F
            cache.v.view(torch.uint8)[i, :, n:] = 0x7F
        if cache.quantized:
            cache.k_scale[i, :, :, n:] = float("nan")
            cache.v_scale[i, :, :, n:] = float("nan")
        else:
            cache.k[i, :, n:] = float("nan")
            cache.v[i, :, n:] = float("nan")
    return cache


def window_k2(gen: torch.Generator) -> dict[str, dict]:
    """K2 with window 4096 and 0 or 4 sinks at lengths on both sides of the
    window, in all four cache modes at T 1 and T 256, against its plain
    version (int8 P requantized per 64-position tile, as the kernel does),
    and the paged K2 (pages of 256, scrambled) torch.equal to it; then both
    timed at T 1 on full 8192-token bf16 caches, and K2 there held to at
    most WINDOW_GAIN of the same call without a window (the live bytes
    halve: the dead tiles are not read)."""
    err = {"decode_window": 0.0, "paged_decode_window": 0.0}
    for mode in ("bf16", "f32", "int8", "fp8"):
        cache = window_cache(mode, gen, K2W_LENGTHS)
        pool = paged_copy(cache, gen)
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        tol = (QUANT_DECODE_TOL if cache.quantized else
               F32_TOL if mode == "f32" else dict(atol=O_ATOL))
        for sink in K2W_SINKS:
            for t in (1, 256):
                q = randn((K2W_B, K2W_HQ, t, K2W_D), gen, dtype)
                kw = dict(window=WIN, sink=sink)
                o = (decode.decode_attention(q[:, :, 0].contiguous(), cache, **kw)[:, :, None]
                     if t == 1 else decode.decode_attention_chunk(q, cache, **kw))
                o_paged = paged.paged_decode_attention_chunk(q, pool, **kw)
                ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                                        **kw)
                torch.cuda.synchronize()
                tag = (f"K2 {mode} window={WIN} sink={sink} B={K2W_B} Hq={K2W_HQ} "
                       f"Hkv={K2W_HKV} D={K2W_D} Smax={K2W_SMAX} T={t} lengths={K2W_LENGTHS}")
                check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
                e = _gate(tag, ref, o, **tol)
                err["decode_window"] = max(err["decode_window"], e)
                check(torch.equal(o_paged, o), f"paged {tag}: differs from the dense K2")
                err["paged_decode_window"] = max(err["paged_decode_window"], e)
                print(f"[kernels] paged {tag} (pages of {PAGE}, scrambled): torch.equal to "
                      "the dense K2")
                del q, o, o_paged, ref
        del cache, pool

    full = window_cache("bf16", gen, [K2W_SMAX] * K2W_B)
    pool = paged_copy(full, gen)
    qd = randn((K2W_B, K2W_HQ, K2W_D), gen)
    sink = K2W_SINKS[-1]
    kw = dict(window=WIN, sink=sink)
    ms = cuda_time_ms(lambda: decode.decode_attention(qd, full, **kw))
    no_window = cuda_time_ms(lambda: decode.decode_attention(qd, full))
    paged_ms = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool, **kw))
    plain = cuda_time_ms(lambda: decode.decode_attention_reference(qd[:, :, None], full, **kw))
    paged_plain = cuda_time_ms(lambda: paged.paged_decode_reference(qd[:, :, None], pool, **kw))
    pos = torch.arange(K2W_SMAX, device="cuda")
    row = (full.length - 1)[:, None]
    mask = ((pos[None] <= row) & ((pos[None] > row - WIN) | (pos[None] < sink)))[:, None, None]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], full.k, full.v, attn_mask=mask, enable_gqa=True))
    lim = bound(roofline.decode_roofline(K2W_B, K2W_HQ, K2W_HKV, K2W_D, [K2W_SMAX] * K2W_B,
                                         window=WIN, sink=sink))
    tag = (f"K2 bf16 window={WIN} sink={sink} B={K2W_B} Hq={K2W_HQ} Hkv={K2W_HKV} D={K2W_D} "
           f"T=1, every length {K2W_SMAX}")
    print(f"[kernels] {tag}: kernel {ms:.4f} ms, the same call without a window {no_window:.4f} "
          f"ms (ratio {ms / no_window:.3f}, must be <= {WINDOW_GAIN}); paged {paged_ms:.4f} ms; "
          f"plain {plain:.4f} ms, paged plain {paged_plain:.4f} ms; bound {lim['bound_ms']:.5f} "
          f"ms by {lim['bound_by']}; SDPA with a boolean window mask {lib:.4f} ms")
    check(ms <= WINDOW_GAIN * no_window,
          f"{tag}: {ms:.4f} ms is more than {WINDOW_GAIN} x the unwindowed {no_window:.4f} ms")
    return {
        "decode_window": dict(max_abs_err=err["decode_window"], ms=ms, plain_ms=plain,
                              library_ms=lib, **lim),
        "paged_decode_window": dict(max_abs_err=err["paged_decode_window"], ms=paged_ms,
                                    plain_ms=paged_plain, library_ms=lib, **lim),
    }


# The logit soft-cap and head dim 256 in K1 and K2 at GEMMA2_9B's widths
# (phase 2's soft-cap gates): its prefill (S 4608, past the local layers'
# 4096-token window) and its decode step (B 2, Smax 8192).
CAP = GEMMA2_9B.logit_softcap  # 50
GWIN = GEMMA2_9B.attn_window  # 4096
GEMMA_PREFILL = (1, 16, 8, 4608, 256)  # B, Hq, Hkv, S, D
GK2_B, GK2_HQ, GK2_HKV, GK2_D, GK2_SMAX = 2, 16, 8, 256, GEMMA2_9B.max_seq_len
GK2_LENGTHS = ([1, GK2_SMAX], [GWIN - 96, GWIN + 1])  # on both sides of the window
HOT = 30.0  # q's factor on the hot inputs: logits to about +-100, the tanh saturated


def softcap_kernels(gen: torch.Generator) -> dict[str, dict]:
    """K1, K2 and the paged K2 with the soft-cap (and D 256) against their
    plain versions, then timed (softcap_k1, softcap_k2); then the backward
    kernels with the cap and K1 with the cap and segment ids
    (softcap_backward_kernels)."""
    out = {"flash_fwd_softcap": softcap_k1(gen)}
    out.update(softcap_k2(gen))
    backward = softcap_backward_kernels(gen)
    k1 = out["flash_fwd_softcap"]
    k1["max_abs_err"] = max(k1["max_abs_err"], backward.pop("flash_fwd_softcap")["max_abs_err"])
    out.update(backward)
    return out


def k1_case(tag: str, q, k, v, causal: bool, err: float, f32: bool = False, **kw) -> float:
    """One K1 call (O and LSE) against its plain version; the largest O
    error so far."""
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    tag = (f"K1 {tag} B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} Sq={q.shape[2]} "
           f"Sk={k.shape[2]} D={q.shape[3]} causal={causal} {kw}")
    e = _gate(tag + " O", o_ref, o, **(F32_TOL if f32 else dict(atol=O_ATOL)))
    _gate(tag + " LSE", lse_ref, lse, LSE_ATOL)
    return max(err, e)


def library_text(ms: float | None, measured: bool = True) -> str:
    """A library time as printed: its milliseconds, "not run" where it did
    not compile, or "not measured" for a case that gives no JSON row (its
    compilation would cost the run seconds for a number no row reads)."""
    if not measured:
        return "not measured (no row)"
    return f"{ms:.4f} ms" if ms else "not run"


def flex_mod_ms(q, k, v, window: int | None, segment_ids=None, do=None,
                cap: float = CAP, slopes: torch.Tensor | None = None) -> float | None:
    """torch.nn.attention.flex_attention with a soft-cap score_mod, or with
    `slopes` an ALiBi one (slope_h * (key position - query position)), and
    the causal (window, segment-id) block mask, compiled, the S_q queries at
    the last S_q of the S_k positions (S_q == S_k in training and prefill,
    1 at a decode step): its forward, or with `do` its backward
    (autograd.grad of O against do): a competitor only, never used by the
    port. None, with the reason printed, where it does not compile on this
    machine."""
    what = "backward" if do is not None else "forward"
    mod = "a soft-cap" if slopes is None else "an ALiBi"
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        torch._dynamo.reset()  # the earlier compilations would pass its recompile limit
        s_q, s_k = q.shape[2], k.shape[2]
        off = s_k - s_q  # bottom-right alignment

        def score_mod(score, b, h, q_idx, kv_idx):
            if slopes is not None:
                return score + slopes[h] * (kv_idx - q_idx - off).to(torch.float32)
            return cap * torch.tanh(score / cap)

        def mask_mod(b, h, q_idx, kv_idx):
            seen = kv_idx <= q_idx + off
            if window:
                seen = seen & (kv_idx > q_idx + off - window)
            if segment_ids is not None:
                seen = seen & (segment_ids[0][b, q_idx] == segment_ids[1][b, kv_idx])
            return seen

        batch = None if segment_ids is None else q.shape[0]
        block_mask = create_block_mask(mask_mod, batch, None, s_q, s_k, device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        leaves = [t.detach().requires_grad_(do is not None) for t in (q, k, v)]
        out = flex(*leaves, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "flex_attention gave non-finite output")
        if do is None:
            run = lambda: flex(q, k, v, score_mod=score_mod,  # noqa: E731
                               block_mask=block_mask, enable_gqa=True)
        else:
            run = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        if not FLEX_TIMED:  # flex_warmup's process: compile (the backward's too), time nothing
            run()
            return None
        return event_time_ms(run, warmup=2, iters=10 if do is None else 3)
    except Exception as e:  # a competitor that does not build here is reported, not run
        print(f"[kernels] flex_attention {what} with {mod} score_mod (window={window}, "
              f"segment ids {segment_ids is not None}) did not run on this machine: "
              f"{type(e).__name__}: {str(e).splitlines()[0][:200] if str(e) else ''}")
        return None


def softcap_k1(gen: torch.Generator) -> dict:
    """K1 with the soft-cap: at GEMMA2_9B's prefill (cap 50, global and
    local layers, each also on hot inputs whose logits reach the cap),
    D 256 without the cap, the cap at D 64 and D 128 (normal and hot), S_q
    1024 against S_k 4608 with pos_offset 3000, non-causal, and the float32 kernel at a small
    shape; then timed at the prefill as the model calls it (no LSE), beside
    SDPA without the cap (with the boolean window mask on a local layer)
    and flex_attention with a soft-cap score_mod where it compiles."""
    b, hq, hkv, s, d = GEMMA_PREFILL
    q, k, v = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv))
    err = 0.0
    hot = (q * HOT).to(torch.bfloat16)
    for w in (None, GWIN):
        err = k1_case("GEMMA2_9B prefill", q, k, v, True, err, window=w, logit_softcap=CAP)
        err = k1_case(f"hot (q x {HOT:g})", hot, k, v, True, err, window=w, logit_softcap=CAP)
    del hot
    err = k1_case("D 256 without a cap", q, k, v, True, err)
    for dd, hk, w in ((64, 4, None), (128, 8, 1000)):
        qd, kd, vd = (randn((1, h, 2048, dd), gen) for h in (32, hk, hk))
        err = k1_case("cap 30", qd, kd, vd, True, err, window=w, logit_softcap=30.0)
        err = k1_case(f"cap 30 hot (q x {HOT:g})", (qd * HOT).to(torch.bfloat16), kd, vd, True,
                      err, window=w, logit_softcap=30.0)
    err = k1_case("S_q != S_k", q[:, :, :1024].contiguous(), k, v, True, err, pos_offset=3000,
                  window=1000, logit_softcap=CAP)
    err = k1_case("non-causal", q[:, :, :2048].contiguous(), k[:, :, :2048].contiguous(),
                  v[:, :, :2048].contiguous(), False, err, logit_softcap=CAP)
    qf, kf, vf = (randn((1, h, 300, 256), gen, torch.float32) for h in (4, 2, 2))
    for w in (None, 65):
        k1_case("float32", qf, kf, vf, True, 0.0, f32=True, window=w, logit_softcap=30.0)

    rows = {}
    for w, layer in ((None, "global"), (GWIN, "local")):
        ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, need_lse=False, window=w, logit_softcap=CAP))
        gc.collect()
        torch.cuda.empty_cache()
        plain = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
            q, k, v, True, need_lse=False, window=w, logit_softcap=CAP), warmup=1, iters=2)
        if w is None:
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            mask = window_mask(s, s, w)
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), warmup=1, iters=3, reps=3)
        flex = flex_mod_ms(q, k, v, w) if layer == "global" else None  # the row's layer
        report = roofline.attention_fwd_roofline(b, hq, hkv, s, s, d, True, need_lse=False,
                                                 window=w)
        lim = bound(report)
        print(f"[kernels] K1 soft-cap {CAP:g} {layer} layer (window={w}) B={b} Hq={hq} "
              f"Hkv={hkv} S={s} D={d} without LSE: kernel {ms:.4f} ms "
              f"({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {lim['bound_ms']:.5f}"
              f" ms by {lim['bound_by']}, plain {plain:.4f} ms, library: flex_attention with "
              f"a soft-cap score_mod " + library_text(flex, layer == "global")
              + f" (extra, another function: SDPA without the cap"
              f"{' with a boolean window mask' if w else ''} {lib:.4f} ms)")
        rows[layer] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=flex, **lim)
    return rows["global"]


def softcap_k2(gen: torch.Generator) -> dict[str, dict]:
    """K2 with cap 50 at GEMMA2_9B's decode widths (B 2, Hq 16, Hkv 8,
    D 256, Smax 8192) with lengths on both sides of the window, window 4096
    and none, in all four cache modes at T 1 and T 256 (and hot inputs on
    the bf16 cache at T 1 and the int8 and fp8 caches at T 256), against
    its plain version (int8 P requantized per 64-position tile, as the
    kernel does), and the paged K2 torch.equal to
    it in each case; then both timed at T 1 on full 8192-token bf16 caches
    (global and local layers) beside SDPA without the cap, and the int8
    cache at T 256 (the paged server's admission chunk)."""
    shape = (GK2_B, GK2_HKV, GK2_SMAX, GK2_D)
    err = {"decode_softcap": 0.0, "paged_decode_softcap": 0.0}
    for mode in ("bf16", "f32", "int8", "fp8"):
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        tol = (QUANT_DECODE_TOL if mode in ("int8", "fp8") else
               F32_TOL if mode == "f32" else dict(atol=O_ATOL))
        for lengths in GK2_LENGTHS:
            cache = window_cache(mode, gen, lengths, shape)
            pool = paged_copy(cache, gen)
            for w in (None, GWIN):
                for t in (1, 256):
                    hot = (mode, t) in (("bf16", 1), ("int8", 256), ("fp8", 256))
                    heats = (1.0, HOT) if hot else (1.0,)
                    for heat in heats:
                        q = (randn((GK2_B, GK2_HQ, t, GK2_D), gen) * heat).to(dtype)
                        kw = dict(window=w, logit_softcap=CAP)
                        o = (decode.decode_attention(q[:, :, 0].contiguous(), cache,
                                                     **kw)[:, :, None]
                             if t == 1 else decode.decode_attention_chunk(q, cache, **kw))
                        o_paged = paged.paged_decode_attention_chunk(q, pool, **kw)
                        ref = decode.decode_attention_reference(
                            q, cache, requant_block=decode.BLOCK_KV, **kw)
                        torch.cuda.synchronize()
                        tag = (f"K2 {mode} soft-cap {CAP:g} window={w} B={GK2_B} Hq={GK2_HQ} "
                               f"Hkv={GK2_HKV} D={GK2_D} Smax={GK2_SMAX} T={t} "
                               f"lengths={lengths}" + (f" hot (q x {heat:g})" if heat != 1.0
                                                       else ""))
                        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
                        e = _gate(tag, ref, o, **tol)
                        err["decode_softcap"] = max(err["decode_softcap"], e)
                        check(torch.equal(o_paged, o), f"paged {tag}: differs from the dense K2")
                        err["paged_decode_softcap"] = max(err["paged_decode_softcap"], e)
                        print(f"[kernels] paged {tag} (pages of {PAGE}, scrambled): "
                              "torch.equal to the dense K2")
                        del q, o, o_paged, ref
            del cache, pool

    full = window_cache("bf16", gen, [GK2_SMAX] * GK2_B, shape)
    pool = paged_copy(full, gen)
    qd = randn((GK2_B, GK2_HQ, GK2_D), gen)
    pos = torch.arange(GK2_SMAX, device="cuda")
    rows = {}
    for w, layer in ((None, "global"), (GWIN, "local")):
        kw = dict(window=w, logit_softcap=CAP)
        ms = cuda_time_ms(lambda: decode.decode_attention(qd, full, **kw))
        paged_ms = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool, **kw))
        plain = cuda_time_ms(lambda: decode.decode_attention_reference(qd[:, :, None], full,
                                                                       **kw))
        paged_plain = cuda_time_ms(lambda: paged.paged_decode_reference(qd[:, :, None], pool,
                                                                        **kw))
        if w is None:
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qd[:, :, None], full.k, full.v, enable_gqa=True))
        else:
            row = (full.length - 1)[:, None]
            mask = ((pos[None] <= row) & (pos[None] > row - w))[:, None, None]
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qd[:, :, None], full.k, full.v, attn_mask=mask, enable_gqa=True))
        lim = bound(roofline.decode_roofline(GK2_B, GK2_HQ, GK2_HKV, GK2_D, [GK2_SMAX] * GK2_B,
                                             window=w))
        # The library call computes the same function: flex_attention with
        # the cap's score_mod (every length is GK2_SMAX: the causal mask of
        # the last position keeps them all).
        flex = flex_mod_ms(qd[:, :, None], full.k, full.v, w) if layer == "global" else None
        print(f"[kernels] K2 bf16 soft-cap {CAP:g} {layer} layer (window={w}) B={GK2_B} "
              f"Hq={GK2_HQ} Hkv={GK2_HKV} D={GK2_D} T=1, every length {GK2_SMAX}: kernel "
              f"{ms:.4f} ms, paged {paged_ms:.4f} ms; plain {plain:.4f} ms, paged plain "
              f"{paged_plain:.4f} ms; bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}; "
              f"library: flex_attention with a soft-cap score_mod "
              + library_text(flex, layer == "global")
              + f" (extra, another function: SDPA without the cap"
              f"{' with a boolean window mask' if w else ''} {lib:.4f} ms)")
        rows[layer] = {
            "decode_softcap": dict(max_abs_err=err["decode_softcap"], ms=ms, plain_ms=plain,
                                   library_ms=flex, **lim),
            "paged_decode_softcap": dict(max_abs_err=err["paged_decode_softcap"],
                                         ms=paged_ms, plain_ms=paged_plain, library_ms=flex,
                                         **lim)}
    del full, pool
    cache8 = window_cache("int8", gen, [GK2_SMAX] * GK2_B, shape)
    q8 = randn((GK2_B, GK2_HQ, CHUNK_T, GK2_D), gen)
    for w in (None, GWIN):
        ms = cuda_time_ms(lambda: decode.decode_attention_chunk(q8, cache8, window=w,
                                                                logit_softcap=CAP))
        lim = bound(roofline.decode_roofline(GK2_B, GK2_HQ, GK2_HKV, GK2_D, [GK2_SMAX] * GK2_B,
                                             t=CHUNK_T, cache_dtype=torch.int8, window=w))
        print(f"[kernels] K2 int8 soft-cap {CAP:g} window={w} B={GK2_B} Hq={GK2_HQ} "
              f"Hkv={GK2_HKV} D={GK2_D} T={CHUNK_T}, every length {GK2_SMAX}: kernel "
              f"{ms:.4f} ms, bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}")
    return rows["global"]


# ALiBi (phase 2's ALiBi gates; phase 17 serves LLAMA_8B with use_alibi):
# K1 at the serving prefill (K1_SHAPES) and at LLAMA_8B's heads over phase
# 9's 4,608-token prefill, K2 at the decode step's shape (DEC_*) at T 1 and
# T 256, and at LLAMA_8B's heads with a window and sinks.
ALIBI_PREFILL = (1, 32, 8, 4608, 128)  # B, Hq, Hkv, S, D
ALIBI_STEEP = 0.8408964276313782  # default_alibi_slopes(32)[0]: 0.84 a position
LSE_SPLIT = 1024  # the sequence-split decode's first part: positions [0, 1024)


def flex_ms(q, k, v, ends=None, slopes=None, window=None, return_lse=False,
            what="ALiBi") -> float | None:
    """torch.nn.attention.flex_attention, compiled, over the causal block
    mask of the S_q queries at the positions ends[b] - S_q + i (ends: a [B]
    int32 tensor of sequence lengths, or every sequence S_k long), with the
    ALiBi score_mod slope_h * (key position - query position) where slopes
    are given, returning the LSE too with `return_lse`: its forward, a
    competitor only, never used by the port. None, with the reason printed,
    where it does not compile on this machine. Dynamo's caches are emptied
    first: the earlier competitors' compilations would otherwise pass its
    recompile limit, and it would run flex_attention eagerly."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        torch._dynamo.reset()

        b, _, s_q, _ = q.shape
        s_k = k.shape[2]
        ends = (torch.full((b,), s_k, dtype=torch.int32, device="cuda") if ends is None
                else ends)

        def row(b_i, q_idx):
            return ends[b_i] - s_q + q_idx

        def mask_mod(b_i, h, q_idx, kv_idx):
            seen = kv_idx <= row(b_i, q_idx)
            if window:
                seen = seen & (kv_idx > row(b_i, q_idx) - window)
            return seen

        def score_mod(score, b_i, h, q_idx, kv_idx):
            if slopes is None:
                return score
            return score + slopes[h] * (kv_idx - row(b_i, q_idx)).to(torch.float32)

        block_mask = create_block_mask(mask_mod, b, None, s_q, s_k, device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        run = lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask,  # noqa: E731
                           enable_gqa=True, return_lse=return_lse)
        out = run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out[0] if return_lse else out).all()),
              "flex_attention gave non-finite output")
        if not FLEX_TIMED:
            return None
        return event_time_ms(run, warmup=2, iters=10)
    except Exception as e:  # a competitor that does not build here is reported, not run
        print(f"[kernels] flex_attention with {what} (window={window}) did not run on this "
              f"machine: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200] if str(e) else ''}")
        return None


def alibi_kernels(gen: torch.Generator) -> dict[str, dict]:
    """K1, K2 and the paged K2 with ALiBi against their plain versions,
    then timed (alibi_k1, alibi_k2), K2's LSE output (decode_lse), and the
    backward kernels with ALiBi, K1 with ALiBi and segment ids
    (alibi_backward_kernels)."""
    out = {"flash_fwd_alibi": alibi_k1(gen)}
    out.update(alibi_k2(gen))
    out["decode_lse"] = decode_lse(gen)
    out.update(alibi_backward_kernels(gen))
    return out


def alibi_k1(gen: torch.Generator) -> dict:
    """K1 with ALiBi (the standard slopes): at the serving prefill (D 64)
    and at LLAMA_8B's heads over a 4,608-token prefill (D 128), with and
    without a 1,000-token window; D 256; S_q 1024 against S_k 4608 with
    pos_offset 3000; non-causal; one head at the steepest standard slope
    over 16,384 keys (biases near -20,000 in the log2 domain on its far
    tiles); the float32 kernel at a small shape. Then timed, as the model
    calls it (no LSE), at both prefill shapes beside K1 without ALiBi on
    the same inputs, its plain version, its bound (the plain causal count:
    ALiBi adds no pair) and flex_attention with an ALiBi score_mod. The
    row is LLAMA_8B's."""
    err = 0.0
    b, hq, hkv, s, d = K1_SHAPES["prefill"]
    pq, pk, pv = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv))
    err = k1_case("ALiBi, serving prefill", pq, pk, pv, True, err, alibi=True)
    b, hq, hkv, s, d = ALIBI_PREFILL
    q, k, v = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv))
    for w in (None, 1000):
        err = k1_case("ALiBi, LLAMA_8B heads", q, k, v, True, err, window=w, alibi=True)
    q2, k2, v2 = (randn((1, h, 2048, 256), gen) for h in (16, 8, 8))
    for w in (None, 1000):
        err = k1_case("ALiBi, D 256", q2, k2, v2, True, err, window=w, alibi=True)
    del q2, k2, v2
    err = k1_case("ALiBi, S_q != S_k", q[:, :, :1024].contiguous(), k, v, True, err,
                  pos_offset=3000, window=1000, alibi=True)
    err = k1_case("ALiBi, non-causal", q[:, :, :2048].contiguous(), k[:, :, :2048].contiguous(),
                  v[:, :, :2048].contiguous(), False, err, alibi=True)
    ql, kl, vl = (randn((1, 1, 16384, 128), gen) for _ in range(3))
    err = k1_case(f"ALiBi, one head of slope {ALIBI_STEEP:.4f} over 16,384 keys", ql, kl, vl,
                  True, err, alibi=True,
                  alibi_slopes=torch.tensor([ALIBI_STEEP], device="cuda"))
    del ql, kl, vl
    qf, kf, vf = (randn((1, h, 300, 128), gen, torch.float32) for h in (4, 2, 2))
    for w in (None, 65):
        k1_case("ALiBi, float32", qf, kf, vf, True, 0.0, f32=True, window=w, alibi=True)

    rows = {}
    for tag, (qq, kk, vv) in (("serving prefill", (pq, pk, pv)),
                              ("LLAMA_8B prefill", (q, k, v))):
        b, hq, s, d = qq.shape
        hkv = kk.shape[1]
        slopes = flash_fwd.alibi_table(True, None, hq, qq.device)
        ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            qq, kk, vv, True, need_lse=False, alibi=True))
        base = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            qq, kk, vv, True, need_lse=False))
        gc.collect()
        torch.cuda.empty_cache()
        plain = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
            qq, kk, vv, True, need_lse=False, alibi=True), warmup=1, iters=2)
        row = tag == "LLAMA_8B prefill"
        flex = flex_ms(qq, kk, vv, slopes=slopes) if row else None
        report = roofline.attention_fwd_roofline(b, hq, hkv, s, s, d, True, need_lse=False)
        lim = bound(report)
        print(f"[kernels] K1 ALiBi {tag} B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal without "
              f"LSE: kernel {ms:.4f} ms ({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; "
              f"without ALiBi {base:.4f} ms, ratio {ms / base:.3f}), bound "
              f"{lim['bound_ms']:.5f} ms by {lim['bound_by']}, plain {plain:.4f} ms, library: "
              f"flex_attention with an ALiBi score_mod " + library_text(flex, row))
        rows[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=flex, **lim)
    return rows["LLAMA_8B prefill"]


def alibi_k2(gen: torch.Generator) -> dict[str, dict]:
    """K2 with ALiBi (the standard slopes) against its plain version (int8
    P requantized per 64-position tile, as the kernel does) at the decode
    step's shape (lengths 1/77/1500/2048, NaN past each) in all four cache
    modes at T 1 and T 256, the paged K2 torch.equal to it on the bf16 and
    int8 caches; at LLAMA_8B's heads (Hq 32, Hkv 8, D 128, Smax 8192) with
    window 4096 and 4 sinks, lengths on both sides of the window; one head
    at the steepest standard slope on an int8 cache of 2,048 at T 1 and
    256. Then timed at the decode shape (bf16 and int8 at T 1 and T 256,
    the paged int8 pool at T 1) beside K2 without ALiBi on the same inputs,
    the plain version, the bound (ALiBi adds no pair) and flex_attention
    with an ALiBi score_mod and the length mask (on the dequantized cache
    for int8). Rows: decode_alibi (bf16), decode_int8_alibi,
    paged_decode_alibi (int8 pool), each at T 1."""
    shape = (DEC_B, DEC_HKV, DEC_SMAX, DEC_D)
    err = {"decode_alibi": 0.0, "decode_int8_alibi": 0.0, "paged_decode_alibi": 0.0}
    caches = {}
    for mode in ("bf16", "f32", "int8", "fp8"):
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        tol = (QUANT_DECODE_TOL if mode in ("int8", "fp8") else
               F32_TOL if mode == "f32" else dict(atol=O_ATOL))
        cache = window_cache(mode, gen, DEC_LENGTHS, shape)
        pool = paged_copy(cache, gen) if mode in ("bf16", "int8") else None
        for t in (1, 256):
            q = randn((DEC_B, DEC_HQ, t, DEC_D), gen, dtype)
            o = (decode.decode_attention(q[:, :, 0].contiguous(), cache, alibi=True)[:, :, None]
                 if t == 1 else decode.decode_attention_chunk(q, cache, alibi=True))
            ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                                    alibi=True)
            torch.cuda.synchronize()
            tag = (f"K2 {mode} ALiBi B={DEC_B} Hq={DEC_HQ} Hkv={DEC_HKV} D={DEC_D} "
                   f"Smax={DEC_SMAX} T={t} lengths={DEC_LENGTHS} (NaN past each length)")
            check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
            e = _gate(tag, ref, o, **tol)
            row = "decode_int8_alibi" if mode == "int8" else "decode_alibi"
            err[row] = max(err[row], e)
            if pool is not None:
                o_paged = paged.paged_decode_attention_chunk(q, pool, alibi=True)
                check(torch.equal(o_paged, o), f"paged {tag}: differs from the dense K2")
                print(f"[kernels] paged {tag} (pages of {PAGE}, scrambled): torch.equal to "
                      "the dense K2")
                err["paged_decode_alibi"] = max(err["paged_decode_alibi"], e)
        if mode in ("bf16", "int8"):
            caches[mode] = (cache, pool)
    wshape = (K2W_B, K2W_HKV, K2W_SMAX, K2W_D)
    for mode in ("bf16", "int8"):
        cache = window_cache(mode, gen, K2W_LENGTHS, wshape)
        pool = paged_copy(cache, gen)
        for t in (1, 256):
            q = randn((K2W_B, K2W_HQ, t, K2W_D), gen)
            kw = dict(window=WIN, sink=4, alibi=True)
            o = decode.decode_attention_chunk(q, cache, **kw)
            o_paged = paged.paged_decode_attention_chunk(q, pool, **kw)
            ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                                    **kw)
            torch.cuda.synchronize()
            tag = (f"K2 {mode} ALiBi window={WIN} sink=4 B={K2W_B} Hq={K2W_HQ} Hkv={K2W_HKV} "
                   f"D={K2W_D} Smax={K2W_SMAX} T={t} lengths={K2W_LENGTHS}")
            e = _gate(tag, ref, o, **(QUANT_DECODE_TOL if mode == "int8" else
                                      dict(atol=O_ATOL)))
            check(torch.equal(o_paged, o), f"paged {tag}: differs from the dense K2")
            row = "decode_int8_alibi" if mode == "int8" else "decode_alibi"
            err[row] = max(err[row], e)
            err["paged_decode_alibi"] = max(err["paged_decode_alibi"], e)
        del cache, pool
    steep = window_cache("int8", gen, [2048], (1, 1, 2048, DEC_D))
    slopes = torch.tensor([ALIBI_STEEP], device="cuda")
    for t in (1, 256):
        q = randn((1, 1, t, DEC_D), gen)
        o = decode.decode_attention_chunk(q, steep, alibi=True, alibi_slopes=slopes)
        ref = decode.decode_attention_reference(q, steep, requant_block=decode.BLOCK_KV,
                                                alibi=True, alibi_slopes=slopes)
        torch.cuda.synchronize()
        tag = f"K2 int8 ALiBi one head of slope {ALIBI_STEEP:.4f}, Smax 2048, T={t}"
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
        err["decode_int8_alibi"] = max(err["decode_int8_alibi"],
                                       _gate(tag, ref, o, **QUANT_DECODE_TOL))

    slopes = flash_fwd.alibi_table(True, None, DEC_HQ, torch.device("cuda"))
    ends = torch.tensor(DEC_LENGTHS, dtype=torch.int32, device="cuda")
    rows = {}
    for mode in ("bf16", "int8"):
        cache, pool = caches[mode]
        k = cache.k if mode == "bf16" else kvcache.dequantize(cache.k, cache.k_scale)
        v = cache.v if mode == "bf16" else kvcache.dequantize(cache.v, cache.v_scale)
        for t in (1, CHUNK_T):
            q = randn((DEC_B, DEC_HQ, t, DEC_D), gen)
            one = q[:, :, 0].contiguous()
            if t == 1:
                ms = cuda_time_ms(lambda: decode.decode_attention(one, cache, alibi=True))
                base = cuda_time_ms(lambda: decode.decode_attention(one, cache))
            else:
                ms = cuda_time_ms(lambda: decode.decode_attention_chunk(q, cache, alibi=True))
                base = cuda_time_ms(lambda: decode.decode_attention_chunk(q, cache))
            plain = cuda_time_ms(lambda: decode.decode_attention_reference(
                q, cache, requant_block=decode.BLOCK_KV, alibi=True), warmup=1, iters=2, reps=3)
            # The lengths' masked-out rows hold NaN; flex's mask keeps them out.
            k_live = torch.nan_to_num(k)
            v_live = torch.nan_to_num(v)
            flex = flex_ms(q, k_live, v_live, ends=ends, slopes=slopes) if t == 1 else None
            lim = bound(roofline.decode_roofline(DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_LENGTHS,
                                                 t=t, cache_dtype=cache.k.dtype))
            print(f"[kernels] K2 {mode} ALiBi B={DEC_B} Hq={DEC_HQ} Hkv={DEC_HKV} D={DEC_D} "
                  f"Smax={DEC_SMAX} T={t} lengths={DEC_LENGTHS}: kernel {ms:.4f} ms (without "
                  f"ALiBi {base:.4f} ms, ratio {ms / base:.3f}), plain {plain:.4f} ms, bound "
                  f"{lim['bound_ms']:.5f} ms by {lim['bound_by']}, library: flex_attention "
                  f"with an ALiBi score_mod and the length mask"
                  + (" on the dequantized bf16 cache" if mode == "int8" else "") + " "
                  + library_text(flex, t == 1))
            if t == 1:
                row = "decode_int8_alibi" if mode == "int8" else "decode_alibi"
                rows[row] = dict(max_abs_err=err[row], ms=ms, plain_ms=plain, library_ms=flex,
                                 **lim)
        if mode == "int8":
            qd = randn((DEC_B, DEC_HQ, DEC_D), gen)
            ms = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool, alibi=True))
            base = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool))
            plain = cuda_time_ms(lambda: paged.paged_decode_reference(
                qd[:, :, None], pool, requant_block=decode.BLOCK_KV, alibi=True))
            flex = flex_ms(qd[:, :, None], k_live, v_live, ends=ends, slopes=slopes)
            lim = bound(roofline.decode_roofline(DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_LENGTHS,
                                                 cache_dtype=torch.int8))
            print(f"[kernels] paged K2 int8 ALiBi T=1 decode step (pages of {PAGE}): kernel "
                  f"{ms:.4f} ms (without ALiBi {base:.4f} ms), plain {plain:.4f} ms, bound "
                  f"{lim['bound_ms']:.5f} ms by {lim['bound_by']}, library: flex_attention "
                  f"with an ALiBi score_mod on the dequantized bf16 cache "
                  + (f"{flex:.4f} ms" if flex else "not run"))
            rows["paged_decode_alibi"] = dict(max_abs_err=err["paged_decode_alibi"], ms=ms,
                                              plain_ms=plain, library_ms=flex, **lim)
    return rows


def split_cache(cache: KVCache, at: int) -> tuple[KVCache, KVCache]:
    """A bf16 cache's positions [0, at) and [at, Smax) as two caches of
    their own (each from position 0, with its own lengths): the two halves
    of a sequence-split decode."""
    n = cache.length.long()
    first = KVCache(k=cache.k[:, :, :at].contiguous(), v=cache.v[:, :, :at].contiguous(),
                    length=n.clamp(max=at).to(torch.int32))
    second = KVCache(k=cache.k[:, :, at:].contiguous(), v=cache.v[:, :, at:].contiguous(),
                     length=(n - at).clamp(min=0).to(torch.int32))
    return first, second


def decode_lse(gen: torch.Generator) -> dict:
    """K2's LSE output (decode._decode_attention(with_lse=True)) against
    its plain version, LSE_ATOL: at the decode shape (16 slices merged by
    decode_merge_kernel) and at T 256 (one slice: the split kernel writes
    it), bf16 and int8 caches, with and without ALiBi, and a slot of length
    0 (LSE -inf, O 0). Then the path that uses it, a sequence-split decode
    (what the JAX package's parallel/serving.py does across cards), on one
    card: the bf16 decode step's cache cut at position LSE_SPLIT into two
    caches, K2 with the LSE on each (the row's launches, counted alone),
    merged by the log-sum-exp rule (parallel/serving.py's lse_merge, the
    rule its split decode applies over ranks) and held against K2 on the
    whole cache: O under O_ATOL, LSE under LSE_ATOL. Timed at the decode
    shape beside K2 without the LSE, the plain version, the bound (the
    decode step's bytes and the LSE written) and flex_attention returning
    the LSE."""
    err = 0.0
    shape = (DEC_B, DEC_HKV, DEC_SMAX, DEC_D)
    lengths = [0] + DEC_LENGTHS[1:]
    for mode in ("bf16", "int8"):
        cache = window_cache(mode, gen, lengths, shape)
        for t in (1, CHUNK_T):
            for alibi in (False, True):
                q = randn((DEC_B, DEC_HQ, t, DEC_D), gen)
                o, lse = decode._decode_attention(q, cache, with_lse=True, alibi=alibi)
                o_ref, lse_ref = decode.decode_attention_reference(
                    q, cache, requant_block=decode.BLOCK_KV, alibi=alibi, with_lse=True)
                torch.cuda.synchronize()
                tag = (f"K2 {mode} LSE output B={DEC_B} Hq={DEC_HQ} Hkv={DEC_HKV} D={DEC_D} "
                       f"Smax={DEC_SMAX} T={t} lengths={lengths} alibi={alibi}")
                check(bool(torch.isneginf(lse[0]).all()) and not bool(o[0].any()),
                      f"{tag}: the empty slot's LSE is not -inf or its O not 0")
                err = max(err, _gate(tag + " LSE", lse_ref[1:], lse[1:], LSE_ATOL))
                _gate(tag + " O", o_ref, o, **(QUANT_DECODE_TOL if mode == "int8" else
                                              dict(atol=O_ATOL)))
                check(torch.equal(o, decode.decode_attention_chunk(q, cache, alibi=alibi)),
                      f"{tag}: O differs from the call without the LSE")

    cache = window_cache("bf16", gen, DEC_LENGTHS, shape)
    halves = split_cache(cache, LSE_SPLIT)
    qd = randn((DEC_B, DEC_HQ, 1, DEC_D), gen)
    torch.cuda.synchronize()
    reset_launches()
    parts = [decode._decode_attention(qd, half, with_lse=True) for half in halves]
    torch.cuda.synchronize()
    launches = read_launches()["decode_lse"]
    o, lse = serving.lse_merge(parts)
    o_whole, lse_whole = decode._decode_attention(qd, cache, with_lse=True)
    torch.cuda.synchronize()
    tag = (f"sequence-split decode, bf16 cache cut at position {LSE_SPLIT} (lengths "
           f"{DEC_LENGTHS} -> {halves[0].length.tolist()} + {halves[1].length.tolist()}), "
           f"two K2 calls with the LSE merged by the log-sum-exp rule, against K2 on the whole "
           f"cache")
    _gate(tag + " O", o_whole.float(), o, O_ATOL)
    _gate(tag + " LSE", lse_whole, lse, LSE_ATOL)
    print(f"[kernels] {tag}: {launches} K2 launches with the LSE")

    ms = cuda_time_ms(lambda: decode._decode_attention(qd, cache, with_lse=True))
    base = cuda_time_ms(lambda: decode._decode_attention(qd, cache))
    plain = cuda_time_ms(lambda: decode.decode_attention_reference(qd, cache, with_lse=True))
    ends = torch.tensor(DEC_LENGTHS, dtype=torch.int32, device="cuda")
    flex = flex_ms(qd, torch.nan_to_num(cache.k), torch.nan_to_num(cache.v), ends=ends,
                   return_lse=True, what="the LSE returned")
    report = roofline.decode_roofline(DEC_B, DEC_HQ, DEC_HKV, DEC_D, DEC_LENGTHS)
    lim = bound(roofline.roofline(report.flops, report.hbm_bytes + 4 * DEC_B * DEC_HQ,
                                  torch.bfloat16))
    print(f"[kernels] K2 bf16 with the LSE T=1 decode step: kernel {ms:.4f} ms (without the LSE "
          f"{base:.4f} ms), plain {plain:.4f} ms, bound {lim['bound_ms']:.5f} ms by "
          f"{lim['bound_by']}, library: flex_attention returning the LSE, length mask "
          + (f"{flex:.4f} ms" if flex else "not run"))
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=flex,
                **lim)


# The window and segment ids in the backward kernels (B3, B4, B5) and
# segment ids in K1 (phase 2's masked gates). Packed rows: the four
# documents of the packed training phase (MISTRAL_7B), 8,128 tokens and 65
# of padding in a row of 8,193, cut to the 8,192 inputs a step attends.
PACK_DOCS = (6100, 1300, 517, 211)
PACK_S = 8192
BWD_WINDOWS = (1, 63, 64, 65, 1000)  # at D 64, S 1000: one key, the tile widths, past S
MASKED_ROWS = ("flash_fwd_segments", "flash_bwd_fused_window", "flash_bwd_dq_window",
               "flash_bwd_dkv_window", "flash_bwd_fused_segments", "flash_bwd_dq_segments",
               "flash_bwd_dkv_segments")


def packed_ids(lens, total: int, device) -> torch.Tensor:
    """[1, total] ids of documents of `lens` then padding (-1)."""
    cu = torch.tensor(np.cumsum([0, *lens]), device=device)
    return varlen.segment_ids_from_cu_seqlens(cu, total)[None]


def masked_case(gen, err: dict, tag: str, shape, dtype=torch.bfloat16, pos_offset=None,
                window=None, lens=None, causal=True, k_lens=None, logit_softcap=None,
                heat=1.0, alibi=False, alibi_slopes=None, dropout_rate=0.0,
                dropout_seed=None) -> tuple:
    """K1, then B3 (fused) and B4 + B5 (split), with a window, segment ids,
    a logit soft-cap, ALiBi and/or dropout against their plain versions on
    one set of inputs (q times `heat`: 30 saturates a cap's tanh); errors
    go to the rows of `err` (dropout rows with dropout, soft-cap rows with a
    cap, ALiBi rows with ALiBi, else segment rows when ids are given; K1's
    to its row with segment ids or with dropout).
    Rows that see no key get O = 0, LSE = -inf and dQ = 0. Padding rows' O
    and every gradient of a padding position must
    be exactly 0, a window of one key gives dQ = dK = 0 (each row's softmax
    gradient vanishes), held to |x| <= 1e-4 on both sides. Returns (q, k,
    v, o, do, lse, kw)."""
    b, hq, hkv, s_q, s_k, d = shape
    q, do = (randn((b, hq, s_q, d), gen, dtype) for _ in range(2))
    if heat != 1.0:
        q = (q.float() * heat).to(dtype)
    k, v = (randn((b, hkv, s_k, d), gen, dtype) for _ in range(2))
    seg = None
    if lens is not None:
        seg = varlen.canonical_segments(packed_ids(lens, s_q, q.device),
                                        packed_ids(k_lens or lens, s_k, q.device), q.device)
    kw = dict(is_causal=causal, pos_offset=pos_offset, window=window, segment_ids=seg,
              logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=alibi_slopes,
              dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    kind = ("dropout" if dropout_rate else "softcap" if logit_softcap else "alibi" if alibi
            else "segments" if seg is not None else "window")
    slopes = ("" if not alibi else " ALiBi " + ("standard slopes" if alibi_slopes is None else
                                                f"slopes {alibi_slopes.tolist()}"))
    name = (f"{tag}: B={b} Hq={hq} Hkv={hkv} Sq={s_q} Sk={s_k} D={d} causal={causal} "
            f"pos_offset={pos_offset} window={window} cap={logit_softcap}{slopes} "
            f"{f'dropout {dropout_rate} seed {dropout_seed} ' if dropout_rate else ''}"
            f"{'hot (q x %g) ' % heat if heat != 1.0 else ''}{str(dtype)[6:]}")
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=O_ATOL) if dtype == torch.bfloat16 else F32_TOL
    e = _gate(f"K1 {name} O", o_ref, o, **tol)
    _gate(f"K1 {name} LSE", lse_ref, lse, LSE_ATOL)
    fwd_row = "flash_fwd_" + ("dropout" if dropout_rate else "softcap" if logit_softcap else
                              "alibi_segments" if alibi else "segments")
    if (seg is not None or logit_softcap or dropout_rate) and fwd_row in err:
        err[fwd_row] = max(err[fwd_row], e)
    dead = torch.isneginf(lse_ref)
    check(torch.equal(torch.isneginf(lse), dead) and not bool(o[dead].any()),
          f"K1 {name}: rows that see no key are not O = 0, LSE = -inf")
    del o_ref, lse_ref
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
    for impl in ("fused", "split"):
        out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl, **kw)
        torch.cuda.synchronize()
        for grad, r, g in zip(("dQ", "dK", "dV"), ref, out):
            row = ("flash_bwd_fused" if impl == "fused" else
                   "flash_bwd_dq" if grad == "dQ" else "flash_bwd_dkv") + "_" + kind
            if window == 1 and grad != "dV":
                top = max(float(g.abs().max()), float(r.abs().max()))
                print(f"[kernels] {impl} {grad} {name}: a window of one key, |{grad}| max "
                      f"{top:.3g} on both sides (<= 1e-4)")
                check(top <= 1e-4, f"{impl} {grad} {name}: a window of one key gives {top}")
                continue
            err[row] = max(err[row], grad_gate(f"{impl} {grad} {name}", r, g, dtype))
        check(not bool(out[0][dead].any()), f"{impl} {name}: dQ of rows without keys is not 0")
        if seg is not None:
            pad_q, pad_k = kw["segment_ids"][0][0] < 0, kw["segment_ids"][1][0] < 0
            check(not bool(out[0][:, :, pad_q].any()) and not bool(out[1][:, :, pad_k].any())
                  and not bool(out[2][:, :, pad_k].any()),
                  f"{impl} {name}: padding positions' gradients are not exactly 0")
        del out
    if seg is not None:
        print(f"[kernels] {name}: padding rows' O and the gradients of the "
              f"{int((seg[0] < 0).sum())} padding rows and {int((seg[1] < 0).sum())} padding "
              f"keys are exactly 0 (fused and split)")
    del ref
    return q, k, v, o, do, lse, kw


def masked_kernels(gen: torch.Generator) -> dict[str, dict]:
    """Phase 2's window and segment gates (masked_case) for B3, B4 and B5
    and, with segment ids, K1; the split path bitwise equal across two
    calls with both; then each row timed (time_masked): the window rows at
    MISTRAL_7B's prefill widths (S 4608, window 4096), the segment rows at
    the packed training shape (S 8192, window 4096, PACK_DOCS)."""
    err = dict.fromkeys(MASKED_ROWS, 0.0)
    for w in BWD_WINDOWS:
        masked_case(gen, err, f"window {w}", (1, 8, 2, 1000, 1000, 64), window=w)
    b, hq, hkv, s, d = K1W_SHAPE
    mistral = masked_case(gen, err, "MISTRAL_7B widths", (b, hq, hkv, s, s, d), window=WIN)
    masked_case(gen, err, "S_q != S_k", (1, 8, 2, 600, 1500, 128), pos_offset=700, window=300)
    masked_case(gen, err, "float32 window", (1, 4, 2, 300, 300, 64), torch.float32, window=65)
    docs = [300, 37, 500, 119]  # off the tile multiples, then 144 of padding
    for causal in (True, False):
        masked_case(gen, err, "ragged documents", (1, 8, 2, 1100, 1100, 64), lens=docs,
                    causal=causal)
    masked_case(gen, err, "documents with a window", (1, 8, 2, 1100, 1100, 128), lens=docs,
                window=100)
    masked_case(gen, err, "(seg_q, seg_k) pair", (1, 8, 2, 300, 1000, 64), lens=[120, 90, 60],
                causal=False, k_lens=[200, 250, 150, 300])
    masked_case(gen, err, "float32 documents", (1, 4, 2, 400, 400, 64), torch.float32,
                lens=[130, 77, 150], window=50)
    packed = masked_case(gen, err, "packed training row", (b, hq, hkv, PACK_S, PACK_S, d),
                         lens=PACK_DOCS, window=WIN)
    q, k, v, o, do, lse, kw = packed
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "split backward with a window and segment ids is not bitwise deterministic")
    print("[kernels] split backward, packed training row with window and segment ids: two "
          "runs bitwise equal (torch.equal on dQ, dK, dV)")
    del first, second
    timed = time_masked("window", *mistral)
    del mistral
    timed.update(time_masked("segments", *packed))
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    return {name: dict(max_abs_err=err[name], **timed[name]) for name in MASKED_ROWS}


def time_masked(kind: str, q, k, v, o, do, lse, kw, layer: str = "",
                library: bool = True) -> dict[str, dict]:
    """Device ms of B3, B4 and B5 (and K1 with the LSE where there are
    segment ids) with the window, segment ids, soft-cap and ALiBi of `kw`,
    beside their plain versions (events around eager calls: a graph of them
    would keep several score blocks in its pool), SDPA's forward or
    forward + backward with the explicit boolean mask (without the cap or
    ALiBi: timed only, never used by the port), with a cap or ALiBi
    flex_attention's forward or backward with a soft-cap or ALiBi score_mod
    where it compiles (the library time then, as it computes the same
    function; with `library` False, for a case that gives no row, it is not
    measured), and each bound from utils/roofline.py, which counts the
    pairs the mask leaves visible (a cap or ALiBi adds nothing). Rows are
    named by kernel and `kind` (K1's with ALiBi "flash_fwd_alibi_segments")."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    few = dict(warmup=1, iters=3, reps=3)
    cap = kw.get("logit_softcap")
    mask = visible(s_q, s_k, kw["is_causal"], kw["pos_offset"], kw["window"],
                   kw["segment_ids"], "cuda")
    shape = (f"{layer}B={b} Hq={hq} Hkv={hkv} S={s_q} D={d} window={kw['window']} "
             f"{'cap ' + format(cap, 'g') + ' ' if cap else ''}"
             f"{'documents ' + str(PACK_DOCS) if kw['segment_ids'] is not None else ''}")
    roof = dict(dtype_bytes=q.element_size(), window=kw["window"], pos_offset=kw["pos_offset"],
                segment_ids=kw["segment_ids"])
    slopes = (flash_fwd.alibi_table(True, kw["alibi_slopes"], hq, q.device) if kw["alibi"]
              else None)
    flex_kw = dict(window=kw["window"], segment_ids=kw["segment_ids"], cap=cap, slopes=slopes)
    mod = cap or slopes is not None  # flex_attention is the library with a score_mod
    flex_ms_of = flex_mod_ms if library else (lambda *a, **k: None)
    lib_name = ("flex_attention" + (" with a soft-cap" if cap else " with an ALiBi")
                + " score_mod")
    out = {}
    if kw["segment_ids"] is not None:
        ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, **kw), **few)
        plain = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(q, k, v, **kw),
                              warmup=1, iters=2)
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), **few)
        flex = flex_ms_of(q, k, v, **flex_kw) if mod else None
        report = roofline.attention_fwd_roofline(b, hq, hkv, s_q, s_k, d, kw["is_causal"],
                                                 **roof)
        print(f"[kernels] K1 with segment ids{' and ' + kind if mod else ''} {shape}: kernel "
              f"{ms:.4f} ms "
              f"({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the visible pairs), bound "
              f"{report.bound_ms:.5f} ms by {report.bound_by}, plain {plain:.4f} ms, SDPA "
              f"forward with a boolean mask{f' (no {kind})' if mod else ''} {lib:.4f} ms"
              + (f", {lib_name} {library_text(flex, library)}" if mod else ""))
        k1_row = "flash_fwd_alibi_segments" if kind == "alibi" else f"flash_fwd_{kind}"
        out[k1_row] = dict(ms=ms, plain_ms=plain, library_ms=flex or lib, **bound(report))
    opts = {key: kw[key] for key in ("pos_offset", "window", "segment_ids", "alibi",
                                     "alibi_slopes")}
    opts["logit_softcap"] = cap
    causal = kw["is_causal"]
    fused = cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
        q, k, v, o, do, lse, causal, **opts), **few)
    dq_ms = cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, causal, **opts),
                         **few)
    _, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, causal, **opts)
    dkv_ms = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta, causal,
                                                          **opts), **few)
    gc.collect()
    torch.cuda.empty_cache()
    plain = event_time_ms(lambda: flash_bwd.flash_attention_backward_reference(
        q, k, v, o, do, lse, **kw), warmup=1, iters=2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
    lib = event_time_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True),
                        warmup=1, iters=3)
    del o_lib, leaves
    flex = flex_ms_of(q, k, v, do=do, **flex_kw) if mod else None
    gc.collect()
    torch.cuda.empty_cache()
    for name, ms in (("fused", fused), ("dq", dq_ms), ("dkv", dkv_ms)):
        report = roofline.attention_bwd_roofline(b, hq, hkv, s_q, s_k, d, causal, kernel=name,
                                                 **roof)
        print(f"[kernels] backward {name} with {kind} {shape}: kernel {ms:.4f} ms "
              f"({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the visible pairs), bound "
              f"{report.bound_ms:.4f} ms by {report.bound_by}, plain backward {plain:.4f} ms, "
              f"SDPA backward with a boolean mask{f' (no {kind})' if mod else ''} {lib:.4f} ms"
              + (f", {lib_name} backward {library_text(flex, library)}" if mod else ""))
        row = {"fused": "flash_bwd_fused", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}[name]
        out[f"{row}_{kind}"] = dict(ms=ms, plain_ms=plain, library_ms=flex or lib,
                                    **bound(report))
    return out


# The soft-cap in the backward kernels (B3, B4, B5) and with segment ids in
# K1 (phase 2's soft-capped backward gates), then GEMMA2_9B's packed
# training row: Hq 16, Hkv 8, D 256, S 8192 over PACK_DOCS, cap 50, on a
# global layer and a local one (window 4096).
SOFTCAP_BWD_ROWS = ("flash_bwd_fused_softcap", "flash_bwd_dq_softcap", "flash_bwd_dkv_softcap")


def softcap_backward_kernels(gen: torch.Generator) -> dict[str, dict]:
    """masked_case with the soft-cap: at D 64, 128 and 256, causal, with a
    window, segment ids, both, and hot inputs (q x HOT); S_q != S_k with a
    pos_offset, non-causal, float32; then at GEMMA2_9B's packed training
    row, global and local, where the split path must be bitwise equal across
    two calls, and each row is timed (time_masked). Returns the global
    layer's rows, and K1's largest error with the cap and segment ids under
    "flash_fwd_softcap"."""
    err = dict.fromkeys(("flash_fwd_softcap", *SOFTCAP_BWD_ROWS), 0.0)
    docs = [300, 37, 500, 119]  # off the tile multiples, then 144 of padding
    for d, cap in ((64, 30.0), (128, 30.0), (256, CAP)):
        shape = (1, 8, 2, 1100, 1100, d)
        masked_case(gen, err, "cap", shape, logit_softcap=cap)
        masked_case(gen, err, "cap with a window", shape, window=129, logit_softcap=cap)
        masked_case(gen, err, "cap with documents", shape, lens=docs, logit_softcap=cap)
        masked_case(gen, err, "cap with documents and a window", shape, lens=docs, window=100,
                    logit_softcap=cap)
        masked_case(gen, err, "cap", shape, lens=docs, window=65, logit_softcap=cap, heat=HOT)
    masked_case(gen, err, "S_q != S_k", (1, 8, 2, 600, 1500, 256), pos_offset=700, window=300,
                logit_softcap=CAP)
    masked_case(gen, err, "non-causal", (1, 4, 4, 300, 300, 256), causal=False,
                logit_softcap=5.0)
    masked_case(gen, err, "float32", (1, 4, 2, 300, 300, 256), torch.float32,
                lens=[130, 77, 50], window=50, logit_softcap=30.0)
    masked_case(gen, err, "float32", (1, 4, 2, 300, 300, 64), torch.float32, logit_softcap=5.0,
                heat=HOT)
    b, hq, hkv, _, d = GEMMA_PREFILL
    timed = {}
    for w, layer in ((None, "global"), (GWIN, "local")):
        row = masked_case(gen, err, f"GEMMA2_9B packed training row, {layer} layer",
                          (b, hq, hkv, PACK_S, PACK_S, d), lens=PACK_DOCS, window=w,
                          logit_softcap=CAP)
        q, k, v, o, do, lse, kw = row
        first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
        second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
        check(all(torch.equal(x, y) for x, y in zip(first, second)),
              f"split backward with the cap at D 256 ({layer} layer) is not bitwise "
              "deterministic")
        print(f"[kernels] split backward, GEMMA2_9B packed training row, {layer} layer: two "
              "runs bitwise equal (torch.equal on dQ, dK, dV)")
        del first, second
        timed[layer] = time_masked("softcap", *row, layer=f"{layer} layer ",
                                   library=layer == "global")  # the rows are the global layer's
        del row, q, k, v, o, do, lse, kw
        gc.collect()
        torch.cuda.empty_cache()
    out = {name: dict(max_abs_err=err[name], **timed["global"][name])
           for name in SOFTCAP_BWD_ROWS}
    out["flash_fwd_softcap"] = dict(max_abs_err=err["flash_fwd_softcap"])
    return out


# ALiBi in the backward kernels (B3, B4, B5) and with segment ids in K1
# (phase 2's ALiBi backward gates; phase 18 trains LLAMA_8B with use_alibi),
# then LLAMA_8B's packed training row (B 1, Hq 32, Hkv 8, D 128, S 8192 over
# PACK_DOCS, causal, no window: phase 18 (a)) and its unpacked row at
# ALIBI_FULL_S (phase 18 (b)).
ALIBI_BWD_ROWS = ("flash_fwd_alibi_segments", "flash_bwd_fused_alibi", "flash_bwd_dq_alibi",
                  "flash_bwd_dkv_alibi")
ALIBI_FULL_S = 4096


def alibi_backward_kernels(gen: torch.Generator) -> dict[str, dict]:
    """masked_case with ALiBi (the standard slopes unless named): at D 64,
    128 and 256, causal, with a window, segment ids, both; S_q != S_k with
    a pos_offset; rows that see no key; non-causal; a window of one key;
    one head at the steepest standard slope over 8,192 keys; float32; then
    LLAMA_8B's packed training row, where the split path must be bitwise
    equal across two calls and each row is timed (time_masked), and its
    unpacked row at ALIBI_FULL_S; at both, the same kernels without ALiBi
    on the same q, k, v and dO, timed in the same way (alibi_cost).
    Returns the packed row's rows."""
    err = dict.fromkeys(ALIBI_BWD_ROWS, 0.0)
    docs = [300, 37, 500, 119]  # off the tile multiples, then 144 of padding
    for d in (64, 128, 256):
        shape = (1, 8, 2, 1100, 1100, d)
        masked_case(gen, err, "ALiBi", shape, alibi=True)
        masked_case(gen, err, "ALiBi with a window", shape, window=129, alibi=True)
        masked_case(gen, err, "ALiBi with documents", shape, lens=docs, alibi=True)
        masked_case(gen, err, "ALiBi with documents and a window", shape, lens=docs, window=100,
                    alibi=True)
    masked_case(gen, err, "ALiBi, S_q != S_k", (1, 8, 2, 600, 1500, 128), pos_offset=700,
                window=300, alibi=True)
    masked_case(gen, err, "ALiBi, rows without keys", (1, 8, 2, 300, 300, 64), pos_offset=-70,
                alibi=True)
    masked_case(gen, err, "ALiBi, non-causal", (1, 4, 4, 300, 300, 256), causal=False,
                alibi=True)
    masked_case(gen, err, "ALiBi, a window of one key", (1, 8, 2, 1000, 1000, 64), window=1,
                alibi=True)
    masked_case(gen, err, "ALiBi, one steep head", (1, 1, 1, PACK_S, PACK_S, 128), alibi=True,
                alibi_slopes=torch.tensor([ALIBI_STEEP], device="cuda"))
    masked_case(gen, err, "ALiBi, float32", (1, 4, 2, 300, 300, 64), torch.float32,
                lens=[130, 77, 50], window=50, alibi=True)
    masked_case(gen, err, "ALiBi, float32", (1, 4, 2, 300, 300, 256), torch.float32,
                alibi=True)
    b, hq, hkv, _, d = ALIBI_PREFILL
    row = masked_case(gen, err, "LLAMA_8B packed training row", (b, hq, hkv, PACK_S, PACK_S, d),
                      lens=PACK_DOCS, alibi=True)
    q, k, v, o, do, lse, kw = row
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "split backward with ALiBi and segment ids is not bitwise deterministic")
    print("[kernels] split backward, LLAMA_8B packed training row with ALiBi and segment ids: "
          "two runs bitwise equal (torch.equal on dQ, dK, dV)")
    del first, second
    timed = time_masked("alibi", *row)
    alibi_cost("LLAMA_8B packed training row", *row)
    del row, q, k, v, o, do, lse, kw
    gc.collect()
    torch.cuda.empty_cache()
    row = masked_case(gen, err, "LLAMA_8B training row", (b, hq, hkv, ALIBI_FULL_S,
                                                            ALIBI_FULL_S, d), alibi=True)
    alibi_cost("LLAMA_8B training row", *row)
    del row
    gc.collect()
    torch.cuda.empty_cache()
    return {name: dict(max_abs_err=err[name], **timed[name]) for name in ALIBI_BWD_ROWS}


def alibi_cost(tag: str, q, k, v, o, do, lse, kw) -> None:
    """ALiBi's cost in B3, B4 and B5 (and in K1 with the LSE where there are
    segment ids): each timed with ALiBi on masked_case's O and LSE and
    without it on K1's O and LSE without ALiBi, same q, k, v and dO, device
    time (cuda_time_ms), the ratio printed."""
    few = dict(warmup=1, iters=3, reps=3)
    base = dict(kw, alibi=False, alibi_slopes=None)
    o0, lse0 = flash_fwd.flash_attention_forward(q, k, v, **base)
    causal = kw["is_causal"]
    ratios = {}
    for name, args, opts in (("alibi", (o, lse), kw), ("none", (o0, lse0), base)):
        opts = {key: opts[key] for key in ("pos_offset", "window", "segment_ids", "alibi",
                                          "alibi_slopes")}
        oo, ll = args
        _, delta = flash_bwd.flash_bwd_dq(q, k, v, oo, do, ll, causal, **opts)
        ms = {"B3": cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
                  q, k, v, oo, do, ll, causal, **opts), **few),
              "B4": cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, oo, do, ll, causal,
                                                                **opts), **few),
              "B5": cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, ll, delta, causal,
                                                                 **opts), **few)}
        if kw["segment_ids"] is not None:
            ms["K1"] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
                q, k, v, causal, **opts), **few)
        ratios[name] = ms
    print(f"[kernels] ALiBi's cost, {tag} B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} "
          f"S={q.shape[2]} D={q.shape[3]}: "
          + ", ".join(f"{kern} {ratios['alibi'][kern]:.4f} ms with ALiBi, "
                      f"{ratios['none'][kern]:.4f} ms without "
                      f"({ratios['alibi'][kern] / ratios['none'][kern] - 1:+.1%})"
                      for kern in ratios["alibi"]))


# qmm8's and qmm4's M: the decode batch's split-K kernel up to 16 (1, 4 and
# 16 take its three row counts), the tensor cores from 17 (a prefill bucket,
# the 4-request chunk step at 1024).
QMM8_MS = (1, 4, 16, 17, 64, 256, 1024)


def quant_matmul_kernels(gen: torch.Generator) -> dict[str, dict]:
    """qmm8 and qmm4 against their plain version on LLAMA_1B's five
    projection shapes at every M of QMM8_MS, two calls bitwise equal; each
    timed at M 4 (a decode step) and M 256 (a prefill bucket), the
    (2048, 5632) one giving the JSON line's numbers (M 4), beside
    torch.matmul on the dequantized bf16 weight."""
    out = {}
    for bits in (8, 4):
        err, entry = 0.0, None
        for k, n in QMM_SHAPES:
            qw = quant_matmul.quantize_weights(randn((k, n), gen) * 0.02, bits)
            for m in QMM8_MS:
                x = randn((m, k), gen)
                y = quant_matmul.quant_matmul(x, qw)
                again = quant_matmul.quant_matmul(x, qw)
                torch.cuda.synchronize()
                err = max(err, _gate(f"qmm{bits} M={m} K={k} N={n}",
                                     quant_matmul.quant_matmul_reference(x, qw), y, **QMM_TOL))
                check(torch.equal(y, again), f"qmm{bits} M={m} K={k} N={n}: two calls differ")
            x = randn((4, k), gen)
            w_bf16 = quant_matmul.dequantize_weights(qw).to(torch.bfloat16)
            x256 = randn((256, k), gen)
            ms = cuda_time_ms(lambda: quant_matmul.quant_matmul(x, qw))
            ms256 = cuda_time_ms(lambda: quant_matmul.quant_matmul(x256, qw))
            plain = cuda_time_ms(lambda: quant_matmul.quant_matmul_reference(x, qw))
            plain256 = cuda_time_ms(lambda: quant_matmul.quant_matmul_reference(x256, qw))
            lib = cuda_time_ms(lambda: torch.matmul(x, w_bf16))
            lib256 = cuda_time_ms(lambda: torch.matmul(x256, w_bf16))
            lim = bound(roofline.quant_matmul_roofline(4, k, n, bits))
            lim256 = bound(roofline.quant_matmul_roofline(256, k, n, bits))
            split = (quant_matmul.qmm8_split if bits == 8 else quant_matmul.qmm4_split)(
                4, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
            plan = f", {split[1]} K-splits of {split[0]} byte rows at M<=16"
            print(f"[kernels] qmm{bits} K={k} N={n}: kernel {ms:.4f} ms at M=4 "
                  f"({nbytes(qw.w) / (ms * 1e-3) / 1e9:.1f} GB/s of weights{plan}), "
                  f"{ms256:.4f} ms at M=256 ({2.0 * 256 * k * n / (ms256 * 1e-3) / 1e12:.2f} "
                  f"TFLOP/s); plain {plain:.4f} ms at M=4, {plain256:.4f} ms at M=256, "
                  f"torch.matmul on the dequantized bf16 weight "
                  f"{lib:.4f} ms at M=4, {lib256:.4f} ms at M=256, bound "
                  f"{lim['bound_ms']:.5f} ms by {lim['bound_by']} (M=4), "
                  f"{lim256['bound_ms']:.5f} ms by {lim256['bound_by']} (M=256)")
            if (k, n) == QMM_TIMED:
                entry = dict(ms=ms, plain_ms=plain, library_ms=lib, **lim)
            del qw, w_bf16
        out[f"qmm{bits}"] = dict(max_abs_err=err, **entry)
    launches, err = 0, 0.0
    for bits in (8, 4):
        out[f"qmm{bits}_a8"], quant = quant_matmul_a8(gen, bits)
        launches += quant["launches"]
        err = max(err, quant["max_abs_err"])
    out["quantize_rows"] = time_quantize_rows(quant["x"], launches, err)
    return out


def time_quantize_rows(x: torch.Tensor, launches: int, err: float) -> dict:
    """quantize_rows' kernel timed on x (LLAMA_1B's gate/up input at M 256)
    beside its plain version and its bound; its launches and largest error
    from the a8 path's calls (quant_matmul_a8). No library call computes it."""
    m, k = x.shape
    ms = cuda_time_ms(lambda: quant_matmul.quantize_rows(x))
    plain = cuda_time_ms(lambda: quant_matmul.quantize_rows_reference(x))
    lim = bound(roofline.quantize_rows_roofline(m, k, x.element_size()))
    print(f"[kernels] quantize_rows M={m} K={k} {str(x.dtype)[6:]}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}; {launches} "
          f"launches on the a8 path's calls, x_q and x_scale equal to the plain version's "
          f"(tolerance 0)")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, **lim)


# LLAMA_8B's projection shapes (K, N), models/config.py: wq/wo, wk/wv,
# w_gate/w_up, w_down, lm_head.
QMM_SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
# The a8 mode's timed shapes, at M 4 and 256: LLAMA_1B's and LLAMA_8B's
# gate/up projection; the first at M 256 gives the JSON line's numbers.
QMM_A8_TIMED = ((2048, 5632), (4096, 14336))


def quant_matmul_a8(gen: torch.Generator, bits: int) -> dict:
    """The a8 mode's path, quant_matmul(x, qw, quantize_activations=True),
    at every M of QMM8_MS on LLAMA_1B's five projection shapes and at M 4
    and 256 on LLAMA_8B's five: the path's calls counted alone (the counters
    set to 0 before each shape's calls and read after), then each result
    torch.equal to its plain version (tolerance 0: int32 sums are exact and
    the f32 tail is the same), x_q and x_scale from the quantization kernel
    torch.equal to quantize_rows_reference's, and two calls torch.equal;
    timed on QMM_A8_TIMED beside the plain version, torch._int_mm on the
    same int8 operands with the two scalings (M > 16, where it takes the
    shape) and torch.matmul on the dequantized bf16 weight. Returns the
    kernels line's row and the quantization's (its launches on the path, its
    largest error, and the M 256 x of the first timed shape)."""
    name = f"qmm{bits}_a8"
    cases = ([(k, n, QMM8_MS) for k, n in QMM_SHAPES]
             + [(k, n, (4, 256)) for k, n in QMM_SHAPES_8B])
    launches = quantized = calls = 0
    err, q_err, entry, q_x = 0.0, 0.0, None, None

    def a8(x, qw):
        return quant_matmul.quant_matmul(x, qw, quantize_activations=True)

    for k, n, ms in cases:
        qw = quant_matmul.quantize_weights(randn((k, n), gen) * 0.02, bits)
        xs = [randn((m, k), gen) for m in ms]
        reset_launches()
        ys = [a8(x, qw) for x in xs]
        torch.cuda.synchronize()
        counts = read_launches()
        launches += counts[name]
        quantized += counts["quantize_rows"]
        calls += len(xs)
        for x, y in zip(xs, ys):
            tag = f"{name} M={x.shape[0]} K={k} N={n}"
            ref = quant_matmul.quant_matmul_reference(x, qw, None, True)
            err = max(err, (y.float() - ref.float()).abs().max().item())
            check(torch.equal(y, ref), f"{tag}: differs from its plain version (tolerance 0), "
                                       f"max abs {err}")
            x_q, x_scale = quant_matmul.quantize_rows(x)
            ref_q, ref_scale = quant_matmul.quantize_rows_reference(x)
            q_err = max(q_err, (x_q.int() - ref_q.int()).abs().max().item(),
                        (x_scale - ref_scale).abs().max().item())
            check(torch.equal(x_q, ref_q) and torch.equal(x_scale, ref_scale),
                  f"{tag}: x_q or x_scale differs from quantize_rows_reference (tolerance 0)")
            check(torch.equal(y, a8(x, qw)), f"{tag}: two calls differ")
        print(f"[kernels] {name} K={k} N={n} M={list(ms)}: torch.equal to the plain version "
              f"(tolerance 0, bit for bit), x_q and x_scale equal to quantize_rows_reference "
              f"(tolerance 0), two calls equal")
        if (k, n) in QMM_A8_TIMED:
            row = time_a8(name, qw, xs[ms.index(4)], xs[ms.index(256)])
            if entry is None:
                entry, q_x = row, xs[ms.index(256)]
        del qw, xs, ys
    check(launches == calls and quantized == calls,
          f"{name}: {launches} product and {quantized} quantize_rows launches counted for "
          f"{calls} calls")
    print(f"[kernels] {name}: {launches} product and {quantized} quantize_rows launches on "
          f"the path's {calls} calls")
    return (dict(launches=launches, max_abs_err=err, **entry),
            dict(launches=quantized, max_abs_err=q_err, x=q_x))


def time_a8(name: str, qw, x4: torch.Tensor, x256: torch.Tensor) -> dict:
    """The a8 mode timed at M 4 and 256 (quantization included), printed
    beside its plain version, torch._int_mm on the same int8 operands plus
    the two scalings (x_q and the weights' int8 values, column-major as
    cuBLAS's int8 product takes them; M 256 only: it refuses M <= 16),
    torch.matmul on the dequantized bf16 weight, and the bound; the M 256
    figures for the JSON line."""
    k, n = qw.k, qw.out_features
    w_int8 = quant_matmul.integer_weights(qw).to(torch.int8).t().contiguous().t()
    w_bf16 = quant_matmul.dequantize_weights(qw).to(torch.bfloat16)
    x_q, x_scale = quant_matmul.quantize_rows(x256)
    rows = {}
    for m, x in ((4, x4), (256, x256)):
        ms = cuda_time_ms(lambda: quant_matmul.quant_matmul(x, qw, quantize_activations=True))
        plain = cuda_time_ms(lambda: quant_matmul.quant_matmul_reference(x, qw, None, True))
        lib = cuda_time_ms(lambda: torch.matmul(x, w_bf16))
        int_mm = None
        if m > 16:
            int_mm = cuda_time_ms(lambda: (torch._int_mm(x_q, w_int8).float() * qw.scale
                                           * x_scale).to(torch.bfloat16))
        lim = bound(roofline.quant_matmul_roofline(m, k, n, qw.bits, a8=True))
        rows[m] = dict(ms=ms, plain_ms=plain, library_ms=int_mm, **lim)
        print(f"[kernels] {name} K={k} N={n} M={m}: kernel {ms:.4f} ms "
              f"({2.0 * m * k * n / (ms * 1e-3) / 1e12:.2f} TOP/s), plain {plain:.4f} ms, "
              f"torch._int_mm + the two scalings "
              + (f"{int_mm:.4f} ms" if int_mm is not None else "refuses M <= 16")
              + f", torch.matmul on the dequantized bf16 weight {lib:.4f} ms, bound "
              f"{lim['bound_ms']:.5f} ms by {lim['bound_by']}")
    return rows[256]


BWD_CASES = [
    # (tag, B, Hq, Hkv, S_q, S_k, D, causal, pos_offset, dtype)
    ("training shape", TRAIN_B, 32, 4, TRAIN_S, TRAIN_S, 64, True, None, torch.bfloat16),
    ("D=128 non-causal", 2, 8, 2, 512, 512, 128, False, None, torch.bfloat16),
    ("Sq<Sk", 1, 32, 4, 256, 1024, 64, True, None, torch.bfloat16),
    ("ragged S=200", 1, 32, 4, 200, 200, 64, True, None, torch.bfloat16),
    ("no-key rows", 1, 8, 2, 256, 256, 64, True, -100, torch.bfloat16),
    ("ragged D=128 causal", 1, 8, 1, 1000, 1000, 128, True, None, torch.bfloat16),
    ("float32", 1, 8, 2, 256, 256, 64, True, None, torch.float32),
]


def backward_kernels(gen: torch.Generator) -> tuple[dict[str, dict], float]:
    """B3's, B4's and B5's ports against flash_attention_backward_reference
    on the same CUDA inputs, then timed at the training shape. O and LSE come
    from K1 with need_lse=True, held first against the plain forward, since
    a wrong O or LSE would reach the kernels and the plain backward alike.
    Returns the backward kernels' entries and K1's largest O error."""
    err = {"flash_bwd_fused": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    k1_err = 0.0
    for tag, b, hq, hkv, s_q, s_k, d, causal, off, dtype in BWD_CASES:
        kw = dict(dtype=dtype, device="cuda")
        q = torch.randn((b, hq, s_q, d), generator=gen, **kw)
        k = torch.randn((b, hkv, s_k, d), generator=gen, **kw)
        v = torch.randn((b, hkv, s_k, d), generator=gen, **kw)
        do = torch.randn((b, hq, s_q, d), generator=gen, **kw)
        name = (f"B={b} Hq={hq} Hkv={hkv} Sq={s_q} Sk={s_k} D={d} causal={causal} "
                f"pos_offset={off} {str(dtype)[6:]} ({tag})")
        o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, pos_offset=off)
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal,
                                                                     pos_offset=off)
        torch.cuda.synchronize()
        k1_err = max(k1_err, _gate(f"K1 {name} O", o_ref, o, O_ATOL))
        _gate(f"K1 {name} LSE", lse_ref, lse, LSE_ATOL)
        del o_ref, lse_ref
        ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, causal,
                                                           pos_offset=off)
        for impl in ("fused", "split"):
            out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, causal, impl=impl,
                                                     pos_offset=off)
            torch.cuda.synchronize()
            for grad, r, g in zip(("dQ", "dK", "dV"), ref, out):
                e = grad_gate(f"{impl} {grad} {name}", r, g, dtype)
                kernel = ("flash_bwd_fused" if impl == "fused" else
                          "flash_bwd_dq" if grad == "dQ" else "flash_bwd_dkv")
                err[kernel] = max(err[kernel], e)
            if off is not None and off < 0:
                dq, dk, dv = out
                unseen = s_q + off  # kv rows past the last row's bound
                check(torch.equal(dq[:, :, :-off], torch.zeros_like(dq[:, :, :-off]))
                      and torch.equal(dk[:, :, unseen:], torch.zeros_like(dk[:, :, unseen:]))
                      and torch.equal(dv[:, :, unseen:], torch.zeros_like(dv[:, :, unseen:])),
                      f"{impl} {name}: rows without keys are not exactly zero")
                print(f"[kernels] {impl} {name}: dQ of the {-off} rows without keys and "
                      f"dK/dV of the {s_k - unseen} kv rows no row sees are exactly 0")
        if tag == "training shape":
            first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, causal, impl="split")
            second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, causal,
                                                        impl="split")
            check(all(torch.equal(x, y) for x, y in zip(first, second)),
                  "split backward is not bitwise deterministic")
            print(f"[kernels] split {name}: two runs bitwise equal (torch.equal on dQ, dK, dV)")
            timing = (q, k, v, o, do, lse)
    return dict(zip(err, ({"max_abs_err": e, **t} for e, t in
                          zip(err.values(), time_backward(*timing))))), k1_err


def time_backward(q, k, v, o, do, lse, with_k1: bool = True):
    """Device ms of the three backward kernels, their plain version and SDPA's
    backward (S_q = S_k, causal) at the training shape, with each bound;
    with_k1 also K1 there (time_k1)."""
    b, hq, s, d = q.shape
    dtype = q.dtype
    few = dict(warmup=1, iters=3, reps=3)
    fused_ms = cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
        q, k, v, o, do, lse, True), **few)
    dq_ms = cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True), **few)
    dq, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True)
    dkv_ms = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta, True), **few)
    plain_ms = cuda_time_ms(lambda: flash_bwd.flash_attention_backward_reference(
        q, k, v, o, do, lse, True), warmup=1, iters=2, reps=3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    lib_ms = event_time_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True))
    shape = f"B={b} Hq={hq} Hkv={k.shape[1]} S={s} D={d} causal {str(dtype)[6:]}"
    out = []
    for name, ms in zip(("fused", "dq", "dkv"), (fused_ms, dq_ms, dkv_ms)):
        report = roofline.attention_bwd_roofline(b, hq, k.shape[1], s, s, d, True,
                                                 dtype_bytes=q.element_size(), kernel=name)
        flops, lim = report.flops, bound(report)
        print(f"[kernels] backward {name} {shape}: kernel {ms:.4f} ms "
              f"({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {lim['bound_ms']:.4f} ms "
              f"by {lim['bound_by']}, plain backward {plain_ms:.4f} ms, SDPA backward "
              f"{lib_ms:.4f} ms")
        out.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **lim))
    if with_k1:
        time_k1("training shape", q, k, v, need_lse=True, few=few)
    return out


def routed(requant_block: int | None = None) -> dict:
    """Generation's kernel entry points -> their plain versions; the int8
    mode's P requantized over the JAX kernel's block, or over
    `requant_block` positions where given (decode.BLOCK_KV: the card
    kernel's arithmetic)."""
    def dense(q, cache, scale=None, window=None, sink=0, logit_softcap=None, alibi=False):
        return decode.decode_attention_reference(q, cache, scale, requant_block, window, sink,
                                                 logit_softcap, alibi)

    def pool(q, cache, scale=None, window=None, sink=0, logit_softcap=None, alibi=False):
        return paged.paged_decode_reference(q, cache, scale, requant_block, window, sink,
                                            logit_softcap, alibi)

    return {
        (generate, "flash_attention"): (
            lambda q, k, v, is_causal=False, scale=None, window=None, logit_softcap=None,
            alibi=False:
            flash_fwd.flash_attention_forward_reference(q, k, v, is_causal, scale,
                                                        need_lse=False, window=window,
                                                        logit_softcap=logit_softcap,
                                                        alibi=alibi)[0]),
        (generate, "decode_attention"): lambda q, *a, **kw: dense(q[:, :, None], *a,
                                                                  **kw)[:, :, 0],
        (generate, "decode_attention_chunk"): dense,
        (generate, "paged_decode_attention"): lambda q, *a, **kw: pool(q[:, :, None], *a,
                                                                       **kw)[:, :, 0],
        (generate, "paged_decode_attention_chunk"): pool,
        (llama, "quant_matmul"): (
            lambda x, qw, out_dtype=None: quant_matmul.quant_matmul_reference(x, qw, out_dtype)),
        # The MoE FFN's card route (the grouped dispatch) -> the masked-dense loop.
        (moe, "moe_ffn_grouped"): moe.moe_ffn_dense_reference,
        # The rings' per-pair calls (parallel/ring.py).
        (ring, "flash_attention_forward"): flash_fwd.flash_attention_forward_reference,
        (ring, "flash_attention_backward"): flash_bwd.flash_attention_backward_reference,
    }


@contextlib.contextmanager
def plain_kernels(requant_block: int | None = None):
    """Route the model's kernel calls (attention and quantized projections)
    to their plain versions (routed)."""
    table = routed(requant_block)
    saved = {key: getattr(*key) for key in table}
    for (module, name), fn in table.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def rule_numbers(a: torch.Tensor, r: torch.Tensor) -> tuple[float, float, float]:
    """(cosine, max |a - r|, LOGIT_REL * max |r|) of two logits tensors, in
    float32: the logits rule holds when cosine > LOGIT_COS and the delta is
    at most the limit."""
    a, r = a.float().flatten(), r.float().flatten()
    cos = float(torch.nn.functional.cosine_similarity(a, r, dim=0))
    return cos, float((a - r).abs().max()), LOGIT_REL * float(r.abs().max())


def logits_rule(tag: str, a: torch.Tensor, r: torch.Tensor, name: str, model: str) -> bool:
    """The serving logits rule on one call's logits, printed: cosine >
    LOGIT_COS and max |delta| <= LOGIT_REL * max |ref|. Non-finite logits
    fail the run."""
    check(bool(torch.isfinite(a).all()), f"{tag} {name}: non-finite logits")
    cos, delta, lim = rule_numbers(a, r)
    print(f"[model] {model} {tag} {name}: cos {cos:.6f} (> {LOGIT_COS}), "
          f"max|d| {delta:.4f} (<= {lim:.4f}), argmax kernel "
          f"{int(a.float().argmax())} plain {int(r.float().argmax())}")
    return cos > LOGIT_COS and delta <= lim


def compare_logits(tag: str, kern: list, plain: list, names: list | None = None,
                   model: str = "LLAMA_1B") -> None:
    """The serving logits rule (logits_rule) on every call."""
    names = names or ["prefill S=150"] + [f"decode {i}" for i in range(1, len(kern))]
    for a, r, name in zip(kern, plain, names):
        check(logits_rule(tag, a, r, name, model), f"{model} {tag} {name} logits disagree")


def generation_run(model, prompt, forced, quant=None, max_len=2048) -> list[torch.Tensor]:
    """A prefill of the prompt and teacher-forced decode steps; their logits."""
    caches = generate.init_caches(model, 1, max_len, quant=quant)
    logits, caches = generate.prefill(model, prompt, caches)
    out = [logits]
    for i in range(forced.shape[0]):
        pos = torch.tensor([prompt.shape[1] + i], dtype=torch.int32, device="cuda")
        logits, caches = generate.decode_step(model, forced[i:i + 1], pos, caches)
        out.append(logits)
    torch.cuda.synchronize()
    return out


def phase_model(model, gen: torch.Generator) -> None:
    cfg = model.cfg
    prompt = torch.randint(0, cfg.vocab_size, (1, 150), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    counts = flash_fwd.LAUNCHES, decode.LAUNCHES
    kern = generation_run(model, prompt, forced)
    check((flash_fwd.LAUNCHES - counts[0], decode.LAUNCHES - counts[1])
          == (cfg.num_layers, 4 * cfg.num_layers), "kernel run missed a kernel")
    counts = flash_fwd.LAUNCHES, decode.LAUNCHES
    with plain_kernels():
        plain = generation_run(model, prompt, forced)
    check((flash_fwd.LAUNCHES, decode.LAUNCHES) == counts,
          "plain run launched a kernel")
    compare_logits("bf16", kern, plain)


def quantized_copy(model, bits: int):
    """A copy of the model with int8/int4 projections and head."""
    return llama.quantize_params(copy.deepcopy(model), bits)


def phase_quant_model(model, w8, gen: torch.Generator) -> dict[str, int]:
    """LLAMA_1B logits, kernels against plain versions, for int8 weights,
    int4 weights, an int8 and an fp8 KV cache; then a prefix admission
    against the full prompt's prefill. Returns the launches of this phase
    (the path of K2's fp8 mode and of qmm4)."""
    cfg = model.cfg
    layers = cfg.num_layers
    prompt = torch.randint(0, cfg.vocab_size, (1, 150), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    w4 = quantized_copy(model, 4)
    per_call = 7 * layers + 1  # projections and the head of one forward
    setups = [  # tag, model, KV quant, {counter: launches of the kernel run}
        ("int8 weights", w8, None, {"qmm8": 5 * per_call, "decode": 4 * layers}),
        ("int4 weights", w4, None, {"qmm4": 5 * per_call, "decode": 4 * layers}),
        ("int8 KV", model, "int8", {"decode_int8": 4 * layers}),
        ("fp8 KV", model, "fp8", {"decode_fp8": 4 * layers}),
    ]
    reset_launches()
    for tag, m, quant, want in setups:
        before = read_launches()
        kern = generation_run(m, prompt, forced, quant)
        added = {k: v - before[k] for k, v in read_launches().items()}
        want = {"flash_fwd": layers, **want}
        check(all(added[k] == v for k, v in want.items())
              and not any(v for k, v in added.items() if k not in want),
              f"{tag}: kernel run launched {added}, want {want}")
        before = read_launches()
        with plain_kernels():
            plain = generation_run(m, prompt, forced, quant)
        check(read_launches() == before, f"{tag}: plain run launched a kernel")
        compare_logits(tag, kern, plain)
    total = read_launches()
    del w4
    prefix_admission(w8, gen)
    return total


def prefix_admission(w8, gen: torch.Generator) -> None:
    """What the server does for a request with a registered prefix: the
    prefix's K/V prefilled into pages, gathered back to a dense cache, then
    chunk_step on the bucket-padded suffix (128 tokens: 1024 query rows in
    K2). Its first-token logits against the full prompt's prefill, with int8
    weights, for a bf16 and an int8 KV cache."""
    cfg = w8.cfg
    n_prefix, n_suffix, bucket = 512, 100, 128
    prompt = torch.randint(0, cfg.vocab_size, (1, n_prefix + n_suffix), generator=gen,
                           device="cuda")
    pages = [3, 1]  # the prefix's two pages, out of order
    for quant in (None, "int8"):
        ref, _ = generate.prefill(w8, prompt, generate.init_caches(w8, 1, 2048, quant=quant))
        _, single = generate.prefill(w8, prompt[:, :n_prefix],
                                     generate.init_caches(w8, 1, 2048, quant=quant))
        seeded = []
        for one in single:
            pool = paged.init_paged_cache(1, cfg.num_kv_heads, 4, PAGE, cfg.head_dim,
                                          2048 // PAGE, dtype=cfg.dtype, quant=quant)
            paged.write_pages(pool, one, pages)
            seeded.append(paged.pages_to_dense(pool, pages, 2048, length=n_prefix))
        piece = torch.zeros((1, bucket), dtype=prompt.dtype, device="cuda")
        piece[:, :n_suffix] = prompt[:, n_prefix:]
        before = decode.LAUNCHES + decode.INT8_LAUNCHES
        logits, _ = generate.chunk_step(
            w8, piece, torch.arange(n_prefix, n_prefix + bucket, device="cuda"), seeded)
        check(decode.LAUNCHES + decode.INT8_LAUNCHES - before == cfg.num_layers,
              "prefix admission missed K2")
        compare_logits(f"int8 weights, {quant or 'bf16'} KV", [logits[0, n_suffix - 1]],
                       [ref[0]], [f"prefix admission ({n_prefix} shared + {n_suffix} suffix "
                                  "tokens) first-token logits vs the full prompt's prefill"])


# The capture gate: 4 slots of max_len 2048 holding prompts of these
# lengths, then CAPTURE_STEPS decode steps, eager and replayed.
CAPTURE_LENGTHS = [5, 77, 300, 1500]
CAPTURE_STEPS = 8


def capture_caches(model, quant: str | None, paged_kv: bool,
                   gen: torch.Generator) -> list:
    """The gate's caches: dense, or a pool of PAGE-token pages in scrambled
    order (the rest of each table row the sentinel), each slot's prompt
    prefilled at B 1 and installed as the server admits it."""
    cfg = model.cfg
    slots, max_len = len(CAPTURE_LENGTHS), 2048
    maxp = max_len // PAGE
    if paged_kv:
        caches = [paged.init_paged_cache(slots, cfg.num_kv_heads, slots * maxp, PAGE,
                                         cfg.head_dim, maxp, dtype=cfg.dtype, quant=quant)
                  for _ in range(cfg.num_layers)]
        perm = torch.randperm(slots * maxp, generator=torch.Generator().manual_seed(SEED))
    else:
        caches = generate.init_caches(model, slots, max_len, quant=quant)
    for s, n in enumerate(CAPTURE_LENGTHS):
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device="cuda")
        _, single = generate.prefill(model, prompt,
                                     generate.init_caches(model, 1, max_len, quant=quant))
        own = paged.pages_needed(n + CAPTURE_STEPS, PAGE)
        table = perm[s * maxp:s * maxp + own].tolist() + [slots * maxp] * (maxp - own) \
            if paged_kv else None
        for cache, one in zip(caches, single):
            if paged_kv:
                paged.write_slot_paged(cache, one, s, table)
            else:
                kvcache.write_slot(cache, one, s)
    return caches


def cache_tensors(caches: list) -> list[torch.Tensor]:
    """Every tensor of the caches (values, scales, tables, lengths) as raw
    bytes, for torch.equal."""
    return [t.view(torch.uint8) for c in caches for f in dataclasses.fields(c)
            if (t := getattr(c, f.name)) is not None]


def clone_caches(caches: list) -> list:
    return [dataclasses.replace(c, **{f.name: getattr(c, f.name).clone()
                                      for f in dataclasses.fields(c)
                                      if getattr(c, f.name) is not None})
            for c in caches]


def phase_capture(model, w8, gen: torch.Generator) -> None:
    """The captured decode step (generate.DecodeGraph) against the eager
    decode_step at LLAMA_1B width, 4 slots, max_len 2048, for bf16 weights
    on a bf16 cache, int8 weights on an int8 cache, bf16 weights on an fp8
    cache, int8 weights on an int8 pool of 256-token pages and int4 weights
    on a bf16 cache (K2 in every mode, the paged K2, qmm8 and qmm4):
    capture_gate in each."""
    w4 = quantized_copy(model, 4)
    setups = [  # tag, model, KV quant, paged
        ("bf16 weights, bf16 KV", model, None, False),
        ("int8 weights, int8 KV", w8, "int8", False),
        ("bf16 weights, fp8 KV", model, "fp8", False),
        (f"int8 weights, int8 paged KV (pages of {PAGE})", w8, "int8", True),
        ("int4 weights, bf16 KV", w4, None, False),
    ]
    for tag, m, quant, paged_kv in setups:
        capture_gate(tag, m, quant, paged_kv, gen)
    del w4


def capture_gate(tag: str, m, quant: str | None, paged_kv: bool, gen: torch.Generator,
                 name: str = "LLAMA_1B", bitwise: bool = False) -> None:
    """From equal caches (capture_caches), CAPTURE_STEPS steps of the eager
    decode_step and of its CUDA-graph replay with other tokens, positions
    and active rows each step. The logits and every cache byte must be
    equal (the same kernels on the same shapes); where they are not, the
    logits must pass phase 3's rule with equal argmax on the active rows
    (with `bitwise`, they must be equal), and the lengths must be equal."""
    cfg = m.cfg
    slots = len(CAPTURE_LENGTHS)
    eager = capture_caches(m, quant, paged_kv, gen)
    graph = generate.DecodeGraph(m, clone_caches(eager))
    lengths, equal = list(CAPTURE_LENGTHS), True
    for i in range(CAPTURE_STEPS):
        active = [(i + s) % 3 != 0 for s in range(slots)]
        token = torch.randint(0, cfg.vocab_size, (slots,), generator=gen, device="cuda",
                              dtype=torch.int32)
        positions = torch.tensor(lengths, dtype=torch.int32)
        act = torch.tensor(active)
        ref, _ = generate.decode_step(m, token, positions.cuda(), eager, active=act.cuda())
        out = graph(token, positions.pin_memory(), act.pin_memory())
        torch.cuda.synchronize()
        lengths = [n + a for n, a in zip(lengths, active)]
        if torch.equal(ref, out) and all(
                torch.equal(a, b) for a, b in zip(cache_tensors(eager),
                                                  cache_tensors(graph.caches))):
            continue
        equal = False
        check(not bitwise, f"{name} {tag} step {i}: the replay differs from the eager step")
        compare_logits(f"captured vs eager, {tag}", [out[act]], [ref[act]],
                       [f"step {i}, active rows {active}"], model=name)
        check(torch.equal(out[act].argmax(-1), ref[act].argmax(-1)),
              f"{tag} step {i}: argmax differs between the replay and the eager step")
    want = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    check(all(torch.equal(c.length, want) and torch.equal(g.length, want)
              for c, g in zip(eager, graph.caches)), f"{tag}: lengths {lengths} not kept")
    print(f"[capture] {name} {tag}, {slots} slots max_len 2048, lengths "
          f"{CAPTURE_LENGTHS} + {CAPTURE_STEPS} steps with changing active rows: captured "
          f"step {'bitwise equal to' if equal else 'within the logits rule of'} the "
          f"eager step (logits and every cache byte){'' if equal else ', NOT bitwise'}; "
          f"{graph.replays} replays, launches a replay {graph.launches}")
    del eager, graph


def phase_server(model, gen: torch.Generator) -> dict[str, int]:
    cfg = model.cfg
    srv = InferenceServer(model, max_slots=4, max_len=2048)
    srv.warmup()  # captures the decode step
    replays = srv.decode_graph().replays
    n_new = 32
    lens = [16 + (37 * i) % 160 for i in range(8)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in lens]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new))
    got = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES}
    st = srv.stats()
    check(sorted(got) == list(range(8)), f"finished {sorted(got)}")
    for uid, toks in got.items():
        check(len(toks) == n_new and all(0 <= x < cfg.vocab_size for x in toks),
              f"request {uid}: {len(toks)} tokens {toks[:4]}...")
    check(launches["flash_fwd"] >= 8 * cfg.num_layers, f"flash_fwd launches {launches}")
    check(launches["decode"] >= cfg.num_layers * st["decode_steps"],
          f"decode launches {launches} for {st['decode_steps']} steps")
    check_replays("[server]", srv, replays, st["decode_steps"])
    print(f"[server] LLAMA_1B 4 slots max_len 2048, 8 requests, prompts {lens}, "
          f"{n_new} new tokens each: all finished; launches {launches} over "
          f"{st['decode_steps']} decode steps")
    print(f"[server] prefill {st['prefill_ms_avg']} ms/request, decode "
          f"{st['decode_ms_avg']} ms/step, host {st['host_ms_avg']} ms/step, "
          f"wall {8 * n_new / wall:.1f} tokens/s ({8 * n_new} tokens in "
          f"{wall:.3f} s; stats() decode-phase rate {st['wall_tokens_per_s']} tokens/s)")
    calibrate("[server]", srv)
    return launches


CALIB_ITERS = 10  # decode steps in calibrate_device_step's CUDA graph
ADMIT_ITERS = 4  # admissions in each of calibrate_admit's two graphs


def check_replays(tag: str, srv: InferenceServer, before: int, steps: int) -> None:
    """Every decode step of the run was one replay of the server's graph."""
    replays = srv.decode_graph().replays - before
    check(replays == steps, f"{tag} {replays} graph replays for {steps} decode steps")
    print(f"{tag} every decode step a CUDA-graph replay: {replays} replays, {steps} steps")


def calibrate(tag: str, srv: InferenceServer) -> None:
    """calibrate_device_step on the server after its run: every slot
    inactive, CALIB_ITERS steps captured in one graph, timed by events."""
    srv.calibrate_device_step(iters=CALIB_ITERS)
    st = srv.stats()
    check(st["device_step_ms"] > 0, f"{tag} calibrate_device_step: {st}")
    print(f"{tag} calibrate_device_step({CALIB_ITERS} steps in one CUDA graph, every slot "
          f"inactive): device_step_ms {st['device_step_ms']}, device_tokens_per_s_bound "
          f"{st['device_tokens_per_s_bound']}")


# Every kernel's launch counter by the kernel's name (a replay of a captured
# decode step adds what the capture counted).
COUNTERS = launch_counters.COUNTERS


def phase_quant_server(w8, gen: torch.Generator) -> dict[str, int]:
    """The quantized paged server at LLAMA_1B width (int8 weights, int8 KV,
    4 slots, max_len 2048, pages of 256) on 8 requests of 32 new tokens:
    (a) dense, (b) paged with a pool one page short of four live requests,
    (c) paged with a registered 512-token prefix before four of the prompts,
    chunked admission of 256 and logprobs. The quantized serving path: the
    launches are those of the three runs (each server's warmup, which
    captures its decode step, and its calibration after the run are left
    out); every decode step is one replay of the server's CUDA graph."""
    cfg = w8.cfg
    layers, per_call = cfg.num_layers, 7 * cfg.num_layers + 1
    n_new, chunk = 32, 256
    lens = [16 + (37 * i) % 160 for i in range(8)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in lens]
    prefix = torch.randint(0, cfg.vocab_size, (512,), generator=gen, device="cuda").tolist()
    common = dict(max_slots=4, max_len=2048, quant="int8")
    runs = {
        "a dense": dict(),
        "b paged": dict(paged=True, page_size=PAGE, num_pages=3),
        "c paged+prefix+chunked": dict(paged=True, page_size=PAGE, num_pages=5,
                                       admit_chunk=chunk, return_logprobs=True),
    }
    torch.cuda.synchronize()
    reset_launches()
    results, total = {}, dict.fromkeys(COUNTERS, 0)
    for name, option in runs.items():
        srv = InferenceServer(w8, **common, **option)
        srv.warmup()  # captures the decode step
        replays = srv.decode_graph().replays
        before = read_launches()
        t0 = time.perf_counter()
        pid = None
        reqs = list(zip(range(8), prompts))
        if "prefix" in name:
            pid = srv.register_prefix(prefix)
            reqs = [(uid, prefix + p if uid % 2 else p) for uid, p in reqs]
        for uid, p in reqs:
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new,
                               prefix_id=pid if len(p) > 512 else None))
        waited = 0  # steps that ended with a free slot but too few free pages
        while srv.queue or any(not sl.free for sl in srv.slots):
            srv.step()
            if srv.paged and srv.queue and any(sl.free for sl in srv.slots):
                nxt = srv.queue[0]
                need = paged.pages_needed(len(nxt.prompt) + nxt.max_new_tokens, PAGE) - len(
                    srv._shared_split(nxt)[1])
                waited += need > srv.allocator.free_pages
        got, srv.finished = srv.finished, {}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        added = {k: v - before[k] for k, v in read_launches().items()}
        check(sorted(got) == list(range(8)), f"{name}: finished {sorted(got)}")
        for uid, toks in got.items():
            check(len(toks) == n_new and all(0 <= x < cfg.vocab_size for x in toks),
                  f"{name} request {uid}: {len(toks)} tokens {toks[:4]}...")
        steps = st["decode_steps"]
        if "prefix" in name:
            chunks = sum(paged.pages_needed(len(p) - (512 if len(p) > 512 else 0), chunk)
                         for _, p in reqs)
            want = {"flash_fwd": layers, "paged_decode": layers * (steps + chunks),
                    "qmm8": per_call * (1 + chunks + steps)}
            lps = srv.finished_logprobs
            check(sorted(lps) == list(range(8)) and all(
                len(v) == n_new and all(math.isfinite(x) and x <= 0.0 for x in v)
                for v in lps.values()), f"{name}: logprobs {lps}")
            print(f"[quant-server] {name}: logprobs of all {8 * n_new} tokens finite and <= 0 "
                  f"(request 1: {[round(x, 4) for x in lps[1][:4]]}...)")
            print(f"[quant-server] {name}: stats {st}")
            srv.unregister_prefix(pid)
            check(srv.allocator.free_pages == srv.allocator.num_pages,
                  f"{name}: {srv.allocator.free_pages} of {srv.allocator.num_pages} pages free "
                  "after unregister_prefix")
        else:
            kernel = "paged_decode" if srv.paged else "decode_int8"
            want = {"flash_fwd": layers * 8, kernel: layers * steps,
                    "qmm8": per_call * (8 + steps)}
        check(all(added[k] == v for k, v in want.items())
              and not any(v for k, v in added.items() if k not in want),
              f"{name}: launched {added}, want {want}")
        if srv.paged:
            check(waited > 0, f"{name}: no request waited for pages")
            check(srv.allocator.free_pages == srv.allocator.num_pages,
                  f"{name}: pages left allocated")
        check_replays(f"[quant-server] {name}:", srv, replays, steps)
        total = {k: total[k] + v for k, v in added.items()}
        results[name] = got
        print(f"[quant-server] LLAMA_1B int8 weights, int8 KV, {name}: 8 requests, prompts "
              f"{[len(p) for _, p in reqs]}, {n_new} new tokens each, all finished in "
              f"{wall:.3f} s ({8 * n_new / wall:.1f} tokens/s, {steps} decode steps, "
              f"{waited} steps ended with a request waiting for pages); launches {added}")
        print(f"[quant-server] {name}: prefill {st['prefill_ms_avg']} ms/request, decode "
              f"{st['decode_ms_avg']} ms/step, host {st['host_ms_avg']} ms/step, admit "
              f"{st['admit_ms_avg']} ms/step")
        if srv.paged:
            print(f"[quant-server] {name}: pages total {st['pages_total']}, free at the end "
                  f"{srv.allocator.free_pages}")
        calibrate(f"[quant-server] {name}:", srv)
        if "prefix" in name:
            admit = srv.calibrate_admit(prompt_len=768, prefix_len=512, iters=ADMIT_ITERS)
            check(all(v > 0 for v in admit.values()), f"{name}: calibrate_admit {admit}")
            print(f"[quant-server] {name}: calibrate_admit(prompt_len=768, prefix_len=512, "
                  f"{ADMIT_ITERS} admissions in one CUDA graph each): {admit}")
        del srv
    check(results["b paged"] == results["a dense"], "paged server tokens differ from dense")
    print("[quant-server] (a) dense and (b) paged servers give equal tokens for all 8 requests")
    return total


def reset_launches() -> None:
    launch_counters.reset()


def read_launches() -> dict[str, int]:
    return launch_counters.read()


@contextlib.contextmanager
def plain_training_attention():
    """Route the training forward's attention to the plain route (the same
    autograd Function over the plain forward and backward)."""
    saved = llama.flash_attention
    llama.flash_attention = plain_flash_attention
    try:
        yield
    finally:
        llama.flash_attention = saved


TRAIN_TC = train.TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=6)


def phase_train_step(model, gen: torch.Generator) -> dict[str, int]:
    """One AdamW train step through the kernels and one on the plain route,
    from the same weights and tokens."""
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=gen,
                           device="cuda")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for route in ("kernels", "plain"):
        model.load_state_dict(start)
        state = train.init_train_state(model, TRAIN_TC)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with plain_training_attention() if route == "plain" else contextlib.nullcontext():
            state, metrics = train.train_step(state, tokens)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        # The clipped gradients: one factor for all, so each one's direction
        # is the raw gradient's.
        grads = {n: p.grad for n, p in model.named_parameters()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[route] = (loss, gnorm, grads, launches)
        print(f"[train] LLAMA_1B B={TRAIN_B} S={TRAIN_S} AdamW step, {route}: loss {loss:.6f} "
              f"grad_norm {gnorm:.6f}, {ms:.1f} ms ({TRAIN_B * TRAIN_S / ms * 1e3:.0f} "
              f"tokens/s), peak {peak:.2f} GiB, launches {launches}")
        del state
    del start
    (l_k, n_k, g_k, launches), (l_p, n_p, g_p, plain_launches) = runs["kernels"], runs["plain"]
    check(launches["flash_fwd"] == cfg.num_layers and launches["flash_bwd_fused"] == cfg.num_layers
          and launches["decode"] == launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
          f"kernel train step launched {launches}")
    check(not any(plain_launches.values()), f"plain train step launched {plain_launches}")
    cos = cosines(g_k, g_p)
    worst = min(cos, key=cos.get)
    print(f"[train] kernels vs plain: |dloss| {abs(l_k - l_p):.6f} (<= {LOSS_ATOL}), "
          f"grad_norm rel {abs(n_k - n_p) / n_p:.6f} (<= {GRAD_NORM_REL}), gradient cosine "
          f"min {cos[worst]:.6f} ({worst}) over {len(cos)} parameters (> {GRAD_COS})")
    check(abs(l_k - l_p) <= LOSS_ATOL and abs(n_k - n_p) <= GRAD_NORM_REL * n_p
          and cos[worst] > GRAD_COS, "train step: kernels and plain route disagree")
    return launches


def phase_trainer(model, gen: torch.Generator) -> dict[str, int]:
    """train.train for 6 AdamW steps on one repeated batch, the deterministic
    split backward selected as a user does, through FLASHATTN_BWD_IMPL."""
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=gen,
                           device="cuda")
    marks = []  # (host clock, peak bytes since the previous mark) at each step's start

    def batches():
        while True:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            yield tokens

    steps = 6
    os.environ[flash_bwd.IMPL_ENV] = "split"
    reset_launches()
    try:
        state, hist = train.train(model, batches(), TRAIN_TC, steps=steps, log_every=1)
    finally:
        del os.environ[flash_bwd.IMPL_ENV]
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
    launches = read_launches()
    for h, (t0, _), (t1, peak) in zip(hist, marks, marks[1:]):
        ms = (t1 - t0) * 1e3
        print(f"[trainer] step {h['step']}: loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f}, {ms:.1f} ms (host clock, synchronised), "
              f"{TRAIN_B * TRAIN_S / ms * 1e3:.0f} tokens/s, max_memory_allocated "
              f"{peak / 2**30:.2f} GiB")
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and state["step"] == steps, f"trainer ran {len(hist)} steps")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"trainer losses {losses}")
    n = steps * cfg.num_layers
    check(launches["flash_fwd"] == launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == n
          and launches["flash_bwd_fused"] == 0, f"trainer launched {launches}")
    print(f"[trainer] LLAMA_1B B={TRAIN_B} S={TRAIN_S}, {steps} AdamW steps (lr {TRAIN_TC.learning_rate},"
          f" warmup {TRAIN_TC.warmup_steps}), split backward: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches}")
    return launches


# Phase 9: MISTRAL_7B at full width.
MISTRAL_PROMPT = 4608  # past the 4096-token window
MISTRAL_SERVED = [4200, 4800, 5400, 6000]  # prompt tokens of the four requests
MISTRAL_NEW = 32
MISTRAL_PREFIX = 1024  # the paged server's registered prefix (4 pages of 256)
WINDOW_COUNTERS = ("flash_fwd_window", "decode_window", "paged_decode_window")


def long_prompt_server(model, tag: str, prompts: list[list[int]], prefix: list[int] | None,
                       log: str = "[mistral]", max_len: int | None = None,
                       tokens: dict | None = None, **options) -> dict[str, int]:
    """One server run on the requests of `prompts` (a prompt that starts
    with `prefix` names the registered prefix): every request finished with
    MISTRAL_NEW valid tokens, every decode step a replay; the launches of
    the run (warmup, prefix registration and calibration left out). Lines
    print under `log`. The slots hold max_len tokens (cfg.max_seq_len by
    default). The requests' tokens go into `tokens` where given."""
    cfg = model.cfg
    srv = InferenceServer(model, max_slots=2, max_len=max_len or cfg.max_seq_len, **options)
    srv.warmup()  # captures the decode step
    pid = srv.register_prefix(prefix) if prefix is not None else None
    replays = srv.decode_graph().replays
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        shared = prefix is not None and p[:len(prefix)] == prefix
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=MISTRAL_NEW,
                           prefix_id=pid if shared else None))
    got = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = srv.stats()
    check(sorted(got) == list(range(len(prompts))), f"{tag}: finished {sorted(got)}")
    for uid, toks in got.items():
        check(len(toks) == MISTRAL_NEW and all(0 <= x < cfg.vocab_size for x in toks),
              f"{tag} request {uid}: {len(toks)} tokens {toks[:4]}...")
    check_replays(f"{log} {tag}:", srv, replays, st["decode_steps"])
    if tokens is not None:
        tokens.update(got)
    n = len(prompts) * MISTRAL_NEW
    print(f"{log} {tag}: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
          f"{MISTRAL_NEW} new tokens each, all finished in {wall:.3f} s ({n / wall:.1f} "
          f"tokens/s, {st['decode_steps']} decode steps); prefill {st['prefill_ms_avg']} "
          f"ms/request, decode {st['decode_ms_avg']} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    # The calibrations capture graphs, whose private memory pool cannot take
    # the allocator's cached free blocks: hand those back to the device
    # first (beside a 61 GB model they are what is left).
    torch.cuda.empty_cache()
    calibrate(f"{log} {tag}:", srv)
    if prefix is not None:
        admit = srv.calibrate_admit(prompt_len=MISTRAL_PREFIX + 256, prefix_len=MISTRAL_PREFIX,
                                    iters=2)
        check(all(v > 0 for v in admit.values()), f"{tag}: calibrate_admit {admit}")
        print(f"{log} {tag}: calibrate_admit(prompt_len={MISTRAL_PREFIX + 256}, "
              f"prefix_len={MISTRAL_PREFIX}, 2 admissions in one CUDA graph each): {admit}")
        srv.unregister_prefix(pid)
        check(srv.allocator.free_pages == srv.allocator.num_pages,
              f"{tag}: pages left allocated")
    del srv
    return launches


def phase_mistral(gen: torch.Generator) -> dict[str, int]:
    """MISTRAL_7B at full width: a 4,608-token prefill and 4 teacher-forced
    decode steps through the kernels (every layer windowed) against the
    plain route; then the bf16 server and the int8-KV paged server with
    chunked admission and a registered prefix. Returns the windowed
    launches of the two server runs."""
    cfg = MISTRAL_7B
    layers = cfg.num_layers
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"[mistral] MISTRAL_7B random weights on the card in {time.perf_counter() - t0:.2f} "
          f"s, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, "
          f"window {cfg.attn_window}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompt = torch.randint(0, cfg.vocab_size, (1, MISTRAL_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    reset_launches()
    kern = generation_run(model, prompt, forced, max_len=cfg.max_seq_len)
    added = read_launches()
    want = {"flash_fwd": layers, "flash_fwd_window": layers, "decode": 4 * layers,
            "decode_window": 4 * layers}
    check({k: v for k, v in added.items() if v} == want,
          f"MISTRAL_7B kernel run launched {added}, want {want}")
    with plain_kernels():
        plain = generation_run(model, prompt, forced, max_len=cfg.max_seq_len)
    check(read_launches() == added, "MISTRAL_7B plain run launched a kernel")
    compare_logits("bf16, every layer windowed", kern, plain,
                   [f"prefill S={MISTRAL_PROMPT}"] + [f"decode {i}" for i in range(1, 5)],
                   model="MISTRAL_7B")
    del kern, plain

    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in MISTRAL_SERVED]
    total = dict.fromkeys(WINDOW_COUNTERS, 0)
    bf16 = long_prompt_server(model, "bf16 server, 2 slots, max_len 8192", prompts, None)
    prefix = prompts[0][:MISTRAL_PREFIX]
    served = [p if uid % 2 == 0 else prefix + p[MISTRAL_PREFIX:]
              for uid, p in enumerate(prompts)]
    paged_run = long_prompt_server(
        model, f"int8-KV paged server (pages of {PAGE}, admit_chunk 256, a "
        f"{MISTRAL_PREFIX}-token prefix before requests 0, 1 and 3)", served, prefix,
        quant="int8", paged=True, page_size=PAGE, admit_chunk=256)
    for runs in (bf16, paged_run):
        total = {k: total[k] + runs[k] for k in total}
    check(bf16["flash_fwd_window"] > 0 and bf16["decode_window"] > 0
          and paged_run["paged_decode_window"] > 0,
          f"a windowed kernel missed the Mistral servers: bf16 {bf16}, paged {paged_run}")
    print(f"[mistral] windowed launches of the two server runs: {total}")
    del model
    torch.cuda.empty_cache()
    return total


# The packed, windowed training phase: MISTRAL_7B at full width cut to
# PACK_LAYERS layers (32 layers with AdamW state pass one card's 80 GB:
# about 7.2 B parameters, whose weights, gradients and two moments alone
# pass 100 GB; 4 layers hold about 1.13 B), one row of 8,193 tokens a step
# from PackedDataset over the four PACK_DOCS documents (an epoch is one
# row, in the epoch's seeded order): a document past the 4096-token window,
# boundaries off the tile multiples and trailing padding in every step.
PACK_LAYERS = 4
PACK_STEPS = 5
PACK_COUNTERS = ("flash_fwd_window", "flash_fwd_segments", "flash_bwd_fused_window",
                 "flash_bwd_fused_segments", "flash_bwd_dq_window", "flash_bwd_dq_segments",
                 "flash_bwd_dkv_window", "flash_bwd_dkv_segments")


def check_packed_row(tokens, segs, cfg) -> str:
    """Fails unless the row holds a document longer than the window (where
    cfg has one), at least two document boundaries off the 64- and
    128-token tile multiples and trailing padding; returns its layout."""
    seg = segs[0]
    live = seg >= 0
    starts = [i for i in range(1, len(seg)) if live[i] and seg[i] != seg[i - 1]]
    ends = starts + [int(live.sum())]
    lengths = [b - a for a, b in zip([0] + starts, ends)]
    off_tile = [x for x in starts if x % 64]
    check((cfg.attn_window is None or max(lengths) > cfg.attn_window) and len(off_tile) >= 2
          and not live[-1]
          and tokens.shape == segs.shape == (1, PACK_S + 1),
          f"packed row: documents {lengths}, boundaries {starts}, {int((~live).sum())} padding")
    return (f"documents {lengths} (boundaries {starts}, {len(off_tile)} off the tile "
            f"multiples), {int((~live).sum())} padding tokens")


@contextlib.contextmanager
def plain_packed_attention():
    """plain_training_attention for the packed path too: the varlen entry
    point reaches flash_attention through ops/varlen.py."""
    saved = varlen.flash_attention
    varlen.flash_attention = plain_flash_attention
    try:
        with plain_training_attention():
            yield
    finally:
        varlen.flash_attention = saved


def phase_packed(gen: torch.Generator) -> dict[str, int]:
    """Phase 10: packed_training on MISTRAL_7B cut to PACK_LAYERS layers."""
    return packed_training(gen, dataclasses.replace(MISTRAL_7B, num_layers=PACK_LAYERS),
                           "MISTRAL_7B", "[packed]", PACK_COUNTERS)


def packed_training(gen: torch.Generator, cfg, name: str, log: str,
                    counters: tuple[str, ...]) -> dict[str, int]:
    """One AdamW step of `cfg` (full width, cut in depth) on a packed row
    through the kernels (K1 with each layer's window, segment ids and the
    cap or ALiBi, the fused backward) against the same step on the plain
    route from
    the same weights, under phase 7's gates; then train.train for
    PACK_STEPS steps on PackedDataset batches through prefetch with the
    split backward, the loss falling; ms, tokens/s and peak memory a step.
    Returns the launches of `counters` over the two runs, each of which
    must be > 0. Lines print under `log`."""
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = cfg.num_layers
    local = sum(llama.layer_window(cfg, i) is not None for i in range(n))
    print(f"{log} {name} cut to {n} layers (full width: hidden {cfg.hidden_size}, GQA "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}, window {cfg.attn_window} on "
          f"{local} layers, soft-cap {cfg.logit_softcap}, ALiBi {cfg.use_alibi}): "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    docs = [rng.integers(1, cfg.vocab_size, n_tok).tolist() for n_tok in PACK_DOCS]
    dataset = data.PackedDataset(docs, batch_size=1, seq_len=PACK_S, seed=SEED)
    batch = next(dataset.batches())
    layout = check_packed_row(batch["tokens"], batch["segment_ids"], cfg)
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    segs = torch.from_numpy(batch["segment_ids"]).cuda()
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    runs = {}
    for route in ("kernels", "plain"):
        model.load_state_dict(start)
        state = train.init_train_state(model, TRAIN_TC)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with plain_packed_attention() if route == "plain" else contextlib.nullcontext():
            state, metrics = train.train_step(state, tokens, segment_ids=segs)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        grads = {k: p.grad for k, p in model.named_parameters()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[route] = (loss, gnorm, grads, launches)
        how = ("attention one kv-head group at a time, forward and backward; "
               if route == "plain" else "")
        print(f"{log} AdamW step, {route} ({how}{layout}): loss {loss:.6f} grad_norm "
              f"{gnorm:.6f}, {ms:.1f} ms ({PACK_S / ms * 1e3:.0f} tokens/s), peak {peak:.2f} "
              f"GiB, launches { {k: v for k, v in launches.items() if v} }")
        del state
    del start
    (l_k, n_k, g_k, launches), (l_p, n_p, g_p, plain_launches) = runs["kernels"], runs["plain"]
    capped = n if cfg.logit_softcap else 0
    biased = n if cfg.use_alibi else 0
    per_step = {"flash_fwd": n, "flash_fwd_window": local, "flash_fwd_segments": n,
                "flash_fwd_softcap": capped, "flash_fwd_alibi": biased,
                "flash_fwd_alibi_segments": biased}
    want = dict(per_step, flash_bwd_fused=n, flash_bwd_fused_window=local,
                flash_bwd_fused_segments=n, flash_bwd_fused_softcap=capped,
                flash_bwd_fused_alibi=biased)
    want = {k: v for k, v in want.items() if v}
    check({k: v for k, v in launches.items() if v} == want,
          f"{name} packed kernel step launched {launches}, want {want}")
    check(not any(plain_launches.values()), f"plain packed step launched {plain_launches}")
    cos = {k: float(F.cosine_similarity(g_k[k].float().flatten(), g_p[k].float().flatten(),
                                        dim=0)) for k in g_k}
    worst = min(cos, key=cos.get)
    print(f"{log} gradient cosines, kernels vs plain: "
          f"{ {k: round(c, 6) for k, c in sorted(cos.items(), key=lambda x: x[1])} }")
    print(f"{log} kernels vs plain: |dloss| {abs(l_k - l_p):.6f} (<= {LOSS_ATOL}), "
          f"grad_norm rel {abs(n_k - n_p) / n_p:.6f} (<= {GRAD_NORM_REL}), gradient cosine "
          f"min {cos[worst]:.6f} ({worst}) over {len(cos)} parameters (> {GRAD_COS})")
    check(abs(l_k - l_p) <= LOSS_ATOL and abs(n_k - n_p) <= GRAD_NORM_REL * n_p
          and cos[worst] > GRAD_COS, f"{name} packed train step: kernels and plain route disagree")
    del runs, g_k, g_p
    total = {k: launches[k] for k in counters}

    marks, layouts = [], []

    def timed(batches):
        for batch in batches:
            layouts.append(check_packed_row(batch["tokens"], batch["segment_ids"], cfg))
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            yield batch

    os.environ[flash_bwd.IMPL_ENV] = "split"
    reset_launches()
    try:
        state, hist = train.train(model, timed(data.prefetch(dataset.batches())), TRAIN_TC,
                                  steps=PACK_STEPS, log_every=1)
    finally:
        del os.environ[flash_bwd.IMPL_ENV]
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
    trained = read_launches()
    for h, row, (t0, _), (t1, peak) in zip(hist, layouts, marks, marks[1:]):
        ms = (t1 - t0) * 1e3
        print(f"{log}-trainer step {h['step']}: loss {h['loss']:.6f} grad_norm "
              f"{h['grad_norm']:.6f}, {ms:.1f} ms (host clock, synchronised), "
              f"{PACK_S / ms * 1e3:.0f} tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"{row}")
    losses = [h["loss"] for h in hist]
    check(len(hist) == PACK_STEPS and all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{name} packed trainer losses {losses}")
    split = {k.replace("flash_bwd_fused", kernel): v for k, v in want.items()
             if k.startswith("flash_bwd_fused") for kernel in ("flash_bwd_dq", "flash_bwd_dkv")}
    trained_want = {k: PACK_STEPS * v for k, v in {**per_step, **split}.items() if v}
    check({k: v for k, v in trained.items() if v} == trained_want,
          f"{name} packed trainer launched {trained}, want {trained_want}")
    print(f"{log}-trainer {PACK_STEPS} AdamW steps of PackedDataset rows through prefetch, "
          f"split backward: loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{({k: trained[k] for k in counters})}")
    for k in counters:
        total[k] += trained[k]
    check(all(total[k] > 0 for k in counters), f"{name} packed phase missed a kernel: {total}")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return total


# GEMMA2_9B at full width and depth (phase 11): 42 layers alternating a
# 4096-token local window (even layers) and global attention, head dim 256,
# soft-caps 50 (attention) and 30 (final), post-norms; random bf16 weights
# from the seed, about 18.5 GB. The traffic is phase 9's: 4 prompts of
# 4,200-6,000 tokens (every local layer's window cuts), 32 new tokens each.
SOFTCAP_COUNTERS = ("flash_fwd_softcap", "decode_softcap", "paged_decode_softcap")


def phase_gemma(gen: torch.Generator) -> dict[str, int]:
    """GEMMA2_9B at full width and depth: a 4,608-token prefill and 4
    teacher-forced decode steps through the kernels (K1 and K2 with the cap
    on every layer, the window on the even ones) against the plain route
    under phase 3's logits rule; then the bf16 server and the int8-KV
    paged server with chunked admission and a registered prefix. Returns
    the soft-capped launches of the two server runs."""
    cfg = GEMMA2_9B
    layers = cfg.num_layers
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"[gemma] GEMMA2_9B random weights on the card in {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, head dim "
          f"{cfg.head_dim}, soft-caps {cfg.logit_softcap:g}/{cfg.final_logit_softcap:g}, "
          f"window {cfg.attn_window} on even layers, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompt = torch.randint(0, cfg.vocab_size, (1, MISTRAL_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kern = generation_run(model, prompt, forced, max_len=cfg.max_seq_len)
    run_s = time.perf_counter() - t0
    added = read_launches()
    local = (layers + 1) // 2
    want = {"flash_fwd": layers, "flash_fwd_window": local, "flash_fwd_softcap": layers,
            "decode": 4 * layers, "decode_window": 4 * local, "decode_softcap": 4 * layers}
    check({k: v for k, v in added.items() if v} == want,
          f"GEMMA2_9B kernel run launched {added}, want {want}")
    print(f"[gemma] kernel run (prefill S={MISTRAL_PROMPT} and 4 decode steps) in "
          f"{run_s:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {want}")
    with plain_kernels():
        plain = generation_run(model, prompt, forced, max_len=cfg.max_seq_len)
    check(read_launches() == added, "GEMMA2_9B plain run launched a kernel")
    compare_logits("bf16, soft-capped, alternate windows", kern, plain,
                   [f"prefill S={MISTRAL_PROMPT}"] + [f"decode {i}" for i in range(1, 5)],
                   model="GEMMA2_9B")
    del kern, plain

    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in MISTRAL_SERVED]
    bf16 = long_prompt_server(model, "bf16 server, 2 slots, max_len 8192", prompts, None,
                              log="[gemma]")
    prefix = prompts[0][:MISTRAL_PREFIX]
    served = [p if uid % 2 == 0 else prefix + p[MISTRAL_PREFIX:]
              for uid, p in enumerate(prompts)]
    paged_run = long_prompt_server(
        model, f"int8-KV paged server (pages of {PAGE}, admit_chunk 256, a "
        f"{MISTRAL_PREFIX}-token prefix before requests 0, 1 and 3)", served, prefix,
        log="[gemma]", quant="int8", paged=True, page_size=PAGE, admit_chunk=256)
    total = {k: bf16[k] + paged_run[k] for k in SOFTCAP_COUNTERS}
    check(bf16["flash_fwd_softcap"] > 0 and bf16["decode_softcap"] > 0
          and paged_run["paged_decode_softcap"] > 0,
          f"a soft-capped kernel missed the Gemma servers: bf16 {bf16}, paged {paged_run}")
    print(f"[gemma] soft-capped launches of the two server runs: {total}")
    del model
    torch.cuda.empty_cache()
    return total


# Phase 12: GEMMA2_9B trained on packed rows, full width cut to PACK_LAYERS
# layers (42 layers with AdamW state pass one card: 9.24 B parameters; 4
# hold about 1.71 B, the 918 M tied embedding and 198 M a layer): layers 0
# and 2 local (window 4096), 1 and 3 global, cap 50 on every layer, through
# the soft-capped, segmented and windowed K1, B3, B4 and B5 at D 256.
GEMMA_PACK_COUNTERS = ("flash_fwd_softcap", "flash_fwd_segments", "flash_fwd_window",
                       *SOFTCAP_BWD_ROWS, "flash_bwd_fused_segments", "flash_bwd_dq_segments",
                       "flash_bwd_dkv_segments")


def phase_gemma_packed(gen: torch.Generator) -> dict[str, int]:
    """Phase 12: packed_training on GEMMA2_9B cut to PACK_LAYERS layers."""
    return packed_training(gen, dataclasses.replace(GEMMA2_9B, num_layers=PACK_LAYERS),
                           "GEMMA2_9B", "[gemma-packed]", GEMMA_PACK_COUNTERS)


# Phase 13: rematerialisation and the measured fused-or-split backward.
# (a) LLAMA_1B at full width, B 4, S 2048 (phase 7's shape); (b) GEMMA2_9B
# cut to PACK_LAYERS layers on phase 12's packed row; (c) GEMMA2_9B at its
# full depth, B 1, S 4096, unpacked, GEMMA_FULL_STEPS sgd_train_steps on one
# repeated batch (about 9.24 B parameters: weights and gradients take
# 34.4 GiB, and without remat every layer's activations stay as well);
# (d) autotune at LLAMA_1B's training shape.
REMAT_B8 = 8
GEMMA_FULL_S = 4096
GEMMA_FULL_STEPS = 5
GEMMA_FULL_LR = 1e-2
REMAT_K1 = {False: 1, True: 2, "dots": 2, "attn": 1}  # K1 launches a layer a step


def remat_launch_want(remat, impl: str, layers: int, extra: dict | None = None) -> dict:
    """The kernel launches one loss and backward should count: K1 once a
    layer, twice under True and "dots" (the recompute); the backward's
    kernels once a layer; `extra` (counter -> launches) added."""
    want = {"flash_fwd": REMAT_K1[remat] * layers}
    if impl == "fused":
        want["flash_bwd_fused"] = layers
    else:
        want.update(flash_bwd_dq=layers, flash_bwd_dkv=layers)
    for k, n in (extra or {}).items():
        want[k] = want.get(k, 0) + n
    return want


def add_launches(total: dict[str, int], got: dict[str, int]) -> None:
    for k, n in got.items():
        total[k] = total.get(k, 0) + n


def remat_gates(model, tokens, log: str, policies, segment_ids=None,
                extra=lambda remat, impl: None, impls=("split", "fused")
                ) -> tuple[dict[str, int], dict]:
    """One loss_fn(...).backward() a policy and backward path (`impls`)
    from the same weights: the loss must equal remat=False's bit for bit;
    the gradients with the split backward (no atomics) too, with the fused
    one (dQ by float atomics, in an order that changes between runs)
    within phase 7's gates. The launches must be remat_launch_want's (`extra(remat, impl)`:
    the windowed, segmented and capped launches). Prints each policy's peak
    and the bytes its layers' forward held per layer; returns the launches
    of all the runs and the bytes per layer by policy."""
    layers = model.cfg.num_layers
    total: dict[str, int] = {}
    held = {}
    for impl in impls:
        ref = None
        for remat in (False, *policies):
            model.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()  # the last run's freed blocks: no fragments
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with profile_train.backward_impl(impl):
                loss = llama.loss_fn(model, tokens, segment_ids, remat=remat)
                loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = {k: n for k, n in read_launches().items() if n}
            want = remat_launch_want(remat, impl, layers, extra(remat, impl))
            check(got == want, f"{log} remat={remat!r} {impl}: launched {got}, want {want}")
            add_launches(total, got)
            grads = {k: p.grad for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            loss = loss.detach()
            if impl == "split":
                held[remat] = profile_train.layer_bytes(model, tokens, remat, segment_ids)
            if ref is None:
                ref = (loss, grads)
                print(f"{log} loss_fn + backward, remat=False, {impl}: loss {float(loss):.6f}, "
                      f"peak {peak:.2f} GiB, launches {got}")
                continue
            l_ref, g_ref = ref
            check(torch.equal(loss, l_ref), f"{log} remat={remat!r} {impl}: loss "
                  f"{float(loss)!r} != {float(l_ref)!r} without remat")
            equal = all(torch.equal(grads[k], g_ref[k]) for k in grads)
            cos = {k: float(F.cosine_similarity(grads[k].float().flatten(),
                                                g_ref[k].float().flatten(), dim=0))
                   for k in grads}
            worst = min(cos, key=cos.get)
            n_k = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads.values()])))
            n_r = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in g_ref.values()])))
            if impl == "split":
                check(equal, f"{log} remat={remat!r} split: gradients not bit for bit equal")
                how = "gradients bit for bit equal (the split backward is deterministic)"
            else:
                check(abs(n_k - n_r) <= GRAD_NORM_REL * n_r and cos[worst] > GRAD_COS,
                      f"{log} remat={remat!r} fused: gradients disagree")
                how = (f"gradients {'bit for bit equal' if equal else 'within phase 7 gates'}"
                       f" (fused: dQ by atomics): grad_norm rel {abs(n_k - n_r) / n_r:.2e} "
                       f"(<= {GRAD_NORM_REL}), cosine min {cos[worst]:.6f} ({worst}, > {GRAD_COS})")
            print(f"{log} loss_fn + backward, remat={remat!r}, {impl}: loss bit for bit equal "
                  f"to remat=False's ({float(loss):.6f}); {how}; peak {peak:.2f} GiB, "
                  f"launches {got}")
            del grads
        del ref
    for remat, b in held.items():
        print(f"{log} remat={remat!r}: {b / 1e6:.1f} MB a layer held after the layers' forward")
    return total, held


def phase_remat(gen: torch.Generator) -> dict[str, int]:
    """Phase 13: remat and autotune (the comment above). Returns the
    launches of the gated runs of (a) and (b) and of (c)'s steps (not the
    timed arms', read a step at a time, nor autotune's timings)."""
    total: dict[str, int] = {}
    # (a) LLAMA_1B at full width.
    cfg = LLAMA_1B
    model = init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=gen,
                           device="cuda")
    got, _ = remat_gates(model, tokens, "[remat]", llama.REMAT_POLICIES)
    add_launches(total, got)
    for arm in profile_train.remat_arms(model, tokens):
        want = remat_launch_want(arm["remat"], arm["impl"], cfg.num_layers)
        check(arm["launches"] == want, f"[remat] arm {arm['remat']!r} {arm['impl']}: launched "
              f"{arm['launches']} a step, want {want}")
    tokens8 = torch.randint(0, cfg.vocab_size, (REMAT_B8, TRAIN_S + 1), generator=gen,
                            device="cuda")
    arm = profile_train.remat_arm(model, tokens8, "attn", "fused")
    check(arm["launches"] == remat_launch_want("attn", "fused", cfg.num_layers),
          f"[remat] B={REMAT_B8} attn launched {arm['launches']}")
    print(f"[remat] LLAMA_1B B={REMAT_B8} S={TRAIN_S} sgd_train_step remat='attn' fused: "
          f"{arm['ms']:.1f} ms/step (median of {[round(w, 1) for w in arm['walls']]}), "
          f"{arm['tokens_per_s']:.0f} tokens/s, peak {arm['peak_gib']:.2f} GiB, "
          f"{arm['layer_mb']:.1f} MB a layer held after the forward, device busy "
          f"{arm['busy_ms']:.1f} ms (idle share {arm['idle']:.3f})")
    del model, tokens8
    gc.collect()
    torch.cuda.empty_cache()

    # (d) autotune at LLAMA_1B's training shape, in the run's own cache file.
    b, hq, hkv, d = TRAIN_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = randn((b, hq, TRAIN_S, d), gen)
    k, v = randn((b, hkv, TRAIN_S, d), gen), randn((b, hkv, TRAIN_S, d), gen)
    entry = autotune.autotune(q, k, v, is_causal=True, verbose=True)
    check(autotune.cached_bwd_impl(b, hq, hkv, TRAIN_S, TRAIN_S, d, True, q.dtype)
          == entry["bwd_impl"], f"[autotune] the cache does not hold {entry}")
    reset_launches()
    check(autotune.autotune(q, k, v, is_causal=True) == entry
          and not any(read_launches().values()), "[autotune] a cache hit measured again")
    winner = entry["bwd_impl"]
    loser = "split" if winner == "fused" else "fused"
    print(f"[autotune] LLAMA_1B training shape B={b} Hq={hq} Hkv={hkv} S={TRAIN_S} D={d} "
          f"causal bf16: fused {entry['fused_ms']:.3f} ms, split {entry['split_ms']:.3f} ms "
          f"(cuda_time_ms, device time) -> {winner}; cache {autotune.cache_path()}")
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    kernels = {"fused": ("flash_bwd_fused",), "split": ("flash_bwd_dq", "flash_bwd_dkv")}
    for env, impl in ((None, winner), (loser, loser)):
        reset_launches()
        with profile_train.backward_impl(env) if env else contextlib.nullcontext():
            flash_bwd.flash_attention_backward(q, k, v, o, q, lse, True, impl="auto")
        got = {k: n for k, n in read_launches().items() if n}
        check(got == {name: 1 for name in kernels[impl]},
              f"[autotune] impl='auto' with {flash_bwd.IMPL_ENV}={env}: launched {got}")
        print(f"[autotune] impl='auto' with {flash_bwd.IMPL_ENV}={env}: launched {got}")
    del q, k, v, o, lse

    # (b) GEMMA2_9B cut to PACK_LAYERS layers on phase 12's packed row.
    cfg = dataclasses.replace(GEMMA2_9B, num_layers=PACK_LAYERS)
    model = init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED)
    docs = [rng.integers(1, cfg.vocab_size, n_tok).tolist() for n_tok in PACK_DOCS]
    batch = next(data.PackedDataset(docs, batch_size=1, seq_len=PACK_S, seed=SEED).batches())
    print(f"[remat-gemma] GEMMA2_9B cut to {PACK_LAYERS} layers, packed row: "
          f"{check_packed_row(batch['tokens'], batch['segment_ids'], cfg)}")
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    segs = torch.from_numpy(batch["segment_ids"]).cuda()
    local = sum(llama.layer_window(cfg, i) is not None for i in range(PACK_LAYERS))

    def gemma_extra(remat, impl):
        fwd = REMAT_K1[remat]
        out = {"flash_fwd_window": fwd * local, "flash_fwd_segments": fwd * PACK_LAYERS,
               "flash_fwd_softcap": fwd * PACK_LAYERS}
        for kern in kernels[impl]:
            out.update({f"{kern}_window": local, f"{kern}_segments": PACK_LAYERS,
                        f"{kern}_softcap": PACK_LAYERS})
        return out

    # The split backward alone: bit for bit. Without remat this row peaks at
    # 69 GiB (split) and 72 GiB (fused); the fused gates run in (a) and (c).
    got, held = remat_gates(model, tokens, "[remat-gemma]", ("attn", True), segs, gemma_extra,
                            impls=("split",))
    add_launches(total, got)
    saved_none = held[False] - held["attn"]  # bytes a layer that "attn" recomputes
    print(f"[remat-gemma] without remat a layer holds {held[False] / 1e6:.1f} MB at S={PACK_S}; "
          f"'attn' {held['attn'] / 1e6:.1f} MB, True {held[True] / 1e6:.1f} MB")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) GEMMA2_9B at full depth.
    cfg = GEMMA2_9B
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[remat-gemma-42] GEMMA2_9B, {cfg.num_layers} layers: {n_params / 1e9:.3f} B random "
          f"bf16 parameters in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA_FULL_S + 1), generator=gen,
                           device="cuda")
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for step in range(GEMMA_FULL_STEPS):
        t0 = time.perf_counter()
        loss = llama.sgd_train_step(model, tokens, GEMMA_FULL_LR, remat="attn")[0]
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[remat-gemma-42] step {step + 1}: loss {losses[-1]:.6f}, {walls[-1]:.1f} ms "
              f"(host clock, synchronised), {GEMMA_FULL_S / walls[-1] * 1e3:.0f} tokens/s")
    peak = torch.cuda.max_memory_allocated()
    got = {k: n for k, n in read_launches().items() if n}
    layers, local = cfg.num_layers, (cfg.num_layers + 1) // 2
    want = {"flash_fwd": layers, "flash_fwd_window": local, "flash_fwd_softcap": layers,
            "flash_bwd_fused": layers, "flash_bwd_fused_window": local,
            "flash_bwd_fused_softcap": layers}
    want = {k: GEMMA_FULL_STEPS * n for k, n in want.items()}
    check(got == want, f"[remat-gemma-42] launched {got}, want {want}")
    add_launches(total, got)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"[remat-gemma-42] losses {losses}")
    ms = statistics.median(walls[1:])
    # Without remat each layer would also hold what "attn" recomputes:
    # (b)'s difference per layer, scaled from S 8192 to S 4096 (linear in
    # the tokens: the flash kernels keep no [S, S] tensor).
    reckoned = peak + layers * saved_none * GEMMA_FULL_S / PACK_S
    print(f"[remat-gemma-42] GEMMA2_9B {layers} layers B=1 S={GEMMA_FULL_S} sgd_train_step "
          f"remat='attn' (lr {GEMMA_FULL_LR}), fused backward: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {ms:.1f} ms/step (median of steps 2-{GEMMA_FULL_STEPS}), "
          f"{GEMMA_FULL_S / ms * 1e3:.0f} tokens/s, peak {peak / 2**30:.2f} GiB; without remat "
          f"reckoned {reckoned / 2**30:.1f} GiB ({layers} x {saved_none / 1e6:.0f} MB x "
          f"{GEMMA_FULL_S}/{PACK_S} more), past the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB: not run")
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return total


# Phase 14: QWEN3_8B and LLAMA31_8B at full width, their depth cut to
# FAMILY_QWEN_LAYERS and FAMILY_LLAMA31_LAYERS to keep the run inside its
# time limit, each freed before the next. Random weights under the Hugging Face names and layouts
# (Qwen3's q_norm/k_norm, [out, in] projections) are written as a sharded
# safetensors checkpoint directory with its config.json, as save_pretrained
# lays one out, and read back on the card by models/convert.py::load_hf_dir
# (the repo's own reader; no transformers, no safetensors), every tensor
# bit-equal to params_from_hf's conversion of the same weights. Each: a
# FAMILY_PROMPT-token prefill and 4 teacher-forced decode steps through the
# kernels against the plain route under phase 3's logits rule, then the
# bf16 server and the int8-KV paged server on phase 9's traffic (max_len
# 8192). LLAMA31_8B also serves one LONG_PROMPT-token prompt (twice its
# 8,192-token original context: the llama3 remap is why users serve it)
# with admit_chunk LONG_CHUNK, its last prompt position's logits from the
# chunks (K2) held against prefill's (K1).
FAMILY_PROMPT = 2000
FAMILY_MAX_LEN = 8192
LONG_PROMPT = 16384
LONG_CHUNK = 512
LONG_NEW = 32


def hf_state_dict(cfg, gen: torch.Generator, device="cuda") -> dict[str, torch.Tensor]:
    """Random weights of `cfg` under the Hugging Face Llama/Qwen names and
    layouts (projections [out, in]; q_norm/k_norm with cfg.qk_norm, q/k/v
    biases with cfg.attn_bias, lm_head unless tied; with cfg.num_experts the
    Qwen MoE families' router mlp.gate and one entry an expert and
    projection, mlp.experts.j.{gate,up,down}_proj, and with
    cfg.moe_shared_intermediate Qwen2-MoE's mlp.shared_expert.* and
    mlp.shared_expert_gate), drawn from `gen` in cfg.dtype as init_params
    draws: normal, scaled by fan-in**-0.5; norms at 1, biases 0.02 x
    normal."""
    h, d, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    nq, nkv = cfg.num_heads * d, cfg.num_kv_heads * d

    def dense(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=gen, dtype=cfg.dtype, device=device)
        return w.mul_(in_f**-0.5)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    sd = {"model.embed_tokens.weight": dense(cfg.vocab_size, h), "model.norm.weight": ones(h)}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = dense(cfg.vocab_size, h)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(h),
                   p + "post_attention_layernorm.weight": ones(h),
                   p + "self_attn.q_proj.weight": dense(nq, h),
                   p + "self_attn.k_proj.weight": dense(nkv, h),
                   p + "self_attn.v_proj.weight": dense(nkv, h),
                   p + "self_attn.o_proj.weight": dense(h, nq)})
        if cfg.num_experts:
            sd[p + "mlp.gate.weight"] = dense(cfg.num_experts, h)
            for j in range(cfg.num_experts):
                sd.update({p + f"mlp.experts.{j}.gate_proj.weight": dense(f, h),
                           p + f"mlp.experts.{j}.up_proj.weight": dense(f, h),
                           p + f"mlp.experts.{j}.down_proj.weight": dense(h, f)})
            if cfg.moe_shared_intermediate:
                fs = cfg.moe_shared_intermediate
                sd.update({p + "mlp.shared_expert.gate_proj.weight": dense(fs, h),
                           p + "mlp.shared_expert.up_proj.weight": dense(fs, h),
                           p + "mlp.shared_expert.down_proj.weight": dense(h, fs),
                           p + "mlp.shared_expert_gate.weight": dense(1, h)})
        else:
            sd.update({p + "mlp.gate_proj.weight": dense(f, h),
                       p + "mlp.up_proj.weight": dense(f, h),
                       p + "mlp.down_proj.weight": dense(h, f)})
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = ones(d)
            sd[p + "self_attn.k_norm.weight"] = ones(d)
        if cfg.attn_bias:
            for name, n in (("q", nq), ("k", nkv), ("v", nkv)):
                sd[p + f"self_attn.{name}_proj.bias"] = torch.randn(
                    n, generator=gen, dtype=cfg.dtype, device=device).mul_(0.02)
    return sd


ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
SHARD_BYTES = 5 * 10**9  # save_pretrained's default max_shard_size, "5GB"


def hf_config(cfg) -> dict:
    """The config.json of `cfg` as transformers writes it for a Qwen3
    (cfg.qk_norm) or Llama checkpoint, or with cfg.num_experts a Qwen3-MoE
    (cfg.qk_norm) or Qwen2-MoE one (its expert width, which the port keeps
    in intermediate_size, as moe_intermediate_size)."""
    out = dict(model_type="qwen3" if cfg.qk_norm else "llama", vocab_size=cfg.vocab_size,
               hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
               num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
               num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
               rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
               max_position_embeddings=cfg.max_seq_len,
               tie_word_embeddings=cfg.tie_embeddings, attention_bias=cfg.attn_bias,
               torch_dtype=str(cfg.dtype).removeprefix("torch."))
    if cfg.rope_scaling is not None:
        factor, low, high, orig = cfg.rope_scaling
        out["rope_scaling"] = dict(rope_type="llama3", factor=factor, low_freq_factor=low,
                                   high_freq_factor=high, original_max_position_embeddings=orig)
    if cfg.num_experts:
        out.update(model_type="qwen3_moe" if cfg.qk_norm else "qwen2_moe",
                   num_experts=cfg.num_experts, num_experts_per_tok=cfg.top_k_experts,
                   norm_topk_prob=cfg.moe_norm_topk, moe_intermediate_size=cfg.intermediate_size,
                   decoder_sparse_step=1, mlp_only_layers=[])
        if cfg.moe_shared_intermediate:
            out["shared_expert_intermediate_size"] = cfg.moe_shared_intermediate
    return out


def write_hf_checkpoint(path, sd: dict[str, torch.Tensor], cfg,
                        shard_bytes: int = SHARD_BYTES) -> int:
    """`sd` and `cfg` as a Hugging Face checkpoint directory at `path`:
    shards model-0000i-of-0000n.safetensors of at most shard_bytes each (an
    8-byte little-endian header length, a JSON header padded to 8 bytes,
    the raw bytes), model.safetensors.index.json and config.json. Tensors
    go to the host one at a time. Returns the bytes of the weights."""
    path = Path(path)
    shards: list[list[str]] = [[]]
    size = 0
    for name, t in sd.items():
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    weight_map, total = {}, 0
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        header, offset = {}, 0
        for name in names:
            t = sd[name]
            n = t.numel() * t.element_size()
            header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                            "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[name] = fname
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        with open(path / fname, "wb") as f:
            f.write(struct.pack("<Q", len(head)) + head)
            for name in names:
                f.write(sd[name].detach().contiguous().view(torch.uint8).cpu().numpy().data)
        total += offset
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps(hf_config(cfg)))
    return total


def load_from_hf_dir(cfg, name: str, gen: torch.Generator, log: str):
    """`cfg`'s model from random HF-named weights: written as a checkpoint
    directory (write_hf_checkpoint) in a temporary directory, converted by
    params_from_hf for the comparison, the HF copy freed, then read by
    load_hf_dir onto the card, timed, its config and every tensor held
    equal to the conversion's. The read is from the page cache (the files
    were just written)."""
    gc.collect()
    torch.cuda.empty_cache()
    hf = hf_state_dict(cfg, gen)
    with tempfile.TemporaryDirectory(prefix="hf_checkpoint_") as ckpt:
        need = sum(t.numel() * t.element_size() for t in hf.values())
        free = shutil.disk_usage(ckpt).free
        check(free > need * 1.05, f"{name}: {free / 1e9:.1f} GB free for a "
              f"{need / 1e9:.1f} GB checkpoint")
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(ckpt, hf, cfg)
        write_s = time.perf_counter() - t0
        want = convert.params_from_hf(hf, cfg)
        del hf
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model, loaded = convert.load_hf_dir(ckpt, cfg.dtype, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - base
        shards = len(list(Path(ckpt).glob("*.safetensors")))
    check(loaded == cfg, f"{name}: load_hf_dir read the config {loaded}")
    got = model.state_dict()
    check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
          f"{name}: load_hf_dir's tensors differ from params_from_hf's")
    del want, got
    n = sum(p.numel() for p in model.parameters())
    features = ", ".join(f for f, on in (
        ("q/k RMSNorm", cfg.qk_norm), (f"llama3 RoPE {cfg.rope_scaling}", cfg.rope_scaling),
        ("q/k/v biases", cfg.attn_bias),
        (f"{cfg.num_experts} experts of width {cfg.intermediate_size}, top "
         f"{cfg.top_k_experts}", cfg.num_experts),
        (f"a shared expert of width {cfg.moe_shared_intermediate}",
         cfg.moe_shared_intermediate)) if on)
    print(f"{log} {name}: {cfg.num_layers} layers, hidden {cfg.hidden_size}, GQA "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{features}; {n / 1e9:.3f} B random bf16 parameters under the Hugging Face names, "
          f"written as {shards} safetensors shards ({nbytes / 1e9:.2f} GB) in {write_s:.2f} s, "
          f"read by load_hf_dir onto the card in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} "
          f"GB/s, page cache), equal to params_from_hf's tensors; load peak "
          f"{load_peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after")
    return model


def family_model_run(cfg, name: str, gen: torch.Generator) -> tuple[dict[str, int], dict]:
    """Phase 14 for one preset (the comment above). Returns the launches of
    its server runs (and of the long prompt's) and, for LLAMA31_8B, the
    kernels line's row of K1 at the long prompt."""
    log = f"[{name.lower()}]"
    layers = cfg.num_layers
    model = load_from_hf_dir(cfg, name, gen, log)
    prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kern = generation_run(model, prompt, forced, max_len=FAMILY_MAX_LEN)
    run_s = time.perf_counter() - t0
    added = {k: v for k, v in read_launches().items() if v}
    want = {"flash_fwd": layers, "decode": 4 * layers}
    check(added == want, f"{name} kernel run launched {added}, want {want}")
    print(f"{log} kernel run (prefill S={FAMILY_PROMPT} and 4 decode steps) in {run_s:.3f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {added}")
    with plain_kernels():
        plain = generation_run(model, prompt, forced, max_len=FAMILY_MAX_LEN)
    check({k: v for k, v in read_launches().items() if v} == want,
          f"{name} plain run launched a kernel")
    compare_logits("bf16", kern, plain,
                   [f"prefill S={FAMILY_PROMPT}"] + [f"decode {i}" for i in range(1, 5)],
                   model=name)
    del kern, plain

    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in MISTRAL_SERVED]
    bf16 = long_prompt_server(model, f"bf16 server, 2 slots, max_len {FAMILY_MAX_LEN}", prompts,
                              None, log=log, max_len=FAMILY_MAX_LEN)
    prefix = prompts[0][:MISTRAL_PREFIX]
    served = [p if uid % 2 == 0 else prefix + p[MISTRAL_PREFIX:]
              for uid, p in enumerate(prompts)]
    paged_run = long_prompt_server(
        model, f"int8-KV paged server (pages of {PAGE}, admit_chunk 256, a "
        f"{MISTRAL_PREFIX}-token prefix before requests 0, 1 and 3)", served, prefix,
        log=log, max_len=FAMILY_MAX_LEN, quant="int8", paged=True, page_size=PAGE,
        admit_chunk=256)
    check(bf16["flash_fwd"] > 0 and bf16["decode"] > 0 and paged_run["paged_decode"] > 0,
          f"a kernel missed the {name} servers: bf16 {bf16}, paged {paged_run}")
    total = {k: bf16[k] + paged_run[k] for k in ("flash_fwd", "decode", "paged_decode")}
    row = None
    if cfg.rope_scaling is not None:
        long_launches, row = long_prompt_admission(model, name, gen, log)
        for k, n in long_launches.items():
            total[k] = total.get(k, 0) + n
    print(f"{log} launches of the server runs: {total}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total, row


def long_prompt_admission(model, name: str, gen: torch.Generator, log: str
                          ) -> tuple[dict[str, int], dict]:
    """LLAMA31_8B on one LONG_PROMPT-token prompt: prefill (K1) and the same
    prompt in LONG_CHUNK-token chunks through chunk_step (K2 at T
    LONG_CHUNK, what chunked admission runs), their last-position logits
    under phase 3's rule; then the server (1 slot, admit_chunk LONG_CHUNK,
    LONG_NEW new tokens, logprobs), its first token's log-probability
    against the chunks' logits. Returns the launches of the three runs and
    the kernels line's row of K1 at this prompt (k1_long_prompt), its
    launches those the counter took in the prefill."""
    cfg = model.cfg
    layers = cfg.num_layers
    max_len = LONG_PROMPT + LONG_CHUNK
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT), generator=gen, device="cuda")
    total: dict[str, int] = {}

    def timed(fn):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in read_launches().items() if v}
        add_launches(total, got)
        return out, (time.perf_counter() - t0) * 1e3, got

    ref, prefill_ms, k1_launches = timed(lambda: generate.prefill(
        model, prompt, generate.init_caches(model, 1, max_len))[0])
    check(k1_launches == {"flash_fwd": layers}, f"{name} long prefill launched {k1_launches}")
    (got, caches), chunk_ms, k2_launches = timed(lambda: generate.chunked_prefill(
        model, prompt, generate.init_caches(model, 1, max_len), chunk=LONG_CHUNK))
    n_chunks = LONG_PROMPT // LONG_CHUNK
    check(k2_launches == {"decode": layers * n_chunks},
          f"{name} chunked prefill launched {k2_launches}")
    kv_gib = sum(c.k.nbytes + c.v.nbytes for c in caches) / 2**30
    del caches
    print(f"{log} {LONG_PROMPT}-token prompt ({LONG_PROMPT // 8192}x the llama3 original "
          f"context {cfg.rope_scaling[3]}): prefill (K1) {prefill_ms:.1f} ms, the same prompt "
          f"in {n_chunks} chunks of {LONG_CHUNK} through chunk_step (K2 at T={LONG_CHUNK}) "
          f"{chunk_ms:.1f} ms (host clock, synchronised; first calls at these shapes); KV "
          f"cache {kv_gib:.2f} GiB (max_len {max_len})")
    compare_logits(f"{LONG_PROMPT}-token prompt, chunks (K2) vs prefill (K1)", [got], [ref],
                   ["last prompt position"], model=name)
    srv = InferenceServer(model, max_slots=1, max_len=max_len, admit_chunk=LONG_CHUNK,
                          return_logprobs=True)
    srv.warmup()
    srv.submit(Request(uid=0, prompt=prompt[0].tolist(), max_new_tokens=LONG_NEW))
    torch.cuda.reset_peak_memory_stats()
    out, wall_ms, srv_launches = timed(srv.run)
    st = srv.stats()
    toks, lps = out[0], srv.finished_logprobs[0]
    check(len(toks) == LONG_NEW and all(0 <= x < cfg.vocab_size for x in toks),
          f"{name} long request: {len(toks)} tokens")
    want_lp = float(torch.log_softmax(got[0].float(), -1)[toks[0]])
    lim = 2 * LOGIT_REL * float(got.abs().max())
    print(f"{log} server, 1 slot, admit_chunk {LONG_CHUNK}: {LONG_PROMPT}-token prompt and "
          f"{LONG_NEW} new tokens in {wall_ms / 1e3:.3f} s; admission {st['prefill_ms_avg']} ms "
          f"(chunks summed, host clock), decode {st['decode_ms_avg']} ms/step "
          f"({LONG_NEW - 1} steps), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"first token {toks[0]}, log-probability {lps[0]:.4f} against the chunked prefill's "
          f"{want_lp:.4f} (|d| <= {lim:.4f}); launches {srv_launches}")
    check(abs(lps[0] - want_lp) <= lim, f"{name} long request's first log-probability")
    check(srv_launches.get("decode", 0) >= layers * n_chunks, f"{name} server {srv_launches}")
    del srv, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    row = k1_long_prompt(cfg, gen, log)
    row["launches"] = k1_launches["flash_fwd"]  # the long prompt's prefill, counted
    return total, row


def k1_long_prompt(cfg, gen: torch.Generator, log: str) -> dict:
    """K1 at the long prompt's attention (B 1, Hq 32, Hkv 8, S 16384,
    D 128, causal, no LSE: as prefill calls it) against its plain version
    computed in 1024-row slices of q (each slice's rows at their global
    positions, pos_offset), the whole output compared; kernel, plain (the
    slices' sum), bound and SDPA's causal forward timed. The kernels line's
    row."""
    b, hq, hkv, s, d = 1, cfg.num_heads, cfg.num_kv_heads, LONG_PROMPT, cfg.head_dim
    q, k, v = (randn((b, n, s, d), gen) for n in (hq, hkv, hkv))
    o, _ = flash_fwd.flash_attention_forward(q, k, v, True, need_lse=False)
    rows = 1024

    def plain():
        return torch.cat([flash_fwd.flash_attention_forward_reference(
            q[:, :, r:r + rows], k, v, True, need_lse=False, pos_offset=r)[0]
            for r in range(0, s, rows)], dim=2)

    tag = f"K1 {cfg.num_layers}-layer model's {s}-token prompt B={b} Hq={hq} Hkv={hkv} D={d}"
    err = _gate(tag + " O (plain in 1024-row slices)", plain(), o, O_ATOL)
    del o
    ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, True, need_lse=False),
                      warmup=1, iters=3, reps=3)
    plain_ms = event_time_ms(plain, warmup=1, iters=1)
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True),
                       warmup=1, iters=3, reps=3)
    report = roofline.attention_fwd_roofline(b, hq, hkv, s, s, d, True, need_lse=False)
    lim = bound(report)
    print(f"{log} {tag} causal without LSE: kernel {ms:.4f} ms "
          f"({report.flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), bound {lim['bound_ms']:.5f} ms "
          f"by {lim['bound_by']}, plain (1024-row slices) {plain_ms:.3f} ms, SDPA causal "
          f"forward {lib:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib, **lim)


FAMILY_QWEN_LAYERS = 12  # of 36
FAMILY_LLAMA31_LAYERS = 16  # of 32


def phase_families(gen: torch.Generator) -> tuple[dict[str, int], dict]:
    """Phase 14: QWEN3_8B, then LLAMA31_8B (family_model_run). Returns the
    launches of both and the kernels line's row of K1 at LLAMA31_8B's long
    prompt."""
    total: dict[str, int] = {}
    print(f"[qwen3_8b] QWEN3_8B's depth cut to {FAMILY_QWEN_LAYERS} of "
          f"{QWEN3_8B.num_layers} layers (the run's time limit)")
    qwen, _ = family_model_run(dataclasses.replace(QWEN3_8B, num_layers=FAMILY_QWEN_LAYERS),
                               "QWEN3_8B", gen)
    add_launches(total, qwen)
    print(f"[llama31_8b] LLAMA31_8B's depth cut to {FAMILY_LLAMA31_LAYERS} of "
          f"{LLAMA31_8B.num_layers} layers (the run's time limit)")
    llama31, row = family_model_run(
        dataclasses.replace(LLAMA31_8B, num_layers=FAMILY_LLAMA31_LAYERS), "LLAMA31_8B", gen)
    add_launches(total, llama31)
    return total, row


# Phase 15: speculative decoding (models/speculate.py), target LLAMA_1B,
# drafts LLAMA_1B itself (it accepts everything: the full-accept rollback
# and re-ingest) and LLAMA_150M (the JAX package's pairing,
# benchmarks/speculate_bench.py); k SPEC_K, a SPEC_PROMPT-token prompt,
# SPEC_NEW new tokens, greedy, dense and paged (pages of SPEC_PAGE): the
# target verifies each round in one chunk_step, K2 at T = SPEC_K + 1. In
# float32 the verification's logits and the decode step's differ by
# rounding only far below the gaps between logits, so the tokens must equal
# generate's and the self-draft accept every draft. In bf16 (the preset)
# the two paths round differently (cuBLAS at M 1 against M 5, K2's splits
# at T 1 against T 5): where the tokens leave generate's, generate's own
# logits, teacher-forced on the speculative tokens, must give every
# speculative token, there and at every later position, or hold it within
# TIE_ULPS bf16 steps of their largest logit: a tie at bf16's rounding.
TIE_ULPS = 4
SPEC_K = 4
SPEC_PROMPT = 128
SPEC_NEW = 32  # cut from 64 to keep the run inside its time limit
SPEC_PAGE = 128


@contextlib.contextmanager
def step_census():
    """Counts the generate.decode_step and generate.chunk_step calls made
    while active, by (the model's layer count, T): the K2 launches they make
    are one a layer a call."""
    calls: dict[tuple[int, int], int] = {}
    saved = generate.decode_step, generate.chunk_step

    def decode_step(model, token, *args, **kw):
        calls[model.cfg.num_layers, 1] = calls.get((model.cfg.num_layers, 1), 0) + 1
        return saved[0](model, token, *args, **kw)

    def chunk_step(model, piece, *args, **kw):
        key = (model.cfg.num_layers, piece.shape[1])
        calls[key] = calls.get(key, 0) + 1
        return saved[1](model, piece, *args, **kw)

    generate.decode_step, generate.chunk_step = decode_step, chunk_step
    try:
        yield calls
    finally:
        generate.decode_step, generate.chunk_step = saved


def bf16_steps(a: float, b: float) -> float:
    """|a - b| in bf16 steps at a's magnitude (8 significant bits)."""
    return abs(a - b) / 2.0 ** (math.floor(math.log2(abs(a))) - 7)


def bf16_ties(model, prompt: torch.Tensor, got: torch.Tensor) -> str:
    """generate's prefill and decode steps teacher-forced on the speculative
    tokens got [1, n]: at each position the speculative token must be
    generate's argmax or lie within TIE_ULPS bf16 steps (of the largest
    logit) below it. Returns the finding."""
    n = got.shape[1]
    caches = generate.init_caches(model, 1, round_up(prompt.shape[1] + SPEC_NEW, 128))
    logits, caches = generate.prefill(model, prompt, caches)
    ties = []
    for i in range(n):
        row = logits[0].float()
        a, b = int(row.argmax()), int(got[0, i])
        if a != b:
            top = float(row[a])
            ulps = bf16_steps(top, float(row[b]))
            check(ulps <= TIE_ULPS,
                  f"[speculate] bf16 token {b} at {i} against generate's {a} after the same "
                  f"tokens: logits {top:.4f} and {float(row[b]):.4f}, {ulps:.1f} bf16 steps "
                  f"apart (> {TIE_ULPS})")
            ties.append(f"{i}: {ulps:.0f}")
        if i + 1 < n:
            pos = torch.tensor([prompt.shape[1] + i], dtype=torch.int32, device="cuda")
            logits, caches = generate.decode_step(model, got[:, i].int(), pos, caches)
    return (f"generate teacher-forced on these tokens gives each but {len(ties)}, each a tie "
            f"within {TIE_ULPS} bf16 steps (position: steps {', '.join(ties)})")


def phase_speculate(gen: torch.Generator) -> tuple[dict[str, int], dict]:
    """Phase 15 (the comment above), in float32 and then in bf16: each
    draft, dense and paged, its tokens against generate.generate's, its
    acceptance and tokens/s against generate's, its K1 and K2 launches those
    its model calls make (step_census); then a sampled bf16 run twice from
    one generator seed gives one output. Returns the launches of the runs
    and the kernels line's row of K2 at T = SPEC_K + 1 (verify_k2). That
    row's launches are those of the dense bf16 runs at T = SPEC_K + 1: the
    counter counts K2's launches at every T under "decode", and the census
    of calls by (layers, T), held equal to that count run by run, splits
    them by T."""
    total: dict[str, int] = {}
    at_t = 0
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(LLAMA_1B, dtype=dtype)
        name = f"LLAMA_1B {str(dtype).split('.')[-1]}"
        target = init_params(cfg, gen, device="cuda")
        drafts = {f"{name} (self-draft)": target,
                  f"LLAMA_150M {str(dtype).split('.')[-1]}": init_params(
                      dataclasses.replace(LLAMA_150M, dtype=dtype), gen, device="cuda")}
        prompt = torch.randint(0, cfg.vocab_size, (1, SPEC_PROMPT), generator=gen,
                               device="cuda")
        generate.generate(target, prompt, max_new_tokens=8)  # warm the path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = generate.generate(target, prompt, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        print(f"[speculate] target {name} generate.generate: {SPEC_NEW} tokens after a "
              f"{SPEC_PROMPT}-token prompt in {gen_s:.3f} s ({SPEC_NEW / gen_s:.1f} tokens/s, "
              f"eager decode steps, host clock)")
        for dname, draft in drafts.items():
            for paged_kv in (False, True):
                speculative_generate(target, draft, prompt, max_new_tokens=8, k=SPEC_K,
                                     paged=paged_kv, page_size=SPEC_PAGE)  # warm the path
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                with step_census() as calls:
                    got, rate = speculative_generate(target, draft, prompt,
                                                     max_new_tokens=SPEC_NEW, k=SPEC_K,
                                                     paged=paged_kv, page_size=SPEC_PAGE)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v for k, v in read_launches().items() if v}
                add_launches(total, launches)
                how = f"paged (pages of {SPEC_PAGE})" if paged_kv else "dense"
                kv = "paged_decode" if paged_kv else "decode"
                k2 = sum(layers * n for (layers, _), n in calls.items())
                check(launches == {"flash_fwd": cfg.num_layers + draft.cfg.num_layers, kv: k2},
                      f"[speculate] {dname} {how} launched {launches}, its calls {calls} make "
                      f"{k2} K2 launches")
                first = next((i for i, (a, b) in enumerate(zip(got[0].tolist(),
                                                               want[0].tolist())) if a != b),
                             None)
                if first is None:
                    finding = "tokens equal generate's"
                else:
                    check(dtype == torch.bfloat16, f"[speculate] {dname} {how}: tokens leave "
                          f"generate's at {first}")
                    finding = (f"tokens leave generate's at {first}; "
                               + bf16_ties(target, prompt, got))
                if draft is target and dtype == torch.float32:
                    check(rate == 1.0, f"[speculate] {dname} {how}: acceptance {rate}")
                if dtype == torch.bfloat16 and not paged_kv:
                    at_t += sum(layers * n for (layers, t), n in calls.items() if t == SPEC_K + 1)
                quality = ("; random weights: the rate says nothing of a trained pair"
                           if draft is not target else "")
                print(f"[speculate] draft {dname}, {how}, k {SPEC_K}: acceptance {rate:.4f}"
                      f"{quality}; {SPEC_NEW} tokens in {wall:.3f} s ({SPEC_NEW / wall:.1f} "
                      f"tokens/s against generate's {SPEC_NEW / gen_s:.1f}); {finding}; calls "
                      f"(layers, T): {dict(sorted(calls.items()))}; launches {launches}")
        if dtype == torch.bfloat16:
            sp = SamplingParams(temperature=0.8, top_k=50)
            runs = [speculative_generate(target, drafts["LLAMA_150M bfloat16"], prompt,
                                         max_new_tokens=SPEC_NEW, k=SPEC_K, sampling=sp,
                                         generator=torch.Generator(device="cuda").manual_seed(SEED))
                    for _ in range(2)]
            check(torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1],
                  "[speculate] two sampled runs from one seed differ")
            check(all(0 <= x < cfg.vocab_size for x in runs[0][0][0].tolist()),
                  "[speculate] sampled tokens out of range")
            print(f"[speculate] sampled ({sp}), {name}, draft LLAMA_150M, generator seed "
                  f"{SEED}: two runs give the same {SPEC_NEW} tokens, acceptance "
                  f"{runs[0][1]:.4f}")
        del drafts, target
        gc.collect()
        torch.cuda.empty_cache()
    row = verify_k2(gen)
    row["launches"] = at_t
    print(f"[speculate] K2 launches at T={SPEC_K + 1} in the dense bf16 runs (verifications "
          f"and full re-ingests): {at_t}")
    return total, row


def verify_k2(gen: torch.Generator) -> dict:
    """K2 bf16 at T = SPEC_K + 1 as the target verifies (LLAMA_1B: B 1, Hq 32,
    Hkv 4, D 64; the speculation's cache of max_len 256 holding 165 tokens,
    the 5 new ones included) against its plain version, then timed beside
    its bound and SDPA with a bottom-right causal mask. The kernels line's
    row."""
    cfg = LLAMA_1B
    t, s_max, n = SPEC_K + 1, 256, SPEC_PROMPT + 32 + SPEC_K + 1
    b, hq, hkv, d = 1, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = KVCache(k=randn((b, hkv, s_max, d), gen), v=randn((b, hkv, s_max, d), gen),
                    length=torch.tensor([n], dtype=torch.int32, device="cuda"))
    q = randn((b, hq, t, d), gen)
    o = decode.decode_attention_chunk(q, cache)
    tag = f"K2 bf16 T={t} B={b} Hq={hq} Hkv={hkv} D={d} Smax={s_max} length {n}"
    err = _gate(tag, decode.decode_attention_reference(q, cache), o, O_ATOL)
    ms = cuda_time_ms(lambda: decode.decode_attention_chunk(q, cache))
    plain = cuda_time_ms(lambda: decode.decode_attention_reference(q, cache))
    pos = torch.arange(s_max, device="cuda")
    row_pos = n - t + torch.arange(t, device="cuda")
    mask = (pos[None] <= row_pos[:, None])[None, None]  # [1, 1, T, Smax]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, cache.k, cache.v,
                                                              attn_mask=mask, enable_gqa=True))
    lim = bound(roofline.decode_roofline(b, hq, hkv, d, [n], t=t))
    print(f"[speculate] {tag} (the verification): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {lim['bound_ms']:.5f} ms by {lim['bound_by']}, SDPA with a bottom-right causal "
          f"mask {lib:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **lim)


# Phase 16: mixture-of-experts models, every layer's FFN the grouped
# dispatch (parallel/moe.py::moe_ffn_grouped; the masked-dense loop,
# moe_ffn_dense_reference, is the plain route). The configs are the public
# config.json files (Hugging Face Qwen/Qwen3-30B-A3B and
# Qwen/Qwen1.5-MoE-A2.7B, the fields the port reads) through
# config_from_hf, which takes the expert width from moe_intermediate_size.
# Qwen3-30B-A3B: 48 layers, GQA 32/4 (group 8) at D 128, q/k RMSNorm, 128
# experts of 768, top 8 renormalised; 30.5 B parameters, 61.1 GB in bf16,
# random weights from the seed. Qwen1.5-MoE-A2.7B: 24 layers, 16/16 heads
# (group 1) at D 128, q/k/v biases, 60 experts of 1408, top 4 with the
# full softmax's gates, a shared expert of 5632 behind a sigmoid gate; 14.3
# B parameters, written under the Hugging Face names as a sharded
# safetensors directory and read back by load_hf_dir.
QWEN3_30B_A3B_JSON = dict(
    model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32,
    num_key_value_heads=4, head_dim=128, num_experts=128, num_experts_per_tok=8,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    max_position_embeddings=40960, rope_theta=1000000.0, rms_norm_eps=1e-06,
    tie_word_embeddings=False, attention_bias=False, sliding_window=None,
    use_sliding_window=False, rope_scaling=None, torch_dtype="bfloat16")
QWEN15_MOE_JSON = dict(
    model_type="qwen2_moe", vocab_size=151936, hidden_size=2048, intermediate_size=5632,
    moe_intermediate_size=1408, shared_expert_intermediate_size=5632, num_hidden_layers=24,
    num_attention_heads=16, num_key_value_heads=16, num_experts=60, num_experts_per_tok=4,
    norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
    max_position_embeddings=8192, rope_theta=1000000.0, rms_norm_eps=1e-06,
    tie_word_embeddings=False, sliding_window=32768, use_sliding_window=False,
    torch_dtype="bfloat16")
MOE_F32_LAYERS = 4  # the float32 run of Qwen3-30B-A3B's widths (about 12 GB)
MOE_HF_LAYERS = 8  # Qwen1.5-MoE-A2.7B's loader round trip, cut from 24 for the time limit
MOE_LAYERS = 24  # Qwen3-30B-A3B, cut from 48 for the time limit
MOE_ADMIT_CHUNK = 512
MOE_COUNTERS = ("flash_fwd", "decode", "paged_decode")


@contextlib.contextmanager
def moe_calls():
    """Counts the calls of the MoE FFN's two routes (moe_ffn_grouped, the
    card's; moe_ffn_dense_reference, the masked-dense loop) made while
    active. A captured step's replays call neither: eager calls only."""
    calls = {"grouped": 0, "dense": 0}
    saved = moe.moe_ffn_grouped, moe.moe_ffn_dense_reference

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    moe.moe_ffn_grouped = counted("grouped", saved[0])
    moe.moe_ffn_dense_reference = counted("dense", saved[1])
    try:
        yield calls
    finally:
        moe.moe_ffn_grouped, moe.moe_ffn_dense_reference = saved


@contextlib.contextmanager
def router_log():
    """Records each router_gates call made while active, in order: its
    picks (sorted within each token) and its float32 logits [T, E]. A
    run's calls go layer by layer, call by call."""
    calls: list[tuple[torch.Tensor, torch.Tensor]] = []
    saved = moe.router_gates

    def gates(x, router_w, top_k, norm_topk=True):
        ids, g = saved(x, router_w, top_k, norm_topk)
        calls.append((torch.sort(ids, dim=-1).values, torch.matmul(x.float(), router_w.float())))
        return ids, g

    moe.router_gates = gates
    try:
        yield calls
    finally:
        moe.router_gates = saved


def routing_flips(kern: list, plain: list, layers: int) -> list[tuple[int, int, int, float]]:
    """(call, layer, token, margin) of every (token, layer) whose picks
    differ between two runs of one model, call for call: the margin is the
    plain run's k-th and (k+1)-th logits' distance in bf16 steps."""
    check(len(kern) == len(plain), f"{len(kern)} router calls against {len(plain)}")
    flips = []
    for c, ((k_ids, _), (p_ids, logits)) in enumerate(zip(kern, plain)):
        edge = torch.topk(logits, k_ids.shape[-1] + 1, dim=-1).values[:, -2:]
        for t in (k_ids != p_ids).any(-1).nonzero()[:, 0].tolist():
            flips.append((c, c % layers, t, bf16_steps(float(edge[t, 0]), float(edge[t, 1]))))
    return flips


# Float32 slack of the changed-pick rule (pick_margins): 8 float32 steps of
# the four logits' magnitudes, for the rounding of its differences.
PICK_SLACK = 8 * 2.0**-24


def pick_margins(a: torch.Tensor, r: torch.Tensor, forced: torch.Tensor,
                 own: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The changed-pick rule of one router call, on the device: the kernel
    run's router logits a [T, E] picked `forced` [T, k]; the plain run's r
    would have picked `own` [T, k]. For every pair of a pick e_f the plain
    route would not make and one e_p it would make instead, the kernel run
    ranked a_f >= a_p and the plain run r_p >= r_f, so
    r_p - r_f <= |a_p - r_p| + |a_f - r_f|: the margin the plain route
    gives up is covered by the two logits' rounding differences. Returns
    (the largest (r_p - r_f) / (|a_p - r_p| + |a_f - r_f| + slack) over the
    pairs, which the rule holds at 1; the number of pairs), 0-dim tensors;
    -inf and 0 where no pick changed. A route that mis-indexes picks or
    experts breaks it."""
    def side(ids, other):
        out = torch.zeros_like(r, dtype=torch.bool).scatter_(1, other, True)
        return r.gather(1, ids), (a - r).abs().gather(1, ids), a.gather(1, ids).abs(), \
            ~out.gather(1, ids)

    r_f, d_f, a_f, m_f = side(forced, own)  # forced picks the plain route would not make
    r_p, d_p, a_p, m_p = side(own, forced)  # its own picks the kernel run did not make
    pair = m_p[:, :, None] & m_f[:, None, :]
    slack = PICK_SLACK * (a_p[:, :, None] + r_p.abs()[:, :, None] + a_f[:, None, :]
                          + r_f.abs()[:, None, :])
    ratio = (r_p[:, :, None] - r_f[:, None, :]) / (d_p[:, :, None] + d_f[:, None, :] + slack)
    return torch.where(pair, ratio, float("-inf")).amax(), pair.sum()


@contextlib.contextmanager
def forced_routing(picks: list):
    """router_gates made to return, call by call, the picks another run
    recorded (router_log's), with gates from this run's own logits by the
    same formula; yields (ties, logits, margins): the ties are (call,
    token, margin) wherever this run's own top k differ from the forced
    picks, the margin the distance in bf16 steps from its own k-th logit
    down to the lowest forced one; the logits this run's routers computed,
    call by call; each call's pick_margins against the recorded run's
    router logits."""
    ties: list[tuple[int, int, float]] = []
    seen: list[torch.Tensor] = []
    margins: list[tuple[torch.Tensor, torch.Tensor]] = []
    saved = moe.router_gates
    calls = iter(enumerate(picks))

    def gates(x, router_w, top_k, norm_topk=True):
        c, (ids, kern_logits) = next(calls)
        logits = torch.matmul(x.float(), router_w.float())
        seen.append(logits)
        vals = logits.gather(-1, ids)
        g = (torch.softmax(vals, dim=-1) if norm_topk
             else torch.exp(vals - torch.logsumexp(logits, dim=-1, keepdim=True)))
        own = torch.topk(logits, top_k, dim=-1)
        margins.append(pick_margins(kern_logits, logits, ids, own.indices))
        kth, low = own.values[:, -1].detach(), vals.min(dim=-1).values.detach()
        moved = (torch.sort(own.indices, dim=-1).values != ids).any(-1)
        for t in moved.nonzero()[:, 0].tolist():
            ties.append((c, t, bf16_steps(float(kth[t]), float(low[t]))))
        return ids, g

    moe.router_gates = gates
    try:
        yield ties, seen, margins
    finally:
        moe.router_gates = saved


def moe_logits_gate(model, name: str, prompt, forced, log: str, bf16: bool) -> None:
    """A prefill of the prompt and teacher-forced decode steps through the
    kernels and the grouped dispatch against the plain route (attention's
    plain versions and the masked-dense loop) under phase 3's logits rule,
    the routing of both runs recorded and every (token, layer) whose picks
    differ printed with its margin.

    In bf16 the two routes round the hidden state differently, picks flip
    at near-ties, and a flipped token then differs by a whole expert, so
    the runs drift apart and flip more, at any margin: the free-running
    pair prints its flips and logits ungated. The gate is a second plain
    run with the routing teacher-forced to the kernel run's picks (as phase
    15 teacher-forces generate on the speculative tokens): its logits must
    pass the rule, and so must every layer's router logits over all its
    calls against the kernel run's; and every pick the plain route would
    have made otherwise must be explained by those router logits'
    differences, pair by pair (pick_margins: r_p - r_f <= |a_p - r_p| +
    |a_f - r_f| in logit units with float32 slack; the worst ratio of each
    layer prints). A bound in bf16 steps cannot be the gate: the same
    rounding makes more steps on larger logits, and the margins grow with
    depth (on Qwen3-30B-A3B: 1.25 steps at layer 0, 8.42 at layer 45, every
    layer's router logits within the rule). The count of changed picks within
    TIE_ULPS bf16 steps prints for information. In float32 (`bf16` False)
    the free-running plain run must pass the rule: no flip excuses a
    miss."""
    cfg = model.cfg
    layers = cfg.num_layers
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with moe_calls() as calls, router_log() as kern_route:
        kern = generation_run(model, prompt, forced, max_len=FAMILY_MAX_LEN)
    run_s = time.perf_counter() - t0
    added = {k: v for k, v in read_launches().items() if v}
    want = {"flash_fwd": layers, "decode": forced.shape[0] * layers}
    check(added == want, f"{name} kernel run launched {added}, want {want}")
    n_calls = (forced.shape[0] + 1) * layers
    check(calls == {"grouped": n_calls, "dense": 0},
          f"{name} kernel run's MoE calls {calls}, want {n_calls} grouped and no masked-dense")
    print(f"{log} kernel run (prefill S={prompt.shape[1]} and {forced.shape[0]} decode steps) "
          f"in {run_s:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {added}, MoE FFN calls {calls}")
    with plain_kernels(), router_log() as plain_route:
        plain = generation_run(model, prompt, forced, max_len=FAMILY_MAX_LEN)
    check({k: v for k, v in read_launches().items() if v} == want,
          f"{name} plain run launched a kernel")
    flips = routing_flips(kern_route, plain_route, layers)
    names = [f"prefill S={prompt.shape[1]}"] + [f"decode {i}" for i in range(1, len(kern))]
    tag = f"{str(cfg.dtype).removeprefix('torch.')}, {layers} layers"
    pairs = sum(int(ids.shape[0]) for ids, _ in kern_route)
    first = {}
    for c, layer, t, m in flips:
        first.setdefault(layer, (names[c // layers], t, m))
    print(f"{log} {name} {tag}, free-running routes: picks differ at {len(flips)} of {pairs} "
          f"(token, layer) pairs, in {len(first)} of {layers} layers; margins in bf16 steps "
          f"(plain route's k-th vs (k+1)-th logit) of each layer's first: "
          + ", ".join(f"layer {layer} {nm} token {t} {m:.2f}"
                      for layer, (nm, t, m) in sorted(first.items())[:12])
          + f"{' ...' if len(first) > 12 else ''}; largest of all "
          f"{max((m for *_, m in flips), default=0.0):.2f}")
    if not bf16:
        compare_logits(f"{tag}, free-running routes", kern, plain, names, model=name)
        del kern, plain
        return
    for a, r, nm in zip(kern, plain, names):
        logits_rule(f"{tag}, free-running routes (not gated)", a, r, nm, name)
    del plain
    with plain_kernels(), forced_routing(kern_route) as (ties, plain_logits, margins):
        plain = generation_run(model, prompt, forced, max_len=FAMILY_MAX_LEN)
    compare_logits(f"{tag}, plain route's routing forced to the kernel run's picks", kern, plain,
                   names, model=name)
    routers = []
    for layer in range(layers):
        a = torch.cat([kern_route[c][1] for c in range(layer, len(kern_route), layers)])
        r = torch.cat([plain_logits[c] for c in range(layer, len(plain_logits), layers)])
        routers.append((layer, *rule_numbers(a, r)))
    worst_cos = min(routers, key=lambda x: x[1])
    worst_rel = max(routers, key=lambda x: x[2] / x[3])
    print(f"{log} {name} {tag}, forced routing: every layer's router logits (all calls) "
          f"against the kernel run's under the logits rule: lowest cos {worst_cos[1]:.6f} (layer "
          f"{worst_cos[0]}), largest max|d| {worst_rel[2]:.4f} of its limit {worst_rel[3]:.4f} "
          f"(layer {worst_rel[0]})")
    for layer, cos, delta, lim in routers:
        check(cos > LOGIT_COS and delta <= lim, f"{name} {tag}: layer {layer}'s router logits "
              f"disagree with the kernel run's: cos {cos:.6f}, max|d| {delta:.4f} (<= {lim:.4f})")
    ratio = torch.stack([m for m, _ in margins]).tolist()
    counts = torch.stack([n for _, n in margins]).tolist()
    worst: dict[int, float] = {}
    for c, x in enumerate(ratio):
        worst[c % layers] = max(worst.get(c % layers, -math.inf), x)
    print(f"{log} {name} {tag}, forced routing: {sum(counts)} (forced pick, own pick) pairs "
          f"where the plain route would pick otherwise, each held to r_p - r_f <= |a_p - r_p| + "
          f"|a_f - r_f| + {PICK_SLACK * 2**24:g} float32 steps; worst ratio by layer (<= 1): "
          + ", ".join(f"{layer}: {x:.3f}" for layer, x in sorted(worst.items())
                      if x > -math.inf))
    bad = {layer: x for layer, x in worst.items() if x > 1.0}
    check(not bad, f"{name} {tag}: changed picks that the router logits' differences do not "
          f"explain (a forced route that mis-indexes picks or experts?), worst ratio by layer "
          f"{bad}")
    by_layer: dict[int, float] = {}
    for c, _, m in ties:
        by_layer[c % layers] = max(by_layer.get(c % layers, 0.0), m)
    near = sum(m <= TIE_ULPS for *_, m in ties)
    print(f"{log} {name} {tag}, forced routing, for information (not a gate): the plain "
          f"route's own top {cfg.top_k_experts} differ from the kernel run's picks at "
          f"{len(ties)} of {pairs} (token, layer) pairs, {near} of them within {TIE_ULPS} bf16 "
          f"steps; largest margin (bf16 steps from its k-th logit down to the lowest forced "
          f"one) by layer: "
          + ", ".join(f"{layer}: {m:.2f}" for layer, m in sorted(by_layer.items())))
    del kern, plain, plain_logits


def moe_module_gate(model, prompt, log: str) -> None:
    """moe_ffn_grouped against the masked-dense loop on layer 0's MLP input
    for the prompt (the embedding through layer 0's attention and
    mlp_norm), at T 2 (a decode step's two slots) and the whole prompt:
    bf16 verify_results at O_ATOL, the same router ids on both sides; each
    route timed by CUDA graph beside its bound (utils/roofline.py's
    moe_roofline over the experts the routing touches) and the bytes every
    expert holds (what the masked-dense loop reads)."""
    cfg = model.cfg
    layer = model.layers[0]
    params = layer.moe.routed()
    args = (cfg.top_k_experts, cfg.mlp_activation, cfg.moe_norm_topk)
    with torch.inference_mode():
        x = llama.embed_tokens(model, prompt)
        cos, sin = llama.input_tables(cfg, prompt)
        x = x + llama._attn_block(layer, x, cos, sin, cfg)
        xn = llama.rms_norm(x, layer.mlp_norm, cfg.norm_eps, cfg.norm_offset)[0]
    for t in (2, xn.shape[0]):
        xt = xn[:t].contiguous()
        with torch.inference_mode():
            got = moe.moe_ffn_grouped(xt, params, *args)
            want = moe.moe_ffn_dense_reference(xt, params, *args)
            ids, _ = moe.router_gates(xt, params["router"], cfg.top_k_experts, cfg.moe_norm_topk)
            ms = cuda_time_ms(lambda: moe.moe_ffn_grouped(xt, params, *args))
            plain_ms = cuda_time_ms(lambda: moe.moe_ffn_dense_reference(xt, params, *args),
                                    warmup=1, iters=3, reps=3)
        rep = verify_results(want, got, atol=O_ATOL)
        touched = int(torch.unique(ids).numel())
        lim = roofline.moe_roofline(t, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                                    cfg.top_k_experts, touched)
        every = 3 * cfg.num_experts * cfg.hidden_size * cfg.intermediate_size * 2
        print(f"{log} MoE FFN, layer 0, T={t} ({cfg.num_experts} experts of "
              f"{cfg.intermediate_size}, top {cfg.top_k_experts}, {touched} experts touched): "
              f"grouped dispatch against the masked-dense loop {rep} (atol={O_ATOL}, rtol=0.01, "
              f"cos>0.999), bitwise {'equal' if torch.equal(got, want) else 'different'}; "
              f"grouped {ms:.4f} ms, masked-dense {plain_ms:.4f} ms, bound {lim.bound_ms:.4f} ms "
              f"by {lim.bound_by} ({lim.hbm_bytes / 1e9:.3f} GB, {lim.flops / 1e12:.4f} "
              f"TFLOP; every expert {every / 1e9:.2f} GB)")
        check(rep.passed, f"MoE FFN T={t}: the grouped dispatch disagrees with the "
              f"masked-dense loop: {rep}")


def sync_gate(model, gen: torch.Generator, log: str, around=contextlib.nullcontext):
    """One eager decode_step (2 slots) and one chunk_step (2 x 512 tokens)
    under torch.cuda.set_sync_debug_mode("error"): any operation that waits
    on the card from the host raises. `around` wraps the two calls (a
    recorder); returns what it yields."""
    cfg = model.cfg
    b, n = 2, 300
    caches = generate.init_caches(model, b, 2048)
    prompt = torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device="cuda")
    _, caches = generate.prefill(model, prompt, caches)
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos = torch.full((b,), n, dtype=torch.int32, device="cuda")
    piece = torch.randint(0, cfg.vocab_size, (b, MOE_ADMIT_CHUNK), generator=gen, device="cuda")
    positions = torch.arange(n + 1, n + 1 + MOE_ADMIT_CHUNK, device="cuda")
    generate.decode_step(model, token, pos, clone_caches(caches))  # loads every library
    generate.chunk_step(model, piece, positions, clone_caches(caches))
    torch.cuda.synchronize()
    with around() as recorded:
        torch.cuda.set_sync_debug_mode("error")
        try:
            generate.decode_step(model, token, pos, caches)
            generate.chunk_step(model, piece, positions, caches)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{log} set_sync_debug_mode('error') around an eager decode_step (B={b}) and a "
          f"chunk_step (B={b}, {MOE_ADMIT_CHUNK} tokens): no operation synchronised with the "
          f"host")
    del caches
    return recorded


def moe_sync_gate(model, gen: torch.Generator, log: str) -> float:
    """sync_gate on a MoE model, its routing recorded. Returns the bytes of
    weights that decode step reads: all but the experts', and the experts
    its routing touched in each layer."""
    cfg = model.cfg
    route = sync_gate(model, gen, log, around=router_log)
    touched = sum(int(torch.unique(ids).numel()) for ids, _ in route[:cfg.num_layers])
    expert = 3 * cfg.hidden_size * cfg.intermediate_size * 2
    others = sum(p.numel() * p.element_size() for name, p in model.named_parameters()
                 if not re.search(r"\.moe\.w_(gate|up|down)$", name))
    others -= model.embed.numel() * model.embed.element_size()  # two rows read, not the table
    print(f"{log} the decode step's routing touched {touched} experts over "
          f"{cfg.num_layers} layers ({touched / cfg.num_layers:.1f} a layer), its weights' "
          f"read {(others + touched * expert) / 1e9:.2f} GB ({others / 1e9:.2f} GB besides the "
          f"experts)")
    return others + touched * expert


def servers(model, name: str, gen: torch.Generator, log: str, step_bytes: float,
            bf16_paged: bool, counters=MOE_COUNTERS) -> dict[str, dict[str, int]]:
    """Phase 9's traffic (4 requests of 4,200-6,000 prompt tokens, 32 new,
    2 slots, max_len 8192) on the bf16 server and the int8-KV paged server
    (pages of 256, admit_chunk MOE_ADMIT_CHUNK, a 1,024-token prefix before
    requests 1 and 3); with bf16_paged also a bf16 paged server, whose
    tokens must equal the bf16 dense server's. device_step_ms beside the
    weights' read of a step (step_bytes at 3.35 TB/s). Returns each run's
    launches of `counters`."""
    cfg = model.cfg
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in MISTRAL_SERVED]
    runs = {}
    dense_tokens, paged_tokens = {}, {}
    runs["bf16"] = long_prompt_server(model, f"bf16 server, 2 slots, max_len "
                                      f"{FAMILY_MAX_LEN}", prompts, None, log=log,
                                      max_len=FAMILY_MAX_LEN, tokens=dense_tokens)
    if bf16_paged:
        runs["bf16 paged"] = long_prompt_server(
            model, f"bf16 paged server (pages of {PAGE})", prompts, None, log=log,
            max_len=FAMILY_MAX_LEN, tokens=paged_tokens, paged=True, page_size=PAGE)
    prefix = prompts[0][:MISTRAL_PREFIX]
    served = [p if uid % 2 == 0 else prefix + p[MISTRAL_PREFIX:]
              for uid, p in enumerate(prompts)]
    runs["int8-KV paged"] = long_prompt_server(
        model, f"int8-KV paged server (pages of {PAGE}, admit_chunk {MOE_ADMIT_CHUNK}, a "
        f"{MISTRAL_PREFIX}-token prefix before requests 1 and 3)", served, prefix, log=log,
        max_len=FAMILY_MAX_LEN, quant="int8", paged=True, page_size=PAGE,
        admit_chunk=MOE_ADMIT_CHUNK)
    if bf16_paged:
        check(paged_tokens == dense_tokens,
              f"{name}: the bf16 paged server's tokens differ from the dense server's")
        print(f"{log} {name}: the bf16 paged and dense servers give equal tokens for all "
              f"{len(prompts)} requests")
    bound_ms = step_bytes / 3.35e12 * 1e3
    print(f"{log} {name}: a decode step's weights' read {step_bytes / 1e9:.2f} GB, "
          f"{bound_ms:.3f} ms at 3.35 TB/s (device_step_ms of each server above)")
    check(runs["bf16"]["flash_fwd"] > 0 and runs["bf16"]["decode"] > 0
          and runs["int8-KV paged"]["paged_decode"] > 0,
          f"a kernel missed the {name} servers: {runs}")
    return {tag: {k: run[k] for k in counters} for tag, run in runs.items()}


def moe_servers(model, name: str, gen: torch.Generator, log: str, step_bytes: float,
                bf16_paged: bool) -> dict[str, int]:
    """servers() on a MoE model, every eager MoE call through the grouped
    dispatch. Returns the launches of the runs, summed."""
    with moe_calls() as calls:
        runs = servers(model, name, gen, log, step_bytes, bf16_paged)
    check(calls["dense"] == 0 and calls["grouped"] > 0,
          f"{name} servers' MoE calls {calls}: the masked-dense loop ran")
    print(f"{log} {name}: eager MoE calls of the servers {calls}")
    total: dict[str, int] = {}
    for run in runs.values():
        add_launches(total, run)
    return total


def moe_hf_config(source: dict, dtype: torch.dtype = torch.bfloat16, layers: int | None = None):
    """config_from_hf of a public config.json (its depth cut to `layers`)."""
    fields = dict(source, **({"num_hidden_layers": layers} if layers else {}))
    return convert.config_from_hf(fields, dtype)


def phase_moe(gen: torch.Generator) -> dict[str, int]:
    """Phase 16 (the comment above). Qwen3-30B-A3B in bf16 at full width
    and depth: the module gate, the whole-model logits gate (the plain
    route's routing teacher-forced to the kernel run's, every pick it
    would change a near-tie), the sync-debug gate, phase 4's capture gate
    (bitwise), the servers; then its widths cut to MOE_F32_LAYERS layers in
    float32, free-running, where no flip excuses a miss; then Qwen1.5-MoE-A2.7B from its
    Hugging Face directory: the logits gate and the servers. Each model is
    freed before the next. Returns the launches of the server runs."""
    log = "[moe]"
    total: dict[str, int] = {}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the router's float32 product must run in float32")
    cfg = moe_hf_config(QWEN3_30B_A3B_JSON, layers=MOE_LAYERS)
    name = "Qwen3-30B-A3B"
    print(f"{log} {name}: depth cut to {MOE_LAYERS} of {QWEN3_30B_A3B_JSON['num_hidden_layers']} "
          f"layers (the run's time limit)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"{log} {name}: {cfg.num_layers} layers, hidden {cfg.hidden_size}, GQA "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}, q/k RMSNorm, "
          f"{cfg.num_experts} experts of {cfg.intermediate_size} (config.json's "
          f"moe_intermediate_size), top {cfg.top_k_experts} renormalised; {n / 1e9:.3f} B "
          f"random bf16 parameters on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    moe_module_gate(model, prompt, log)
    moe_logits_gate(model, name, prompt, forced, log, bf16=True)
    step_bytes = moe_sync_gate(model, gen, log)
    capture_gate("bf16 weights, bf16 KV", model, None, False, gen, name=name, bitwise=True)
    add_launches(total, moe_servers(model, name, gen, log, step_bytes, bf16_paged=True))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = moe_hf_config(QWEN3_30B_A3B_JSON, torch.float32, layers=MOE_F32_LAYERS)
    model = init_params(cfg32, gen, device="cuda")
    print(f"{log} {name} widths cut to {MOE_F32_LAYERS} layers in float32: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    moe_logits_gate(model, f"{name} ({MOE_F32_LAYERS} layers)", prompt, forced, log,
                    bf16=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    name = "Qwen1.5-MoE-A2.7B"
    cfg = moe_hf_config(QWEN15_MOE_JSON, layers=MOE_HF_LAYERS)
    print(f"{log} {name}: depth cut to {MOE_HF_LAYERS} of {QWEN15_MOE_JSON['num_hidden_layers']} "
          f"layers (the run's time limit)")

    def weight_bytes(layers: int) -> int:
        meta = llama.Llama(dataclasses.replace(cfg, num_layers=layers), device="meta")
        return sum(p.numel() * p.element_size() for p in meta.parameters())

    per_layer = weight_bytes(1) - weight_bytes(0)
    need = weight_bytes(cfg.num_layers) * 1.05
    free = shutil.disk_usage(tempfile.gettempdir()).free
    if free < need:
        fit = max(1, int((free / 1.05 - weight_bytes(0)) / per_layer))
        print(f"{log} {name}: {free / 1e9:.1f} GB free on the disk for a {need / 1e9:.1f} GB "
              f"checkpoint: depth cut to {fit} of {cfg.num_layers} layers for the loader's "
              f"round trip and this model's gates and servers")
        cfg = moe_hf_config(QWEN15_MOE_JSON, layers=fit)
    model = load_from_hf_dir(cfg, name, gen, log)
    prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    moe_logits_gate(model, name, prompt, forced, log, bf16=True)
    step_bytes = moe_sync_gate(model, gen, log)
    add_launches(total, moe_servers(model, name, gen, log, step_bytes, bf16_paged=False))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{log} launches of the server runs: {total}")
    return total


ALIBI_COUNTERS = ("flash_fwd", "decode", "paged_decode", "flash_fwd_alibi", "decode_alibi",
                  "paged_decode_alibi")


def phase_alibi(gen: torch.Generator) -> dict[str, int]:
    """Phase 17 (the comment above): LLAMA_8B with use_alibi at full width
    and depth, random weights from the seed. Logits gates (bf16 KV and
    int8 KV, kernels against the plain route), the sync-debug gate, phase
    4's capture gate (bitwise), the bf16, bf16 paged and int8-KV paged
    servers. Returns the ALiBi launches of its kernel runs and servers by
    row: flash_fwd_alibi, decode_alibi (bf16 caches), decode_int8_alibi,
    paged_decode_alibi."""
    log = "[alibi]"
    cfg = dataclasses.replace(LLAMA_8B, use_alibi=True)
    name = "LLAMA_8B with use_alibi"
    layers = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"{log} {name}: {layers} layers, hidden {cfg.hidden_size}, GQA {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, D {cfg.head_dim}, vocab {cfg.vocab_size}, RoPE off, ALiBi with "
          f"the standard slopes (2^-8(h+1)/{cfg.num_heads}); {n / 1e9:.3f} B random bf16 "
          f"parameters on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(llama.rope_tables(cfg, torch.arange(4, device="cuda")) == (None, None),
          f"{name}: RoPE tables built for an ALiBi model")
    prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")
    names = [f"prefill S={FAMILY_PROMPT}"] + [f"decode {i}" for i in range(1, 5)]
    rows = {"flash_fwd_alibi": 0, "decode_alibi": 0, "decode_int8_alibi": 0,
            "paged_decode_alibi": 0}
    for quant, kv, mode in ((None, "bf16 KV", "decode"), ("int8", "int8 KV", "decode_int8")):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kern = generation_run(model, prompt, forced, quant=quant, max_len=FAMILY_MAX_LEN)
        run_s = time.perf_counter() - t0
        added = {k: v for k, v in read_launches().items() if v}
        want = {"flash_fwd": layers, "flash_fwd_alibi": layers, mode: 4 * layers,
                "decode_alibi": 4 * layers}
        check(added == want, f"{name} {kv} kernel run launched {added}, want {want}")
        print(f"{log} {kv} kernel run (prefill S={FAMILY_PROMPT} and 4 decode steps) in "
              f"{run_s:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches {added}")
        # int8 KV: the plain route requantizes P per 64-position tile, as K2
        # does (the JAX kernel's 4,096-position block loses more of the far
        # keys' P: another arithmetic, not the kernel's).
        with plain_kernels(decode.BLOCK_KV if quant else None):
            plain = generation_run(model, prompt, forced, quant=quant, max_len=FAMILY_MAX_LEN)
        check({k: v for k, v in read_launches().items() if v} == want,
              f"{name} {kv} plain run launched a kernel")
        compare_logits(kv, kern, plain, names, model=name)
        del kern, plain
        rows["flash_fwd_alibi"] += added["flash_fwd_alibi"]
        rows[f"{mode}_alibi"] += added["decode_alibi"]
    sync_gate(model, gen, log)
    tables = flash_fwd.standard_slope_table.cache_info().currsize
    capture_gate("bf16 weights, bf16 KV", model, None, False, gen, name=name, bitwise=True)
    check(flash_fwd.standard_slope_table.cache_info().currsize == tables,
          f"{name}: a slope table was built during the capture gate")
    step_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    step_bytes -= model.embed.numel() * model.embed.element_size()  # two rows read
    runs = servers(model, name, gen, log, step_bytes, bf16_paged=True, counters=ALIBI_COUNTERS)
    for tag, run in runs.items():
        check(run["flash_fwd_alibi"] == run["flash_fwd"]
              and run["decode_alibi"] == run["decode"]
              and run["paged_decode_alibi"] == run["paged_decode"],
              f"{name} {tag} server: a launch without ALiBi: {run}")
        rows["flash_fwd_alibi"] += run["flash_fwd_alibi"]
        rows["decode_alibi"] += run["decode_alibi"]
        rows["paged_decode_alibi"] += run["paged_decode_alibi"]
    print(f"{log} {name}: ALiBi launches of the kernel runs and servers by row {rows}")
    check(all(rows.values()), f"{name}: an ALiBi kernel missed its path: {rows}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# Phase 18: training LLAMA_8B with use_alibi (the attention shape of MPT-7B
# and BLOOM-7B1: GQA 32/8 at D 128, RoPE off). (a) cut to PACK_LAYERS layers
# (about 1.9 B parameters: the 32 layers with AdamW's two float32 moments
# pass one card's 80 GB) on the packed row of 8,192 tokens, packed_training:
# K1 with ALiBi and segment ids, B3 with ALiBi against the plain route under
# phase 7's gates, then PACK_STEPS train.train steps on the split backward.
# (b) all 32 layers, B 1, ALIBI_FULL_S tokens unpacked, remat="attn",
# GEMMA_FULL_STEPS sgd_train_steps on one repeated batch (8.03 B parameters:
# 16.1 GB of bf16 weights and as much of gradients, 2.1 GB of float32
# logits, about 0.12 GB of kept residuals a layer).
ALIBI_TRAIN_ROWS = ("flash_fwd_alibi", "flash_fwd_alibi_segments", "flash_bwd_fused_alibi",
                    "flash_bwd_dq_alibi", "flash_bwd_dkv_alibi")


def phase_alibi_train(gen: torch.Generator) -> dict[str, int]:
    """Phase 18 (the comment above). Returns the ALiBi launches of (a)'s
    gated step and trainer and of (b)'s steps, by row."""
    cfg = dataclasses.replace(LLAMA_8B, use_alibi=True)
    name = "LLAMA_8B with use_alibi"
    total = packed_training(gen, dataclasses.replace(cfg, num_layers=PACK_LAYERS), name,
                            "[alibi-packed]", ALIBI_TRAIN_ROWS)
    log = "[alibi-32]"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{log} {name}, {cfg.num_layers} layers: {n_params / 1e9:.3f} B random bf16 "
          f"parameters in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (1, ALIBI_FULL_S + 1), generator=gen,
                           device="cuda")
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for step in range(GEMMA_FULL_STEPS):
        t0 = time.perf_counter()
        loss = llama.sgd_train_step(model, tokens, GEMMA_FULL_LR, remat="attn")[0]
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        print(f"{log} step {step + 1}: loss {losses[-1]:.6f}, {walls[-1]:.1f} ms (host clock, "
              f"synchronised), {ALIBI_FULL_S / walls[-1] * 1e3:.0f} tokens/s")
    peak = torch.cuda.max_memory_allocated()
    got = {k: n for k, n in read_launches().items() if n}
    layers = cfg.num_layers
    want = {k: GEMMA_FULL_STEPS * layers for k in ("flash_fwd", "flash_fwd_alibi",
                                                   "flash_bwd_fused", "flash_bwd_fused_alibi")}
    check(got == want, f"{log} launched {got}, want {want}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"{log} losses {losses}")
    ms = statistics.median(walls[1:])
    print(f"{log} {name} {layers} layers B=1 S={ALIBI_FULL_S} sgd_train_step remat='attn' "
          f"(lr {GEMMA_FULL_LR}), fused backward: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{ms:.1f} ms/step (median of steps 2-{GEMMA_FULL_STEPS}), "
          f"{ALIBI_FULL_S / ms * 1e3:.0f} tokens/s, peak {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated)")
    add_launches(total, {k: got.get(k, 0) for k in ALIBI_TRAIN_ROWS})
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{log} ALiBi launches of phase 18 by row: {total}")
    return total


# Phase 19: attention dropout through flash_attention(dropout_rate=,
# dropout_seed=) at the source's headline shape (bench.py's B 4, H 8,
# S 16384, D 128, causal, bf16), every gate against the plain
# dropout_keep_mask and the plain route on the same mask.
DROPOUT_ROWS = ("flash_fwd_dropout", "flash_bwd_fused_dropout", "flash_bwd_dq_dropout",
                "flash_bwd_dkv_dropout")
DROP_RATE = 0.1
DROP_SEED = 20181
# The readouts' (dtype, D, rate, seed), each at B 2, GQA 32/4, S_k 1024
# (eight kv tiles of K1 at D 64 and 128, sixteen at D 256), S_q 256 for K1
# and 128 (256 at D 256) for the backward's.
DROP_READS = [(torch.bfloat16, 64, 0.1, -7), (torch.bfloat16, 128, 0.5, 0),
              (torch.bfloat16, 256, 0.1, 2**31 - 1), (torch.float32, 64, 0.5, 2**31 - 1),
              (torch.float32, 128, 0.1, -7), (torch.float32, 256, 0.5, 0)]
DROP_FRACTION_S = 4096
DROP_FRACTION_TOL = 5e-3


def dropout_readouts() -> None:
    """Phase 19 (a): each kernel's keep mask read out of its outputs
    (utils/dropout_readout.py: q = 0 makes P uniform; one-hot V for K1, one
    hot K with v = dO = e_0 for B4, one-hot dO of one head a group for B3's
    and B5's dV) against the plain dropout_keep_mask on the card, zero
    mismatches allowed; then K1's keep fraction on a 4096 x 4096 tile."""
    dev = torch.device("cuda")
    b, hq, hkv, s_k = 2, 32, 4, 1024
    for dtype, d, rate, seed in DROP_READS:
        s_fwd, s_bwd = 256, 256 if d == 256 else 128
        want = dropout_readout.plain_mask(b, hq, s_fwd, s_k, rate, seed, dev)
        args = (b, hq, hkv, s_bwd, s_k, d, dtype, rate, seed, dev)
        reads = {"K1": dropout_readout.forward_mask(b, hq, hkv, s_fwd, s_k, d, dtype, rate,
                                                    seed, dev),
                 "B4": dropout_readout.dq_mask(*args),
                 "B3": dropout_readout.dv_mask(*args, impl="fused"),
                 "B5": dropout_readout.dv_mask(*args, impl="split")}
        torch.cuda.synchronize()
        for name, got in reads.items():
            ref = want[:, :, :got.shape[2]]  # the mask keys on the arrays' rows
            bad = int((got != ref).sum())
            print(f"[dropout] readout {name} B={b} Hq={hq} Hkv={hkv} Sq={got.shape[2]} "
                  f"Sk={s_k} D={d} {str(dtype)[6:]} rate {rate} seed {seed}: {bad} of "
                  f"{ref.numel()} elements differ from dropout_keep_mask (kept "
                  f"{float(ref.float().mean()):.4f})")
            check(bad == 0, f"dropout readout {name} {dtype} D={d} rate {rate} seed {seed}: "
                            f"{bad} mismatches")
    for rate in (0.1, 0.5):
        got = dropout_readout.forward_mask(1, 1, 1, DROP_FRACTION_S, DROP_FRACTION_S, 64,
                                           torch.bfloat16, rate, DROP_SEED, dev)
        frac = float(got.float().mean())
        bad = int((got != dropout_readout.plain_mask(1, 1, DROP_FRACTION_S, DROP_FRACTION_S,
                                                     rate, DROP_SEED, dev)).sum())
        print(f"[dropout] K1's keep fraction on a {DROP_FRACTION_S} x {DROP_FRACTION_S} tile, "
              f"rate {rate}: {frac:.5f} (1 - rate {1 - rate}, within {DROP_FRACTION_TOL}); "
              f"{bad} elements differ from dropout_keep_mask")
        check(abs(frac - (1 - rate)) <= DROP_FRACTION_TOL and bad == 0,
              f"K1's keep fraction at rate {rate}: {frac}, {bad} mismatches")


def dropout_kernels(gen: torch.Generator) -> tuple[dict[str, float], tuple]:
    """Phase 19 (b) beside the headline path: K1, B3 and B4 + B5 with
    dropout against their plain versions on the same mask (masked_case) at
    LLAMA_1B's training attention (B 4, Hq 32, Hkv 4, S 2048, D 64, causal),
    then on the packed rows of MISTRAL_7B (window 4096 and segment ids),
    GEMMA2_9B (D 256, cap 50, segment ids) and LLAMA_8B with ALiBi (segment
    ids), rate DROP_RATE. Returns the rows' largest errors and LLAMA_1B's
    inputs."""
    err = dict.fromkeys(DROPOUT_ROWS, 0.0)
    drop = dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
    train_row = masked_case(gen, err, "LLAMA_1B training attention with dropout",
                            (TRAIN_B, 32, 4, TRAIN_S, TRAIN_S, 64), **drop)
    masked_case(gen, err, "MISTRAL_7B packed row with dropout", (1, 32, 8, PACK_S, PACK_S, 128),
                lens=PACK_DOCS, window=WIN, **drop)
    gc.collect()
    torch.cuda.empty_cache()
    masked_case(gen, err, "GEMMA2_9B packed row with dropout", (1, 16, 8, PACK_S, PACK_S, 256),
                lens=PACK_DOCS, logit_softcap=CAP, **drop)
    gc.collect()
    torch.cuda.empty_cache()
    masked_case(gen, err, "LLAMA_8B packed row with ALiBi and dropout",
                (1, 32, 8, PACK_S, PACK_S, 128), lens=PACK_DOCS, alibi=True, **drop)
    gc.collect()
    torch.cuda.empty_cache()
    return err, train_row


def dropout_path(gen: torch.Generator) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 19's main path: flash_attention(q, k, v, is_causal=True,
    dropout_rate=DROP_RATE, dropout_seed=seed) and its gradients at the
    headline shape, the seed a CUDA tensor that changes from step to step
    as a trainer's would: a step on the fused backward (the default) and
    one on the split backward (FLASHATTN_BWD_IMPL=split) with one seed, the
    split step again with it and a step with the next seed. Then, against
    the plain forward and backward on the same mask (ops/reference.py):
    K1's O and the split and fused dQ on three 256-row slices of every head
    (the rows' scores against every key; their position passed as
    pos_offset and dropout_row0), and K1's O and the split and fused dQ,
    dK and dV of batch 0, head 0 whole (MHA: bh stays 0 in the [1, 1]
    slice, so the mask is the same; the plain backward's score blocks are
    [1, 1, 16384, 16384], 1 GiB each in float32); the fused gradients
    against the split ones; the same seed's O and split gradients bitwise
    equal, the next seed's O another. Returns the launches the path
    counted and the largest errors by kernels-line row."""
    b, h, hkv, s, d = K1_SHAPES["D=128 headline"]
    leaves = [randn((b, n, s, d), gen).requires_grad_() for n in (h, hkv, hkv)]
    do = randn((b, h, s, d), gen)
    seed = torch.tensor(DROP_SEED, dtype=torch.int32, device="cuda")
    tag = f"B={b} Hq={h} Hkv={hkv} S={s} D={d} causal dropout {DROP_RATE}"

    def step(impl: str):
        os.environ[flash_bwd.IMPL_ENV] = impl
        try:
            o = flash_attention(*leaves, is_causal=True, dropout_rate=DROP_RATE,
                                dropout_seed=seed)
            return (o.detach(), *torch.autograd.grad(o, leaves, do))
        finally:
            del os.environ[flash_bwd.IMPL_ENV]

    reset_launches()
    t0 = time.perf_counter()
    fused = step("fused")
    split = step("split")
    again = step("split")
    seed += 1
    other = step("split")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: n for k, n in read_launches().items() if n}
    print(f"[dropout] path {tag}: 4 forward + backward steps through flash_attention in "
          f"{wall:.2f} s (host clock, first calls included); launched {got}")
    want = {"flash_fwd": 4, "flash_fwd_dropout": 4, "flash_bwd_fused": 1,
            "flash_bwd_fused_dropout": 1, "flash_bwd_dq": 3, "flash_bwd_dq_dropout": 3,
            "flash_bwd_dkv": 3, "flash_bwd_dkv_dropout": 3}
    check(got == want, f"[dropout] path launched {got}, want {want}")
    check(all(torch.equal(x, y) for x, y in zip(split, again)),
          "[dropout] one seed, two split steps: O or the gradients differ")
    check(not torch.equal(other[0], split[0]), "[dropout] another seed gave the same O")
    print(f"[dropout] path {tag}: one seed twice, O and the split gradients bitwise equal "
          f"(torch.equal); the next seed's O differs")
    check(torch.equal(fused[0], split[0]), "[dropout] the fused and split steps' O differ")
    del again, other
    for name, a, g in zip(("dQ", "dK", "dV"), split[1:], fused[1:]):
        grad_gate(f"fused {name} against split {name}, {tag}", a, g, torch.bfloat16)
    check(bool(torch.isfinite(split[0]).all()), f"K1 {tag}: non-finite O")
    q, k, v = (t.detach() for t in leaves)
    o = split[0]
    drop = dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
    err = dict.fromkeys(DROPOUT_ROWS, 0.0)
    rows = 256
    for r0 in (0, s // 2 - rows // 2, s - rows):
        sl = slice(r0, r0 + rows)
        where = f"{tag}, q rows [{r0}, {r0 + rows})"
        o_ref, lse_ref = reference.reference_attention_with_lse(
            q[:, :, sl], k, v, True, pos_offset=r0, dropout_row0=r0, **drop)
        err["flash_fwd_dropout"] = max(err["flash_fwd_dropout"],
                                       _gate(f"K1 {where} O", o_ref, o[:, :, sl], O_ATOL))
        dq_ref = reference.reference_attention_backward(
            q[:, :, sl], k, v, o[:, :, sl], do[:, :, sl], lse_ref, True, pos_offset=r0,
            dropout_row0=r0, **drop)[0]
        err["flash_bwd_dq_dropout"] = max(err["flash_bwd_dq_dropout"], grad_gate(
            f"B4 {where} dQ", dq_ref, split[1][:, :, sl], torch.bfloat16))
        err["flash_bwd_fused_dropout"] = max(err["flash_bwd_fused_dropout"], grad_gate(
            f"B3 {where} dQ", dq_ref, fused[1][:, :, sl], torch.bfloat16))
        del o_ref, lse_ref, dq_ref
    one = slice(0, 1)
    where = f"{tag}, batch 0 head 0, every row"
    o_ref, lse_ref = reference.reference_attention_with_lse(q[one, one], k[one, one],
                                                            v[one, one], True, **drop)
    err["flash_fwd_dropout"] = max(err["flash_fwd_dropout"],
                                   _gate(f"K1 {where} O", o_ref, o[one, one], O_ATOL))
    del o_ref
    ref = reference.reference_attention_backward(q[one, one], k[one, one], v[one, one],
                                                 o[one, one], do[one, one], lse_ref, True,
                                                 **drop)
    del lse_ref
    for name, r, a, g in zip(("dQ", "dK", "dV"), ref, split[1:], fused[1:]):
        row = "flash_bwd_dq_dropout" if name == "dQ" else "flash_bwd_dkv_dropout"
        err[row] = max(err[row], grad_gate(f"B4/B5 {where} {name}", r, a[one, one],
                                           torch.bfloat16))
        err["flash_bwd_fused_dropout"] = max(err["flash_bwd_fused_dropout"], grad_gate(
            f"B3 {where} {name}", r, g[one, one], torch.bfloat16))
    del ref, fused, split, leaves, q, k, v, o
    gc.collect()
    torch.cuda.empty_cache()
    return {k: got[k] for k in DROPOUT_ROWS}, err


def dropout_identities(q, k, v, o, do, lse, kw) -> None:
    """Phase 19 (c) on LLAMA_1B's training attention: rate 0 (with a seed)
    gives the bits of the call without dropout, K1 and the split backward,
    and launches no dropout kernel; a seed tensor on the card gives the int
    seed's bits."""
    clean = dict(kw, dropout_rate=0.0, dropout_seed=None)
    zero = dict(kw, dropout_rate=0.0)
    before = {n: read_launches()[n] for n in DROPOUT_ROWS}
    o0, lse0 = flash_fwd.flash_attention_forward(q, k, v, **clean)
    o1, lse1 = flash_fwd.flash_attention_forward(q, k, v, **zero)
    g0 = flash_bwd.flash_attention_backward(q, k, v, o0, do, lse0, impl="split", **clean)
    g1 = flash_bwd.flash_attention_backward(q, k, v, o0, do, lse0, impl="split", **zero)
    check(torch.equal(o0, o1) and torch.equal(lse0, lse1)
          and all(torch.equal(a, b) for a, b in zip(g0, g1)),
          "[dropout] rate 0 differs from the call without dropout")
    check({n: read_launches()[n] for n in DROPOUT_ROWS} == before,
          "[dropout] rate 0 launched a dropout kernel")
    check(torch.equal(lse0, lse), "[dropout] the LSE with dropout is not the LSE without it")
    seed_t = torch.tensor(kw["dropout_seed"], dtype=torch.int32, device="cuda")
    o2, _ = flash_fwd.flash_attention_forward(q, k, v, **dict(kw, dropout_seed=seed_t))
    check(torch.equal(o2, o), "[dropout] a seed tensor on the card differs from the int seed")
    print("[dropout] LLAMA_1B training attention: rate 0 gives the bits without dropout "
          "(K1 O and LSE, the split gradients) and launches no dropout kernel; the LSE with "
          "dropout is the LSE without it; a seed tensor on the card gives the int seed's O")


def time_dropout(label: str, q, k, v, o, do, lse, drop: dict, plain: bool) -> dict[str, dict]:
    """Phase 19 (d): K1, B3, B4 and B5 with dropout (`drop`: the rate and
    seed) timed on the card (device ms, cuda_time_ms) beside the same
    kernels without dropout on the same inputs, the plain route (events;
    unless `plain` is False, where its score blocks would not fit), SDPA's
    forward or forward + backward with dropout_p (its mask is Philox's,
    another mask: timed only, never a route or an oracle) and the bound of
    utils/roofline.py (dropout adds no product and no byte). Returns the
    kernels line's rows."""
    few = dict(warmup=1, iters=3, reps=3)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    ms, base = {}, {}
    for opts, into in ((drop, ms), ({}, base)):
        into["K1"] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, **opts), **few)
        into["B3"] = cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
            q, k, v, o, do, lse, True, **opts), **few)
        into["B4"] = cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True,
                                                                 **opts), **few)
        _, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True, **opts)
        into["B5"] = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta, True,
                                                                  **opts), **few)
    gqa = hkv != hq
    lib_f = event_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=drop["dropout_rate"], is_causal=True, enable_gqa=gqa), iters=5)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, dropout_p=drop["dropout_rate"],
                                           is_causal=True, enable_gqa=gqa)
    lib_b = event_time_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True),
                          iters=3)
    del o_lib, leaves
    plain_f = plain_b = None
    if plain:
        plain_f = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
            q, k, v, True, **drop), warmup=1, iters=2)
        plain_b = event_time_ms(lambda: flash_bwd.flash_attention_backward_reference(
            q, k, v, o, do, lse, True, **drop), warmup=1, iters=2)
    gc.collect()
    torch.cuda.empty_cache()
    shape = f"{label} B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal {str(q.dtype)[6:]}"
    out = {}
    for name, row in (("K1", "flash_fwd_dropout"), ("B3", "flash_bwd_fused_dropout"),
                      ("B4", "flash_bwd_dq_dropout"), ("B5", "flash_bwd_dkv_dropout")):
        roof = dict(dtype_bytes=q.element_size())
        report = (roofline.attention_fwd_roofline(b, hq, hkv, s, s, d, True, **roof)
                  if name == "K1" else roofline.attention_bwd_roofline(
                      b, hq, hkv, s, s, d, True,
                      kernel={"B3": "fused", "B4": "dq", "B5": "dkv"}[name], **roof))
        lib = lib_f if name == "K1" else lib_b
        plain_ms = plain_f if name == "K1" else plain_b
        print(f"[dropout] {name} with dropout {drop['dropout_rate']}, {shape}: kernel "
              f"{ms[name]:.4f} ms ({report.flops / (ms[name] * 1e-3) / 1e12:.2f} TFLOP/s), "
              f"without dropout {base[name]:.4f} ms ({ms[name] / base[name] - 1:+.1%}), bound "
              f"{report.bound_ms:.5f} ms by {report.bound_by}, plain "
              + (f"{plain_ms:.4f} ms" if plain else "left out (its score blocks would not fit)")
              + f", SDPA {'forward' if name == 'K1' else 'backward'} with dropout_p (another "
              f"mask, Philox) {lib:.4f} ms")
        out[row] = dict(ms=ms[name], plain_ms=plain_ms, library_ms=lib, **bound(report))
    return out


def phase_dropout(gen: torch.Generator) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 19 (the comment above): (a) the readouts, (b) the kernels
    against the plain route beside the headline path, (c) rate 0 and the
    seeds, the main path at the headline shape, (d) the timings. Returns
    the path's launches and the kernels line's rows."""
    t0 = time.perf_counter()
    dropout_readouts()
    print(f"[dropout] (a) readouts in {time.perf_counter() - t0:.1f} s")
    err, train_row = dropout_kernels(gen)
    dropout_identities(*train_row)
    launches, path_err = dropout_path(gen)
    err = {n: max(err[n], path_err[n]) for n in DROPOUT_ROWS}
    q, k, v, o, do, lse, kw = train_row
    # the seed on the card, as a trainer passes it: an int adds a fill kernel a call
    drop = dict(dropout_rate=DROP_RATE,
                dropout_seed=torch.tensor(DROP_SEED, dtype=torch.int32, device="cuda"))
    timed = time_dropout("LLAMA_1B training attention", q, k, v, o, do, lse, drop, plain=True)
    del train_row, q, k, v, o, do, lse, kw
    gc.collect()
    torch.cuda.empty_cache()
    b, h, hkv, s, d = K1_SHAPES["D=128 headline"]
    q, k, v, do = (randn((b, n, s, d), gen) for n in (h, hkv, hkv, h))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, **drop)
    time_dropout("headline", q, k, v, o, do, lse, drop, plain=False)
    del q, k, v, o, do, lse
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dropout] launches of phase 19's path by row: {launches}")
    return launches, {n: dict(max_abs_err=err[n], **timed[n]) for n in DROPOUT_ROWS}


# Phase 2's kernels with the q/k alignment read on the card (dyn_pos_offset):
# at (a)'s zigzag chunk pair, B 1, Hq 32, Hkv 8, a 4,096-row chunk against a
# 4,096-key chunk, D 128, bf16, the offset (2n-1 - rank - src) C of rank 1's
# first hop at n = 2 (C = 4,096), the window 4,096 and ALiBi: phase 20 (a)'s
# case "zigzag, window 4,096 + ALiBi". Then every other option the JAX
# kernels take with the offset (dynoff_variants): the soft-cap with the
# window at D 256 on GEMMA2_9B's local-layer pair (phase 20 (a)'s Gemma
# case: C 2,048, its hops' offsets 2,048, 4,096 and 6,144), dropout with the
# window and with ALiBi at DYN_SHAPE, and float32 with the window.
DYNOFF_ROWS = ("flash_fwd_dynoff", "flash_bwd_fused_dynoff", "flash_bwd_dq_dynoff",
               "flash_bwd_dkv_dynoff")
DYN_SHAPE = (1, 32, 8, 4096, 128)  # B, Hq, Hkv, S (rows = keys), D
DYN_OFFSET = 4096
DYN_WINDOW = 4096
DYN_VARIANTS = ("softcap", "dropout", "f32")  # the rows' suffixes: DYNOFF_ROWS + "_" + it
DYN_GEMMA = (1, 16, 8, 2048, 256)  # B, Hq, Hkv, S (rows = keys), D; offset DYN_OFFSET
DYN_F32 = (1, 4, 2, 1024, 64)  # B, Hq, Hkv, S, D; offset and window 1,024
# The card-offset dropout readouts (dtype, D, rate, seed, options): B 1, Hq 8,
# Hkv 2, S_q 128 (256 at D 256), S_k 512, every pair visible at offset 1,000
# (the window's edge left of key 0; ALiBi's slopes 1e-3, so no P underflows).
DYN_DROP_READS = [(torch.bfloat16, 64, 0.5, -7, "alibi"), (torch.bfloat16, 128, 0.1, 0, "window"),
                  (torch.bfloat16, 256, 0.1, 2**31 - 1, "window"),
                  (torch.float32, 64, 0.5, 5, "window, alibi")]


def flex_dyn_ms(q, k, v, off: int, window: int | None, slopes, do, cap: float | None = None
                ) -> tuple:
    """torch.nn.attention.flex_attention over the left edge of a window at
    the alignment `off` (key c seen by query r iff c >= r + off - window +
    1, no causal bound; every key without a window), with the ALiBi
    score_mod slope_h * (c - r - off), or with `cap` the soft-cap's, compiled
    once: (its forward's ms, its backward's ms, autograd.grad of O against
    do); a competitor only, never used by the port. (None, None), with the
    reason printed, where it does not compile on this machine."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        torch._dynamo.reset()
        s_q, s_k = q.shape[2], k.shape[2]

        def score_mod(score, b, h, q_idx, kv_idx):
            if cap is not None:
                return cap * torch.tanh(score / cap)
            return score + slopes[h] * (kv_idx - q_idx - off).to(torch.float32)

        def mask_mod(b, h, q_idx, kv_idx):
            return kv_idx >= q_idx + off - window + 1

        block_mask = (create_block_mask(mask_mod, None, None, s_q, s_k, device="cuda")
                      if window is not None else None)
        flex = torch.compile(flex_attention, dynamic=False)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flex(*leaves, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "flex_attention gave non-finite output")
        iters = 10 if FLEX_TIMED else 1  # flex_warmup's process: compile both, time nothing
        with torch.no_grad():
            fwd = event_time_ms(lambda: flex(q, k, v, score_mod=score_mod,
                                             block_mask=block_mask, enable_gqa=True),
                                warmup=2 * FLEX_TIMED, iters=iters)
        bwd = event_time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                            warmup=2 * FLEX_TIMED, iters=min(iters, 3))
        return (fwd, bwd) if FLEX_TIMED else (None, None)
    except Exception as e:  # a competitor that does not build here is reported, not run
        print(f"[dynoff] flex_attention with the left edge and "
              f"{'the soft-cap' if cap is not None else 'ALiBi'} did not run on this "
              f"machine: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200] if str(e) else ''}")
        return None, None


def sdpa_masked_ms(q, k, v, do, bias, dropout_p: float = 0.0) -> tuple[float, float]:
    """SDPA's forward and backward ms (events) with an additive float mask
    `bias` and dropout_p, K and V repeated to Hq heads beforehand: a
    competitor only, timed, never a route or an oracle (its dropout mask is
    Philox's)."""
    group = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))
    fwd = event_time_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=bias, dropout_p=dropout_p), iters=5)
    leaves = [t.detach().requires_grad_() for t in (q, ke, ve)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias, dropout_p=dropout_p)
    bwd = event_time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=3)
    return fwd, bwd


def left_edge_bias(hq: int, s_q: int, s_k: int, off: int, window: int | None, slopes,
                   dtype) -> torch.Tensor:
    """[1, Hq or 1, S_q, S_k] additive mask of a card-offset call: -inf left
    of the window's edge, plus ALiBi's slope_h * (c - r - off) with slopes."""
    r = torch.arange(s_q, device="cuda")[:, None]
    c = torch.arange(s_k, device="cuda")[None, :]
    bias = torch.zeros((s_q, s_k), dtype=torch.float32, device="cuda")
    if window is not None:
        bias = bias.masked_fill(c < r + off - window + 1, float("-inf"))
    bias = bias[None, None]
    if slopes is not None:
        bias = bias + slopes[None, :, None, None] * (c - r - off).float()[None, None]
    return bias.to(dtype)


# Where a gradient element sums thousands of terms that cancel (ALiBi's
# steep heads weigh the same last keys from every row; q times 30 makes
# dK's terms large), the bf16 rounding of P and dS, which the kernels and
# the plain version each do, leaves errors beside a small |dV| or |dK| that
# no bf16 computation keeps under the elementwise bf16 gate: the plain
# version itself reads max_norm 1.6-3.7 on dV and 2.1-3.7 on dK at
# DYN_SHAPE with ALiBi, 2.8-5.1 on dK on the hot soft-cap inputs, against
# the float64 gradients (utils/grad_oracle.py; PERF.md §6). There the
# kernels are held to the plain version's own accuracy: each one's error
# against the float64 gradients (relative L2, largest absolute, largest
# normalized under GRAD_TOL) at most ORACLE_RATIO times the plain version's,
# and cos > 0.999. The L2 and largest absolute errors are steady from draw to
# draw (the outputs' own bf16 rounding sets the latter), the largest
# normalized one is not, hence its wider factor; a wrong mask, bias or tile
# moves all three by more.
ORACLE_RATIO = dict(l2=1.25, max_abs=1.5, max_norm=3.0)


def oracle_gate(name: str, exact: torch.Tensor, plain: torch.Tensor, got: torch.Tensor) -> float:
    """`got` (a kernel's gradient) against the float64 gradient `exact`, no
    farther from it than ORACLE_RATIO times the plain version `plain` is;
    returns got's largest absolute difference from the plain version."""
    tol = GRAD_TOL[torch.bfloat16]
    reps = [verify_results(exact, t, **tol) for t in (plain, got)]
    l2 = [((t.double() - exact).norm() / exact.norm()).item() for t in (plain, got)]
    stats = {"l2": l2, "max_abs": [r.max_abs_err for r in reps],
             "max_norm": [r.max_normalized_err for r in reps]}
    vs_plain = verify_results(plain, got, **tol)
    print(f"[kernels] {name} against the float64 gradients: "
          + ", ".join(f"{key} {p:.4g} plain, {g:.4g} kernel (ratio {g / p:.3f}, at most "
                      f"{ORACLE_RATIO[key]})" for key, (p, g) in stats.items())
          + f", cos {reps[1].cosine:.6f} (> 0.999); against the plain version {vs_plain}")
    check(reps[1].cosine > 0.999 and all(g <= ORACLE_RATIO[key] * p
                                         for key, (p, g) in stats.items()),
          f"{name} is farther from the float64 gradients than the plain version allows: {stats}")
    return vs_plain.max_abs_err


def dyn_gates(tag: str, q, k, v, do, off_t, off: int, kw: dict,
              oracle: bool = False) -> tuple[dict, tuple]:
    """K1 (O, LSE, rows without a key), B3 and B4 + B5 with the offset read
    on the card (off_t, a card tensor) against their plain versions (the int
    off), under the bf16 gates or float32's, or with `oracle` the
    gradients by oracle_gate against utils/grad_oracle.py's float64 ones
    (the window, ALiBi's standard slopes, the soft-cap and dropout as kw has
    them): their largest errors by kernel
    ("fwd", "fused", "dq", "dkv") and K1's (O, LSE); each call exactly one
    launch of its card-offset kernel."""
    f32 = q.dtype == torch.float32
    err = dict.fromkeys(("fwd", "fused", "dq", "dkv"), 0.0)
    before = {n: read_launches()[n] for n in DYNOFF_ROWS}
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=off_t, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, False,
                                                                 dyn_pos_offset=off, **kw)
    err["fwd"] = _gate(f"K1 {tag} O", o_ref, o, **(F32_TOL if f32 else dict(atol=O_ATOL)))
    _gate(f"K1 {tag} LSE", lse_ref, lse, LSE_ATOL)
    dead = torch.isneginf(lse_ref)
    check(torch.equal(dead, torch.isneginf(lse)) and not bool(o[dead].any()),
          f"K1 {tag}: rows without a key differ")
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, False,
                                                       dyn_pos_offset=off, **kw)
    exact = None
    if oracle:
        exact = grad_oracle.float64_backward(
            q, k, v, do, pos_offset=off, window=kw.get("window"),
            alibi_slopes=(flash_fwd.default_alibi_slopes(q.shape[1], q.device)
                          if kw.get("alibi") else None),
            logit_softcap=kw.get("logit_softcap"), dropout_rate=kw.get("dropout_rate", 0.0),
            dropout_seed=kw.get("dropout_seed"))
    for impl, kernels in (("fused", ("fused",) * 3), ("split", ("dq", "dkv", "dkv"))):
        got = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl=impl,
                                                 dyn_pos_offset=off_t, **kw)
        for i, (name, kernel, r, g) in enumerate(zip(("dQ", "dK", "dV"), kernels, ref, got)):
            what = f"{impl} {name} {tag}"
            e = (oracle_gate(what, exact[i], r, g) if oracle
                 else grad_gate(what, r, g, q.dtype))
            err[kernel] = max(err[kernel], e)
    del ref, got, exact
    launched = {n: read_launches()[n] - before[n] for n in DYNOFF_ROWS}
    check(launched == dict.fromkeys(DYNOFF_ROWS, 1),
          f"{tag}: the offset's kernels launched {launched}")
    return err, (o, lse)


def time_dyn(rows, tag: str, q, k, v, o, do, lse, off_t, off: int, kw: dict, err: dict,
             libs: tuple, lib_name: str) -> dict[str, dict]:
    """The four kernels of a card-offset call timed on the card (device ms,
    cuda_time_ms) beside their plain versions (events), the library call's
    forward and backward ms (`libs`, from `lib_name`; timed only) and the
    bound of utils/roofline.py over the visible pairs; the kernels line's
    rows (`rows`, in DYNOFF_ROWS' order; their launches come from phase 20)."""
    few = dict(warmup=1, iters=5, reps=3)
    dyn = dict(dyn_pos_offset=off_t, **kw)
    ms = {"fwd": cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, False, **dyn),
                              **few),
          "fused": cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
              q, k, v, o, do, lse, False, **dyn), **few),
          "dq": cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, False, **dyn),
                             **few)}
    _, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, False, **dyn)
    ms["dkv"] = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta, False,
                                                             **dyn), **few)
    plain = dict(dyn_pos_offset=off, **kw)
    plain_f = event_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
        q, k, v, False, **plain), warmup=1, iters=2)
    plain_b = event_time_ms(lambda: flash_bwd.flash_attention_backward_reference(
        q, k, v, o, do, lse, False, **plain), warmup=1, iters=2)
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    roof = dict(window=kw.get("window"), pos_offset=off, dtype_bytes=q.element_size())
    out = {}
    for row, kernel in zip(rows, ("fwd", "fused", "dq", "dkv")):
        report = (roofline.attention_fwd_roofline(b, hq, hkv, s_q, s_k, d, False, **roof)
                  if kernel == "fwd" else
                  roofline.attention_bwd_roofline(b, hq, hkv, s_q, s_k, d, False,
                                                  kernel=kernel, **roof))
        plain_ms, lib = (plain_f, libs[0]) if kernel == "fwd" else (plain_b, libs[1])
        print(f"[dynoff] {row} {tag}: kernel {ms[kernel]:.4f} ms "
              f"({report.flops / (ms[kernel] * 1e-3) / 1e12:.2f} TFLOP/s over the visible "
              f"pairs), bound {report.bound_ms:.5f} ms by {report.bound_by}, plain "
              f"{plain_ms:.4f} ms, {lib_name} {'forward' if kernel == 'fwd' else 'backward'} "
              + (f"{lib:.4f} ms" if lib is not None else "did not run"))
        out[row] = dict(max_abs_err=err[kernel], ms=ms[kernel], plain_ms=plain_ms,
                        library_ms=lib, **bound(report))
    return out


def dynoff_kernels(gen: torch.Generator) -> dict[str, dict]:
    """K1, B3, B4 and B5 with dyn_pos_offset (their libraries
    flash_fwd_dynoff and flash_bwd{,_fused}_dynoff) against their plain
    versions at DYN_SHAPE with the window's left edge and ALiBi, the offset
    a CUDA tensor (read on the card), the gradients held to the plain
    version's accuracy against float64 ones (oracle_gate); the second
    oracle, an offset at S_k (every pair causally visible) equal to the
    causal kernels with pos_offset = offset within the bf16 gates; D 64 with segment ids and
    the window alone against the plain versions; then the four timed beside
    the plain versions, flex_attention with the same mask and bias, and the
    bound of utils/roofline.py over the visible pairs of the left edge;
    then every other option (dynoff_variants). Returns the kernels line's
    rows (their launches come from phase 20)."""
    b, hq, hkv, s, d = DYN_SHAPE
    q, do = (randn((b, hq, s, d), gen) for _ in range(2))
    k, v = (randn((b, hkv, s, d), gen) for _ in range(2))
    off_t = torch.tensor([DYN_OFFSET], dtype=torch.int32, device="cuda")
    kw = dict(window=DYN_WINDOW, alibi=True)
    tag = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} dyn_pos_offset {DYN_OFFSET} (a card tensor), "
           f"window {DYN_WINDOW}, ALiBi")
    err, (o, lse) = dyn_gates(tag, q, k, v, do, off_t, DYN_OFFSET, kw, oracle=True)
    # The second oracle: at an offset of S_k every pair is causally visible.
    o_d, lse_d = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=s, **kw)
    o_c, lse_c = flash_fwd.flash_attention_forward(q, k, v, True, pos_offset=s, **kw)
    _gate(f"K1 offset {s} on the card vs causal pos_offset {s} O", o_c, o_d, O_ATOL)
    _gate(f"K1 offset {s} on the card vs causal pos_offset {s} LSE", lse_c, lse_d, LSE_ATOL)
    for impl in ("fused", "split"):
        g_d = flash_bwd.flash_attention_backward(q, k, v, o_d, do, lse_d, False, impl=impl,
                                                 dyn_pos_offset=s, **kw)
        g_c = flash_bwd.flash_attention_backward(q, k, v, o_c, do, lse_c, True, impl=impl,
                                                 pos_offset=s, **kw)
        for name, r, g in zip(("dQ", "dK", "dV"), g_c, g_d):
            grad_gate(f"{impl} {name} offset {s} on the card vs causal pos_offset {s}", r, g,
                      torch.bfloat16)
    del o_d, lse_d, o_c, lse_c, g_d, g_c
    # D 64 with segment ids (two documents, padding) and the window alone.
    q6, k6, v6, do6 = (randn((1, 8, 1024, 64), gen) for _ in range(4))
    ids = torch.full((1, 1024), -1, dtype=torch.int32, device="cuda")
    ids[0, :400], ids[0, 400:1000] = 0, 1
    kw6 = dict(window=700, segment_ids=varlen.canonical_segments(ids, ids, "cuda"))
    dyn_gates("D=64 segment ids, window 700, offset 300", q6, k6, v6, do6,
              torch.tensor([300], dtype=torch.int32, device="cuda"), 300, kw6)
    del q6, k6, v6, do6
    slopes = flash_fwd.default_alibi_slopes(hq, "cuda")
    libs = flex_dyn_ms(q, k, v, DYN_OFFSET, DYN_WINDOW, slopes, do)
    out = time_dyn(DYNOFF_ROWS, tag, q, k, v, o, do, lse, off_t, DYN_OFFSET, kw, err, libs,
                   "flex_attention")
    del q, k, v, o, do, lse
    gc.collect()
    torch.cuda.empty_cache()
    out.update(dynoff_variants(gen))
    return out


def dyn_dropout_readouts() -> None:
    """Each kernel's keep mask in card-offset calls with dropout, read out
    of its outputs as phase 19 (a) reads it (utils/dropout_readout.py; the
    offset 1,000 on the card, a window whose edge lies left of every key, or
    ALiBi with slopes 1e-3, or both: P stays positive everywhere) against
    the plain dropout_keep_mask, zero mismatches allowed; every call a
    launch of the card-offset kernels."""
    dev = torch.device("cuda")
    b, hq, hkv, s_k, off = 1, 8, 2, 512, 1000
    for dtype, d, rate, seed, what in DYN_DROP_READS:
        s_q = 256 if d == 256 else 128
        opts = dict(dyn_pos_offset=torch.tensor([off], dtype=torch.int32, device=dev))
        if "window" in what:
            opts["window"] = off + s_q
        if "alibi" in what:
            opts.update(alibi=True, alibi_slopes=torch.full((hq,), 1e-3, device=dev))
        before = {n: read_launches()[n] for n in DYNOFF_ROWS}
        args = (b, hq, hkv, s_q, s_k, d, dtype, rate, seed, dev)
        reads = {"K1": dropout_readout.forward_mask(*args, **opts),
                 "B4": dropout_readout.dq_mask(*args, **opts),
                 "B3": dropout_readout.dv_mask(*args, impl="fused", **opts),
                 "B5": dropout_readout.dv_mask(*args, impl="split", **opts)}
        torch.cuda.synchronize()
        launched = {n: read_launches()[n] - before[n] for n in DYNOFF_ROWS}
        check(all(launched.values()), f"card-offset readouts launched {launched}")
        want = dropout_readout.plain_mask(b, hq, s_q, s_k, rate, seed, dev)
        for name, got in reads.items():
            bad = int((got != want).sum())
            print(f"[dynoff] dropout readout {name} B={b} Hq={hq} Hkv={hkv} Sq={s_q} "
                  f"Sk={s_k} D={d} {str(dtype)[6:]} offset {off} on the card, {what}, rate "
                  f"{rate} seed {seed}: {bad} of {want.numel()} elements differ from "
                  f"dropout_keep_mask (kept {float(want.float().mean()):.4f})")
            check(bad == 0, f"card-offset dropout readout {name} {dtype} D={d} {what}: "
                            f"{bad} mismatches")


def dynoff_variants(gen: torch.Generator) -> dict[str, dict]:
    """The card-offset kernels with every other option the JAX kernels take,
    against their plain versions (dyn_gates), then timed (time_dyn): the
    soft-cap 50 with the window 4,096 at D 256 on GEMMA2_9B's local-layer
    pair (DYN_GEMMA, offset 4,096: the window's edge cuts the pair in half),
    beside flex_attention with the cap and the left edge, and on hot inputs
    (q times HOT) by oracle_gate; dropout
    (DROP_RATE) with the window, with ALiBi and with both at DYN_SHAPE, the
    readouts first (dyn_dropout_readouts), the three against the plain
    version on the same mask (the two with ALiBi by oracle_gate), the last
    timed beside SDPA with dropout_p and ALiBi + the left edge as a float
    mask; float32 with the window at
    DYN_F32 under the float32 gates, beside SDPA with the left edge. Returns
    the kernels line's rows (DYNOFF_ROWS + "_softcap", "_dropout", "_f32")."""
    out = {}
    b, hq, hkv, s, d = DYN_GEMMA
    q, k, v, do = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv, hq))
    off_t = torch.tensor([DYN_OFFSET], dtype=torch.int32, device="cuda")
    kw = dict(window=GWIN, logit_softcap=CAP)
    tag = (f"GEMMA2_9B's local-layer pair B={b} Hq={hq} Hkv={hkv} S={s} D={d} dyn_pos_offset "
           f"{DYN_OFFSET} (a card tensor), window {GWIN}, cap {CAP}")
    err, (o, lse) = dyn_gates(tag, q, k, v, do, off_t, DYN_OFFSET, kw)
    hot = [x * HOT if i == 0 else x for i, x in enumerate((q, k, v, do))]
    dyn_gates(tag + f", hot inputs (q x {HOT}: the cap saturates)", *hot, off_t, DYN_OFFSET, kw,
              oracle=True)
    del hot
    libs = flex_dyn_ms(q, k, v, DYN_OFFSET, GWIN, None, do, cap=CAP)
    out.update(time_dyn([f"{r}_softcap" for r in DYNOFF_ROWS], tag, q, k, v, o, do, lse, off_t,
                        DYN_OFFSET, kw, err, libs, "flex_attention with the cap"))
    del q, k, v, o, do, lse
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dyn_dropout_readouts()
    print(f"[dynoff] dropout readouts in {time.perf_counter() - t0:.1f} s")
    b, hq, hkv, s, d = DYN_SHAPE
    q, k, v, do = (randn((b, h, s, d), gen) for h in (hq, hkv, hkv, hq))
    drop = dict(dropout_rate=DROP_RATE,
                dropout_seed=torch.tensor(DROP_SEED, dtype=torch.int32, device="cuda"))
    shape = (f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} dyn_pos_offset {DYN_OFFSET} (a card "
             f"tensor), dropout {DROP_RATE}")
    err = dict.fromkeys(("fwd", "fused", "dq", "dkv"), 0.0)
    for opts in (dict(window=DYN_WINDOW), dict(alibi=True), dict(window=DYN_WINDOW, alibi=True)):
        e, (o, lse) = dyn_gates(f"{shape}, {opts}", q, k, v, do, off_t, DYN_OFFSET,
                                dict(opts, **drop), oracle="alibi" in opts)
        err = {n: max(err[n], e[n]) for n in err}
    slopes = flash_fwd.default_alibi_slopes(hq, "cuda")
    bias = left_edge_bias(hq, s, s, DYN_OFFSET, DYN_WINDOW, slopes, q.dtype)
    libs = sdpa_masked_ms(q, k, v, do, bias, DROP_RATE)
    del bias
    out.update(time_dyn([f"{r}_dropout" for r in DYNOFF_ROWS], f"{shape}, window "
                        f"{DYN_WINDOW}, ALiBi", q, k, v, o, do, lse, off_t, DYN_OFFSET,
                        dict(window=DYN_WINDOW, alibi=True, **drop), err, libs,
                        "SDPA with dropout_p and ALiBi + the left edge as a float mask (Philox's "
                        "mask: timed only)"))
    del q, k, v, o, do, lse
    gc.collect()
    torch.cuda.empty_cache()

    b, hq, hkv, s, d = DYN_F32
    q, k, v, do = (randn((b, h, s, d), gen, torch.float32) for h in (hq, hkv, hkv, hq))
    off_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    kw = dict(window=s)
    tag = (f"float32 B={b} Hq={hq} Hkv={hkv} S={s} D={d} dyn_pos_offset {s} (a card tensor), "
           f"window {s}")
    err, (o, lse) = dyn_gates(tag, q, k, v, do, off_t, s, kw)
    libs = sdpa_masked_ms(q, k, v, do, left_edge_bias(hq, s, s, s, s, None, q.dtype))
    out.update(time_dyn([f"{r}_f32" for r in DYNOFF_ROWS], tag, q, k, v, o, do, lse, off_t, s,
                        kw, err, libs, "SDPA with the left edge as a float mask"))
    del q, k, v, o, do, lse
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 20: context parallelism. Two ranks, spawned processes sharing the
# one card (cuda:0) through a gloo process group: every exchange is staged
# through host memory (parallel/distributed.py, "gloo-host"). Times taken
# while two ranks share one card say nothing of context parallelism's
# speed and are printed as wall time only.
CP_WORLD = 2
CP_OPS_SHAPE = (1, 32, 8, 16384, 128)  # LLAMA31_8B's attention at phase 14's prompt length
CP_GEMMA_SHAPE = (1, 16, 8, 8192, 256)  # GEMMA2_9B's attention at its 8,192-token context
CP_DROP_SHAPE = (1, 32, 4, 4096, 64)  # LLAMA_1B's attention
CP_F32_SHAPE = (1, 4, 2, 2048, 64)
# name: the sharded_ring_attention options, and: "bwd" the backward path
# (FLASHATTN_BWD_IMPL, as a user selects it), "shape" and "dtype" (else
# CP_OPS_SHAPE, bf16), "plain" (held against the same ranks on the plain
# route, not against one process's kernels), "row" (its card-offset
# launches count in DYNOFF_ROWS + row).
CP_CASES = {
    "ring, causal": dict(mode="ring"),
    "zigzag, causal": dict(mode="zigzag"),
    "zigzag, window 4096 + ALiBi": dict(mode="zigzag", window=DYN_WINDOW, alibi=True, row=""),
    "zigzag, window 4096 + ALiBi, split backward": dict(mode="zigzag", window=DYN_WINDOW,
                                                        alibi=True, bwd="split", row=""),
    "ulysses, causal": dict(mode="ulysses"),
    # Gemma-2's local layer: each rank holds two 2,048-row chunks, and the
    # window's left edge cuts the (hi, lo) pairs at offsets read on the card
    "GEMMA2_9B local layer, zigzag, window 4096 + cap 50": dict(
        mode="zigzag", window=GWIN, logit_softcap=CAP, shape=CP_GEMMA_SHAPE, row="_softcap"),
    "GEMMA2_9B local layer, zigzag, window 4096 + cap 50, split backward": dict(
        mode="zigzag", window=GWIN, logit_softcap=CAP, shape=CP_GEMMA_SHAPE, bwd="split",
        row="_softcap"),
    "LLAMA_1B attention, zigzag, ALiBi + dropout 0.1": dict(
        mode="zigzag", alibi=True, dropout_rate=DROP_RATE, dropout_seed=DROP_SEED,
        shape=CP_DROP_SHAPE, plain=True, row="_dropout"),
    "LLAMA_1B attention, zigzag, ALiBi + dropout 0.1, split backward": dict(
        mode="zigzag", alibi=True, dropout_rate=DROP_RATE, dropout_seed=DROP_SEED,
        shape=CP_DROP_SHAPE, plain=True, bwd="split", row="_dropout"),
    "float32, zigzag, window 1024": dict(mode="zigzag", window=1024, shape=CP_F32_SHAPE,
                                         dtype=torch.float32, row="_f32"),
    "float32, zigzag, window 1024, split backward": dict(
        mode="zigzag", window=1024, shape=CP_F32_SHAPE, dtype=torch.float32, bwd="split",
        row="_f32"),
}
CP_PATH_ROWS = tuple(n + row for row in ("",) + tuple(f"_{v}" for v in DYN_VARIANTS)
                     for n in DYNOFF_ROWS)
CP_TRAIN_S = 4096
CP_TRAIN_STEPS = 3
CP_JOIN_S = 900  # the ranks' time limit, joined by the parent
CP_GLOO_S = 300  # a collective's time limit


def cp_ops(mesh, rank: int) -> dict[str, int]:
    """Phase 20 (a) in rank `rank`: each CP_CASES case through
    sharded_ring_attention (the global view, on every rank) and its
    gradients, rank 0 holding them against K1 and the backward on the
    whole sequence in its one process (under the bf16 gates, or float32's),
    or, for a "plain" case, against the same ranks' run on the plain route
    (plain_kernels: the rings' per-pair calls to their plain versions, the
    same folded dropout seeds). Returns the launches of the card-offset
    kernels by kernels-line row (CP_PATH_ROWS)."""
    from flashattn_tpu_torch import parallel

    inputs = {}
    path = dict.fromkeys(CP_PATH_ROWS, 0)
    for name, case in CP_CASES.items():
        kw = {a: x for a, x in case.items()
              if a not in ("bwd", "shape", "dtype", "plain", "row")}
        impl = case.get("bwd", "auto")
        shape, dtype = case.get("shape", CP_OPS_SHAPE), case.get("dtype", torch.bfloat16)
        if (shape, dtype) not in inputs:  # the same inputs on every rank
            gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + len(inputs))
            b, hq, hkv, s, d = shape
            q, do = (randn((b, hq, s, d), gen, dtype) for _ in range(2))
            k, v = (randn((b, hkv, s, d), gen, dtype) for _ in range(2))
            inputs[shape, dtype] = q, k, v, do
        q, k, v, do = inputs[shape, dtype]
        b, hq, hkv, s, d = shape
        desc = f"B={b} Hq={hq} Hkv={hkv} S={s} ({s // CP_WORLD} a rank) D={d} {str(dtype)[6:]}"

        def run():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with (profile_train.backward_impl(impl) if impl != "auto"
                  else contextlib.nullcontext()):
                o = parallel.sharded_ring_attention(*leaves, mesh, True, **kw)
                grads = torch.autograd.grad(o, leaves, do)
            return o.detach(), grads

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        o, grads = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: c for n, c in read_launches().items() if c}
        split = impl == "split"
        check(got.get("flash_fwd", 0) > 0
              and got.get("flash_bwd_dq" if split else "flash_bwd_fused", 0) > 0,
              f"[cp] rank {rank} {name}: launched {got}")
        if "row" in case:
            bwd = ("flash_bwd_dq_dynoff", "flash_bwd_dkv_dynoff") if split else (
                "flash_bwd_fused_dynoff",)
            check(all(got.get(n, 0) > 0 for n in ("flash_fwd_dynoff",) + bwd),
                  f"[cp] rank {rank} {name}: the offset's kernels launched {got}")
            add_launches(path, {n + case["row"]: got.get(n, 0) for n in DYNOFF_ROWS})
        print(f"[cp] rank {rank} {name}, {desc}: forward and gradients in {wall:.2f} s wall "
              f"(two ranks on one card over gloo-host: not a speed), launches {got}", flush=True)
        if case.get("plain"):  # the same ranks on the plain route
            with plain_kernels():
                o_ref, g_ref = run()
            against = "the same ranks on the plain route"
        elif rank == 0:
            opts = {a: kw.get(a) for a in ("window", "logit_softcap")}
            o_ref, lse_ref = flash_fwd.flash_attention_forward(q, k, v, True,
                                                               alibi=kw.get("alibi", False),
                                                               **opts)
            g_ref = flash_bwd.flash_attention_backward(q, k, v, o_ref, do, lse_ref, True,
                                                       impl=impl, alibi=kw.get("alibi", False),
                                                       **opts)
            del lse_ref
            against = "one process's K1 and backward on the whole sequence"
        if rank == 0:
            _gate(f"[cp] {name} O against {against}", o_ref, o,
                  **(F32_TOL if dtype == torch.float32 else dict(atol=O_ATOL)))
            for gname, r, g in zip(("dQ", "dK", "dV"), g_ref, grads):
                grad_gate(f"[cp] {name} {gname} against {against}", r, g, dtype)
        if rank == 0 or case.get("plain"):
            del o_ref, g_ref
        del o, grads
        torch.cuda.empty_cache()
    del inputs
    return path


def cp_train(mesh, rank: int) -> None:
    """Phase 20 (b) in rank `rank`: LLAMA_1B at full width and depth, the
    sequence over sp: CP_TRAIN_STEPS steps of train.train under the mesh
    against the same steps in one process, phase 7's gates (every step's
    loss and grad norm, the last step's gradients' cosines); rank 0 runs
    the one-process side."""
    import itertools

    cfg = LLAMA_1B
    tokens = torch.randint(0, cfg.vocab_size, (1, CP_TRAIN_S + 1),
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 21),
                           device="cuda")

    def model():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 22),
                           device="cuda")

    log = f"[cp-train] rank {rank}"
    m = model()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = train.train(m, itertools.repeat(tokens), TRAIN_TC, steps=CP_TRAIN_STEPS,
                              log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: c for n, c in read_launches().items() if c}
    # The contiguous causal ring: rank r runs r + 1 hops a layer a step.
    hops = (rank + 1) * cfg.num_layers * CP_TRAIN_STEPS
    check(got.get("flash_fwd") == hops
          and got.get("flash_bwd_fused", 0) + got.get("flash_bwd_dq", 0) == hops,
          f"{log}: the mesh's steps launched {got}, want {hops} K1 and backward launches")
    losses = [h["loss"] for h in hist]
    print(f"{log}: LLAMA_1B {cfg.num_layers} layers, S={CP_TRAIN_S} over sp {CP_WORLD} "
          f"({CP_TRAIN_S // CP_WORLD} a rank), train.train under the mesh, {CP_TRAIN_STEPS} "
          f"AdamW steps in {wall:.1f} s wall (not a speed): losses {losses}, grad norms "
          f"{[h['grad_norm'] for h in hist]}, launches {got}", flush=True)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{log}: losses {losses}")
    if rank == 0:  # one process, the same steps from the same weights
        ref_model = model()
        ref_state, ref = train.train(ref_model, itertools.repeat(tokens), TRAIN_TC,
                                     steps=CP_TRAIN_STEPS, log_every=1)
        for h, r in zip(hist, ref):
            dl = abs(h["loss"] - r["loss"])
            dn = abs(h["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
            print(f"[cp-train] step {h['step']}: loss {h['loss']:.6f} vs one process "
                  f"{r['loss']:.6f} (|d| {dl:.6f} <= {LOSS_ATOL}), grad_norm "
                  f"{h['grad_norm']:.6f} vs {r['grad_norm']:.6f} (rel {dn:.6f} <= "
                  f"{GRAD_NORM_REL})", flush=True)
            check(dl <= LOSS_ATOL and dn <= GRAD_NORM_REL,
                  f"[cp-train] step {h['step']}: the mesh and one process disagree")
        # The last step's gradients (summed over the ranks, then clipped by
        # one factor: their directions are the raw gradients').
        ref_grads = dict(ref_model.named_parameters())
        cos = {n: float(F.cosine_similarity(p.grad.float().flatten(),
                                            ref_grads[n].grad.float().flatten(), dim=0))
               for n, p in m.named_parameters()}
        worst = min(cos, key=cos.get)
        print(f"[cp-train] step {CP_TRAIN_STEPS}'s gradients, the mesh vs one process: cosine "
              f"min {cos[worst]:.6f} ({worst}) over {len(cos)} parameters (> {GRAD_COS})",
              flush=True)
        check(cos[worst] > GRAD_COS, "[cp-train] the mesh's gradients disagree with one "
              "process's")
        del ref_model, ref_state
    del m, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()


def cp_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 20: joins the gloo group, runs (a) and (b) and
    writes the launches of the offset kernels' path to `out`/rank<r>.pt.
    Raises on any failed gate: the process then exits nonzero."""
    from flashattn_tpu_torch import parallel
    from flashattn_tpu_torch.parallel.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize_distributed("gloo", f"file://{store}", world, rank, timeout=CP_GLOO_S)
    mesh = parallel.make_mesh({"sp": world})
    if rank == 0:
        print(f"[cp] {world} ranks on {torch.cuda.get_device_name(0)} (cuda:0, shared), "
              f"process group gloo, transport of their exchanges: "
              f"{transport(mesh.group('sp'), torch.device('cuda'))}", flush=True)
    path = cp_ops(mesh, rank)
    torch.distributed.barrier()
    cp_train(mesh, rank)
    torch.save(path, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def spawn_ranks(target, world: int, tag: str) -> list:
    """Runs target(rank, world, store, out) in `world` processes started
    with spawn (CUDA cannot be forked) after phase 1's build, joined within
    CP_JOIN_S seconds; a rank that fails or hangs fails the phase, and none
    outlives it. Returns what each rank saved as out/rank<r>.pt."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=target, args=(r, world, store, tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + CP_JOIN_S
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one failed: the other would wait on it until its timeout
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"{tag} the ranks exited with {codes} (a rank failed, or "
              f"passed {CP_JOIN_S} s)")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]


def phase_context_parallel() -> dict[str, int]:
    """Phase 20 (the comment above): CP_WORLD ranks of cp_rank
    (spawn_ranks). Returns the offset kernels' launches on (a)'s zigzag
    paths by kernels-line row (the window + ALiBi, the soft-cap, dropout and
    float32 cases), summed over the ranks."""
    launches = dict.fromkeys(CP_PATH_ROWS, 0)
    for got in spawn_ranks(cp_rank, CP_WORLD, "[cp]"):
        add_launches(launches, got)
    print(f"[cp] the offset's kernels on (a)'s zigzag paths, both ranks: {launches}")
    return launches


# Phase 21: tensor, pipeline and expert parallelism, sequence- and
# heads-split decode, and recovery (phase_parallel). Two ranks share cuda:0
# over gloo-host, as phase 20's do.
PAR_WORLD = 2
PAR_TRAIN = (4, 2048)  # LLAMA_1B training: B, S
PAR_STEPS = 3
PAR_MICROBATCHES = 4  # of the pipeline's B 4: 1 row each
PAR_DEC = (4, 32, 8, 32768, 128)  # LLAMA31_8B's decode attention: B, Hq, Hkv, Smax, D
PAR_DEC_LENGTHS = [32768, 24000, 17000, 9000]  # the last ends in rank 0's half (16,384)
PAR_MOE_T = 2000  # the FFN alone: tokens (1,000 a rank under the a2a dispatch)
PAR_MOE_CF = 8.0  # capacity factor of the FFN's a2a dispatch (TINY_MOE's): no pair dropped
PAR_MOE_LAYERS = 2  # Qwen3-30B-A3B's widths in float32, depth cut to 2
# The model's a2a capacity factor: E / k makes a queue as long as a rank's
# tokens, so no pick is dropped whatever the routing (at 8, layer 1 of the
# random model sends more than a queue's 1,024 slots to one expert).
PAR_MOE_MODEL_CF = QWEN3_30B_A3B_JSON["num_experts"] / QWEN3_30B_A3B_JSON["num_experts_per_tok"]
PAR_MOE_S = 2048
PAR_RECOVER_LAYERS = 2  # LLAMA_1B's widths for resilient_train
PAR_RECOVER_STEPS = 6
PAR_RECOVER_AT = 3  # the step whose loss is replaced by NaN, once
PAR_MOE_ULPS = 2  # the FFN's gate: bf16 steps of the largest output


def par_sub(log: str, what: str, t0: float) -> None:
    torch.cuda.synchronize()
    print(f"{log} {what}: {time.perf_counter() - t0:.1f} s", flush=True)


def par_train(rank: int, ckpt: str) -> dict[str, int]:
    """Phase 21 (a) in rank `rank`: LLAMA_1B at full width and depth, B 4,
    S 2048, bf16, on the same tokens and weights: the collective probe;
    PAR_STEPS steps of train.train under {"model": 2} (the rank's
    shard_params shard, the fused backward), then save_checkpoint under
    the mesh to `ckpt`; PAR_STEPS AdamW steps (train.make_optimizer)
    through pipeline_loss_fn under {"pp": 2} (11 layers a stage,
    PAR_MICROBATCHES microbatches, the split backward selected by
    FLASHATTN_BWD_IMPL). Rank 0 holds both against the same steps in one
    process (phase 7's gates: each step's loss and grad norm, the last
    step's gradients' cosines; finite losses, the last below the first)
    and restores the model run's checkpoint into one process. Returns the
    runs' launches."""
    import itertools

    from flashattn_tpu_torch import parallel
    from flashattn_tpu_torch.parallel.mesh import full_tensor
    from flashattn_tpu_torch.utils.failure import probe_collectives

    cfg = LLAMA_1B
    b, s = PAR_TRAIN
    log = f"[par-train] rank {rank}"
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1),
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 23),
                           device="cuda")

    def model():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 24),
                           device="cuda")

    tp = parallel.make_mesh({"model": PAR_WORLD})
    pp = parallel.make_mesh({"pp": PAR_WORLD})
    t0 = time.perf_counter()
    check(probe_collectives(tp, timeout_s=60.0), f"{log}: the collective probe failed")
    print(f"{log}: probe_collectives over {PAR_WORLD} ranks healthy in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    whole = model()
    total: dict[str, int] = {}
    shape = f"LLAMA_1B {cfg.num_layers} layers, B={b} S={s} bf16"

    shard = llama.shard_params(whole, tp)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, hist_tp = train.train(shard, itertools.repeat(tokens), TRAIN_TC, steps=PAR_STEPS,
                                 log_every=1, mesh=tp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: c for n, c in read_launches().items() if c}
    t0 = time.perf_counter()
    train.save_checkpoint(ckpt, state, mesh=tp)
    save_s = time.perf_counter() - t0
    want = cfg.num_layers * PAR_STEPS
    check(got.get("flash_fwd") == want and got.get("flash_bwd_fused") == want,
          f"{log}: the model axis's steps launched {got}, want {want} K1 and B3 launches")
    add_launches(total, got)
    print(f"{log}: {shape} under model 2 (Hq {cfg.num_heads // PAR_WORLD}, Hkv "
          f"{cfg.num_kv_heads // PAR_WORLD}, F {cfg.intermediate_size // PAR_WORLD}, vocab "
          f"{cfg.vocab_size // PAR_WORLD} a rank), train.train {PAR_STEPS} AdamW steps in "
          f"{wall:.1f} s, save_checkpoint (the whole model and its AdamW state) in {save_s:.1f} "
          f"s wall (two ranks on one card over gloo-host: not a speed): "
          f"losses {[h['loss'] for h in hist_tp]}, grad norms "
          f"{[h['grad_norm'] for h in hist_tp]}, launches {got}", flush=True)
    specs = shard.shardings()
    grads_tp = {n: full_tensor(p.grad, specs[n], tp) for n, p in shard.named_parameters()}
    params_tp = {n: full_tensor(p.detach(), specs[n], tp) for n, p in shard.named_parameters()}
    del state, shard

    pm = llama.stack_pipeline_params(whole, PAR_WORLD, pp)
    del whole
    opt, sched = train.make_optimizer(pm, TRAIN_TC)
    hist_pp = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with profile_train.backward_impl("split"):
        for step in range(1, PAR_STEPS + 1):
            opt.zero_grad(set_to_none=True)
            loss = llama.pipeline_loss_fn(pm, tokens, pp, PAR_MICROBATCHES)
            loss.backward()
            llama.reduce_gradients(pm, pp)
            gnorm = llama.global_grad_norm(pm, pp)
            train.clip_by_global_norm_([p.grad for p in pm.parameters()], gnorm,
                                       TRAIN_TC.grad_clip)
            opt.step()
            sched.step()
            hist_pp.append({"step": step, "loss": float(loss.detach()),
                            "grad_norm": float(gnorm)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: c for n, c in read_launches().items() if c}
    ticks = PAR_MICROBATCHES + PAR_WORLD - 1
    want = ticks * pm.layers_per_stage * PAR_STEPS  # every tick runs the stage, and its backward
    check(got.get("flash_fwd") == want and got.get("flash_bwd_dq") == want
          and got.get("flash_bwd_dkv") == want and not got.get("flash_bwd_fused"),
          f"{log}: the pipeline's steps launched {got}, want {want} K1, B4 and B5 launches")
    add_launches(total, got)
    print(f"{log}: {shape} under pp 2 ({pm.layers_per_stage} layers a stage, "
          f"{PAR_MICROBATCHES} microbatches, {ticks} ticks a step), {PAR_STEPS} AdamW steps in "
          f"{wall:.1f} s wall (not a speed): losses {[h['loss'] for h in hist_pp]}, grad norms "
          f"{[h['grad_norm'] for h in hist_pp]}, launches {got}", flush=True)
    k = pm.layers_per_stage
    grads_pp = {}
    for n, p in pm.named_parameters():
        if n.startswith("stages."):
            g = full_tensor(p.grad, ("pp",) + (None,) * (p.dim() - 1), pp)
            for st in range(PAR_WORLD):
                for i in range(k):
                    grads_pp[f"layers.{st * k + i}.{n[len('stages.'):]}"] = g[st, i]
        else:
            grads_pp[n] = p.grad
    del pm, opt, sched
    for hist in (hist_tp, hist_pp):
        losses = [h["loss"] for h in hist]
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{log}: losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if rank == 0:
        ref_model = model()
        ref_state, ref = train.train(ref_model, itertools.repeat(tokens), TRAIN_TC,
                                     steps=PAR_STEPS, log_every=1)
        ref_grads = {n: p.grad for n, p in ref_model.named_parameters()}
        for tag, hist, grads in (("model 2", hist_tp, grads_tp), ("pp 2", hist_pp, grads_pp)):
            for h, r in zip(hist, ref):
                dl = abs(h["loss"] - r["loss"])
                dn = abs(h["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
                print(f"[par-train] {tag} step {h['step']}: loss {h['loss']:.6f} vs one process "
                      f"{r['loss']:.6f} (|d| {dl:.6f} <= {LOSS_ATOL}), grad_norm "
                      f"{h['grad_norm']:.6f} vs {r['grad_norm']:.6f} (rel {dn:.6f} <= "
                      f"{GRAD_NORM_REL})", flush=True)
                check(dl <= LOSS_ATOL and dn <= GRAD_NORM_REL,
                      f"[par-train] {tag} step {h['step']}: the mesh and one process disagree")
            check(set(grads) == set(ref_grads), f"[par-train] {tag}: gradients of other names")
            cos = {n: float(F.cosine_similarity(g.float().flatten(),
                                                ref_grads[n].float().flatten(), dim=0))
                   for n, g in grads.items()}
            worst = min(cos, key=cos.get)
            print(f"[par-train] {tag} step {PAR_STEPS}'s gradients (gathered) vs one process: "
                  f"cosine min {cos[worst]:.6f} ({worst}) over {len(cos)} parameters "
                  f"(> {GRAD_COS})", flush=True)
            check(cos[worst] > GRAD_COS, f"[par-train] {tag}: the gradients disagree with one "
                  "process's")
        del ref_state, ref_model, ref_grads, grads_tp, grads_pp
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 25),
                          device="cuda")
        restored = train.restore_checkpoint(ckpt, train.init_train_state(one, TRAIN_TC))
        same = all(torch.equal(p.detach(), params_tp[n]) for n, p in one.named_parameters())
        moments = restored["optimizer"].state_dict()["state"]
        check(restored["step"] == PAR_STEPS and same
              and all(m["exp_avg"].shape == p.shape
                      for m, p in zip(moments.values(), one.parameters())),
              "[par-train] the model axis's checkpoint does not restore into one process")
        print(f"[par-train] the model 2 run's checkpoint (the whole model and its AdamW state, "
              f"gathered, written by rank 0) restored into one process in "
              f"{time.perf_counter() - t0:.1f} s: step {restored['step']}, every parameter "
              f"equal to the ranks' gathered ones", flush=True)
        del restored, one
    del params_tp
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return total


def par_decode(rank: int) -> dict[str, int]:
    """Phase 21 (b) in rank `rank`: LLAMA31_8B's decode attention (PAR_DEC)
    on a cache of PAR_DEC positions with PAR_DEC_LENGTHS. bf16, int8 and fp8
    caches through sharded_decode_attention over sp 2 (16,384 positions a
    rank; rank 1 holds none of the last sequence), held by rank 0 against
    one process's K2 over the whole cache (O_ATOL, QUANT_DECODE_TOL); then
    the bf16 cache dense and as a scrambled pool of PAGE-token pages
    (paged_copy) split over heads under {"model": 2}, each rank's block gathered
    and held by rank 0 bit for bit against one process's K2 on the same
    heads, and against K2 over every head at O_ATOL (not bit for bit: K2's
    split count follows the kv heads, _num_splits). Returns the launches
    of the split calls."""
    from flashattn_tpu_torch import parallel
    from flashattn_tpu_torch.parallel import serving
    from flashattn_tpu_torch.parallel.mesh import full_tensor, local_block

    b, hq, hkv, smax, d = PAR_DEC
    log = f"[par-decode] rank {rank}"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    kn, vn = randn((b, hkv, smax, d), gen), randn((b, hkv, smax, d), gen)
    q = randn((b, hq, d), gen)
    lengths = torch.tensor(PAR_DEC_LENGTHS, dtype=torch.int32, device="cuda")
    sp = parallel.make_mesh({"sp": PAR_WORLD})
    tp = parallel.make_mesh({"model": PAR_WORLD})
    total: dict[str, int] = {}
    shape = f"B={b} Hq={hq} Hkv={hkv} D={d} Smax={smax} lengths {PAR_DEC_LENGTHS}"
    local = serving.local_cache_lengths(lengths, PAR_WORLD, smax // PAR_WORLD).tolist()
    bf16_cache = None
    for quant in (None, "int8", "fp8"):
        cache = kvcache.init_cache(b, hkv, smax, d, quant=quant)
        kvcache.update_cache(cache, kn, vn, assume_fits=True)
        cache.length.copy_(lengths)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        o = serving.sharded_decode_attention(q, cache, sp)
        torch.cuda.synchronize()
        got = {n: c for n, c in read_launches().items() if c}
        mode = quant or "bf16"
        want = {"decode_lse": 1, {None: "decode", "int8": "decode_int8",
                                  "fp8": "decode_fp8"}[quant]: 1}
        check(got == want, f"{log} {mode}: the split decode launched {got}, want {want}")
        add_launches(total, got)
        print(f"{log} {mode} cache {shape}, split over sp 2 (local lengths {local}): "
              f"sharded_decode_attention in {(time.perf_counter() - t0) * 1e3:.1f} ms wall "
              f"(not a speed), launches {got}", flush=True)
        if rank == 0:
            whole = decode.decode_attention(q, cache)
            tol = dict(atol=O_ATOL) if quant is None else QUANT_DECODE_TOL
            _gate(f"[par-decode] {mode} cache split over sp 2, merged by the LSE rule, against "
                  f"one process's K2 over the whole cache", whole, o, **tol)
        if quant is None:
            bf16_cache = cache
        else:
            del cache
    pool = paged_copy(bf16_cache, gen)
    for name, c, call, paged_ in (
            ("dense", bf16_cache, decode.decode_attention, False),
            ("paged", pool, paged.paged_decode_attention, True)):
        part = serving.local_cache(c, serving.head_specs("model", paged_), tp)
        q_l = local_block(q, (None, "model"), tp).contiguous()
        torch.cuda.synchronize()
        reset_launches()
        o_l = call(q_l, part)
        torch.cuda.synchronize()
        got = {n: v for n, v in read_launches().items() if v}
        key = "paged_decode" if paged_ else "decode"
        check(got == {key: 1}, f"{log} {name} heads split: launched {got}")
        add_launches(total, got)
        o = full_tensor(o_l, (None, "model"), tp)
        print(f"{log} bf16 {name} cache split over model 2 ({hkv // PAR_WORLD} kv heads a "
              f"rank): launches {got}", flush=True)
        if rank == 0:
            h = hq // PAR_WORLD
            for r in range(PAR_WORLD):
                ref = call(q[:, r * h:(r + 1) * h].contiguous(), serving.local_cache(
                    c, serving.head_specs("model", paged_), _MeshAt(tp, r)))
                check(torch.equal(o[:, r * h:(r + 1) * h], ref),
                      f"[par-decode] {name}: rank {r}'s heads differ from one process's K2 on them")
            _gate(f"[par-decode] bf16 {name} cache split over heads against one process's K2 "
                  f"over every head", call(q, c), o, O_ATOL)
            print(f"[par-decode] bf16 {name} cache split over model 2: each rank's heads "
                  f"torch.equal to one process's K2 on the same heads", flush=True)
    del bf16_cache, pool
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return total


class _MeshAt:
    """A mesh's sizes read at another rank's coordinates along one axis
    (to cut that rank's block in this process)."""

    def __init__(self, mesh, index: int):
        self.mesh, self.at = mesh, index

    def size(self, axis: str) -> int:
        return self.mesh.size(axis)

    def index(self, axis: str) -> int:
        return self.at


def par_experts(rank: int) -> dict[str, int]:
    """Phase 21 (c) in rank `rank`: Qwen3-30B-A3B's MoE FFN at layer 0's
    widths (128 experts, top 8, H 2048, I 768), bf16, T PAR_MOE_T tokens
    over ep 2: moe_ffn (the rank's 64 experts over every token) and
    moe_ffn_a2a (1,000 tokens a rank, capacity factor PAR_MOE_CF) against
    moe_ffn_grouped in one process on rank 0: the same picks, the outputs
    within PAR_MOE_ULPS bf16 steps of the largest output (the experts'
    float32 sums in another order, rounded to bf16), the a2a's dropped
    pairs counted; then the model's widths cut to PAR_MOE_LAYERS layers in
    float32, B 1, S PAR_MOE_S: one AdamW train_step under {"ep": 2} (the
    a2a dispatch at PAR_MOE_MODEL_CF, no pick dropped), its forward's
    logits against one process's under the logits rule, free-running
    (phase 16's float32 run), and phase 22 (d)'s gates on the step
    (par_expert_step). Returns the step's launches."""
    from flashattn_tpu_torch import parallel
    from flashattn_tpu_torch.parallel.collectives import gather_from_group
    from flashattn_tpu_torch.parallel.mesh import local_block

    log = f"[par-moe] rank {rank}"
    ep = parallel.make_mesh({"ep": PAR_WORLD})
    group = ep.group("ep")
    cfg = moe_hf_config(QWEN3_30B_A3B_JSON)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    params = moe.init_moe_params(gen, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
                                 torch.bfloat16)
    x = randn((PAR_MOE_T, cfg.hidden_size), gen)
    k = cfg.top_k_experts
    local = {n: (v if n == "router" else local_block(v, ("ep", None, None), ep).contiguous())
             for n, v in params.items()}
    x_l = local_block(x, ("ep",), ep).contiguous()
    with torch.no_grad():
        t0 = time.perf_counter()
        dense = moe.moe_ffn(x, local, k, group, norm_topk=cfg.moe_norm_topk)
        par_sub(log, f"moe_ffn (masked-dense, {cfg.num_experts // PAR_WORLD} experts a rank "
                f"over all {PAR_MOE_T} tokens) wall, not a speed", t0)
        t0 = time.perf_counter()
        a2a_l = moe.moe_ffn_a2a(x_l, local, k, group, capacity_factor=PAR_MOE_CF,
                                norm_topk=cfg.moe_norm_topk)
        par_sub(log, f"moe_ffn_a2a ({PAR_MOE_T // PAR_WORLD} tokens a rank) wall, not a speed",
                t0)
        a2a = gather_from_group(a2a_l, group, 0)
        ids_l, _ = moe.router_gates(x_l, params["router"], k, cfg.moe_norm_topk)
        cap = moe.default_capacity(PAR_MOE_CF, k, x_l.shape[0], cfg.num_experts)
        dropped = int((~moe.capacity_slots(ids_l, cfg.num_experts, cap)[1]).sum())
        print(f"{log}: the a2a dispatch's capacity {cap} a (expert, rank) queue, {dropped} of "
              f"{ids_l.numel()} (token, pick) pairs dropped", flush=True)
        check(dropped == 0, f"{log}: the a2a dispatch dropped {dropped} pairs")
        if rank == 0:
            ref = moe.moe_ffn_grouped(x, params, k, norm_topk=cfg.moe_norm_topk)
            # the a2a routes rank 0's 1,000 tokens on their own (another product's rounding):
            # a pick that differs must be a near-tie the router logits explain (pick_margins)
            half = slice(0, PAR_MOE_T // PAR_WORLD)
            ids, _ = moe.router_gates(x, params["router"], k, cfg.moe_norm_topk)
            moved = int((torch.sort(ids[half], -1).values
                         != torch.sort(ids_l, -1).values).any(-1).sum())
            ratio, pairs = pick_margins(torch.matmul(x_l.float(), params["router"].float()),
                                        torch.matmul(x.float(), params["router"].float())[half],
                                        ids_l, ids[half])
            print(f"[par-moe] rank 0's tokens: picks of the a2a's router against one "
                  f"process's: {moved} of {PAR_MOE_T // PAR_WORLD} tokens differ ({int(pairs)} "
                  f"pairs, worst pick_margins ratio {float(ratio):.3f} <= 1); moe_ffn's router "
                  f"sees every token, as one process's", flush=True)
            check(float(ratio) <= 1.0, "[par-moe] the a2a's picks differ beyond a near-tie")
            lim = PAR_MOE_ULPS * 2.0**-7 * float(ref.float().abs().max())
            for name, out in (("moe_ffn", dense), ("moe_ffn_a2a", a2a)):
                err = float((out.float() - ref.float()).abs().max())
                print(f"[par-moe] {name} over ep 2 against moe_ffn_grouped in one process, "
                      f"T={PAR_MOE_T}: max|d| {err:.6f} (<= {lim:.6f}, {PAR_MOE_ULPS} bf16 steps "
                      f"of the largest output {float(ref.float().abs().max()):.4f})", flush=True)
                check(err <= lim, f"[par-moe] {name} disagrees with the grouped dispatch")
    del params, local, dense, a2a
    cfg32 = dataclasses.replace(moe_hf_config(QWEN3_30B_A3B_JSON, torch.float32,
                                              layers=PAR_MOE_LAYERS),
                                moe_capacity_factor=PAR_MOE_MODEL_CF)
    tokens = torch.randint(0, cfg32.vocab_size, (1, PAR_MOE_S + 1),
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 29),
                           device="cuda")
    got = par_expert_step(rank, ep, cfg32, tokens)
    torch.distributed.barrier()
    return got


# Phase 21 (c)'s float32 model and phase 22 (d): one AdamW step of the cut
# under {"ep": 2}. Its first step runs at the full learning rate (no
# warmup), so the updates are compared too.
PAR_MOE_TC = train.TrainConfig(learning_rate=3e-4, warmup_steps=0, total_steps=6)
PAR_MOE_SEED = SEED + 28  # the whole float32 model's weights


def cosines(a: dict[str, torch.Tensor], b: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each named tensor's cosine between two maps, in float32."""
    return {n: float(F.cosine_similarity(a[n].float().flatten(), b[n].float().flatten(), dim=0))
            for n in a}


@contextlib.contextmanager
def model_logits(out: list):
    """Records the logits of each llama.forward call made while active (a
    train step's forward: loss_fn's)."""
    saved = llama.forward

    def forward(*args, **kw):
        logits = saved(*args, **kw)
        out.append(logits.detach())
        return logits

    llama.forward = forward
    try:
        yield out
    finally:
        llama.forward = saved


def par_expert_step(rank: int, ep, cfg, tokens) -> dict[str, int]:
    """The model part of phase 21 (c) and phase 22 (d), in rank `rank` of
    phase 21's two: one AdamW train.train_step of `cfg` (Qwen3-30B-A3B's
    widths cut to PAR_MOE_LAYERS layers, float32, B 1, S PAR_MOE_S) under
    {"ep": 2}, each rank its block of every layer's experts, the a2a
    dispatch at PAR_MOE_MODEL_CF (the dropped pairs counted: none), against
    one process's train_step from the same weights on the same tokens. The
    step's forward logits against one process's under the logits rule,
    free-running (phase 21 (c)'s gate, phase 16's float32 run; printed by
    rank 0); then phase 7's gates: the loss, the grad norm, every
    gradient's cosine (the rank's expert blocks against the same blocks of
    the whole model's) and every parameter's update (its value after the
    step less its value before). Two ranks on one card cannot hold both
    models beside the ep step's AdamW state and activations (the reckoning
    prints), so each side draws the weights from PAR_MOE_SEED, and the
    ranks compare in turn. Returns the ep step's launches."""
    from flashattn_tpu_torch.parallel.mesh import local_block

    log = f"[par-moe] rank {rank}"
    specs = llama.param_shardings(cfg)

    def drawn():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(PAR_MOE_SEED),
                           device="cuda")

    shard = llama.shard_params(drawn(), ep)
    n_shard = sum(p.numel() for p in shard.parameters())
    n_whole = sum(p.numel() for p in llama.Llama(cfg, device="meta").parameters())
    if rank == 0:
        print(f"[par-moe] memory, reckoned (float32, 4 B a value): the ep step holds on each "
              f"rank its shard ({n_shard / 1e9:.3f} B parameters), their gradients and AdamW's "
              f"two moments, {16 * n_shard / 1e9:.1f} GB, {2 * 16 * n_shard / 1e9:.1f} GB for "
              f"both ranks, plus each rank's activations and a2a queues; a rank's comparison "
              f"then keeps the step's gradients and parameters ({8 * n_shard / 1e9:.1f} GB a "
              f"rank) and runs one process's step ({n_whole / 1e9:.3f} B parameters: "
              f"{16 * n_whole / 1e9:.1f} GB, and {4 * n_shard / 1e9:.1f} GB of its blocks "
              f"before the step)", flush=True)
    state = train.init_train_state(shard, PAR_MOE_TC)
    drops = []
    slots = moe.capacity_slots

    def counted(ids, e, capacity):
        dest, keep = slots(ids, e, capacity)
        drops.append(int((~keep).sum()))
        return dest, keep

    shape = (1, cfg.num_heads, cfg.num_kv_heads, PAR_MOE_S, PAR_MOE_S, cfg.head_dim, True,
             cfg.dtype)
    impl = flash_bwd.resolve_impl("auto", shape)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    moe.capacity_slots = counted
    try:
        with model_logits([]) as logits:
            state, metrics = train.train_step(state, tokens, mesh=ep)
    finally:
        moe.capacity_slots = slots
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got = {n: c for n, c in read_launches().items() if c}
    want = {"flash_fwd": cfg.num_layers, **backward_launches(impl, cfg.num_layers)}
    check(got == want, f"{log}: the ep train step launched {got}, want {want}")
    print(f"{log}: Qwen3-30B-A3B widths, {cfg.num_layers} layers, float32, B=1 S={PAR_MOE_S}, "
          f"AdamW train_step under ep 2 ({cfg.num_experts // PAR_WORLD} experts a rank, the a2a "
          f"dispatch, capacity factor {PAR_MOE_MODEL_CF:g}: dropped pairs by layer {drops}) in "
          f"{step_s:.1f} s wall (not a speed): loss {loss:.6f} grad_norm {gnorm:.6f}, launches "
          f"{got}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(drops == [0] * cfg.num_layers, f"{log}: the a2a dropped {drops}")
    grads = {n: p.grad for n, p in shard.named_parameters()}
    after = {n: p.detach() for n, p in shard.named_parameters()}
    del state, shard
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    for turn in range(PAR_WORLD):
        if rank == turn:
            whole = drawn()
            start = {n: local_block(p.detach(), specs[n], ep).clone()
                     for n, p in whole.named_parameters()}
            with model_logits([]) as ref_logits:
                ref_state, ref = train.train_step(train.init_train_state(whole, PAR_MOE_TC),
                                                  tokens)
            l_ref, n_ref = float(ref["loss"]), float(ref["grad_norm"])
            if rank == 0:
                compare_logits(f"float32, {cfg.num_layers} layers, the train step's forward under "
                               "ep 2 against one process's (free-running routes)", logits,
                               ref_logits, [f"prefill S={PAR_MOE_S}"], model="Qwen3-30B-A3B")
            g_ref = {n: local_block(p.grad, specs[n], ep) for n, p in whole.named_parameters()}
            p_ref = {n: local_block(p.detach(), specs[n], ep)
                     for n, p in whole.named_parameters()}
            cos_g = cosines(grads, g_ref)
            cos_u = cosines({n: after[n] - start[n] for n in after},
                            {n: p_ref[n] - start[n] for n in p_ref})
            moved = max(float((after[n] - p_ref[n]).abs().max()) for n in p_ref)
            wg, wu = min(cos_g, key=cos_g.get), min(cos_u, key=cos_u.get)
            print(f"[par-moe-train] rank {rank}: the ep step against one process's step "
                  f"({n_whole / 1e9:.3f} B parameters, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB): |dloss| "
                  f"{abs(loss - l_ref):.3e} (<= {LOSS_ATOL}), grad_norm rel "
                  f"{abs(gnorm - n_ref) / n_ref:.3e} (<= {GRAD_NORM_REL}); over this rank's "
                  f"{len(cos_g)} parameters (its blocks of the experts) the gradient cosine min "
                  f"{cos_g[wg]:.6f} ({wg}), the update's cosine min {cos_u[wu]:.6f} ({wu}) "
                  f"(> {GRAD_COS}); parameters after the step max|d| {moved:.3e} (the learning "
                  f"rate {PAR_MOE_TC.learning_rate:g})", flush=True)
            check(abs(loss - l_ref) <= LOSS_ATOL and abs(gnorm - n_ref) <= GRAD_NORM_REL * n_ref
                  and cos_g[wg] > GRAD_COS and cos_u[wu] > GRAD_COS,
                  f"{log}: the ep step disagrees with one process's")
            del ref_state, whole, start, g_ref, p_ref, ref_logits
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    del grads, after, logits
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        print(f"[par-moe] the float32 cut: the ep step and both ranks' comparisons in "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    return got


def par_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 21: joins the gloo group, runs (a), (b) and (c)
    and writes their launches to `out`/rank<r>.pt. Raises on any failed
    gate: the process then exits nonzero."""
    from flashattn_tpu_torch import parallel
    from flashattn_tpu_torch.parallel.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize_distributed("gloo", f"file://{store}", world, rank, timeout=CP_GLOO_S)
    if rank == 0:
        print(f"[par] {world} ranks on {torch.cuda.get_device_name(0)} (cuda:0, shared), "
              f"process group gloo, transport of their exchanges: "
              f"{transport(None, torch.device('cuda'))}", flush=True)
    total: dict[str, int] = {}
    for sub, fn in (("(a) training", lambda: par_train(rank, os.path.join(out, "ckpt"))),
                    ("(b) decode", lambda: par_decode(rank)),
                    ("(c) experts", lambda: par_experts(rank))):
        t0 = time.perf_counter()
        add_launches(total, fn())
        if rank == 0:
            print(f"[par] {sub}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(total, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def par_recovery() -> dict[str, int]:
    """Phase 21 (d), in this process: resilient_train on LLAMA_1B's widths
    cut to PAR_RECOVER_LAYERS layers, B 2, S 2048, PAR_RECOVER_STEPS
    AdamW steps with a checkpoint every 2, the loss of step
    PAR_RECOVER_AT replaced by NaN once: exactly one recovery event (kind
    nonfinite, restored to step 2), the step count reached, finite
    parameters; the step timer reads each step after its loss is read
    back."""
    from flashattn_tpu_torch.utils.failure import StepTimer, resilient_train

    cfg = dataclasses.replace(LLAMA_1B, num_layers=PAR_RECOVER_LAYERS)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 30), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    left = [1]

    def batches():
        while True:
            yield torch.randint(0, cfg.vocab_size, (2, 2049), generator=gen, device="cuda")

    def step_fn(state, batch):
        state, metrics = train.train_step(state, batch)
        if state["step"] == PAR_RECOVER_AT and left[0]:
            left[0] -= 1
            metrics = dict(metrics, loss=torch.full_like(metrics["loss"], float("nan")))
        return state, metrics

    timer = StepTimer(factor=100.0, calibrate=2, patience=3)
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        state, events = resilient_train(train.init_train_state(model, TRAIN_TC), batches(),
                                        step_fn, steps=PAR_RECOVER_STEPS, ckpt_dir=ckpt,
                                        ckpt_every=2, max_recoveries=2, step_timer=timer)
    torch.cuda.synchronize()
    got = {n: c for n, c in read_launches().items() if c}
    print(f"[par-recover] LLAMA_1B widths, {cfg.num_layers} layers, B=2 S=2048: "
          f"resilient_train {PAR_RECOVER_STEPS} steps with a NaN loss at step "
          f"{PAR_RECOVER_AT} in {time.perf_counter() - t0:.1f} s: events "
          f"{[(e.step, e.kind, e.restored_step) for e in events]}, step {state['step']}, "
          f"launches {got}", flush=True)
    check(len(events) == 1 and events[0].kind == "nonfinite" and events[0].restored_step == 2
          and state["step"] == PAR_RECOVER_STEPS
          and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "[par-recover] resilient_train did not recover once and reach its step count")
    # every step ran the layers, the failed one and the steps after the restore included
    n = (PAR_RECOVER_STEPS + 1) * cfg.num_layers
    check(got.get("flash_fwd") == n, f"[par-recover] launched {got}, want {n} K1 launches")
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return got


def phase_parallel() -> dict[str, int]:
    """Phase 21 (the comment above): PAR_WORLD ranks of par_rank
    (spawn_ranks), then (d) in this process. Returns the launches of every
    path, summed over the ranks."""
    launches: dict[str, int] = {}
    for got in spawn_ranks(par_rank, PAR_WORLD, "[par]"):
        add_launches(launches, got)
    t0 = time.perf_counter()
    add_launches(launches, par_recovery())
    print(f"[par] (d) recovery: {time.perf_counter() - t0:.1f} s")
    print(f"[par] phase 21's launches, both ranks and (d): {launches}")
    return launches


# Phase 22: mixture-of-experts training (phase_moe_train). Qwen3-30B-A3B's
# and Qwen1.5-MoE-A2.7B's config.json widths (QWEN3_30B_A3B_JSON,
# QWEN15_MOE_JSON), their depth cut; random weights from the seed. AdamW
# keeps its moments in the parameters' type: 8 B a parameter in bf16, 16 in
# float32; Qwen3-30B-A3B's 48 layers (30.5 B parameters) cannot train on
# one card.
MOE_TRAIN_S = 2048
MOE_TRAIN_LAYERS = 4  # (a) bf16, kernels against the plain route
MOE_TRAIN_F32_LAYERS = 2  # (b) float32, each preset
MOE_TRAINER_LAYERS = 8  # (c) 5.61 B parameters, 44.9 GB of weights, gradients and moments
MOE_TRAINER_S = 4096
MOE_TRAINER_STEPS = 6
MOE_TRAINER_RESERVE = 20e9  # (c)'s activations, logits and AdamW's temporaries, reckoned
MOE_GMM_T = 2048  # the grouped products' backward against the per-expert loop
MOE_FFN_T = 4096  # two runs of the FFN's backward, and its times
GMM_F32_TOL = dict(atol=1e-5, rtol=1e-4)
MOE_ODD_COUNTS = [0, 1, 3, 17, 0, 5, 129, 2] * 16  # rows an expert: empty, and off 8 and 16


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def backward_launches(impl: str, layers: int) -> dict[str, int]:
    """The backward kernels' launches of `layers` attention backwards on
    `impl` ("fused": B3; "split": B4 and B5)."""
    if impl == "fused":
        return {"flash_bwd_fused": layers}
    return {"flash_bwd_dq": layers, "flash_bwd_dkv": layers}


def tuned_backward(cfg, s: int, gen: torch.Generator) -> str:
    """autotune at a layer's attention (B 1, cfg's heads, S `s`, causal, in
    cfg's dtype) in the run's cache: the backward impl="auto" then takes."""
    q = randn((1, cfg.num_heads, s, cfg.head_dim), gen, cfg.dtype)
    k, v = (randn((1, cfg.num_kv_heads, s, cfg.head_dim), gen, cfg.dtype) for _ in range(2))
    entry = autotune.autotune(q, k, v, is_causal=True)
    print(f"[moe-train] autotune at B 1, Hq {cfg.num_heads}, Hkv {cfg.num_kv_heads}, S {s}, "
          f"D {cfg.head_dim}, causal: {entry}")
    return entry["bwd_impl"]


def grouped_products_backward(gen: torch.Generator) -> None:
    """torch._grouped_mm (the grouped dispatch's product) forward and
    backward against a per-expert torch.matmul loop, at Qwen3-30B-A3B's
    expert widths (H 2048, F 768, 128 experts): on the expert offsets of
    a routing of MOE_GMM_T tokens, top 8, and on MOE_ODD_COUNTS (empty
    experts, counts off 8 and 16 rows: PyTorch's MoE trainers pad each
    group to such a multiple for the weight gradient's product, the route
    pads nothing); y, dX and every expert's dW, bf16 under the bf16 gates,
    float32 within GMM_F32_TOL. A refusal raises: the route has no
    fallback."""
    cfg = moe_hf_config(QWEN3_30B_A3B_JSON)
    h, f, e, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.top_k_experts
    for dtype in (torch.bfloat16, torch.float32):
        x = randn((MOE_GMM_T, h), gen).to(dtype)
        router = (randn((h, e), gen, torch.float32) * h**-0.5).to(dtype)
        ids, _ = moe.router_gates(x, router, k)
        for tag, counts in ((f"a routing of T={MOE_GMM_T}, top {k}",
                             torch.bincount(ids.reshape(-1), minlength=e)),
                            ("rows 0-129 an expert", torch.tensor(MOE_ODD_COUNTS, device="cuda"))):
            offs = torch.cumsum(counts, 0, dtype=torch.int32)
            n = int(offs[-1])
            xs = randn((n, h), gen).to(dtype).requires_grad_()
            w = (randn((e, h, f), gen, torch.float32) * h**-0.5).to(dtype).requires_grad_()
            dy = randn((n, f), gen).to(dtype)
            y = torch._grouped_mm(xs, w, offs=offs)
            y.backward(dy)
            ref_y, ref_dx, ref_dw = torch.empty_like(y), torch.empty_like(xs), torch.zeros_like(w)
            with torch.no_grad():
                for j, (lo, hi) in enumerate(zip([0] + offs[:-1].tolist(), offs.tolist())):
                    if hi > lo:
                        ref_y[lo:hi] = torch.matmul(xs[lo:hi], w[j])
                        ref_dx[lo:hi] = torch.matmul(dy[lo:hi], w[j].t())
                        ref_dw[j] = torch.matmul(xs[lo:hi].t(), dy[lo:hi])
            odd = {m: int((counts % m != 0).sum()) for m in (8, 16)}
            for what, ref, out in (("y", ref_y, y.detach()), ("dX", ref_dx, xs.grad),
                                   ("dW", ref_dw, w.grad)):
                tol = (GMM_F32_TOL if dtype == torch.float32
                       else dict(atol=O_ATOL) if what == "y" else GRAD_TOL[dtype])
                rep = verify_results(ref, out, **tol)
                print(f"[moe-train] torch._grouped_mm {str(dtype).removeprefix('torch.')}, {tag} "
                      f"({n} rows; experts whose rows are not a multiple of 8: {odd[8]}, of 16: "
                      f"{odd[16]}, empty: {int((counts == 0).sum())}): {what} against the "
                      f"per-expert torch.matmul loop {rep} ({tol}), bitwise "
                      f"{'equal' if torch.equal(ref, out) else 'different'}")
                check(rep.passed, f"torch._grouped_mm's {what} disagrees with the per-expert loop")
            del xs, w, y, ref_y, ref_dx, ref_dw


def moe_ffn_backward(gen: torch.Generator) -> dict:
    """moe_ffn_grouped (Qwen3-30B-A3B's layer widths, T MOE_FFN_T, bf16)
    forward and backward twice on the same inputs: y, dX and every routed
    parameter's gradient torch.equal (the gather's fixed-order backward);
    its forward (recording the graph, as in training) and backward
    (torch.autograd.grad on the retained graph) in CUDA-event time beside
    moe_roofline's and moe_bwd_roofline's bounds over the experts the
    routing touched, and the masked-dense loop's forward and backward on
    the same inputs. Returns the backward's numbers."""
    cfg = moe_hf_config(QWEN3_30B_A3B_JSON)
    h, f, e, k = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.top_k_experts
    params = moe.init_moe_params(gen, h, f, e, torch.bfloat16)
    x = randn((MOE_FFN_T, h), gen)
    dy = randn((MOE_FFN_T, h), gen)
    names = ["x"] + sorted(params)

    def leaves():
        return [x.clone().requires_grad_()] + [params[n].clone().requires_grad_()
                                               for n in names[1:]]

    def run():
        ins = leaves()
        y = moe.moe_ffn_grouped(ins[0], dict(zip(names[1:], ins[1:])), k)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in ins]

    first, second = run(), run()
    same = {n: torch.equal(a, b) for n, a, b in zip(["y"] + names, first, second)}
    print(f"[moe-train] moe_ffn_grouped forward and backward twice, T={MOE_FFN_T}, bf16: "
          f"torch.equal {same}")
    check(all(same.values()), f"moe_ffn_grouped's backward is not reproducible: {same}")
    del first, second
    ids, _ = moe.router_gates(x, params["router"], k)
    touched = int(torch.unique(ids).numel())
    times = {}
    for route, fn in (("grouped", moe.moe_ffn_grouped), ("masked-dense", moe.moe_ffn_dense_reference)):
        ins = leaves()
        p = dict(zip(names[1:], ins[1:]))
        iters = 5 if route == "grouped" else 2
        fwd = event_time_ms(lambda: fn(ins[0], p, k), warmup=1, iters=iters)
        y = fn(ins[0], p, k)
        bwd = event_time_ms(lambda: torch.autograd.grad(y, ins, dy, retain_graph=True),
                            warmup=1, iters=iters)
        times[route] = (fwd, bwd)
        del ins, p, y
    fb = roofline.moe_roofline(MOE_FFN_T, h, f, e, k, touched)
    bb = roofline.moe_bwd_roofline(MOE_FFN_T, h, f, e, k, touched)
    print(f"[moe-train] MoE FFN, Qwen3-30B-A3B's layer widths, T={MOE_FFN_T}, bf16, {touched} "
          f"experts touched ({card()}; CUDA events, eager): grouped forward "
          f"{times['grouped'][0]:.4f} ms (bound {fb.bound_ms:.4f} ms by {fb.bound_by}), "
          f"backward {times['grouped'][1]:.4f} ms (bound {bb.bound_ms:.4f} ms by "
          f"{bb.bound_by}: {bb.hbm_bytes / 1e9:.3f} GB, {bb.flops / 1e12:.4f} TFLOP); the "
          f"masked-dense loop forward {times['masked-dense'][0]:.4f} ms, backward "
          f"{times['masked-dense'][1]:.4f} ms")
    return dict(ms=times["grouped"][1], plain_ms=times["masked-dense"][1], **bound(bb))


def grad_groups(name: str) -> str:
    """The kind of a MoE model's parameter, for the gradient report."""
    for key, kind in ((".moe.router", "router"), (".moe.shared", "shared expert"),
                      (".moe.", "experts"), ("norm", "norms"), ("embed", "embedding"),
                      ("lm_head", "head")):
        if key in name:
            return kind
    return "attention"


def moe_train_step(cfg, name: str, gen: torch.Generator) -> tuple[dict[str, int], int]:
    """Phase 22 (a) (bf16) and (b) (float32): one AdamW train.train_step of
    the MoE model `cfg` through the kernels (K1, the backward autotune
    picks in bf16, the grouped dispatch) and one on the plain route
    (plain_flash_attention, the masked-dense loop) from the same weights
    and tokens, B 1, S MOE_TRAIN_S, under phase 7's gates on every
    gradient. In bf16 the plain route's routing is teacher-forced to the
    kernel run's picks (forced_routing), each pick it would change held to
    pick_margins; in float32 both run free and no flip excuses a miss.
    Returns the kernel run's launches and its grouped MoE FFN calls."""
    log = "[moe-train]"
    bf16 = cfg.dtype == torch.bfloat16
    dt = str(cfg.dtype).removeprefix("torch.")
    tag = f"{name} widths, {cfg.num_layers} layers, {dt}, B=1 S={MOE_TRAIN_S}"
    gc.collect()
    torch.cuda.empty_cache()
    model = init_params(cfg, gen, device="cuda")
    n = sum(p.numel() for p in model.parameters())
    esize = model.embed.element_size()
    print(f"{log} {tag}: {n / 1e9:.3f} B parameters; the weights, a copy to restart from, both "
          f"runs' gradients and AdamW's two moments {6 * n * esize / 1e9:.1f} GB reckoned, "
          f"beside the activations (the masked-dense loop's: every expert over every token)")
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_S + 1), generator=gen,
                           device="cuda")
    shape = (1, cfg.num_heads, cfg.num_kv_heads, MOE_TRAIN_S, MOE_TRAIN_S, cfg.head_dim, True,
             cfg.dtype)
    impl = tuned_backward(cfg, MOE_TRAIN_S, gen) if bf16 else flash_bwd.resolve_impl("auto", shape)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    runs = {}
    for route in ("kernels", "plain"):
        model.load_state_dict(start)
        state = train.init_train_state(model, TRAIN_TC)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        picks = None
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(moe_calls())
            if route == "plain":
                stack.enter_context(plain_training_attention())
                stack.enter_context(plain_kernels())
            if route == "plain" and bf16:
                ties, _, margins = stack.enter_context(forced_routing(runs["kernels"][4]))
            else:
                picks = stack.enter_context(router_log())
            t0 = time.perf_counter()
            state, metrics = train.train_step(state, tokens)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in read_launches().items() if v}
        grads = {k: p.grad for k, p in model.named_parameters()}
        runs[route] = (loss, gnorm, grads, launches, picks, dict(calls))
        print(f"{log} {tag} AdamW step, {route}: loss {loss:.6f} grad_norm {gnorm:.6f}, "
              f"{ms:.1f} ms (host clock, synchronised), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, MoE "
              f"FFN calls {dict(calls)}")
        del state
    del start
    (l_k, n_k, g_k, launches, kern_picks, k_calls), (l_p, n_p, g_p, plain_launches, plain_picks,
                                                      p_calls) = runs["kernels"], runs["plain"]
    layers = cfg.num_layers
    want = {"flash_fwd": layers, **backward_launches(impl, layers)}
    check(launches == want, f"{tag}: the kernel step launched {launches}, want {want} ({impl})")
    check(k_calls == {"grouped": layers, "dense": 0},
          f"{tag}: the kernel step's MoE FFN calls {k_calls}")
    check(not plain_launches and p_calls == {"grouped": 0, "dense": layers},
          f"{tag}: the plain step launched {plain_launches}, MoE FFN calls {p_calls}")
    pairs = layers * MOE_TRAIN_S
    if bf16:
        ratio = max(float(m.detach()) for m, _ in margins)
        changed = sum(int(c) for _, c in margins)
        print(f"{log} {tag}, plain route's routing forced to the kernel run's picks: its own top "
              f"{cfg.top_k_experts} differ at {len(ties)} of {pairs} (token, layer) pairs; "
              f"{changed} (forced pick, own pick) pairs, worst pick_margins ratio {ratio:.3f} "
              f"(<= 1)")
        check(ratio <= 1.0, f"{tag}: changed picks that the router logits' differences do not "
              f"explain: ratio {ratio:.3f}")
    else:
        flips = routing_flips(kern_picks, plain_picks, layers)
        print(f"{log} {tag}, free-running routes: picks differ at {len(flips)} of {pairs} "
              f"(token, layer) pairs (no excuse: the gates below hold regardless)")
    cos = cosines(g_k, g_p)
    worst = min(cos, key=cos.get)
    kinds: dict[str, tuple[float, str]] = {}
    for n, c in cos.items():
        kind = grad_groups(n)
        if kind not in kinds or c < kinds[kind][0]:
            kinds[kind] = (c, n)
    print(f"{log} {tag} kernels vs plain: |dloss| {abs(l_k - l_p):.6f} (<= {LOSS_ATOL}), "
          f"grad_norm rel {abs(n_k - n_p) / n_p:.6f} (<= {GRAD_NORM_REL}), gradient cosine min "
          f"{cos[worst]:.6f} ({worst}) over {len(cos)} parameters (> {GRAD_COS}); by kind: "
          + ", ".join(f"{kind} {c:.6f} ({n})" for kind, (c, n) in sorted(kinds.items())))
    check(abs(l_k - l_p) <= LOSS_ATOL and abs(n_k - n_p) <= GRAD_NORM_REL * n_p
          and cos[worst] > GRAD_COS, f"{tag}: kernels and plain route disagree")
    del model, runs, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k_calls["grouped"]


def moe_trainer(gen: torch.Generator) -> tuple[dict[str, int], int]:
    """Phase 22 (c): train.train for MOE_TRAINER_STEPS AdamW steps on one
    repeated batch, Qwen3-30B-A3B's widths at MOE_TRAINER_LAYERS layers
    (or the deepest cut whose reckoned state fits the free memory beside
    MOE_TRAINER_RESERVE, printed), bf16, B 1, S MOE_TRAINER_S, through K1,
    the backward autotune picks and the grouped dispatch: finite losses,
    the last below the first; ms/step, tokens/s and peak memory a step
    beside the card's name and power limit. Returns the launches and the
    grouped MoE FFN calls."""
    log = "[moe-trainer]"

    def state_bytes(layers: int) -> int:
        meta = llama.Llama(moe_hf_config(QWEN3_30B_A3B_JSON, layers=layers), device="meta")
        return 8 * sum(p.numel() for p in meta.parameters())  # bf16 weights, grads, 2 moments

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    layers = MOE_TRAINER_LAYERS
    while layers > 1 and state_bytes(layers) + MOE_TRAINER_RESERVE > free:
        layers -= 1
    print(f"{log} memory, reckoned: weights, gradients and AdamW's two moments in bf16, 8 B a "
          f"parameter: {state_bytes(MOE_TRAINER_LAYERS) / 1e9:.1f} GB at {MOE_TRAINER_LAYERS} "
          f"layers (Qwen3-30B-A3B's 48: {state_bytes(48) / 1e9:.1f} GB), plus "
          f"{MOE_TRAINER_RESERVE / 1e9:.0f} GB for activations, logits and AdamW's temporaries; "
          f"{free / 1e9:.1f} GB free: {layers} layers"
          + ("" if layers == MOE_TRAINER_LAYERS else f" (cut from {MOE_TRAINER_LAYERS})"))
    cfg = moe_hf_config(QWEN3_30B_A3B_JSON, layers=layers)
    impl = tuned_backward(cfg, MOE_TRAINER_S, gen)
    model = init_params(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_TRAINER_S + 1), generator=gen,
                           device="cuda")
    marks = []  # (host clock, peak bytes since the previous mark) at each step's start

    def batches():
        while True:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            yield tokens

    reset_launches()
    with moe_calls() as calls:
        state, hist = train.train(model, batches(), TRAIN_TC, steps=MOE_TRAINER_STEPS,
                                  log_every=1)
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), torch.cuda.max_memory_allocated()))
    launches = {k: v for k, v in read_launches().items() if v}
    for h, (t0, _), (t1, peak) in zip(hist, marks, marks[1:]):
        ms = (t1 - t0) * 1e3
        print(f"{log} step {h['step']}: loss {h['loss']:.6f} grad_norm {h['grad_norm']:.6f}, "
              f"{ms:.1f} ms (host clock, synchronised), {MOE_TRAINER_S / ms * 1e3:.0f} tokens/s, "
              f"max_memory_allocated {peak / 2**30:.2f} GiB ({card()})")
    losses = [h["loss"] for h in hist]
    check(len(hist) == MOE_TRAINER_STEPS and state["step"] == MOE_TRAINER_STEPS,
          f"{log} ran {len(hist)} steps")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"{log} losses {losses}")
    n = MOE_TRAINER_STEPS * cfg.num_layers
    want = {"flash_fwd": n, **backward_launches(impl, n)}
    check(launches == want and calls == {"grouped": n, "dense": 0},
          f"{log} launched {launches}, want {want}; MoE FFN calls {calls}")
    print(f"{log} Qwen3-30B-A3B widths, {cfg.num_layers} layers, B=1 S={MOE_TRAINER_S}, "
          f"{MOE_TRAINER_STEPS} AdamW steps (lr {TRAIN_TC.learning_rate}, warmup "
          f"{TRAIN_TC.warmup_steps}), the {impl} backward: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {launches}")
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, calls["grouped"]


def phase_moe_train(gen: torch.Generator) -> dict[str, int]:
    """Phase 22 (the comment at the top): the grouped products' backward
    against the per-expert loop; moe_ffn_grouped's backward twice, equal,
    and timed; (a) the bf16 step at MOE_TRAIN_LAYERS layers, kernels
    against the plain route; (b) the float32 steps of both presets at
    MOE_TRAIN_F32_LAYERS layers; (c) train.train at MOE_TRAINER_LAYERS
    layers. (d) ran in phase 21's ranks (par_expert_step). Prints the MoE
    FFN backward's row (PERF.md's kernel table: torch._grouped_mm is
    PyTorch's, no kernel of the kernels line), its launches the grouped
    FFN's backward calls of (a)-(c); returns the launches of (a)-(c)."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 runs and the router's product must run in float32")
    grouped_products_backward(gen)
    row = moe_ffn_backward(gen)
    total: dict[str, int] = {}
    grouped = 0
    runs = [(moe_hf_config(QWEN3_30B_A3B_JSON, layers=MOE_TRAIN_LAYERS), "Qwen3-30B-A3B")]
    runs += [(moe_hf_config(source, torch.float32, layers=MOE_TRAIN_F32_LAYERS), name)
             for source, name in ((QWEN3_30B_A3B_JSON, "Qwen3-30B-A3B"),
                                  (QWEN15_MOE_JSON, "Qwen1.5-MoE-A2.7B"))]
    for launches, calls in [moe_train_step(cfg, name, gen) for cfg, name in runs] + [
            moe_trainer(gen)]:
        add_launches(total, launches)
        grouped += calls
    row = {"name": "moe_ffn_backward", "route": "torch._grouped_mm",
           "source": "flashattn_tpu_torch/parallel/moe.py",
           "replaces": "flashattn_tpu/parallel/moe.py:75", "launches": grouped, **row,
           "library_ms": None}
    print(f"[moe-train] launches of (a)-(c): {total}; the MoE FFN backward's row (no kernel "
          f"of ours): {json.dumps(row)}")
    return total


# Phase 2 times flex_attention beside the kernels (the library_ms of the
# rows with a soft-cap or ALiBi), and compiling each of its eleven cases
# takes 5-15 s of the host. A process of its own compiles the same cases on
# zeros into this run's Inductor cache (TORCHINDUCTOR_CACHE_DIR, on disk)
# from the end of phase 1's build on, ahead of phase 2, whose compilations
# then read the cache. It starts compiling only when FLEX_WARM_AFTER of the
# libraries are built: before that nvcc holds every core, and the warm-up
# slowed the build by more than it saved. It runs each case once and times
# nothing, so beside phase 2's timings it takes the card for a few
# milliseconds a case.
# ---- phase 23: head dims 32, 80 and 96 ----

HD_DIMS = (32, 80, 96)
# H2O-Danube2-1.8B's attention (32 heads of 80 over 2,560, 8 KV heads) at
# B 4, S 2,048, causal, bf16: the widths at which K1, B3, B4 and B5 are held
# and timed at each of the three dims; K2 at its heads over a cache of
# 2,048 positions (DEC_LENGTHS).
HD_B, HD_HQ, HD_HKV, HD_S = 4, 32, 8, 2048
HD_ROWS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv", "decode",
           "decode_int8", "decode_fp8", "paged_decode")
HD_T = 4  # K2's query rows a sequence in the edge gates (T 1 is the timed step)
# The JAX package's quality gate (tests/test_quant_ppl.py): its config, its
# optimizer settings and steps, its token batch's shape.
PPL_CFG = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128,
                      dtype=torch.float32)
PPL_TC = train.TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=80)
PPL_STEPS = 60
PPL_TOKENS = (2, 65)
PPL_KV_BUDGET = 0.1  # fp8 and int8 caches, int8 weights (BASELINE.json's north star)
PPL_W4_BUDGET = 1.0  # int4 weights (the JAX test's looser gate)
PPL_ROUTES = 0.05  # the kernel route's perplexity against the plain route's, absolute
TINY_SERVED = [100, 170, 230, 300]  # TINY's requests' prompt tokens, MISTRAL_NEW new each
TINY_MAX_LEN = 512
TINY_TRAIN = (4, 512)  # B, S of TINY's train step


def head_dim_k1_gates(gen: torch.Generator) -> dict[int, float]:
    """K1 at head dims 32, 80 and 96 (in the 64 and 128 tiles) against its
    plain version: causal GQA on a ragged length, S_q < S_k, non-causal, a
    window, ALiBi, the soft-cap, the offset read on the card
    (dyn_pos_offset) and the float32 kernel. Returns each dim's largest bf16
    O error."""
    cases = [(1, 8, 2, 200, 200, True, {}), (2, 4, 4, 64, 300, True, {}),
             (1, 4, 2, 130, 130, False, {}), (1, 8, 2, 300, 300, True, dict(window=65)),
             (1, 8, 2, 256, 256, True, dict(alibi=True)),
             (1, 8, 2, 256, 256, True, dict(logit_softcap=CAP)),
             (1, 8, 2, 256, 256, False, dict(dyn_pos_offset=200, window=150))]
    err = {}
    for d in HD_DIMS:
        err[d] = 0.0
        for b, hq, hkv, s_q, s_k, causal, kw in cases:
            q = randn((b, hq, s_q, d), gen)
            k, v = (randn((b, hkv, s_k, d), gen) for _ in range(2))
            err[d] = k1_case(f"head dim {d}", q, k, v, causal, err[d], **kw)
        q, k, v = (randn((1, h, 200, d), gen, torch.float32) for h in (8, 2, 2))
        k1_case(f"head dim {d} float32", q, k, v, True, 0.0, f32=True)
    return err


def head_dim_backward_gates(d: int, gen: torch.Generator) -> dict[str, float]:
    """B3 and B4 + B5 at head dim d against the plain backward on the same
    O and LSE (K1's): causal GQA on a ragged length, S_q < S_k, non-causal,
    a window, ALiBi, the soft-cap, dropout, the offset read on the card and
    float32. Returns each kernel's largest error."""
    cases = [("ragged", 1, 8, 2, 200, 200, True, {}, torch.bfloat16),
             ("Sq<Sk", 1, 4, 2, 130, 300, True, {}, torch.bfloat16),
             ("non-causal", 2, 4, 4, 128, 128, False, {}, torch.bfloat16),
             ("window", 1, 8, 2, 300, 300, True, dict(window=65), torch.bfloat16),
             ("ALiBi", 1, 8, 2, 256, 256, True, dict(alibi=True), torch.bfloat16),
             ("soft-cap", 1, 8, 2, 256, 256, True, dict(logit_softcap=CAP), torch.bfloat16),
             ("dropout", 1, 8, 2, 256, 256, True, dict(dropout_rate=DROP_RATE,
                                                       dropout_seed=DROP_SEED), torch.bfloat16),
             ("card offset", 1, 8, 2, 256, 256, False, dict(dyn_pos_offset=200, window=150),
              torch.bfloat16),
             ("float32", 1, 4, 2, 200, 200, True, {}, torch.float32)]
    err = {"flash_bwd_fused": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for tag, b, hq, hkv, s_q, s_k, causal, kw, dtype in cases:
        q, do = (randn((b, hq, s_q, d), gen, dtype) for _ in range(2))
        k, v = (randn((b, hkv, s_k, d), gen, dtype) for _ in range(2))
        o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, **kw)
        ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, causal, **kw)
        name = (f"head dim {d} {tag} B={b} Hq={hq} Hkv={hkv} Sq={s_q} Sk={s_k} causal={causal} "
                f"{str(dtype)[6:]}")
        for impl in ("fused", "split"):
            out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, causal, impl=impl, **kw)
            torch.cuda.synchronize()
            for grad, r, g in zip(("dQ", "dK", "dV"), ref, out):
                kernel = ("flash_bwd_fused" if impl == "fused" else
                          "flash_bwd_dq" if grad == "dQ" else "flash_bwd_dkv")
                err[kernel] = max(err[kernel], grad_gate(f"{impl} {grad} {name}", r, g, dtype))
    return err


def head_dim_decode_gates(d: int, gen: torch.Generator) -> dict[str, float]:
    """K2 at head dim d on bf16, f32, int8 and fp8 caches (B 2, Hq 8, Hkv 2,
    Smax 2,048, lengths 0, 77 and 2,048, NaN past each) at T 1 and T 4
    against its plain version (int8 P requantized per 64-position tile, as
    the kernel does), an empty row exactly 0; the paged K2 on bf16 and int8
    pools of scrambled 256-token pages torch.equal to the dense K2. Returns
    each kernel's largest error."""
    lengths = [0, 77, 2048]
    b, hq, hkv = len(lengths), 8, 2
    err = {"decode": 0.0, "decode_int8": 0.0, "decode_fp8": 0.0, "paged_decode": 0.0}
    for mode in ("bf16", "f32", "int8", "fp8"):
        cache = filled_cache(mode, gen, b, hkv, d, lengths)
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        kernel = "decode" if mode in ("bf16", "f32") else f"decode_{mode}"
        tol = (F32_TOL if mode == "f32" else dict(atol=O_ATOL) if mode == "bf16"
               else QUANT_DECODE_TOL)
        pool = paged_copy(cache, gen) if mode in ("bf16", "int8") else None
        for t in (1, HD_T):
            q = randn((b, hq, t, d), gen, dtype)
            ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV)
            o = (decode.decode_attention(q[:, :, 0].contiguous(), cache)[:, :, None]
                 if t == 1 else decode.decode_attention_chunk(q, cache))
            torch.cuda.synchronize()
            tag = (f"K2 {mode} head dim {d} B={b} Hq={hq} Hkv={hkv} Smax={DEC_SMAX} T={t} "
                   f"lengths={lengths} (NaN past each length)")
            check(bool(torch.isfinite(o).all()) and not bool(o[0].any()),
                  f"{tag}: non-finite output, or the empty row not 0")
            err[kernel] = max(err[kernel], _gate(tag, ref, o, **tol))
            if pool is not None:
                po = paged.paged_decode_attention_chunk(q, pool)
                check(torch.equal(po, decode.decode_attention_chunk(q, cache)),
                      f"paged {tag}: differs from the dense K2")
                err["paged_decode"] = max(err["paged_decode"], err[kernel])
                print(f"[head-dims] paged {tag}, page={PAGE} scrambled: torch.equal to the "
                      f"dense K2")
    return err


def head_dim_widths(d: int, gen: torch.Generator) -> dict[str, dict]:
    """K1, B3, B4 + B5, K2 (bf16, int8, fp8) and the paged K2 at head dim d
    at Danube2's attention widths (HD_*), each against its plain version
    and timed beside it, its bound at the true d (utils/roofline.py) and
    SDPA: the JSON line's rows of d."""
    b, hq, hkv, s = HD_B, HD_HQ, HD_HKV, HD_S
    q, do = (randn((b, hq, s, d), gen) for _ in range(2))
    k, v = (randn((b, hkv, s, d), gen) for _ in range(2))
    name = f"head dim {d} B={b} Hq={hq} Hkv={hkv} S={s} causal bf16"
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, True)
    rows = {"flash_fwd": dict(max_abs_err=_gate(f"K1 {name} O", o_ref, o, O_ATOL))}
    _gate(f"K1 {name} LSE", lse_ref, lse, LSE_ATOL)
    del o_ref, lse_ref
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, True)
    for impl in ("fused", "split"):
        out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, impl=impl)
        torch.cuda.synchronize()
        for grad, r, g in zip(("dQ", "dK", "dV"), ref, out):
            kernel = ("flash_bwd_fused" if impl == "fused" else
                      "flash_bwd_dq" if grad == "dQ" else "flash_bwd_dkv")
            e = grad_gate(f"{impl} {grad} {name}", r, g, torch.bfloat16)
            rows.setdefault(kernel, dict(max_abs_err=0.0))
            rows[kernel]["max_abs_err"] = max(rows[kernel]["max_abs_err"], e)
    del ref, out
    rows["flash_fwd"].update(time_k1(f"head dim {d}", q, k, v, need_lse=True,
                                     few=dict(warmup=1, iters=5, reps=3)))
    for kernel, t in zip(("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"),
                         time_backward(q, k, v, o, do, lse, with_k1=False)):
        rows[kernel].update(t)
    del q, k, v, o, do, lse
    lengths = DEC_LENGTHS
    for mode in ("bf16", "int8", "fp8"):
        cache = filled_cache(mode, gen, HD_B, HD_HKV, d)
        kernel = "decode" if mode == "bf16" else f"decode_{mode}"
        qd = randn((b, hq, d), gen)
        ref = decode.decode_attention_reference(qd[:, :, None], cache,
                                                requant_block=decode.BLOCK_KV)[:, :, 0]
        o = decode.decode_attention(qd, cache)
        tol = dict(atol=O_ATOL) if mode == "bf16" else QUANT_DECODE_TOL
        tag = (f"K2 {mode} head dim {d} B={b} Hq={hq} Hkv={hkv} Smax={DEC_SMAX} T=1 "
               f"lengths={lengths}")
        e = _gate(tag, ref, o, **tol)
        ms = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
        plain = cuda_time_ms(lambda: decode.decode_attention_reference(
            qd[:, :, None], cache, requant_block=decode.BLOCK_KV))
        lim = bound(roofline.decode_roofline(b, hq, hkv, d, lengths, cache_dtype=cache.k.dtype,
                                             q_dtype_bytes=qd.element_size()))
        lib = masked_sdpa_ms(qd, cache)
        print(f"[head-dims] {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{lim['bound_ms']:.5f} ms by {lim['bound_by']}, SDPA with a length mask"
              f"{'' if mode == 'bf16' else ' on the dequantized bf16 cache'} {lib:.4f} ms")
        rows[kernel] = dict(max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib, **lim)
        if mode == "int8":
            pool = paged_copy(cache, gen)
            po = paged.paged_decode_attention(qd, pool)
            check(torch.equal(po, o), f"paged {tag}: differs from the dense K2")
            ms = cuda_time_ms(lambda: paged.paged_decode_attention(qd, pool))
            plain = cuda_time_ms(lambda: paged.paged_decode_reference(
                qd[:, :, None], pool, requant_block=decode.BLOCK_KV))
            print(f"[head-dims] paged {tag}, page={PAGE} scrambled: torch.equal to the dense "
                  f"K2; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {lim['bound_ms']:.5f} "
                  f"ms, SDPA {lib:.4f} ms")
            rows["paged_decode"] = dict(max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib,
                                        **lim)
            del pool
        del cache
    return rows


def head_dim_path(d: int, gen: torch.Generator) -> dict[str, int]:
    """The entry points a user calls at head dim d, at Danube2's attention
    widths, with every launch counter set to 0 first: flash_attention's
    forward and gradients (the fused backward, then the split one by
    FLASHATTN_BWD_IMPL), decode_attention on bf16, int8 and fp8 caches and
    paged_decode_attention on an int8 pool. Returns the launches."""
    b, hq, hkv, s = HD_B, HD_HQ, HD_HKV, HD_S
    leaves = [randn((b, h, s, d), gen).requires_grad_() for h in (hq, hkv, hkv)]
    do = randn((b, hq, s, d), gen)
    caches = {mode: filled_cache(mode, gen, HD_B, HD_HKV, d) for mode in ("bf16", "int8", "fp8")}
    pool = paged_copy(caches["int8"], gen)
    qd = randn((b, hq, d), gen)
    torch.cuda.synchronize()
    reset_launches()
    for impl in ("fused", "split"):
        with profile_train.backward_impl(impl):
            o = flash_attention(*leaves, is_causal=True)
            grads = torch.autograd.grad(o, leaves, do)
    outs = [decode.decode_attention(qd, c) for c in caches.values()]
    outs.append(paged.paged_decode_attention(qd, pool))
    torch.cuda.synchronize()
    got = read_launches()
    check(all(bool(torch.isfinite(x).all()) for x in (o, *grads, *outs)),
          f"head dim {d} path: a non-finite output")
    want = dict(flash_fwd=2, flash_bwd_fused=1, flash_bwd_dq=1, flash_bwd_dkv=1, decode=1,
                decode_int8=1, decode_fp8=1, paged_decode=1)
    check(all(got[k] == n for k, n in want.items()), f"head dim {d} path launched {got}")
    print(f"[head-dims] head dim {d} path (flash_attention forward and gradients, fused then "
          f"split; decode_attention on bf16, int8 and fp8 caches; paged_decode_attention): "
          f"launches { {k: got[k] for k in HD_ROWS} }")
    return {k: got[k] for k in HD_ROWS}


@contextlib.contextmanager
def counted(total: dict[str, int]):
    """The launches of the body (every counter set to 0 first) added to
    `total`."""
    torch.cuda.synchronize()
    reset_launches()
    yield
    torch.cuda.synchronize()
    add_launches(total, read_launches())


def ppl_line(what: str, route: str, ppl: float, against: float | None = None,
             ref: str = "", budget: float | None = None) -> None:
    """One perplexity on a line of its own, with its delta and budget."""
    extra = ""
    if against is not None:
        extra = (f", delta {abs(ppl - against):.6f} against {ref} {against:.6f}"
                 + (f" (< {budget})" if budget is not None else ""))
    print(f"[ppl] {what}, {route} route: ppl {ppl:.6f}{extra}")


def ppl_gate(gen: torch.Generator, launches: dict[str, int]) -> None:
    """(a) The JAX package's quality gate on the card (tests/test_quant_ppl.py:
    its config, D 32 in float32, 60 AdamW steps at lr 2e-3 on B 2 x 65
    tokens, through K1 and the fused backward at D 32), then perplexity
    through prefill and 63 teacher-forced decode steps (K2 at D 32) on the
    model's float32 cache and on fp8 and int8 caches, with int8 and int4
    weights (qmm8, qmm4), and with the weights cast to bf16 on bf16, fp8
    and int8 caches; generate with int8 weights and an int8 cache. Every
    perplexity on the kernel route and on the plain one (each kernel call
    its plain version), each delta against its gate. The kernel route's
    launches are added to `launches`."""
    model = init_params(PPL_CFG, gen, device="cuda")
    tokens = torch.randint(0, PPL_CFG.vocab_size, PPL_TOKENS, generator=gen, device="cuda")
    state = train.init_train_state(model, PPL_TC)
    t0 = time.perf_counter()
    with counted(launches):
        for _ in range(PPL_STEPS):
            state, m = train.train_step(state, tokens)
        loss = float(m["loss"])
    print(f"[ppl] {PPL_STEPS} AdamW steps (lr {PPL_TC.learning_rate}, B {PPL_TOKENS[0]} x "
          f"{PPL_TOKENS[1]} tokens, head dim 32, float32) through the kernels in "
          f"{time.perf_counter() - t0:.2f} s: last loss {loss:.6f} (< 1.0)")
    check(math.isfinite(loss) and loss < 1.0, f"the quality gate's model did not train: {loss}")
    del state
    bf16 = llama.Llama(dataclasses.replace(PPL_CFG, dtype=torch.bfloat16), device="cuda")
    bf16.load_state_dict(model.state_dict())
    models = {"float32": model, "int8 weights": quantized_copy(model, 8),
              "int4 weights": quantized_copy(model, 4), "bf16 weights": bf16}
    runs = [("float32", None), ("float32", "fp8"), ("float32", "int8"), ("int8 weights", None),
            ("int4 weights", None), ("bf16 weights", None), ("bf16 weights", "fp8"),
            ("bf16 weights", "int8")]
    ppl = {}
    for name, quant in runs:
        with counted(launches):
            ppl[name, quant, "kernel"] = perplexity.decode_ppl(models[name], tokens, quant)
        with plain_kernels(requant_block=decode.BLOCK_KV):
            ppl[name, quant, "plain"] = perplexity.decode_ppl(models[name], tokens, quant)
    with counted(launches):
        ppl_train = perplexity.train_ppl(model, tokens)
    with plain_training_attention():
        ppl_train_plain = perplexity.train_ppl(model, tokens)
    cache = {None: "its own cache", "fp8": "fp8 cache", "int8": "int8 cache"}
    for route in ("kernel", "plain"):
        train_ppl = ppl_train if route == "kernel" else ppl_train_plain
        print(f"[ppl] training forward, {route} route: ppl {train_ppl:.6f} (exp of loss_fn)")
        full = ppl["float32", None, route]
        ppl_line("float32 weights, float32 cache", route, full, train_ppl, "the training forward",
                 0.05 * train_ppl + 0.05)
        check(abs(full - train_ppl) < 0.05 * train_ppl + 0.05,
              f"{route}: the decode path's ppl {full} against the training forward's {train_ppl}")
        gates = [(("float32", "fp8"), ("float32", None), PPL_KV_BUDGET),
                 (("float32", "int8"), ("float32", None), PPL_KV_BUDGET),
                 (("int8 weights", None), ("float32", None), PPL_KV_BUDGET),
                 (("int4 weights", None), ("float32", None), PPL_W4_BUDGET),
                 (("bf16 weights", "fp8"), ("bf16 weights", None), PPL_KV_BUDGET),
                 (("bf16 weights", "int8"), ("bf16 weights", None), PPL_KV_BUDGET)]
        ppl_line("bf16 weights, bf16 cache", route, ppl["bf16 weights", None, route])
        for (name, quant), (ref_name, ref_quant), budget in gates:
            got, ref = ppl[name, quant, route], ppl[ref_name, ref_quant, route]
            what = f"{name}, {cache[quant]}"
            ppl_line(what, route, got, ref, f"{ref_name}, {cache[ref_quant]}", budget)
            check(abs(got - ref) < budget, f"{route}: {what} ppl {got} against {ref}")
    routes = {(name, quant): abs(ppl[name, quant, "kernel"] - ppl[name, quant, "plain"])
              for name, quant in runs}
    for (name, quant), delta in routes.items():
        check(delta < PPL_ROUTES, f"{name}, {cache[quant]}: the kernel route's ppl is "
              f"{delta} from the plain route's")
    print(f"[ppl] every kernel-route perplexity within {PPL_ROUTES} of the plain route's "
          f"(largest delta {max(routes.values()):.6f})")
    with counted(launches):
        out = generate.generate(models["int8 weights"], tokens[:1, :8], max_new_tokens=8,
                                max_len=128, quant="int8")
    check(out.shape == (1, 8) and bool(((out >= 0) & (out < PPL_CFG.vocab_size)).all()),
          f"generate with int8 weights and an int8 cache: {out}")
    print(f"[ppl] generate, int8 weights and an int8 cache: 8 tokens {out[0].tolist()}")


def tiny_servers(gen: torch.Generator, launches: dict[str, int]) -> None:
    """(b) TINY (D 32, 8 heads over 4 KV heads; random bf16 weights) served:
    4 requests of 100-300 prompt tokens, MISTRAL_NEW new each, 2 slots,
    max_len 512, on the bf16 server, the int8-KV server and the int8-KV
    paged server (pages of 256), whose tokens must equal the dense int8-KV
    server's; every decode step a replay. The runs' launches are added to
    `launches`."""
    model = init_params(TINY, gen, device="cuda")
    prompts = [torch.randint(0, TINY.vocab_size, (n,), generator=gen, device="cuda").tolist()
               for n in TINY_SERVED]
    dense, paged_tokens = {}, {}
    for tag, opts, tokens in (("bf16 server", {}, None),
                              ("int8-KV server", dict(quant="int8"), dense),
                              (f"int8-KV paged server (pages of {PAGE})",
                               dict(quant="int8", paged=True, page_size=PAGE), paged_tokens)):
        add_launches(launches, long_prompt_server(model, f"TINY {tag}", prompts, None,
                                                  log="[tiny]", max_len=TINY_MAX_LEN,
                                                  tokens=tokens, **opts))
    check(paged_tokens == dense, "TINY: the int8-KV paged server's tokens differ from the dense "
          "int8-KV server's")
    print(f"[tiny] the int8-KV paged and dense servers give equal tokens for all "
          f"{len(prompts)} requests")


def tiny_train_step(gen: torch.Generator, launches: dict[str, int]) -> None:
    """(c) One AdamW train step of TINY (B 4, S 512) through K1 and the
    fused backward, and one through the split backward, each against the
    same step on the plain route from the same weights under phase 7's
    gates. The kernel steps' launches are added to `launches`."""
    model = init_params(TINY, gen, device="cuda")
    b, s = TINY_TRAIN
    tokens = torch.randint(0, TINY.vocab_size, (b, s + 1), generator=gen, device="cuda")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for route in ("plain", "fused", "split"):
        model.load_state_dict(start)
        state = train.init_train_state(model, TRAIN_TC)
        ctx = (plain_training_attention() if route == "plain"
               else profile_train.backward_impl(route))
        with ctx, counted(launches if route != "plain" else {}):
            state, metrics = train.train_step(state, tokens)
        runs[route] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                       {n: p.grad for n, p in model.named_parameters()})
        del state
    l_p, n_p, g_p = runs["plain"]
    for route in ("fused", "split"):
        l_k, n_k, g_k = runs[route]
        cos = cosines(g_k, g_p)
        worst = min(cos, key=cos.get)
        print(f"[tiny] TINY B={b} S={s} AdamW step, kernels ({route} backward) vs plain: loss "
              f"{l_k:.6f} / {l_p:.6f}, |dloss| {abs(l_k - l_p):.6f} (<= {LOSS_ATOL}), grad_norm "
              f"rel {abs(n_k - n_p) / n_p:.6f} (<= {GRAD_NORM_REL}), gradient cosine min "
              f"{cos[worst]:.6f} ({worst}) over {len(cos)} parameters (> {GRAD_COS})")
        check(abs(l_k - l_p) <= LOSS_ATOL and abs(n_k - n_p) <= GRAD_NORM_REL * n_p
              and cos[worst] > GRAD_COS, f"TINY train step ({route}): kernels and plain disagree")


def phase_head_dims(gen: torch.Generator, k1_err: dict[int, float]
                    ) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 23 (the docstring above): each kernel's edge gates and its rows
    at Danube2's widths at head dims 32, 80 and 96, the quality gate (a),
    TINY served (b) and trained (c) at D 32, and the entry points' path at
    D 80 and 96. Returns the rows' launches and the rows, named
    `<kernel>_d<dim>`; `k1_err` holds phase 2's K1 errors by dim."""
    clock = PhaseClock()
    rows: dict[str, dict] = {}
    launches: dict[str, int] = {}
    for d in HD_DIMS:
        err = {"flash_fwd": k1_err[d], **head_dim_backward_gates(d, gen),
               **head_dim_decode_gates(d, gen)}
        for kernel, row in head_dim_widths(d, gen).items():
            row["max_abs_err"] = max(row["max_abs_err"], err[kernel])
            rows[f"{kernel}_d{d}"] = row
        gc.collect()
        torch.cuda.empty_cache()
        clock.done(f"23 head dim {d}: gates and Danube2's widths")
    d32: dict[str, int] = {}
    ppl_gate(gen, d32)
    clock.done("23 (a) the quality gate")
    tiny_servers(gen, d32)
    tiny_train_step(gen, d32)
    clock.done("23 (b), (c) TINY served and trained")
    for d in HD_DIMS:
        got = d32 if d == 32 else head_dim_path(d, gen)
        launches.update({f"{k}_d{d}": got.get(k, 0) for k in HD_ROWS})
    print(f"[head-dims] the rows' launches: {launches}")
    return launches, rows


FLEX_WARM_AFTER = 15
FLEX_TIMED = True  # False in flex_warmup's process


def flex_warm_cases() -> list:
    """Every flex_attention compilation of phase 2, in phase 2's order, as
    (name, call): the same helper (flex_mod_ms, flex_ms, flex_dyn_ms) on
    zeros of its call site's shapes and types, with the call site's
    constants. A case that drifts from its call site costs phase 2 that
    compilation's time, nothing else."""
    dev = torch.device("cuda")

    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    def packed(b, hq, hkv, d, grad, **kw):
        ids = packed_ids(PACK_DOCS, PACK_S, dev)
        seg = varlen.canonical_segments(ids, ids, dev)
        q = z(b, hq, PACK_S, d)
        return flex_mod_ms(q, z(b, hkv, PACK_S, d), z(b, hkv, PACK_S, d), None,
                           segment_ids=seg, do=q if grad else None, **kw)

    b, hq, hkv, s, d = GEMMA_PREFILL
    ab, ahq, ahkv, a_s, ad = ALIBI_PREFILL
    db, dhq, dhkv, ds, dd = DYN_SHAPE
    gb, ghq, ghkv, gs, gd = DYN_GEMMA
    ends = torch.tensor(DEC_LENGTHS, dtype=torch.int32, device=dev)
    dec = (z(DEC_B, DEC_HQ, 1, DEC_D), z(DEC_B, DEC_HKV, DEC_SMAX, DEC_D),
           z(DEC_B, DEC_HKV, DEC_SMAX, DEC_D))
    slopes = flash_fwd.alibi_table(True, None, ahq, dev)
    gk2 = (z(GK2_B, GK2_HQ, 1, GK2_D), z(GK2_B, GK2_HKV, GK2_SMAX, GK2_D),
           z(GK2_B, GK2_HKV, GK2_SMAX, GK2_D))
    return [
        ("soft-cap K1", lambda: flex_mod_ms(z(b, hq, s, d), z(b, hkv, s, d), z(b, hkv, s, d),
                                            None)),
        ("soft-cap K2", lambda: flex_mod_ms(*gk2, None)),
        ("soft-cap packed row", lambda: packed(b, hq, hkv, d, False, cap=CAP, slopes=None)),
        ("soft-cap packed row, backward", lambda: packed(b, hq, hkv, d, True, cap=CAP,
                                                         slopes=None)),
        ("ALiBi K1", lambda: flex_ms(z(ab, ahq, a_s, ad), z(ab, ahkv, a_s, ad),
                                     z(ab, ahkv, a_s, ad), slopes=slopes)),
        ("ALiBi K2", lambda: flex_ms(*dec, ends=ends,
                                     slopes=flash_fwd.alibi_table(True, None, DEC_HQ, dev))),
        ("K2's LSE", lambda: flex_ms(*dec, ends=ends, return_lse=True,
                                     what="the LSE returned")),
        ("ALiBi packed row", lambda: packed(ab, ahq, ahkv, ad, False, cap=None,
                                            slopes=slopes)),
        ("ALiBi packed row, backward", lambda: packed(ab, ahq, ahkv, ad, True, cap=None,
                                                      slopes=slopes)),
        ("card offset", lambda: flex_dyn_ms(z(db, dhq, ds, dd), z(db, dhkv, ds, dd),
                                            z(db, dhkv, ds, dd), DYN_OFFSET, DYN_WINDOW,
                                            flash_fwd.default_alibi_slopes(dhq, dev),
                                            z(db, dhq, ds, dd))),
        ("card offset, soft-cap", lambda: flex_dyn_ms(z(gb, ghq, gs, gd), z(gb, ghkv, gs, gd),
                                                      z(gb, ghkv, gs, gd), DYN_OFFSET, GWIN,
                                                      None, z(gb, ghq, gs, gd), cap=CAP)),
    ]


def flex_warmup() -> None:
    """The warm-up process: waits until FLEX_WARM_AFTER libraries are
    built, then compiles flex_warm_cases in order, printing each one's
    seconds."""
    global FLEX_TIMED
    FLEX_TIMED = False
    while sum(_build.library_path(lib).exists() for lib in LIBRARIES) < FLEX_WARM_AFTER:
        time.sleep(1.0)
    t_all = time.perf_counter()
    for name, call in flex_warm_cases():
        t0 = time.perf_counter()
        call()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[flex-warm] {name} compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[flex-warm] every case in {time.perf_counter() - t_all:.1f} s", flush=True)


@contextlib.contextmanager
def flex_warmed():
    """flex_warmup in a process of its own (spawn) while the body runs
    (phases 1 and 2), stopped when the body ends: once phase 2 is done
    nothing reads what it compiles. Without a card it starts nothing (phase
    1 raises)."""
    if not torch.cuda.is_available():
        yield
        return
    import torch.multiprocessing as mp

    proc = mp.get_context("spawn").Process(target=flex_warmup)
    proc.start()
    try:
        yield
    finally:
        if proc.is_alive():
            print("[flex-warm] stopped with phase 2 done")
            proc.terminate()
        elif proc.exitcode:
            print(f"[flex-warm] exited with code {proc.exitcode}: phase 2 compiled its cases")
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()


class PhaseClock:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase}: {now - self.t:.1f} s")
        self.t = now


def main() -> None:
    # autotune's and Inductor's caches in a directory of this run: no winner
    # measured elsewhere steers impl="auto", phase 13 writes none outside,
    # and phase 2's flex_attention compilations read what this run's
    # warm-up (flex_warmed) compiled.
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir, "autotune.json")
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache_dir, "inductor")
        run()


def run() -> None:
    t_start = time.perf_counter()
    clock = PhaseClock()
    with flex_warmed():
        device_name = phase_environment()
        clock.done("1 environment and build")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        timed = phase_kernels(gen)
        clock.done("2 kernels against their plain versions")
    t0 = time.perf_counter()
    model = init_params(LLAMA_1B, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] LLAMA_1B random weights on the card in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters")
    phase_model(model, gen)
    w8 = quantized_copy(model, 8)
    quant_model = phase_quant_model(model, w8, gen)
    phase_capture(model, w8, gen)
    launches = phase_server(model, gen)
    quant_server = phase_quant_server(w8, gen)
    del w8
    launches.update({k: quant_server[k] for k in ("decode_int8", "paged_decode", "qmm8")})
    launches.update({k: quant_model[k] for k in ("decode_fp8", "qmm4")})
    clock.done("3-6 LLAMA_1B serving")
    launches["flash_bwd_fused"] = phase_train_step(model, gen)["flash_bwd_fused"]
    split = phase_trainer(model, gen)
    launches.update(flash_bwd_dq=split["flash_bwd_dq"], flash_bwd_dkv=split["flash_bwd_dkv"])
    del model
    torch.cuda.empty_cache()
    clock.done("7-8 LLAMA_1B training")
    launches.update(phase_mistral(gen))
    clock.done("9 MISTRAL_7B serving")
    add_launches(launches, phase_packed(gen))
    clock.done("10 packed MISTRAL_7B training")
    launches.update(phase_gemma(gen))
    clock.done("11 GEMMA2_9B serving")
    add_launches(launches, phase_gemma_packed(gen))
    clock.done("12 packed GEMMA2_9B training")
    add_launches(launches, phase_remat(gen))
    clock.done("13 remat and autotune")
    families, k1_long = phase_families(gen)
    add_launches(launches, families)
    clock.done("14 QWEN3_8B and LLAMA31_8B from Hugging Face names")
    spec, k2_verify = phase_speculate(gen)
    add_launches(launches, spec)
    clock.done("15 speculative decoding")
    add_launches(launches, phase_moe(gen))
    clock.done("16 Qwen3-30B-A3B and Qwen1.5-MoE-A2.7B, mixture-of-experts")
    launches.update(phase_alibi(gen))
    clock.done("17 LLAMA_8B with ALiBi")
    add_launches(launches, phase_alibi_train(gen))
    clock.done("18 LLAMA_8B with ALiBi training")
    drop_launches, drop_rows = phase_dropout(gen)
    launches.update(drop_launches)
    timed.update(drop_rows)
    clock.done("19 flash attention with dropout")
    launches.update(phase_context_parallel())
    clock.done("20 context parallelism on two ranks")
    launches["decode_lse"] = timed["decode_lse"].pop("launches")
    for row in ("qmm8_a8", "qmm4_a8", "quantize_rows"):
        launches[row] = timed[row].pop("launches")
    add_launches(launches, phase_parallel())
    clock.done("21 tensor, pipeline and expert parallelism on two ranks, split decode, recovery")
    add_launches(launches, phase_moe_train(gen))
    clock.done("22 mixture-of-experts training")
    hd_launches, hd_rows = phase_head_dims(gen, timed.pop("head_dim_k1_err"))
    launches.update(hd_launches)
    timed.update(hd_rows)
    clock.done("23 head dims 32, 80 and 96: the quality gate, TINY, Danube2's widths")
    decode_src = ("flashattn_tpu_torch/csrc/decode.cu", "flashattn_tpu/ops/decode.py:351")
    qmm_src = "flashattn_tpu_torch/csrc/quant_matmul.cu"
    sources = {
        "flash_fwd": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                      "flashattn_tpu/ops/flash_fwd.py:469"),
        "flash_fwd_window": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                             "flashattn_tpu/ops/flash_fwd.py:469"),
        "decode_window": decode_src,
        "paged_decode_window": ("flashattn_tpu_torch/csrc/decode.cu",
                                "flashattn_tpu/ops/paged.py:378"),
        "decode": decode_src,
        "decode_int8": decode_src,
        "decode_fp8": decode_src,
        "paged_decode": ("flashattn_tpu_torch/csrc/decode.cu",
                         "flashattn_tpu/ops/paged.py:378"),
        "flash_fwd_softcap": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                              "flashattn_tpu/ops/flash_fwd.py:469"),
        "decode_softcap": ("flashattn_tpu_torch/csrc/decode_d256.cu", decode_src[1]),
        "paged_decode_softcap": ("flashattn_tpu_torch/csrc/decode_d256.cu",
                                 "flashattn_tpu/ops/paged.py:378"),
        "flash_fwd_alibi": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                            "flashattn_tpu/ops/flash_fwd.py:469"),
        "decode_alibi": ("flashattn_tpu_torch/csrc/decode_alibi.cu", decode_src[1]),
        "decode_int8_alibi": ("flashattn_tpu_torch/csrc/decode_alibi.cu", decode_src[1]),
        "paged_decode_alibi": ("flashattn_tpu_torch/csrc/decode_alibi.cu",
                               "flashattn_tpu/ops/paged.py:378"),
        "decode_lse": decode_src,
        "qmm8": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:81"),
        "qmm4": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:123"),
        "qmm8_a8": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:81"),
        "qmm4_a8": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:123"),
        # x's row quantization in the jitted wrapper of the a8 mode's kernels
        "quantize_rows": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:226"),
        "flash_bwd_fused": ("flashattn_tpu_torch/csrc/flash_bwd_fused.cu",
                            "flashattn_tpu/ops/flash_bwd_fused.py:336"),
        "flash_bwd_dq": ("flashattn_tpu_torch/csrc/flash_bwd.cu",
                         "flashattn_tpu/ops/flash_bwd.py:138"),
        "flash_bwd_dkv": ("flashattn_tpu_torch/csrc/flash_bwd.cu",
                          "flashattn_tpu/ops/flash_bwd.py:286"),
        "flash_fwd_alibi_segments": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                                     "flashattn_tpu/ops/flash_fwd.py:469"),
        "flash_bwd_fused_alibi": ("flashattn_tpu_torch/csrc/flash_bwd_fused_alibi.cu",
                                  "flashattn_tpu/ops/flash_bwd_fused.py:336"),
        "flash_bwd_dq_alibi": ("flashattn_tpu_torch/csrc/flash_bwd_alibi.cu",
                               "flashattn_tpu/ops/flash_bwd.py:138"),
        "flash_bwd_dkv_alibi": ("flashattn_tpu_torch/csrc/flash_bwd_alibi.cu",
                                "flashattn_tpu/ops/flash_bwd.py:286"),
        "flash_fwd_dropout": ("flashattn_tpu_torch/csrc/flash_fwd_dropout.cu",
                              "flashattn_tpu/ops/flash_fwd.py:469"),
        "flash_bwd_fused_dropout": ("flashattn_tpu_torch/csrc/flash_bwd_fused_dropout.cu",
                                    "flashattn_tpu/ops/flash_bwd_fused.py:336"),
        "flash_bwd_dq_dropout": ("flashattn_tpu_torch/csrc/flash_bwd_dropout.cu",
                                 "flashattn_tpu/ops/flash_bwd.py:138"),
        "flash_bwd_dkv_dropout": ("flashattn_tpu_torch/csrc/flash_bwd_dropout.cu",
                                  "flashattn_tpu/ops/flash_bwd.py:286"),
        "flash_fwd_dynoff": ("flashattn_tpu_torch/csrc/flash_fwd_dynoff.cu",
                             "flashattn_tpu/ops/flash_fwd.py:469"),
        "flash_bwd_fused_dynoff": ("flashattn_tpu_torch/csrc/flash_bwd_fused_dynoff.cu",
                                   "flashattn_tpu/ops/flash_bwd_fused.py:336"),
        "flash_bwd_dq_dynoff": ("flashattn_tpu_torch/csrc/flash_bwd_dynoff.cu",
                                "flashattn_tpu/ops/flash_bwd.py:138"),
        "flash_bwd_dkv_dynoff": ("flashattn_tpu_torch/csrc/flash_bwd_dynoff.cu",
                                 "flashattn_tpu/ops/flash_bwd.py:286"),
    }
    for row in MASKED_ROWS + SOFTCAP_BWD_ROWS:  # the same kernels with a window, segment
        sources[row] = sources[row.rsplit("_", 1)[0]]  # ids or a soft-cap
    for variant in DYN_VARIANTS:  # the card offset's kernels with the cap (D 256), dropout or
        for row in DYNOFF_ROWS:  # float32; dropout's in the libraries with it
            src, rep = sources[row]
            lib = "_dynoff_dropout.cu" if variant == "dropout" else "_dynoff.cu"
            sources[f"{row}_{variant}"] = (src.replace("_dynoff.cu", lib), rep)
    for d in HD_DIMS:  # the same kernels at head dims 32, 80 and 96
        for kernel in HD_ROWS:
            sources[f"{kernel}_d{d}"] = sources[kernel]
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **timed[k]}
        for k, (src, rep) in sources.items()
    ]
    # K1 at LLAMA31_8B's 16,384-token prompt and K2 at the speculative
    # verifier's T: rows of their own, their launches counted in phases 14
    # and 15.
    kernels.append({"name": "flash_fwd_long_prompt", "route": "cuda",
                    "source": sources["flash_fwd"][0], "replaces": sources["flash_fwd"][1],
                    **k1_long})
    kernels.append({"name": f"decode_t{SPEC_K + 1}", "route": "cuda", "source": decode_src[0],
                    "replaces": decode_src[1], **k2_verify})
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on its path: {[k['name'] for k in kernels if not k['launches']]}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
