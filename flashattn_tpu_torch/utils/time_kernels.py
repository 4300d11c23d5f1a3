"""Device time of the port's kernels at the serving and training shapes,
through their public entry points only.

    python -m flashattn_tpu_torch.utils.time_kernels [--tag NAME]

Times, by CUDA-graph replay (utils/timing.py::cuda_time_ms), on LLAMA_1B's
decode step (B 4, Hq 32, Hkv 4, D 64, Smax 2048, lengths 1/77/1500/2048):
K2 on bf16, int8 and fp8 caches and the paged K2 on an int8 pool of
256-token pages at T 1, K2 int8 at T 256 (a chunked admission's step);
qmm8 and qmm4 on the gate/up projection (K 2048, N 5632) at M 4 and 256;
K1, causal, at the prefill bucket (B 1, Hq 32, Hkv 4, S 256, D 64, no
LSE), the training shape (B 4, Hq 32, Hkv 4, S 2048, D 64, with the LSE)
and D 128 (B 4, Hq = Hkv = 8, S 16384, with the LSE); the backward
kernels, causal, at the training shape: B3 (fused) and B4 (dQ) and B5
(dK/dV); the sliding window at MISTRAL_7B's shapes: K1 at a 4,608-token prefill (B 1, Hq 32,
Hkv 8, D 128, window 4096, no LSE), K2 and the paged K2 (pages of 256) on
a bf16 cache at T 1 (B 4, Hq 32, Hkv 8, D 128, Smax 8192, every length
8192, window 4096, 4 sinks) beside the same K2 call without a window;
and, where the package has them (ops/flash_bwd.py's segment counters),
the packed training row (B 1, Hq 32, Hkv 8, D 128, S 8192, window 4096,
documents of 6100, 1300, 517 and 211 tokens, then 64 of padding): K1 with
the LSE and B3, B4 and B5 with the window and segment ids; and, where the
package has the soft-cap (ops/flash_fwd.py's SOFTCAP_LAUNCHES), GEMMA2_9B's
rows with cap 50: K1 at its prefill (B 1, Hq 16, Hkv 8, S 4608, D 256, no
LSE) on a global layer, a local one (window 4096) and without the cap, K1
with the cap at the MISTRAL_7B window row (the cap's own cost at D 128),
and K2 on a bf16 cache at T 1 (B 2, Hq 16, Hkv 8, D 256, Smax 8192, every
length 8192) global and local, the paged K2 (pages of 256) global, and K2
on an int8 cache at T 256; and, where the backward kernels take the
soft-cap (ops/flash_bwd.py's DQ_SOFTCAP_LAUNCHES), GEMMA2_9B's packed
training row (B 1, Hq 16, Hkv 8, D 256, S 8192, the packed row's
documents): K1 with the LSE and B3, B4 and B5 with cap 50 on a global
layer, a local one (window 4096) and the global one without the cap; and,
where the package has ALiBi (ops/flash_fwd.py's ALIBI_LAUNCHES), K1 with
ALiBi at the prefill bucket and at LLAMA_8B's heads over a 4,608-token
prefill (B 1, Hq 32, Hkv 8, D 128, no LSE), K2 with ALiBi at the decode
step on bf16 and int8 caches at T 1 and the int8 cache at T 256, the
paged K2 with ALiBi on the int8 pool at T 1; and, where the backward
kernels take ALiBi (ops/flash_bwd.py's DQ_ALIBI_LAUNCHES), LLAMA_8B's
training rows with ALiBi (B 1, Hq 32, Hkv 8, D 128): K1 with the LSE and
B3, B4 and B5 on the packed row (S 8192, the packed row's documents) and
B3, B4 and B5 on the unpacked row of 4,096 tokens; and, where the
kernels take attention dropout (ops/flash_fwd.py's DROPOUT_LAUNCHES), K1
with the LSE and B3, B4 and B5 with dropout (rate 0.1) at the training
shape and at D 128 (B 4, Hq = Hkv = 8, S 16384); and, where the kernels
take dyn_pos_offset (ops/flash_fwd.py's DYNOFF_LAUNCHES), K1 with the LSE
and B3, B4 and B5 at the zigzag ring's chunk pair (B 1, Hq 32, Hkv 8, a
4,096-row chunk against 4,096 keys, D 128) with the offset 4,096 read on
the card, the window 4,096 and ALiBi. Prints the card's name and power limit, then one JSON line of
milliseconds. It calls nothing but the public functions, so run as a file
with another checkout of the package first on PYTHONPATH,

    PYTHONPATH=<other checkout> python flashattn_tpu_torch/utils/time_kernels.py --tag old

it times that checkout's kernels: two versions compared in turns on one
card. `--only k1,backward` times those groups alone (decode, qmm, k1,
backward, window, packed, softcap, gemma_packed, alibi, alibi_train,
dropout, dynoff). Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import torch

from flashattn_tpu_torch.ops import (decode, flash_bwd, flash_bwd_fused, flash_fwd, kvcache, paged,
                                     quant_matmul)
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.utils.timing import cuda_time_ms

SEED = 0
B, HQ, HKV, D, SMAX = 4, 32, 4, 64, 2048
LENGTHS = [1, 77, 1500, 2048]
PAGE = 256
CHUNK = 256
K, N = 2048, 5632
# K1's shapes: name -> (B, Hq, Hkv, S, D, need_lse).
K1_SHAPES = {"k1_prefill": (1, 32, 4, 256, 64, False),
             "k1_train": (4, 32, 4, 2048, 64, True),
             "k1_d128": (4, 8, 8, 16384, 128, True)}
# The windowed kernels at MISTRAL_7B's widths.
WIN, SINK = 4096, 4
K1_WINDOW = (1, 32, 8, 4608, 128)  # B, Hq, Hkv, S, D
WIN_B, WIN_HKV, WIN_SMAX = 4, 8, 8192
GROUPS = ("decode", "qmm", "k1", "backward", "window", "packed", "softcap", "gemma_packed",
          "alibi", "alibi_train", "dropout", "dynoff")
# GEMMA2_9B's rows: its prefill (B, Hq, Hkv, S, D) and its decode step.
CAP = 50.0
K1_GEMMA = (1, 16, 8, 4608, 256)
GEMMA_B, GEMMA_SMAX = 2, 8192
# The packed training row of chip_smoke.py's packed phase.
PACK_DOCS, PACK_S = (6100, 1300, 517, 211), 8192


def cache_of(quant: str | None, gen: torch.Generator) -> KVCache:
    shape = (B, HKV, SMAX, D)
    kv = [torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
          for _ in range(2)]
    length = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    if quant is None:
        return KVCache(k=kv[0], v=kv[1], length=length)
    cache = kvcache.init_cache(B, HKV, SMAX, D, quant=quant, device="cuda")
    kvcache.update_cache(cache, kv[0], kv[1], assume_fits=True)
    cache.length.copy_(length)
    return cache


def pool_of(cache: KVCache) -> paged.PagedKVCache:
    """The int8 cache's content in a pool of PAGE-token pages, in order."""
    maxp = SMAX // PAGE
    pool = paged.init_paged_cache(B, HKV, B * maxp, PAGE, D, maxp, quant="int8",
                                  device="cuda")
    for i, n in enumerate(LENGTHS):
        pages = list(range(i * maxp, (i + 1) * maxp))
        row = KVCache(k=cache.k[i:i + 1], v=cache.v[i:i + 1], length=cache.length[i:i + 1],
                      k_scale=cache.k_scale[i:i + 1], v_scale=cache.v_scale[i:i + 1])
        paged.write_pages(pool, row, pages)
        paged.set_block_table(pool, i, pages, n)
    return pool


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tag", default="", help="a label printed with the numbers")
    parser.add_argument("--only", default=",".join(GROUPS),
                        help=f"comma-separated groups to time, of {','.join(GROUPS)}")
    args = parser.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        raise SystemExit(f"--only takes groups of {GROUPS}, got {args.only}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ms = {}
    if "decode" in only:
        ms.update(decode_rows(gen))
    if "qmm" in only:
        ms.update(qmm_rows(gen))
    if "k1" in only:
        ms.update(k1_rows(gen))
    if "backward" in only:
        ms.update(backward(gen, K1_SHAPES["k1_train"][:5], "train"))
    if "window" in only:
        ms.update(windowed(gen))
    if "packed" in only and hasattr(flash_bwd, "DQ_SEGMENT_LAUNCHES"):
        ms.update(packed(gen))
    if "softcap" in only and hasattr(flash_fwd, "SOFTCAP_LAUNCHES"):
        ms.update(softcapped(gen))
    if "gemma_packed" in only and hasattr(flash_bwd, "DQ_SOFTCAP_LAUNCHES"):
        ms.update(gemma_packed(gen))
    if "alibi" in only and hasattr(flash_fwd, "ALIBI_LAUNCHES"):
        ms.update(alibi(gen))
    if "alibi_train" in only and hasattr(flash_bwd, "DQ_ALIBI_LAUNCHES"):
        ms.update(alibi_train(gen))
    if "dropout" in only and hasattr(flash_fwd, "DROPOUT_LAUNCHES"):
        ms.update(dropout(gen))
    if "dynoff" in only and hasattr(flash_fwd, "DYNOFF_LAUNCHES"):
        ms.update(dynoff(gen))
    print(json.dumps({"tag": args.tag, "ms": ms}))


def decode_rows(gen: torch.Generator) -> dict[str, float]:
    """K2 on bf16, int8 and fp8 caches at T 1, int8 at T 256, the paged K2."""
    ms = {}
    qd = torch.randn((B, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    for quant in (None, "int8", "fp8"):
        cache = cache_of(quant, gen)
        ms[f"decode_{quant or 'bf16'}"] = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
        if quant == "int8":
            q256 = torch.randn((B, HQ, CHUNK, D), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
            ms[f"decode_int8_t{CHUNK}"] = cuda_time_ms(
                lambda: decode.decode_attention_chunk(q256, cache))
            pool = pool_of(cache)
            ms["paged_decode_int8"] = cuda_time_ms(
                lambda: paged.paged_decode_attention(qd, pool))
    return ms


def qmm_rows(gen: torch.Generator) -> dict[str, float]:
    """qmm8 and qmm4 on the gate/up projection at M 4 and 256."""
    ms = {}
    w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
    for bits in (8, 4):
        qw = quant_matmul.quantize_weights(w, bits)
        for m in (4, 256):
            x = torch.randn((m, K), generator=gen, device="cuda", dtype=torch.bfloat16)
            ms[f"qmm{bits}_m{m}"] = cuda_time_ms(lambda: quant_matmul.quant_matmul(x, qw))
    return ms


def k1_rows(gen: torch.Generator) -> dict[str, float]:
    """K1, causal, at K1_SHAPES."""
    ms = {}
    for name, (b, hq, hkv, s, d, need_lse) in K1_SHAPES.items():
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv))
        ms[name] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, need_lse=need_lse), warmup=2, iters=5, reps=5)
        del q, k, v
    return ms


def backward(gen: torch.Generator, shape, tag: str, **opts) -> dict[str, float]:
    """B3, B4 and B5 (causal) at shape (B, Hq, Hkv, S, D) with the forward's
    O and LSE, and the options (window, segment_ids, logit_softcap, alibi,
    dropout_rate and dropout_seed) of both; K1 with the LSE too where there
    are segment ids or dropout."""
    b, hq, hkv, s, d = shape
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, **opts)
    few = dict(warmup=2, iters=5, reps=5)
    out = {f"b3_{tag}": cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
               q, k, v, o, do, lse, True, **opts), **few),
           f"b4_{tag}": cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True,
                                                                    **opts), **few)}
    _, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, True, **opts)
    out[f"b5_{tag}"] = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta, True,
                                                                    **opts), **few)
    if "segment_ids" in opts or "dropout_rate" in opts:
        out[f"k1_{tag}"] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, **opts), **few)
    return out


def packed_ids():
    """The packed training row's canonical (seg_q, seg_k)."""
    # Imported here: a checkout from before segment ids has no ops/varlen.py.
    from flashattn_tpu_torch.ops.varlen import canonical_segments, segment_ids_from_cu_seqlens

    cu = torch.tensor([0, *itertools.accumulate(PACK_DOCS)], device="cuda")
    ids = segment_ids_from_cu_seqlens(cu, PACK_S)[None]
    return canonical_segments(ids, ids, ids.device)


def packed(gen: torch.Generator) -> dict[str, float]:
    """K1, B3, B4 and B5 with the window and segment ids at the packed
    training row."""
    b, hq, hkv, _, d = K1_WINDOW
    return backward(gen, (b, hq, hkv, PACK_S, d), "packed", window=WIN,
                    segment_ids=packed_ids())


def gemma_packed(gen: torch.Generator) -> dict[str, float]:
    """K1, B3, B4 and B5 at GEMMA2_9B's packed training row with cap 50, on
    a global layer, a local one (window 4096), and without the cap."""
    b, hq, hkv, _, d = K1_GEMMA
    shape, seg = (b, hq, hkv, PACK_S, d), packed_ids()
    ms = backward(gen, shape, "gemma_packed", segment_ids=seg, logit_softcap=CAP)
    ms.update(backward(gen, shape, "gemma_packed_local", segment_ids=seg, window=WIN,
                       logit_softcap=CAP))
    ms.update(backward(gen, shape, "gemma_packed_nocap", segment_ids=seg))
    return ms


def windowed(gen: torch.Generator) -> dict[str, float]:
    """The sliding window's rows: K1 at the Mistral prefill, K2 dense and
    paged at T 1 on full 8192-token caches, and K2 there without a window."""
    b, hq, hkv, s, d = K1_WINDOW
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (hq, hkv, hkv))
    ms = {"k1_window": cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
        q, k, v, True, need_lse=False, window=WIN))}
    shape = (WIN_B, WIN_HKV, WIN_SMAX, d)
    cache = KVCache(*(torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                      for _ in range(2)),
                    length=torch.full((WIN_B,), WIN_SMAX, dtype=torch.int32, device="cuda"))
    maxp = WIN_SMAX // PAGE
    pool = paged.init_paged_cache(WIN_B, WIN_HKV, WIN_B * maxp, PAGE, d, maxp, device="cuda")
    for i in range(WIN_B):
        row = KVCache(k=cache.k[i:i + 1], v=cache.v[i:i + 1], length=cache.length[i:i + 1])
        paged.write_slot_paged(pool, row, i, list(range(i * maxp, (i + 1) * maxp)))
    qd = torch.randn((WIN_B, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    ms["decode_window_bf16"] = cuda_time_ms(
        lambda: decode.decode_attention(qd, cache, window=WIN, sink=SINK))
    ms["decode_no_window_bf16"] = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
    ms["paged_decode_window_bf16"] = cuda_time_ms(
        lambda: paged.paged_decode_attention(qd, pool, window=WIN, sink=SINK))
    return ms


def softcapped(gen: torch.Generator) -> dict[str, float]:
    """GEMMA2_9B's soft-capped rows (module docstring)."""
    b, hq, hkv, s, d = K1_GEMMA
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (hq, hkv, hkv))
    ms = {}
    for name, kw in (("k1_gemma", dict(logit_softcap=CAP)),
                     ("k1_gemma_window", dict(window=WIN, logit_softcap=CAP)),
                     ("k1_d256", {})):
        ms[name] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, need_lse=False, **kw))
    b, hq, hkv, s, d = K1_WINDOW
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (hq, hkv, hkv))
    ms["k1_window_softcap"] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
        q, k, v, True, need_lse=False, window=WIN, logit_softcap=CAP))
    del q, k, v
    _, hq, hkv, _, d = K1_GEMMA
    shape = (GEMMA_B, hkv, GEMMA_SMAX, d)
    length = torch.full((GEMMA_B,), GEMMA_SMAX, dtype=torch.int32, device="cuda")
    kv = [torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
          for _ in range(2)]
    cache = KVCache(*kv, length=length)
    maxp = GEMMA_SMAX // PAGE
    pool = paged.init_paged_cache(GEMMA_B, hkv, GEMMA_B * maxp, PAGE, d, maxp, device="cuda")
    for i in range(GEMMA_B):
        row = KVCache(k=cache.k[i:i + 1], v=cache.v[i:i + 1], length=cache.length[i:i + 1])
        paged.write_slot_paged(pool, row, i, list(range(i * maxp, (i + 1) * maxp)))
    qd = torch.randn((GEMMA_B, hq, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    ms["decode_gemma_bf16"] = cuda_time_ms(
        lambda: decode.decode_attention(qd, cache, logit_softcap=CAP))
    ms["decode_gemma_window_bf16"] = cuda_time_ms(
        lambda: decode.decode_attention(qd, cache, window=WIN, logit_softcap=CAP))
    ms["paged_decode_gemma_bf16"] = cuda_time_ms(
        lambda: paged.paged_decode_attention(qd, pool, logit_softcap=CAP))
    del pool
    cache8 = kvcache.init_cache(GEMMA_B, hkv, GEMMA_SMAX, d, quant="int8", device="cuda")
    kvcache.update_cache(cache8, *kv, assume_fits=True)
    q256 = torch.randn((GEMMA_B, hq, CHUNK, d), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    ms[f"decode_gemma_int8_t{CHUNK}"] = cuda_time_ms(
        lambda: decode.decode_attention_chunk(q256, cache8, logit_softcap=CAP))
    return ms


def alibi(gen: torch.Generator) -> dict[str, float]:
    """The ALiBi rows (module docstring), the standard slopes."""
    ms = {}
    for name, (b, hq, hkv, s, d) in (("k1_prefill_alibi", K1_SHAPES["k1_prefill"][:5]),
                                     ("k1_llama8b_alibi", (1, 32, 8, 4608, 128))):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv))
        ms[name] = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
            q, k, v, True, need_lse=False, alibi=True))
    qd = torch.randn((B, HQ, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    for quant in (None, "int8"):
        cache = cache_of(quant, gen)
        ms[f"decode_{quant or 'bf16'}_alibi"] = cuda_time_ms(
            lambda: decode.decode_attention(qd, cache, alibi=True))
    q256 = torch.randn((B, HQ, CHUNK, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    ms[f"decode_int8_t{CHUNK}_alibi"] = cuda_time_ms(
        lambda: decode.decode_attention_chunk(q256, cache, alibi=True))
    pool = pool_of(cache)
    ms["paged_decode_int8_alibi"] = cuda_time_ms(
        lambda: paged.paged_decode_attention(qd, pool, alibi=True))
    return ms


def alibi_train(gen: torch.Generator) -> dict[str, float]:
    """LLAMA_8B's training rows with ALiBi (module docstring)."""
    b, hq, hkv, _, d = K1_WINDOW
    ms = backward(gen, (b, hq, hkv, PACK_S, d), "alibi_packed", segment_ids=packed_ids(),
                  alibi=True)
    ms.update(backward(gen, (b, hq, hkv, 4096, d), "alibi_s4096", alibi=True))
    return ms


def dropout(gen: torch.Generator) -> dict[str, float]:
    """K1, B3, B4 and B5 with dropout (rate 0.1) at the training shape and
    at D 128 (module docstring), the seed a tensor on the card, as a
    trainer passes it (an int seed adds a fill kernel a call)."""
    drop = dict(dropout_rate=0.1,
                dropout_seed=torch.tensor(20181, dtype=torch.int32, device="cuda"))
    ms = backward(gen, K1_SHAPES["k1_train"][:5], "train_dropout", **drop)
    ms.update(backward(gen, K1_SHAPES["k1_d128"][:5], "d128_dropout", **drop))
    return ms



def dynoff(gen: torch.Generator) -> dict[str, float]:
    """K1 (with the LSE), B3, B4 and B5 with dyn_pos_offset (module
    docstring), not causal, the offset a tensor on the card."""
    b, hq, hkv, s, d = 1, 32, 8, 4096, 128
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda", dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    opts = dict(window=4096, alibi=True,
                dyn_pos_offset=torch.tensor([4096], dtype=torch.int32, device="cuda"))
    few = dict(warmup=2, iters=5, reps=5)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, **opts)
    ms = {"k1_dynoff": cuda_time_ms(lambda: flash_fwd.flash_attention_forward(
              q, k, v, False, **opts), **few),
          "b3_dynoff": cuda_time_ms(lambda: flash_bwd_fused.flash_attention_backward_fused(
              q, k, v, o, do, lse, False, **opts), **few),
          "b4_dynoff": cuda_time_ms(lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, False,
                                                                   **opts), **few)}
    _, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, False, **opts)
    ms["b5_dynoff"] = cuda_time_ms(lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                   False, **opts), **few)
    return ms


if __name__ == "__main__":
    main()
