"""The port imports no JAX: every module of flashattn_tpu_torch, and
chip_smoke.py, import and run on the CPU in a process where `import jax`
fails (generation, the server, two training steps, the quantized paged
server with a shared prefix and chunked admission, its calibrations, the
timing harness, the roofline, a windowed model with sinks generating
and serving, packed windowed training: ops/varlen.py's
flash_attention_varlen with its gradient, and models/data.py's
PackedDataset through prefetch into train.train, a Gemma-2-shaped model
(D 256, soft-caps, post-norms, alternate windows) generating and serving
from an int8 KV pool with chunked admission, a Qwen3-shaped model read
by load_hf_dir from a safetensors checkpoint, served from an int8 KV pool
and decoded speculatively, and a Qwen2-MoE-shaped model, its experts read
from one entry each by load_hf_dir, served from an int8 KV pool; the
parallel layer on one gloo rank: the rings, Ulysses, the model under
data x sp, model and pp, the sharded decode, the expert dispatchers and
the collective probe). A CPU call takes the plain versions and launches no
kernel."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError

import flashattn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(flashattn_tpu_torch.__path__,
                                                "flashattn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the GPU smoke script imports no JAX either

import torch
from flashattn_tpu_torch.models import generate, llama, train
from flashattn_tpu_torch.models.config import TINY
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import (decode, flash_bwd, flash_bwd_fused, flash_fwd, paged,
                                     quant_matmul)

model = llama.init_params(TINY, torch.Generator().manual_seed(0), device="cpu")
generate.generate(model, torch.tensor([[1, 2, 3]]), max_new_tokens=3)
srv = InferenceServer(model, max_slots=2, max_len=128)
srv.submit(Request(uid=0, prompt=[4, 5], max_new_tokens=3))
assert len(srv.run()[0]) == 3
state, hist = train.train(model, iter([torch.randint(0, 512, (2, 17))] * 2),
                          train.TrainConfig(warmup_steps=1), steps=2, log_every=1)
assert state["step"] == 2 and len(hist) == 2
# The quantized, paged serving path: int8 weights, an int8 KV pool, a shared
# prefix and chunked admission.
llama.quantize_params(model, bits=8)
srv = InferenceServer(model, max_slots=2, max_len=256, quant="int8", paged=True,
                      page_size=64, admit_chunk=64, return_logprobs=True)
pid = srv.register_prefix(list(range(64)))
srv.submit(Request(uid=1, prompt=list(range(70)), max_new_tokens=3, prefix_id=pid))
srv.submit(Request(uid=2, prompt=[4, 5], max_new_tokens=3))
out = srv.run()
assert len(out[1]) == len(out[2]) == 3 and len(srv.finished_logprobs[1]) == 3
srv.unregister_prefix(pid)
assert srv.allocator.free_pages == srv.allocator.num_pages
# The server's calibrations, the timing harness and the roofline.
assert srv.calibrate_device_step(iters=2) > 0 and srv.stats()["device_step_ms"] > 0
assert srv.calibrate_admit(prompt_len=130, prefix_len=64, iters=1)["device_speedup"] > 0
from flashattn_tpu_torch.utils import roofline, timing
assert roofline.attention_fwd_roofline(1, 2, 2, 64, 64, 64, True,
                                       chip=roofline.H100_SXM).bound_ms > 0
assert timing.measure_looped(torch.matmul, torch.ones(4, 4), torch.ones(4, 4), iters=3) > 0
# A windowed model (alternate layers, sinks): generation and the paged server
# with chunked admission, prompts past the window.
import dataclasses
win = llama.init_params(dataclasses.replace(TINY, attn_window=16, attn_sink=4,
                                            window_pattern="alternate"),
                        torch.Generator().manual_seed(1), device="cpu")
generate.generate(win, torch.tensor([list(range(40))]), max_new_tokens=3)
srv = InferenceServer(win, max_slots=2, max_len=128, paged=True, page_size=64,
                      admit_chunk=32)
srv.submit(Request(uid=3, prompt=list(range(50)), max_new_tokens=20))
assert len(srv.run()[3]) == 20
# Packed, windowed training: varlen attention with its gradient, then
# PackedDataset batches through prefetch into the trainer.
from flashattn_tpu_torch.models import data
from flashattn_tpu_torch.ops.varlen import flash_attention_varlen
q = torch.randn((1, 4, 50, 16), requires_grad=True)
ids = torch.tensor([[0] * 20 + [1] * 25 + [-1] * 5], dtype=torch.int32)
flash_attention_varlen(q, q[:, :2], q[:, :2], segment_ids=ids, is_causal=True,
                       window=8).sum().backward()
assert q.grad is not None
ds = data.PackedDataset([list(range(1, n)) for n in (30, 12, 45, 7)], batch_size=2,
                        seq_len=32, seed=0)
state, hist = train.train(win, data.prefetch(ds.batches()), train.TrainConfig(warmup_steps=1),
                          steps=2, log_every=1)
assert state["step"] == 2 and len(hist) == 2
# A Gemma-2-shaped model: head dim 256, attention and final soft-caps,
# post-norms, alternate windows; generation and the int8-KV paged server.
gemma = llama.init_params(dataclasses.replace(
    TINY, head_dim=256, num_layers=2, attn_window=16, window_pattern="alternate",
    logit_softcap=50.0, final_logit_softcap=30.0, use_post_norms=True, norm_offset=1.0,
    mlp_activation="gelu_tanh", scale_embeddings=True, tie_embeddings=True),
    torch.Generator().manual_seed(2), device="cpu")
generate.generate(gemma, torch.tensor([list(range(30))]), max_new_tokens=3)
srv = InferenceServer(gemma, max_slots=2, max_len=128, quant="int8", paged=True,
                      page_size=64, admit_chunk=32)
srv.submit(Request(uid=4, prompt=list(range(45)), max_new_tokens=4))
assert len(srv.run()[4]) == 4
# A Qwen3-shaped model (q/k RMSNorm, D 128) loaded by load_hf_dir from a
# sharded safetensors checkpoint under the Hugging Face names (written by
# chip_smoke.py's writer: no safetensors package), through the int8-KV paged
# server with chunked admission, then speculative decoding (self-draft,
# paged caches).
import tempfile
from pathlib import Path
from flashattn_tpu_torch.models import convert
from flashattn_tpu_torch.models.speculate import speculative_generate
qcfg = dataclasses.replace(TINY, head_dim=128, num_heads=4, num_kv_heads=2, qk_norm=True,
                           norm_eps=1e-6, rope_theta=1e6)
hf = chip_smoke.hf_state_dict(qcfg, torch.Generator().manual_seed(3), device="cpu")
with tempfile.TemporaryDirectory() as ckpt:
    chip_smoke.write_hf_checkpoint(ckpt, hf, qcfg, shard_bytes=1 << 20)
    assert len(list(Path(ckpt).glob("model-*-of-*.safetensors"))) > 1
    qwen, loaded_cfg = convert.load_hf_dir(ckpt, torch.bfloat16, device="cpu")
assert loaded_cfg == qcfg, loaded_cfg
want = convert.params_from_hf(hf, qcfg)
assert all(torch.equal(v, want[k]) for k, v in qwen.state_dict().items())
srv = InferenceServer(qwen, max_slots=2, max_len=128, quant="int8", paged=True, page_size=64,
                      admit_chunk=32)
srv.submit(Request(uid=5, prompt=list(range(45)), max_new_tokens=4))
srv.submit(Request(uid=6, prompt=[7, 8, 9], max_new_tokens=4))
out = srv.run()
assert len(out[5]) == len(out[6]) == 4
toks, rate = speculative_generate(qwen, qwen, torch.tensor([list(range(20))]), max_new_tokens=6,
                                  k=2, paged=True, page_size=64)
assert rate == 1.0 and toks.shape == (1, 6)
# A Qwen2-MoE-shaped model (routed experts, a shared expert, biases) read by
# load_hf_dir from a sharded checkpoint of one entry an expert, then the
# int8-KV paged server with chunked admission: every FFN the grouped dispatch.
mcfg = chip_smoke.moe_hf_config(dict(chip_smoke.QWEN15_MOE_JSON, hidden_size=64,
                                     num_attention_heads=2, num_key_value_heads=2,
                                     moe_intermediate_size=32, shared_expert_intermediate_size=48,
                                     num_experts=6, num_hidden_layers=2, vocab_size=128))
hf = chip_smoke.hf_state_dict(mcfg, torch.Generator().manual_seed(4), device="cpu")
with tempfile.TemporaryDirectory() as ckpt:
    chip_smoke.write_hf_checkpoint(ckpt, hf, mcfg, shard_bytes=1 << 15)
    moe_model, loaded_cfg = convert.load_hf_dir(ckpt, torch.bfloat16, device="cpu")
assert loaded_cfg == mcfg and moe_model.layers[1].moe.w_gate.shape == (6, 64, 32), loaded_cfg
srv = InferenceServer(moe_model, max_slots=2, max_len=128, quant="int8", paged=True,
                      page_size=64, admit_chunk=32)
srv.submit(Request(uid=7, prompt=list(range(45)), max_new_tokens=4))
assert len(srv.run()[7]) == 4
# The parallel layer on a process group of one gloo rank: the zigzag ring
# through the global view with a window and ALiBi (dyn_pos_offset), its
# gradient, Ulysses, an SGD step and train.train under a data x sp mesh, a
# loss under model, pp (remat) and the sharded decode, both expert
# dispatchers and the collective probe.
import os
from flashattn_tpu_torch import parallel
with tempfile.TemporaryDirectory() as rdv:
    parallel.initialize_distributed("gloo", f"file://{os.path.join(rdv, 'store')}", 1, 0)
    mesh = parallel.make_mesh({"data": 1, "sp": 1})
    x = torch.randn((1, 2, 16, 8), requires_grad=True)
    parallel.sharded_ring_attention(x, x, x, mesh, True, mode="zigzag", window=4,
                                    alibi=True).sum().backward()
    parallel.sharded_ring_attention(x, x, x, mesh, True, mode="ulysses").sum().backward()
    assert x.grad is not None
    cp = llama.init_params(TINY, torch.Generator().manual_seed(5), device="cpu")
    loss, _ = llama.sgd_train_step(cp, torch.randint(0, 512, (1, 17)), mesh=mesh)
    state, hist = train.train(cp, iter([torch.randint(0, 512, (1, 17))] * 2),
                              train.TrainConfig(warmup_steps=1), steps=2, log_every=1, mesh=mesh)
    assert bool(torch.isfinite(loss)) and len(hist) == 2
    # Tensor, pipeline and expert parallelism, sharded decode and the probe.
    tp = parallel.make_mesh({"data": 1, "model": 1})
    llama.loss_fn(llama.shard_params(cp, tp), torch.randint(0, 512, (2, 17)), mesh=tp).backward()
    pp = parallel.make_mesh({"data": 1, "pp": 1})
    llama.pipeline_loss_fn(llama.stack_pipeline_params(cp, 1, pp), torch.randint(0, 512, (2, 17)),
                           pp, 2, remat=True).backward()
    sp = parallel.make_mesh({"sp": 1})
    from flashattn_tpu_torch.ops.kvcache import init_cache
    kv = init_cache(1, 2, 64, 16, dtype=torch.float32, device="cpu")
    kv.length.fill_(10)
    assert parallel.sharded_decode_attention(torch.randn(1, 4, 16), kv, sp).shape == (1, 4, 16)
    experts = parallel.init_moe_params(torch.Generator().manual_seed(6), 16, 32, 4)
    xs = torch.randn(8, 16)
    assert parallel.moe_ffn(xs, experts, 2).shape == parallel.moe_ffn_a2a(xs, experts, 2).shape
    from flashattn_tpu_torch.utils.failure import probe_collectives
    assert probe_collectives(sp, 30.0, device="cpu")
    torch.distributed.destroy_process_group()
from flashattn_tpu_torch.ops import launches
assert not any(launches.read().values()), f"CPU call counted a launch: {launches.read()}"
counts = (flash_fwd.LAUNCHES, decode.LAUNCHES, decode.INT8_LAUNCHES, decode.FP8_LAUNCHES,
          paged.LAUNCHES, quant_matmul.QMM8_LAUNCHES, quant_matmul.QMM4_LAUNCHES,
          flash_bwd.DQ_LAUNCHES, flash_bwd.DKV_LAUNCHES, flash_bwd_fused.LAUNCHES,
          flash_fwd.WINDOW_LAUNCHES, decode.WINDOW_LAUNCHES, paged.WINDOW_LAUNCHES,
          flash_fwd.SEGMENT_LAUNCHES, flash_bwd_fused.WINDOW_LAUNCHES,
          flash_bwd_fused.SEGMENT_LAUNCHES, flash_bwd.DQ_WINDOW_LAUNCHES,
          flash_bwd.DKV_SEGMENT_LAUNCHES, flash_fwd.SOFTCAP_LAUNCHES,
          decode.SOFTCAP_LAUNCHES, paged.SOFTCAP_LAUNCHES)
assert counts == (0,) * 21, f"CPU call counted a launch: {counts}"
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "flashattn_tpu" or m.startswith("flashattn_tpu.")]
assert loaded == ["jax"], loaded  # only the None placeholder
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
    assert int(proc.stdout.split()[1]) >= 20  # every module was imported
