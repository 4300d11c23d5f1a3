"""Kernels K1 (flash forward; bf16 at D 64 and D 128, bitwise
deterministic, alone on the card under torch.profiler), K2
(flash-decode, dense and paged, bf16/f32, int8 and fp8 caches), the
backward kernels (B3's fused kernel, B4's dQ and
B5's dK/dV kernels) and qmm8/qmm4 (weight-only quantized matmuls) on the
card, against their plain PyTorch versions on the same CUDA tensors, at the
edges the smoke run does not reach: float32 inputs, rows that see no key, an
empty sequence, a full cache, D=128, large GQA groups, long chunks (T 256),
ragged lengths, pages of 64 and 256, K2 bitwise deterministic and its
int8 call alone on the card (no PyTorch kernel around its own two, under
torch.profiler), qmm8 and qmm4 at M 1 to
1024 on both sides of the split-K/tensor-core boundary (M 16/17) with bf16
and float32 x, the
wrappers' refusals, autograd through flash_attention, and small models on the card
against the CPU. The bf16 backward's tensor-core tile also meets the
training shape's GQA (Hq 32, Hkv 4) at S 1024 and a ragged S 1000 at D 128,
over which its q-tile double buffer wraps many times; the split path is
bitwise deterministic at D 64 and D 128, and fused and split agree in bf16
and float32. The decode step captured in a CUDA graph (generate.DecodeGraph)
gives the eager step's logits and cache bytes exactly, for every cache kind
and weight width; a captured server re-admits into a freed slot as a fresh
server admits, replays once a decode step and counts each replay's
launches, which the profiler sees run; the calibrations leave the caches alone; the timing harness,
the profiler helper and the roofline's card detection work on the card. The
backward kernels take the sliding window (windows of one key to past S,
GQA at D 128, S_q != S_k with a pos_offset, rows without keys, MISTRAL_7B's
widths) and, with K1, packed-document segment ids (ragged documents and
padding, causal or not, with a window, a (seg_q, seg_k) pair with S_q !=
S_k; padding's outputs and gradients exactly 0), the split path bitwise
equal with both; varlen attention, the packed model's loss and a train
step run through the kernels. K1 and K2 (dense and paged, every cache
mode) take head dim 256 and the logit soft-cap (caps of 5 to 50 on logits
that pass them, with windows, sinks, S_q != S_k and rows without keys;
paged equal to dense bit for bit), and a tiny Gemma-2 model on the card
matches the CPU. The backward kernels take the soft-cap (its tanh
derivative) and D 256, with a window, segment ids (K1 too) and hot inputs
whose logits saturate the tanh, the split path bitwise equal at D 256;
gradients through flash_attention and varlen with a cap run them, and a
tiny Gemma-2 model's loss gradients on the card match the CPU's. K1 and K2
(dense and paged, every cache mode) take ALiBi (D 64, 128 and 256, with a
window, S_q != S_k, rows without keys, one steep head over 16,384 keys and
over an int8 cache of 2,048; paged equal to dense bit for bit), K2 writes
the rows' LSE (merged or from one slice; -inf for an empty slot), and a
tiny ALiBi model on the card matches the CPU and captures its step. The
backward kernels take ALiBi (D 64, 128 and 256; no mask, a window, segment
ids with and without a window, GQA, S_q != S_k with a pos_offset, rows
without keys, one steep head over 4,096 keys; bf16 and float32, fused and
split), K1 takes ALiBi with segment ids, the split path is bitwise equal
with ALiBi, gradients through flash_attention and varlen with ALiBi run
them, and a tiny ALiBi model's loss gradients on the card match the CPU's.
K1, B3, B4 and B5 take attention dropout: each kernel's keep mask, read
out of its outputs (utils/dropout_readout.py), equals the plain
dropout_keep_mask bit for bit (bf16 and float32, D 64, 128 and 256, GQA,
rates 0.1 and 0.5, seeds -7, 0 and 2^31 - 1); the kernels match their
plain versions on the same mask beside every option; rate 0 gives the
bits of the call without dropout; one seed gives one result, an int or a
tensor on the card; a gradient through flash_attention with dropout runs
them; the libraries without dropout hold none of its kernels.

These tests need a CUDA device and skip without one. On the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX, which the card's machine
does not need.) Tolerances: bf16 outputs atol 2e-2 (the repo's bf16 gate),
float32 atol 1e-4 and rtol 1e-4 (exp2 against exp, fp32 sums in another
order), LSE atol 1e-3; quantized decode rtol 2e-2, atol 2e-2 (the JAX
package's quantized-decode gate, tests/test_decode.py; the kernel
requantizes int8 P per 64-position tile, the plain version per row); the
quantized matmuls atol 2e-2, rtol 1e-2 (bf16 outputs, fp32 sums in another
order); paged decode equal to dense decode bit for bit; small quantized
models on the card against the CPU atol 2e-2, rtol 2e-2, or with an int8 KV
cache chip_smoke.py's logits rule (cosine > 0.999, max |d| <= 0.05 max |ref|); gradients in bf16 rtol 2e-2, atol 5e-2 (the repo's
bf16-gradient gate), in float32 atol 2e-4, rtol 1e-4 (fp32 sums over up to
eight q heads in another order; the fused kernel's dQ atomics add in an
order that changes between runs).
"""

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flashattn_tpu_torch.models import generate, llama, train
from flashattn_tpu_torch.models.config import LLAMA_1B, ModelConfig
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import (decode, flash_bwd, flash_bwd_fused, flash_fwd, kvcache,
                                     paged, quant_matmul)
from flashattn_tpu_torch.ops import launches as launch_counters
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.utils import roofline, timing
from flashattn_tpu_torch.utils.verify import verify_results

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent

TOL = {torch.bfloat16: dict(atol=2e-2), torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype, device=dev)


FWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, causal, pos_offset)
    "no_key_rows": (1, 4, 2, 128, 128, 64, True, -70),
    "sq_above_sk": (1, 4, 2, 200, 96, 64, True, None),
    "gqa8_d128": (2, 8, 1, 300, 300, 128, True, None),
    "ragged_noncausal": (1, 4, 4, 77, 333, 128, False, None),
    "shifted_right": (1, 2, 1, 65, 65, 64, True, 30),
    "training_shape": (4, 32, 4, 2048, 2048, 64, True, None),
    "one_row_past_a_tile": (1, 4, 2, 129, 129, 64, True, None),
    "diagonal_crosses_kv_tile": (1, 4, 2, 64, 300, 64, True, None),
    "whole_tiles_without_keys": (1, 4, 2, 384, 384, 128, True, -130),
    # 32 kv tiles: the two-stage K/V ring of the 128-row D 128 kernel turns 16 times.
    "d128_many_kv_tiles": (1, 2, 1, 4096, 4096, 128, True, None),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_kernel_matches_plain(dev, dtype, case):
    b, hq, hkv, s_q, s_k, d, causal, off = FWD_CASES[case]
    q = randn((b, hq, s_q, d), dtype, dev, 1)
    k = randn((b, hkv, s_k, d), dtype, dev, 2)
    v = randn((b, hkv, s_k, d), dtype, dev, 3)
    before = flash_fwd.LAUNCHES
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, pos_offset=off)
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES == before + 1
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
        q, k, v, causal, pos_offset=off)
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    rep = verify_results(lse_ref, lse, atol=1e-3)
    assert rep.passed, f"LSE: {rep}"
    if off is not None and off < 0:
        dead = -off  # rows r < -off see no key
        assert torch.equal(o[:, :, :dead], torch.zeros_like(o[:, :, :dead]))
        assert bool(torch.isneginf(lse[:, :, :dead]).all())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_is_bitwise_deterministic(dev, d):
    """Two bf16 K1 calls give equal bits: no atomics, one kv order."""
    q = randn((2, 8, 1000, d), torch.bfloat16, dev, 70)
    k = randn((2, 2, 1000, d), torch.bfloat16, dev, 71)
    v = randn((2, 2, 1000, d), torch.bfloat16, dev, 72)
    first = flash_fwd.flash_attention_forward(q, k, v, True)
    second = flash_fwd.flash_attention_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


K1_PROFILE = """
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from flashattn_tpu_torch.ops import flash_fwd

g = torch.Generator(device="cuda").manual_seed(73)
q = torch.randn((1, 32, 256, 64), generator=g, dtype=torch.bfloat16, device="cuda")
k = torch.randn((1, 4, 256, 64), generator=g, dtype=torch.bfloat16, device="cuda")
flash_fwd.flash_attention_forward(q, k, k, True)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    flash_fwd.flash_attention_forward(q, k, k, True)
    torch.cuda.synchronize()
print([e.name for e in prof.events()
       if e.device_type == DeviceType.CUDA and not e.is_user_annotation])
"""


def test_flash_fwd_launches_only_its_kernel(dev):
    """One bf16 K1 call runs one kernel on the card, the wgmma kernel: the
    tensor maps are built on the host, and no PyTorch kernel runs around it.
    Profiled in a process of its own: with a second profiler session in the
    test process, the session of test_int8_decode_launches_only_its_kernels
    recorded no device event in some runs."""
    out = subprocess.run([sys.executable, "-c", K1_PROFILE], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    kernels = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert len(kernels) == 1 and "flash_fwd_wgmma_kernel" in kernels[0], kernels


DECODE_CASES = {
    # name: (Hq, Hkv, T, D, Smax, lengths)
    "d128_t1": (8, 2, 1, 128, 512, [0, 1, 300, 512]),
    "g8_t8_rows64": (16, 2, 8, 64, 1024, [8, 100, 1000, 1024]),
    "mha_t3": (4, 4, 3, 64, 256, [3, 64, 65, 256]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(dev, dtype, case):
    hq, hkv, t, d, s_max, lengths = DECODE_CASES[case]
    b = len(lengths)
    cache = kvcache.KVCache(
        k=randn((b, hkv, s_max, d), dtype, dev, 4),
        v=randn((b, hkv, s_max, d), dtype, dev, 5),
        length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    for i, n in enumerate(lengths):  # garbage past every length
        cache.k[i, :, n:] = float("nan")
        cache.v[i, :, n:] = float("nan")
    q = randn((b, hq, t, d), dtype, dev, 6)
    before = decode.LAUNCHES
    o = decode.decode_attention_chunk(q, cache)
    torch.cuda.synchronize()
    assert decode.LAUNCHES == before + 1
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache)
    rep = verify_results(ref, o, **TOL[dtype])
    assert rep.passed, rep
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(o[i], torch.zeros_like(o[i]))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = randn((1, 4, 64, 64), torch.bfloat16, dev, 7)
    k = randn((1, 2, 64, 64), torch.bfloat16, dev, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd.flash_attention_forward(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="dtypes"):
        flash_fwd.flash_attention_forward(q, k.float(), k)
    with pytest.raises(ValueError, match="dtypes"):
        flash_fwd.flash_attention_forward(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd.flash_attention_forward(q[..., :48].contiguous(),
                                          k[..., :48].contiguous(),
                                          k[..., :48].contiguous())
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off
        flash_fwd.flash_attention_forward(flat[1:].view(q.shape), k, k)
    cache = kvcache.init_cache(1, 2, 128, 64, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="cache"):
        decode.decode_attention(q[:, :, 0], cache)  # bf16 q, f32 cache


def test_update_cache_on_card_equals_cpu(dev):
    b, hkv, s_max, d, t = 3, 2, 16, 8, 3
    cpu = kvcache.KVCache(k=torch.randn(b, hkv, s_max, d),
                          v=torch.randn(b, hkv, s_max, d),
                          length=torch.tensor([2, 14, 9], dtype=torch.int32))
    gpu = kvcache.KVCache(cpu.k.to(dev), cpu.v.to(dev), cpu.length.to(dev))
    k_new, v_new = torch.randn(b, hkv, t, d), torch.randn(b, hkv, t, d)
    active = torch.tensor([True, True, False])
    kvcache.update_cache(cpu, k_new, v_new, active=active)
    kvcache.update_cache(gpu, k_new.to(dev), v_new.to(dev), active=active.to(dev))
    for name in ("k", "v", "length"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name


def test_model_steps_on_card_match_cpu(dev):
    """Prefill and decode steps of a small float32 model: kernels on the card
    against the plain path on the CPU, same weights and tokens."""
    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      dtype=torch.float32)
    cpu_model = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    gpu_model = llama.Llama(cfg, dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        caches = generate.init_caches(model, 2, 128)
        logits, caches = generate.prefill(model, prompt.to(d), caches)
        steps = [logits.cpu()]
        for i in range(3):
            token = torch.tensor([i + 1, i + 2], dtype=torch.int32, device=d)
            pos = torch.full((2,), 37 + i, dtype=torch.int32, device=d)
            logits, caches = generate.decode_step(model, token, pos, caches)
            steps.append(logits.cpu())
        outs.append(steps)
    for i, (ref, out) in enumerate(zip(*outs)):
        rep = verify_results(ref, out, atol=1e-3, rtol=1e-3)
        assert rep.passed, f"step {i}: {rep}"


GRAD_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=5e-2),
            torch.float32: dict(atol=2e-4, rtol=1e-4)}

BWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, causal, pos_offset)
    "gqa8_causal": (1, 8, 1, 256, 256, 64, True, None),
    "d128_noncausal": (2, 4, 2, 192, 192, 128, False, None),
    "sq_below_sk": (1, 4, 2, 64, 256, 64, True, None),
    "ragged": (1, 4, 2, 200, 200, 64, True, None),
    "ragged_d128_cross": (1, 2, 1, 77, 333, 128, False, None),
    "no_key_rows": (1, 4, 2, 192, 192, 64, True, -100),
    # the training shape's GQA at half its length
    "gqa8_train_s1024": (1, 32, 4, 1024, 1024, 64, True, None),
    # ragged, long enough for the q-tile double buffer to wrap many times
    "ragged_d128_wrap": (1, 8, 1, 1000, 1000, 128, True, None),
}


def bwd_inputs(case, dtype, dev):
    b, hq, hkv, s_q, s_k, d, causal, off = BWD_CASES[case]
    q = randn((b, hq, s_q, d), dtype, dev, 11)
    k = randn((b, hkv, s_k, d), dtype, dev, 12)
    v = randn((b, hkv, s_k, d), dtype, dev, 13)
    do = randn((b, hq, s_q, d), dtype, dev, 14)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, pos_offset=off)
    return (q, k, v, o, do, lse), dict(is_causal=causal, pos_offset=off)


def launches():
    return (flash_bwd_fused.LAUNCHES, flash_bwd.DQ_LAUNCHES, flash_bwd.DKV_LAUNCHES)


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_kernels_match_plain(dev, impl, dtype, case):
    args, kw = bwd_inputs(case, dtype, dev)
    before = launches()
    out = flash_bwd.flash_attention_backward(*args, impl=impl, **kw)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(launches(), before))
    assert added == ((1, 0, 0) if impl == "fused" else (0, 1, 1))
    ref = flash_bwd.flash_attention_backward_reference(*args, **kw)
    for name, r, g in zip(("dQ", "dK", "dV"), ref, out):
        assert g.dtype == dtype and g.shape == r.shape
        assert bool(torch.isfinite(g).all()), name
        rep = verify_results(r, g, **GRAD_TOL[dtype])
        assert rep.passed, f"{name}: {rep}"
    off = kw["pos_offset"]
    if off is not None and off < 0:
        dq = out[0]
        assert torch.equal(dq[:, :, :-off], torch.zeros_like(dq[:, :, :-off]))


@pytest.mark.parametrize("case", ["no_key_rows", "ragged_d128_wrap"])
def test_dq_kernel_delta_matches_plain(dev, case):
    """B4 also writes delta = rowsum(dO * O) for the dK/dV kernel: held
    against the plain sum in float32, and dQ against the plain backward."""
    (q, k, v, o, do, lse), kw = bwd_inputs(case, torch.bfloat16, dev)
    dq, delta = flash_bwd.flash_bwd_dq(q, k, v, o, do, lse, kw["is_causal"],
                                       pos_offset=kw["pos_offset"])
    torch.cuda.synchronize()
    want = (do.float() * o.float()).sum(-1)
    assert delta.shape == want.shape and delta.dtype == torch.float32
    rep = verify_results(want, delta, **TOL[torch.float32])
    assert rep.passed, f"delta: {rep}"
    rep = verify_results(flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)[0],
                         dq, **GRAD_TOL[torch.bfloat16])
    assert rep.passed, f"dQ: {rep}"


@pytest.mark.parametrize("case", ["gqa8_causal", "ragged_d128_wrap"])
def test_split_is_bitwise_deterministic(dev, case):
    args, kw = bwd_inputs(case, torch.bfloat16, dev)
    first = flash_bwd.flash_attention_backward(*args, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(*args, impl="split", **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fwd_bwd_bitwise_deterministic_on_the_split_path(dev, monkeypatch):
    """tests/test_determinism.py's check on the path that pins it: with
    FLASHATTN_BWD_IMPL=split, forward and gradients through flash_attention
    are bitwise equal across runs (the fused path adds dQ with atomics and
    is not)."""
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "split")
    q, k, v, do = (randn((1, 2, 384, 64), torch.bfloat16, dev, 30 + i) for i in range(4))

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*leaves, is_causal=True)
        return (o, *torch.autograd.grad(o, leaves, do))

    before = launches()
    first, second = run(), run()
    assert launches()[1:] == (before[1] + 2, before[2] + 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_matches_split(dev, monkeypatch, dtype):
    """The two paths compute one function, within the gradient gate of the
    dtype; FLASHATTN_BWD_IMPL selects for impl="auto"."""
    args, kw = bwd_inputs("ragged", dtype, dev)
    split = flash_bwd.flash_attention_backward(*args, impl="split", **kw)
    fused = flash_bwd.flash_attention_backward(*args, impl="fused", **kw)
    for a, b in zip(split, fused):
        rep = verify_results(a, b, **GRAD_TOL[dtype])
        assert rep.passed, rep
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "split")
    before = launches()
    auto = flash_bwd.flash_attention_backward(*args, **kw)
    assert launches()[1] == before[1] + 1
    assert all(torch.equal(a, b) for a, b in zip(split, auto))


def test_backward_refuses_what_the_kernels_do_not_take(dev):
    args, kw = bwd_inputs("ragged", torch.bfloat16, dev)
    q, k, v, o, do, lse = args
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd.flash_attention_backward(q, k, v, o, do.transpose(2, 3).contiguous()
                                           .transpose(2, 3), lse, **kw)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd.flash_attention_backward(q, k, v, o, do, lse.double(), **kw)
    with pytest.raises(ValueError, match="dtypes"):
        flash_bwd.flash_attention_backward(q, k, v, o.float(), do, lse, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_through_flash_attention(dev, dtype):
    """Gradients through flash_attention (K1 with the LSE, then the fused
    kernel) against the same Function over the plain versions."""
    b, hq, hkv, s, d = 2, 8, 2, 160, 64
    leaves = [randn(shape, dtype, dev, 20 + i).requires_grad_()
              for i, shape in enumerate([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)])]
    do = randn((b, hq, s, d), dtype, dev, 24)
    before = (flash_fwd.LAUNCHES, *launches())
    o = flash_attention(*leaves, is_causal=True)
    got = torch.autograd.grad(o, leaves, do)
    assert (flash_fwd.LAUNCHES, *launches()) == (before[0] + 1, before[1] + 1, *before[2:])
    o_ref = plain_flash_attention(*leaves, is_causal=True)
    want = torch.autograd.grad(o_ref, leaves, do)
    assert verify_results(o_ref, o, **TOL[dtype]).passed
    for name, r, g in zip(("dQ", "dK", "dV"), want, got):
        rep = verify_results(r, g, **GRAD_TOL[dtype])
        assert rep.passed, f"{name}: {rep}"


def test_train_step_on_card_matches_cpu(dev):
    """Two AdamW steps of a small float32 D-64 model: kernels on the card
    against the plain path on the CPU, same weights and tokens."""
    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      dtype=torch.float32)
    tc = train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    cpu_model = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_model = llama.Llama(cfg, dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(1))
    states = [train.init_train_state(m, tc) for m in (cpu_model, gpu_model)]
    for _ in range(2):
        metrics = []
        for i, state in enumerate(states):
            states[i], m = train.train_step(state, tokens)
            metrics.append(m)
        for key in ("loss", "grad_norm"):
            assert float(metrics[1][key]) == pytest.approx(float(metrics[0][key]), rel=1e-4), key
    # Adam turns tiny gradient differences of near-zero entries into update
    # differences up to lr: bound the share of such entries, not each one.
    for (name, a), b in zip(cpu_model.named_parameters(), gpu_model.parameters()):
        err = (a - b.detach().cpu()).abs()
        assert float(err.max()) <= 2 * tc.learning_rate, name
        assert float((err > 1e-5).float().mean()) < 1e-3, name


# ---- quantized and paged K2, qmm8/qmm4 (the quantized, paged serving path) ----

QTOL = dict(rtol=2e-2, atol=2e-2)

QDECODE_CASES = {
    # name: (Hq, Hkv, T, D, Smax, lengths)
    "serving_t1": (32, 4, 1, 64, 2048, [1, 77, 1500, 2048]),
    "chunk_t256": (32, 4, 256, 64, 2048, [256, 300, 1500, 2048]),
    "empty_and_full_d128": (8, 2, 3, 128, 512, [0, 3, 300, 512]),
}


def quantized_cache(quant, b, hkv, s_max, d, lengths, dev, seed=40):
    """A cache filled with quantized random tokens, NaN (fp8 code 0x7f, and
    NaN scales) past every length, as a recycled slot may hold."""
    cache = kvcache.init_cache(b, hkv, s_max, d, dtype=torch.bfloat16, quant=quant, device=dev)
    kvcache.update_cache(cache, randn((b, hkv, s_max, d), torch.bfloat16, dev, seed),
                         randn((b, hkv, s_max, d), torch.bfloat16, dev, seed + 1),
                         assume_fits=True)
    cache.length.copy_(torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        if quant == "fp8":
            cache.k.view(torch.uint8)[i, :, n:] = 0x7F
            cache.v.view(torch.uint8)[i, :, n:] = 0x7F
        cache.k_scale[i, :, :, n:] = float("nan")
        cache.v_scale[i, :, :, n:] = float("nan")
    return cache


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("case", sorted(QDECODE_CASES))
def test_quantized_decode_kernel_matches_plain(dev, quant, case):
    hq, hkv, t, d, s_max, lengths = QDECODE_CASES[case]
    b = len(lengths)
    cache = quantized_cache(quant, b, hkv, s_max, d, lengths, dev)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 42)
    counter = "INT8_LAUNCHES" if quant == "int8" else "FP8_LAUNCHES"
    before = getattr(decode, counter)
    o = decode.decode_attention_chunk(q, cache)
    torch.cuda.synchronize()
    assert getattr(decode, counter) == before + 1
    assert bool(torch.isfinite(o).all())
    # The plain version requantizing int8 P per 64-position tile, as the
    # kernel does (its default is the JAX kernel's block).
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV)
    rep = verify_results(ref, o, **QTOL)
    assert rep.passed, rep
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(o[i], torch.zeros_like(o[i]))


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [1, 4])
def test_decode_is_bitwise_deterministic(dev, quant, t):
    """Two K2 calls give equal bits: each slice's warps merge in warp order
    and the slices in split order, never by atomics."""
    b, hq, hkv, d, s_max = 4, 32, 4, 64, 2048
    lengths = [1, 77, 1500, 2048]
    if quant is None:
        cache = kvcache.KVCache(k=randn((b, hkv, s_max, d), torch.bfloat16, dev, 43),
                                v=randn((b, hkv, s_max, d), torch.bfloat16, dev, 44),
                                length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    else:
        cache = quantized_cache(quant, b, hkv, s_max, d, lengths, dev, seed=43)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 45)
    first = decode.decode_attention_chunk(q, cache)
    second = decode.decode_attention_chunk(q, cache)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_decode_launches_only_its_kernels(dev):
    """One int8 K2 call at T 1 runs the port's kernels alone on the card:
    q's quantization is inside the split kernel, so no PyTorch kernel (no
    aten elementwise pass) runs before it or between it and the merge."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = quantized_cache("int8", 4, 4, 2048, 64, [1, 77, 1500, 2048], dev)
    q = randn((4, 32, 64), torch.bfloat16, dev, 46)
    decode.decode_attention(q, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode.decode_attention(q, cache)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert kernels and "decode_mma_kernel" in kernels[0], kernels
    assert all("decode_mma_kernel" in k or "decode_merge_kernel" in k for k in kernels), kernels


def paged_copy(cache, page, dev, seed=50):
    """The dense cache's content in a pool of scrambled pages; table entries
    past each sequence's pages hold the sentinel num_pages."""
    b, hkv, s_max, d = cache.k.shape
    maxp = s_max // page
    quant = None if not cache.quantized else (
        "int8" if cache.k.dtype == torch.int8 else "fp8")
    pool = paged.init_paged_cache(b, hkv, b * maxp + 5, page, d, maxp, dtype=cache.k.dtype
                                  if quant is None else torch.bfloat16, quant=quant,
                                  device=dev)
    perm = torch.randperm(b * maxp + 5, generator=torch.Generator().manual_seed(seed))
    for i in range(b):
        n = int(cache.length[i])
        live = paged.pages_needed(n, page)
        own = perm[i * maxp:i * maxp + live].tolist()
        table = own + [pool.num_pages] * (maxp - live)
        row = kvcache.KVCache(
            k=cache.k[i:i + 1], v=cache.v[i:i + 1], length=cache.length[i:i + 1],
            k_scale=None if quant is None else cache.k_scale[i:i + 1],
            v_scale=None if quant is None else cache.v_scale[i:i + 1])
        paged.write_pages(pool, row, table)
        paged.set_block_table(pool, i, table, n)
    return pool


@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_paged_decode_kernel_equals_dense(dev, quant, page, t):
    b, hq, hkv, d, s_max = 4, 32, 4, 64, 2048
    lengths = [256, 300, 1500, 2048]
    if quant is None:
        cache = kvcache.KVCache(k=randn((b, hkv, s_max, d), torch.bfloat16, dev, 60),
                                v=randn((b, hkv, s_max, d), torch.bfloat16, dev, 61),
                                length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    else:
        cache = quantized_cache(quant, b, hkv, s_max, d, lengths, dev, seed=60)
    pool = paged_copy(cache, page, dev)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 62)
    before = paged.LAUNCHES
    o_paged = paged.paged_decode_attention_chunk(q, pool)
    o_dense = decode.decode_attention_chunk(q, cache)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == before + 1
    assert torch.equal(o_paged, o_dense)
    ref = paged.paged_decode_reference(q, pool, requant_block=decode.BLOCK_KV)
    rep = verify_results(ref, o_paged, **(TOL[torch.bfloat16] if quant is None else QTOL))
    assert rep.passed, rep


def test_paged_decode_never_reads_unowned_pages(dev):
    """A chunk whose padding runs past the pages a sequence owns (chunked
    admission with a chunk longer than a page): the table entries there are
    the sentinel num_pages, or any index outside the pool, and the kernel
    reads none of them. Rows inside the owned pages equal the dense K2's."""
    b, hq, hkv, d, page, t = 2, 16, 2, 64, 64, 256
    cache = kvcache.KVCache(k=randn((b, hkv, 512, d), torch.bfloat16, dev, 63),
                            v=randn((b, hkv, 512, d), torch.bfloat16, dev, 64),
                            length=torch.tensor([300, 512], dtype=torch.int32, device=dev))
    pool = paged_copy(cache, page, dev)
    owned = 3  # sequence 0 keeps 3 of its 5 live pages: positions [0, 192)
    pool.block_table[0, owned] = pool.num_pages
    pool.block_table[0, owned + 1] = 1 << 30
    q = randn((b, hq, t, d), torch.bfloat16, dev, 65)
    o = paged.paged_decode_attention_chunk(q, pool)
    dense = decode.decode_attention_chunk(q, cache)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    first = 300 - t  # row t of the chunk sits at position first + t
    inside = owned * page - first  # rows at positions < 192 see owned pages only
    assert torch.equal(o[0, :, :inside], dense[0, :, :inside])
    assert torch.equal(o[1], dense[1])


QMM_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]


# qmm8: the split-K kernel up to M 16 (M 1, 4 and 16 take its three row
# counts), the tensor cores above it in bf16 (17: one row past a tile; 1000:
# a ragged last tile), the CUDA-core kernel for float32 x above it.
QMM_BITS_M = ([(8, m) for m in (1, 4, 16, 17, 64, 256, 1000)]
              + [(4, m) for m in (1, 4, 7, 16, 17, 256, 1024)])


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits,m", QMM_BITS_M)
@pytest.mark.parametrize("kn", QMM_SHAPES)
def test_quant_matmul_kernel_matches_plain(dev, bits, m, kn, x_dtype):
    k, n = kn
    w = randn((k, n), torch.float32, dev, 70) * 0.02
    qw = quant_matmul.quantize_weights(w, bits)
    x = randn((m, k), x_dtype, dev, 71)
    counter = "QMM8_LAUNCHES" if bits == 8 else "QMM4_LAUNCHES"
    before = getattr(quant_matmul, counter)
    for out_dtype in (None, torch.float32):
        y = quant_matmul.quant_matmul(x, qw, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert y.shape == (m, n) and y.dtype == (out_dtype or x_dtype)
        rep = verify_results(quant_matmul.quant_matmul_reference(x, qw, out_dtype), y,
                             atol=2e-2, rtol=1e-2)
        assert rep.passed, rep
    assert getattr(quant_matmul, counter) == before + 2


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [4, 256])
def test_qmm8_is_bitwise_deterministic(dev, m, bits):
    """Two calls give equal bits, for qmm8 and qmm4: the split-K partial
    sums (M 4) are added in split order, never by atomics, and the
    tensor-core tiles (M 256) own their outputs."""
    k, n = 2048, 5632
    qw = quant_matmul.quantize_weights(randn((k, n), torch.float32, dev, 74) * 0.02, bits)
    x = randn((m, k), torch.bfloat16, dev, 75)
    first = quant_matmul.quant_matmul(x, qw)
    second = quant_matmul.quant_matmul(x, qw)
    assert torch.equal(first, second)


def test_quant_matmul_refuses_what_the_kernel_does_not_take(dev):
    qw = quant_matmul.quantize_weights(randn((96, 64), torch.float32, dev, 72), 8)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant_matmul.quant_matmul(randn((2, 96), torch.bfloat16, dev, 73), qw)


# The a8 mode: the split-K kernel up to M 16 (1, 4, 7 and 16 take its three
# row counts), the int8 tensor cores above it (17: one row past a tile;
# 1000: a ragged last tile).
QMM_A8_M = (1, 4, 7, 16, 17, 256, 1000)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", QMM_A8_M)
@pytest.mark.parametrize("kn", QMM_SHAPES)
def test_quant_matmul_a8_kernel_equals_plain(dev, bits, m, kn, x_dtype):
    """The a8 mode on the card equals its plain version bit for bit (int32
    sums are exact and the f32 tail is the same), its quantization equals
    quantize_rows_reference bit for bit, and a call counts one launch in
    its kernel's counter, in the "_a8" one and in quantize_rows'."""
    k, n = kn
    qw = quant_matmul.quantize_weights(randn((k, n), torch.float32, dev, 76) * 0.02, bits)
    x = randn((m, k), x_dtype, dev, 77)
    names = (f"qmm{bits}", f"qmm{bits}_a8", "quantize_rows")
    before = launch_counters.read()
    for out_dtype in (None, torch.float32):
        y = quant_matmul.quant_matmul(x, qw, out_dtype=out_dtype, quantize_activations=True)
        torch.cuda.synchronize()
        assert y.shape == (m, n) and y.dtype == (out_dtype or x_dtype)
        assert torch.equal(y, quant_matmul.quant_matmul_reference(x, qw, out_dtype, True))
    after = launch_counters.read()
    assert {c: after[c] - before[c] for c in after if after[c] != before[c]} == {
        c: 2 for c in names}
    x_q, x_scale = quant_matmul.quantize_rows(x)
    ref_q, ref_scale = quant_matmul.quantize_rows_reference(x)
    assert torch.equal(x_q, ref_q) and torch.equal(x_scale, ref_scale)


def test_quantize_rows_kernel_rounds_half_to_even(dev):
    """Rows of amax 127 * 2^e (scale 2^e exactly) filled with (j + 0.5) 2^e,
    a zero row and rows of random magnitude: the kernel's x_q and x_scale
    equal the plain version's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(78)
    x = torch.randn((64, 512), generator=g, device=dev)
    x *= torch.exp2(torch.empty((64, 1), device=dev).uniform_(-20, 20, generator=g))
    x[1] = 0.0
    j = torch.randint(-127, 127, (3, 512), generator=g, device=dev).float()
    for r, e in enumerate((0, -3, 5)):
        x[2 + r] = (j[r] + 0.5) * 2.0 ** e
        x[2 + r, 0] = 127.0 * 2.0 ** e
    for dtype in (torch.float32, torch.bfloat16):
        got = quant_matmul.quantize_rows(x.to(dtype))
        want = quant_matmul.quantize_rows_reference(x.to(dtype))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1][2, 0] == 1.0 and got[1][1, 0] == torch.tensor(1e-10)


def test_quant_matmul_a8_refuses_what_the_kernel_does_not_take(dev):
    qw = quant_matmul.quantize_weights(randn((96, 64), torch.float32, dev, 72), 8)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant_matmul.quant_matmul(randn((2, 96), torch.bfloat16, dev, 73), qw,
                                  quantize_activations=True)
    qw = quant_matmul.quantize_weights(randn((128, 64), torch.float32, dev, 72), 8)
    x = randn((2 * 128 + 4,), torch.bfloat16, dev, 73)[4:].view(2, 128)  # 8-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_matmul.quant_matmul(x, qw, quantize_activations=True)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_model_steps_on_card_match_cpu(dev, quant, bits):
    """A float32 D-64 model with quantized weights and KV cache: prefill, a
    prompt chunk and decode steps, kernels on the card against the plain path
    on the CPU from the same weights and tokens."""
    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                      dtype=torch.float32)
    cpu_model = llama.quantize_params(
        llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), bits)
    gpu_model = llama.quantize_params(llama.Llama(cfg, dev), bits)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(1))
    piece = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        caches = generate.init_caches(model, 2, 256, quant=quant)
        logits, caches = generate.prefill(model, prompt.to(d), caches)
        steps = [logits.cpu()]
        logits, caches = generate.chunk_step(model, piece.to(d),
                                             torch.arange(37, 77, device=d), caches)
        steps.append(logits.cpu())
        for i in range(2):
            token = torch.tensor([i + 1, i + 2], dtype=torch.int32, device=d)
            pos = torch.full((2,), 77 + i, dtype=torch.int32, device=d)
            logits, caches = generate.decode_step(model, token, pos, caches)
            steps.append(logits.cpu())
        outs.append(steps)
    for i, (ref, out) in enumerate(zip(*outs)):
        if quant == "int8":
            # The kernel requantizes int8 P per 64-position tile, the CPU plain
            # version per JAX block (the whole 256-position cache): chip_smoke's
            # logits rule, cosine > 0.999 and max |d| <= 0.05 max |ref|.
            cos = float(torch.nn.functional.cosine_similarity(
                ref.flatten(), out.flatten(), dim=0))
            delta = float((ref - out).abs().max())
            assert cos > 0.999 and delta <= 0.05 * float(ref.abs().max()), (i, cos, delta)
        else:
            rep = verify_results(ref, out, atol=2e-2, rtol=2e-2)
            assert rep.passed, f"step {i}: {rep}"


def test_llama1b_quantized_paged_server_matches_dense(dev):
    """LLAMA_1B widths (2 layers), int8 weights and int8 KV: the paged server,
    with a pool too small for every request at once, gives the dense
    server's tokens, and frees its pages."""
    cfg = ModelConfig(num_layers=2)
    assert (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads) == (
        LLAMA_1B.hidden_size, LLAMA_1B.num_heads, LLAMA_1B.num_kv_heads)
    model = llama.quantize_params(
        llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev), 8)
    gen = torch.Generator().manual_seed(3)
    reqs = [(uid, torch.randint(0, cfg.vocab_size, (16 + 37 * uid % 160,),
                                generator=gen).tolist(), 24) for uid in range(6)]
    got = {}
    for kind, kw in (("dense", {}), ("paged", dict(paged=True, page_size=256, num_pages=3))):
        srv = InferenceServer(model, max_slots=4, max_len=2048, quant="int8", **kw)
        for uid, prompt, n in reqs:
            srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        got[kind] = srv.run()
        if kind == "paged":
            assert srv.allocator.free_pages == 3
    assert got["paged"] == got["dense"]


SMALL = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=8, num_kv_heads=2, head_dim=64)


def small_model(dev, bits=None, **overrides):
    """A bf16 D-64 model with random weights, its projections quantized to
    `bits` when given."""
    cfg = ModelConfig(**SMALL, **overrides)
    model = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return llama.quantize_params(model, bits) if bits else model


def filled_caches(model, quant, paged_kv, lengths, dev, max_len=512, page=64, steps=8):
    """Caches of len(lengths) slots holding prefilled prompts of `lengths`
    tokens: dense, or a pool of scrambled pages (the rest of each table row
    the sentinel) with room for `steps` more tokens."""
    cfg = model.cfg
    slots, maxp = len(lengths), max_len // page
    if paged_kv:
        caches = [paged.init_paged_cache(slots, cfg.num_kv_heads, slots * maxp, page,
                                         cfg.head_dim, maxp, dtype=cfg.dtype, quant=quant,
                                         device=dev) for _ in range(cfg.num_layers)]
        perm = torch.randperm(slots * maxp, generator=torch.Generator().manual_seed(5))
    else:
        caches = generate.init_caches(model, slots, max_len, quant=quant)
    gen = torch.Generator().manual_seed(6)
    for s, n in enumerate(lengths):
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen).to(dev)
        _, single = generate.prefill(model, prompt,
                                     generate.init_caches(model, 1, max_len, quant=quant))
        own = paged.pages_needed(n + steps, page)
        for cache, one in zip(caches, single):
            if paged_kv:
                table = perm[s * maxp:s * maxp + own].tolist() + [slots * maxp] * (maxp - own)
                paged.write_slot_paged(cache, one, s, table)
            else:
                kvcache.write_slot(cache, one, s)
    return caches


def cache_bytes(caches):
    """Every tensor of the caches (values, scales, tables, lengths) as raw bytes."""
    return [t.view(torch.uint8) for c in caches for f in dataclasses.fields(c)
            if (t := getattr(c, f.name)) is not None]


def clone_caches(caches):
    return [dataclasses.replace(c, **{f.name: getattr(c, f.name).clone()
                                      for f in dataclasses.fields(c)
                                      if getattr(c, f.name) is not None})
            for c in caches]


CAPTURE_CASES = {
    # name: (weight bits, KV quant, paged, config overrides)
    "bf16": (None, None, False, {}),
    "int8_weights_int8_kv": (8, "int8", False, {}),
    "fp8_kv": (None, "fp8", False, {}),
    "int8_weights_int8_paged_kv": (8, "int8", True, {}),
    "int4_weights": (4, None, False, {}),
    # a 0-d CPU tensor scales the embedding (llama.embed_tokens)
    "scaled_embeddings": (None, None, False, dict(scale_embeddings=True)),
    # a window the lengths grow past, with sinks; alternate layers windowed
    "window_sinks": (None, None, False, dict(attn_window=64, attn_sink=4)),
    "window_alternate_int8_paged_kv": (8, "int8", True,
                                       dict(attn_window=64, attn_sink=4,
                                            window_pattern="alternate")),
    # Qwen's q/k norm and biases; longrope whose original context (302) the
    # third slot's positions pass during the steps: the replay picks the
    # long factor set on the device, as the eager step does
    "qk_norm_bias": (None, None, False, dict(qk_norm=True, attn_bias=True)),
    "longrope_crossing": (None, None, True,
                          dict(rope_longrope=(tuple(1.0 + 0.03 * i for i in range(32)),
                                              tuple(2.0 + 0.2 * i for i in range(32)),
                                              302, 1.19))),
}


@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_captured_decode_step_equals_eager(dev, case):
    """chip_smoke.py's capture gate at a small width: from equal caches, 8
    steps with other tokens, positions and active rows each step, the
    replayed step's logits and every cache byte equal the eager step's (the
    same kernels on the same shapes)."""
    bits, quant, paged_kv, overrides = CAPTURE_CASES[case]
    model = small_model(dev, bits, **overrides)
    lengths = [5, 77, 300, 64]
    eager = filled_caches(model, quant, paged_kv, lengths, dev)
    graph = generate.DecodeGraph(model, clone_caches(eager))
    gen = torch.Generator().manual_seed(7)
    for i in range(8):
        active = [(i + s) % 3 != 0 for s in range(len(lengths))]
        token = torch.randint(0, model.cfg.vocab_size, (len(lengths),), generator=gen,
                              dtype=torch.int32)
        positions = torch.tensor(lengths, dtype=torch.int32)
        act = torch.tensor(active)
        ref, _ = generate.decode_step(model, token.to(dev), positions.to(dev), eager,
                                      active=act.to(dev))
        out = graph(token.to(dev), positions.pin_memory(), act.pin_memory())
        torch.cuda.synchronize()
        assert torch.equal(ref, out), f"step {i}: logits differ"
        assert all(torch.equal(a, b) for a, b in zip(cache_bytes(eager),
                                                     cache_bytes(graph.caches))), i
        lengths = [n + a for n, a in zip(lengths, active)]
    assert eager[0].length.tolist() == lengths
    assert graph.replays == 9  # one at capture, one a step


def test_decode_graph_refuses_cpu_caches(dev):
    model = small_model(dev)
    cpu = generate.init_caches(llama.Llama(model.cfg, device="cpu"), 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        generate.DecodeGraph(model, cpu)


@pytest.mark.parametrize("paged_kv", [False, True])
def test_captured_server_readmits_into_a_freed_slot(dev, paged_kv):
    """One slot, three requests admitted into it in turn under replay (the
    cache rows, pages and tables written in place under the graph): each
    request's tokens equal those of a fresh captured server that runs it
    alone; every decode step is one replay."""
    model = small_model(dev, 8)
    kw = dict(max_slots=1, max_len=512, quant="int8")
    if paged_kv:
        kw.update(paged=True, page_size=64, num_pages=4)
    gen = torch.Generator().manual_seed(8)
    reqs = [(uid, torch.randint(0, 256, (n,), generator=gen).tolist(), new)
            for uid, (n, new) in enumerate([(40, 12), (7, 20), (100, 9)])]
    srv = InferenceServer(model, **kw)
    for uid, prompt, n in reqs:
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    got = srv.run()
    assert srv.decode_graph().replays == srv.stats()["decode_steps"] + 1  # + the capture's
    for uid, prompt, n in reqs:
        fresh = InferenceServer(model, **kw)
        fresh.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        assert fresh.run()[uid] == got[uid], uid


def test_captured_server_runs_are_equal(dev):
    """Two captured servers with 2 slots on 5 requests (slots recycle mid-
    flight, admissions land between replays) give equal tokens; the first
    is warmed up, the second captures at its first decode step."""
    model = small_model(dev)
    gen = torch.Generator().manual_seed(9)
    reqs = [(uid, torch.randint(0, 256, (5 + 23 * uid,), generator=gen).tolist(), 6 + uid)
            for uid in range(5)]
    outs = []
    for warm in (True, False):
        srv = InferenceServer(model, max_slots=2, max_len=512)
        if warm:
            srv.warmup()
            assert all(int(c.length.abs().sum()) == 0 for c in srv.caches)
        for uid, prompt, n in reqs:
            srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        outs.append(srv.run())
        assert srv.decode_graph().replays == srv.stats()["decode_steps"] + 1
    assert outs[0] == outs[1] and sorted(outs[0]) == list(range(5))


def test_replays_count_the_captured_launches(dev):
    """A replay adds what one eager step launches, and the capture itself
    adds nothing: after N replays the counters moved by N x the deltas."""
    model = small_model(dev, 8)
    caches = generate.init_caches(model, 2, 256, quant="int8")
    zeros = torch.zeros((2,), dtype=torch.int32, device=dev)
    idle = torch.zeros((2,), dtype=torch.bool, device=dev)
    before = launch_counters.read()
    generate.decode_step(model, zeros, zeros, caches, active=idle)
    step = {k: v - before[k] for k, v in launch_counters.read().items() if v != before[k]}
    assert step == {"decode_int8": 2, "qmm8": 7 * 2 + 1}
    before = launch_counters.read()
    graph = generate.DecodeGraph(model, caches)  # an eager step, the capture, a replay
    assert graph.launches == step
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    after = launch_counters.read()
    assert {k: v - before[k] for k, v in after.items() if v != before[k]} == {
        k: 7 * v for k, v in step.items()}


REPLAY_PROFILE = r"""
import collections, json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.ops import launches

N = int(sys.argv[1])
cfg = ModelConfig(**json.loads(sys.argv[2]))
model = llama.quantize_params(
    llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"), 8)
caches = generate.init_caches(model, 2, 1024, quant="int8")
for c in caches:
    c.length.copy_(torch.tensor([300, 1000], dtype=torch.int32))
graph = generate.DecodeGraph(model, caches)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    with record_function("run.eager"):  # the step the graph holds, on its buffers
        generate.decode_step(model, graph.token, graph.positions, caches, active=graph.active)
        torch.cuda.synchronize()
    before = launches.read()
    with record_function("run.replay"):
        for _ in range(N):
            graph.replay()
        torch.cuda.synchronize()
    after = launches.read()
PORT = ["decode_mma_kernel", "decode_merge_kernel", "qmm_splitk_kernel", "qmm_reduce_kernel"]
events = prof.events()
ranges = {e.name[4:]: e.time_range for e in events if e.name.startswith("run.")}
kernels = {run: collections.Counter() for run in ranges}
for e in events:
    if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
        for run, r in ranges.items():
            if r.start <= e.time_range.start <= r.end:
                kernels[run].update(k for k in PORT if k in e.name)
print(json.dumps({"deltas": graph.launches, "counted": {
    k: after[k] - before[k] for k in after if after[k] != before[k]},
    "eager": kernels["eager"], "replay": kernels["replay"]}))
"""


def test_replays_run_the_captured_kernels(dev):
    """On the card, N replays run N x the eager step's instances of the
    port's kernels (K2's split and merge kernels, qmm8's split-K kernel
    and its reduction), as torch.profiler records them, and the counters
    move by N x the capture's deltas: one K2 split kernel a decode_int8
    launch, one split-K kernel a qmm8 launch. Profiled in a process of its
    own, as test_flash_fwd_launches_only_its_kernel."""
    n = 5
    out = subprocess.run([sys.executable, "-c", REPLAY_PROFILE, str(n), json.dumps(SMALL)],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    deltas, eager, replay = got["deltas"], got["eager"], got["replay"]
    assert got["counted"] == {k: n * v for k, v in deltas.items()}
    assert set(deltas) == {"decode_int8", "qmm8"}
    port = ["decode_mma_kernel", "decode_merge_kernel", "qmm_splitk_kernel",
            "qmm_reduce_kernel"]
    assert all(eager.get(k, 0) > 0 for k in port), eager
    assert eager["decode_mma_kernel"] == deltas["decode_int8"], eager
    assert eager["qmm_splitk_kernel"] == deltas["qmm8"], eager
    assert all(replay.get(k, 0) == n * eager[k] for k in port), (replay, eager)


def test_calibrations_leave_the_server_alone(dev):
    """calibrate_device_step (one chain, and the two-chain slope) and
    calibrate_admit on the card: positive times, and every live cache byte,
    table and length as before, mid-flight; the run then ends with the
    tokens of a server that never calibrated."""
    model = small_model(dev, 8)
    kw = dict(max_slots=2, max_len=512, quant="int8", paged=True, page_size=64)
    reqs = [(0, list(range(3, 40)), 9), (1, list(range(100, 180)), 12)]
    outs = []
    for calibrated in (True, False):
        srv = InferenceServer(model, **kw)
        for uid, prompt, n in reqs:
            srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
        for _ in range(4):
            srv.step()
        if calibrated:
            before = [t.clone() for t in cache_bytes(srv.caches)]
            assert srv.calibrate_device_step(iters=4) > 0
            assert srv.calibrate_device_step(iters=50) > 0
            st = srv.stats()
            assert st["device_step_ms"] > 0 and st["device_tokens_per_s_bound"] > 0
            admit = srv.calibrate_admit(prompt_len=300, prefix_len=128, iters=2)
            assert all(v > 0 for v in admit.values()), admit
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(before, cache_bytes(srv.caches)))
        outs.append(srv.run())
    assert outs[0] == outs[1]


def test_measure_looped_times_the_device_and_counts_replays(dev):
    """measure_looped on a K2 call: a graph of 20 calls timed by events,
    close to cuda_time_ms's reading, and the decode counter moved by the
    launches that ran (the warm-up call and 3 replays of 20); cuda_time_ms
    counts its replays the same way."""
    cache = quantized_cache("int8", 4, 4, 2048, 64, [1, 77, 1500, 2048], dev)
    q = randn((4, 32, 64), torch.bfloat16, dev, 90)
    before = decode.INT8_LAUNCHES
    t = timing.measure_looped(lambda q: decode.decode_attention(q, cache), q, iters=20,
                              repeats=2)
    assert decode.INT8_LAUNCHES - before == 1 + 3 * 20
    before = decode.INT8_LAUNCHES
    ref = timing.cuda_time_ms(lambda: decode.decode_attention(q, cache)) / 1e3
    # 3 warm-up calls, then 20 a replay: the upload's and the 5 timed.
    assert decode.INT8_LAUNCHES - before == 3 + (1 + 5) * 20
    assert ref / 3 < t < ref * 3, (t, ref)
    slope = timing.measure_looped_slope(lambda q: decode.decode_attention(q, cache), q,
                                        est=ref, repeats=1)
    assert ref / 3 < slope < ref * 3, (slope, ref)


PROFILE_FN = r"""
import json, glob, sys
import torch
from flashattn_tpu_torch.ops import decode, kvcache
from flashattn_tpu_torch.utils.profiling import profile_fn
cache = kvcache.init_cache(2, 2, 256, 64)
cache.length.fill_(100)
q = torch.randn((2, 8, 64), dtype=torch.bfloat16, device="cuda")
log_dir = profile_fn(lambda q: decode.decode_attention(q, cache), q, log_dir=sys.argv[1])
events = json.load(open(glob.glob(log_dir + "/*.pt.trace.json")[0]))["traceEvents"]
print(sorted({e["name"] for e in events if e.get("cat") == "kernel"}))
"""


def test_profile_fn_traces_the_card(dev, tmp_path):
    """profile_fn's trace holds K2's kernels as device events (in a process
    of its own: a second profiler session in the test process may record
    no device event)."""
    out = subprocess.run([sys.executable, "-c", PROFILE_FN, str(tmp_path / "trace")],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    kernels = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert any("decode_mma_kernel" in k for k in kernels), kernels


def test_detect_chip_on_the_card(dev):
    name = torch.cuda.get_device_name(0)
    if "H100" not in name:
        with pytest.raises(ValueError, match="no roofline spec"):
            roofline.detect_chip()
        return
    spec = roofline.detect_chip()
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    assert spec.bf16_tflops == 989.0 and spec.hbm_gib == total


# ---- the sliding window and attention sinks: K1, K2 dense and paged ----

WINDOW_FWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, pos_offset, window)
    "w1": (1, 4, 2, 300, 300, 64, None, 1),
    "w63_d128": (1, 4, 2, 515, 515, 128, None, 63),
    "w64": (2, 4, 1, 400, 400, 64, None, 64),
    "w65_d128": (1, 8, 2, 333, 333, 128, None, 65),
    "w128_tile_edges_d128": (1, 2, 1, 1024, 1024, 128, None, 128),
    "w200_sq_below_sk": (1, 8, 2, 130, 700, 128, None, 200),
    "w129_offset": (1, 4, 1, 256, 600, 64, 100, 129),
    "w_past_s_d128": (1, 4, 2, 257, 257, 128, None, 1000),
    "w100_no_key_rows": (1, 4, 2, 256, 256, 64, -120, 100),
    "w30_rows_right_of_keys": (1, 4, 2, 200, 96, 64, 50, 30),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(WINDOW_FWD_CASES))
def test_windowed_flash_fwd_kernel_matches_plain(dev, dtype, case):
    """K1 with a sliding window against its plain version: windows of one
    key, at and beside the kv tile widths (64, 128), past S; S_q != S_k,
    pos_offset, rows that see no key on either side."""
    b, hq, hkv, s_q, s_k, d, off, w = WINDOW_FWD_CASES[case]
    q = randn((b, hq, s_q, d), dtype, dev, 81)
    k = randn((b, hkv, s_k, d), dtype, dev, 82)
    v = randn((b, hkv, s_k, d), dtype, dev, 83)
    before = (flash_fwd.LAUNCHES, flash_fwd.WINDOW_LAUNCHES)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, pos_offset=off, window=w)
    torch.cuda.synchronize()
    assert (flash_fwd.LAUNCHES, flash_fwd.WINDOW_LAUNCHES) == (before[0] + 1, before[1] + 1)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
        q, k, v, True, pos_offset=off, window=w)
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    rep = verify_results(lse_ref, lse, atol=1e-3)
    assert rep.passed, f"LSE: {rep}"
    dead = torch.isneginf(lse_ref)
    assert torch.equal(torch.isneginf(lse), dead)
    assert not bool(o[dead].any())


WINDOW_DECODE_CASES = {
    # name: (Hq, Hkv, T, D, Smax, lengths, window, sink)
    "t1_straddle_d128": (16, 2, 1, 128, 1024, [1, 64, 65, 130, 700, 1024], 64, 4),
    "t1_no_sink": (8, 2, 1, 64, 512, [3, 100, 300, 512], 100, 0),
    "t4_sink_past_tile": (8, 4, 4, 64, 1024, [4, 90, 600, 1024], 200, 70),
    "t64_rows64_d128": (8, 2, 64, 128, 1024, [64, 100, 700, 1024], 129, 4),
    "t256": (16, 4, 256, 64, 2048, [256, 300, 1500, 2048], 1000, 4),
    "window_past_smax": (8, 2, 3, 64, 256, [3, 80, 256], 5000, 2),
}


def window_cache(quant, dtype, b, hkv, s_max, d, lengths, dev, seed):
    if quant is not None:
        return quantized_cache(quant, b, hkv, s_max, d, lengths, dev, seed=seed)
    cache = kvcache.KVCache(
        k=randn((b, hkv, s_max, d), dtype, dev, seed),
        v=randn((b, hkv, s_max, d), dtype, dev, seed + 1),
        length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    for i, n in enumerate(lengths):  # garbage past every length
        cache.k[i, :, n:] = float("nan")
        cache.v[i, :, n:] = float("nan")
    return cache


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("case", sorted(WINDOW_DECODE_CASES))
def test_windowed_decode_kernel_matches_plain(dev, mode, case):
    """K2 with a window and sinks in all four cache modes against its plain
    version (int8 P requantized per 64-position tile, as the kernel does):
    lengths on both sides of the window, sinks inside and past a tile."""
    hq, hkv, t, d, s_max, lengths, w, sink = WINDOW_DECODE_CASES[case]
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    quant = mode if mode in ("int8", "fp8") else None
    cache = window_cache(quant, dtype, len(lengths), hkv, s_max, d, lengths, dev, 84)
    q = randn((len(lengths), hq, t, d), dtype, dev, 86)
    before = decode.WINDOW_LAUNCHES
    o = decode.decode_attention_chunk(q, cache, window=w, sink=sink)
    torch.cuda.synchronize()
    assert decode.WINDOW_LAUNCHES == before + 1
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                            window=w, sink=sink)
    rep = verify_results(ref, o, **(QTOL if quant else TOL[dtype]))
    assert rep.passed, rep
    if t == 1:
        o1 = decode.decode_attention(q[:, :, 0].contiguous(), cache, window=w, sink=sink)
        assert torch.equal(o1, o[:, :, 0])


@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [1, 256])
def test_windowed_paged_decode_equals_dense(dev, quant, page, t):
    """The paged K2 with a window and sinks equals the dense K2 bit for bit
    on the same content in scrambled pages: the sink tiles fetch their own
    pages, left of the window's."""
    b, hq, hkv, d, s_max = 4, 16, 4, 64, 2048
    lengths = [256, 600, 1500, 2048]
    cache = window_cache(quant, torch.bfloat16, b, hkv, s_max, d, lengths, dev, 87)
    pool = paged_copy(cache, page, dev)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 89)
    before = paged.WINDOW_LAUNCHES
    o_paged = paged.paged_decode_attention_chunk(q, pool, window=500, sink=4)
    o_dense = decode.decode_attention_chunk(q, cache, window=500, sink=4)
    torch.cuda.synchronize()
    assert paged.WINDOW_LAUNCHES == before + 1
    assert torch.equal(o_paged, o_dense)
    ref = paged.paged_decode_reference(q, pool, requant_block=decode.BLOCK_KV, window=500,
                                       sink=4)
    rep = verify_results(ref, o_paged, **(TOL[torch.bfloat16] if quant is None else QTOL))
    assert rep.passed, rep


def test_windowed_decode_reads_only_the_live_span(dev):
    """A full 8192-token cache with a window of 1024 and 4 sinks: the kernel
    reads the sink tile and the window's tiles alone. NaN everywhere else
    cannot reach the output, and the output equals the call on a cache that
    holds only those positions."""
    b, hq, hkv, d, s_max, w = 2, 8, 2, 64, 8192, 1024
    cache = window_cache(None, torch.bfloat16, b, hkv, s_max, d, [s_max, 5000], dev, 90)
    q = randn((b, hq, d), torch.bfloat16, dev, 92)
    clean = decode.decode_attention(q, cache, window=w, sink=4)
    for i, n in enumerate([s_max, 5000]):
        dead = slice(64, (n - w) // 64 * 64)  # between the sink tile and the window's tiles
        cache.k[i, :, dead] = float("nan")
        cache.v[i, :, dead] = float("nan")
    poisoned = decode.decode_attention(q, cache, window=w, sink=4)
    torch.cuda.synchronize()
    assert torch.equal(clean, poisoned)


def test_windowed_attention_needs_no_gradient(dev):
    """flash_attention with a window runs K1 alone (no LSE, no backward)
    without a gradient; when an input requires one it runs K1 with the LSE
    and the windowed backward, whose gradients match the plain route's."""
    q = randn((1, 4, 128, 64), torch.bfloat16, dev, 93)
    k = randn((1, 2, 128, 64), torch.bfloat16, dev, 94)
    before = launch_counters.read()
    o = flash_attention(q, k, k, is_causal=True, window=32)
    added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
    assert added == {"flash_fwd": 1, "flash_fwd_window": 1}
    ref, _ = flash_fwd.flash_attention_forward_reference(q, k, k, True, window=32)
    assert verify_results(ref, o, **TOL[torch.bfloat16]).passed
    leaves = [q.clone().requires_grad_(), k.clone().requires_grad_()]
    got = torch.autograd.grad(flash_attention(leaves[0], leaves[1], leaves[1], is_causal=True,
                                              window=32), leaves, q)
    want = torch.autograd.grad(plain_flash_attention(leaves[0], leaves[1], leaves[1],
                                                     is_causal=True, window=32), leaves, q)
    for r, g in zip(want, got):
        rep = verify_results(r, g, **GRAD_TOL[torch.bfloat16])
        assert rep.passed, rep


# ---- the window and segment ids in the backward kernels (B3, B4, B5), segment ids in K1 ----

WINDOW_BWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, pos_offset, window)
    "w1": (1, 8, 2, 1000, 1000, 64, None, 1),
    "w63": (1, 8, 2, 1000, 1000, 64, None, 63),
    "w64": (1, 8, 2, 1000, 1000, 64, None, 64),
    "w65": (1, 8, 2, 1000, 1000, 64, None, 65),
    "w1000_past_s": (1, 8, 2, 1000, 1000, 64, None, 1000),
    "w129_d128_gqa": (1, 8, 1, 700, 700, 128, None, 129),
    "w300_sq_below_sk_offset": (1, 8, 2, 600, 1500, 128, 700, 300),
    "w100_no_key_rows": (1, 4, 2, 256, 256, 64, -120, 100),
    # MISTRAL_7B's widths past the 4096-token window
    "mistral_w4096": (1, 32, 8, 4608, 4608, 128, None, 4096),
}


def window_bwd_inputs(case, dtype, dev):
    b, hq, hkv, s_q, s_k, d, off, w = WINDOW_BWD_CASES[case]
    q, do = (randn((b, hq, s_q, d), dtype, dev, seed) for seed in (95, 96))
    k, v = (randn((b, hkv, s_k, d), dtype, dev, seed) for seed in (97, 98))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, pos_offset=off, window=w)
    return (q, k, v, o, do, lse), dict(is_causal=True, pos_offset=off, window=w)


def assert_grads_match(ref, out, dtype, window=None):
    """The three gradients against the plain version. With a window of one
    key a row's softmax gradient vanishes (dS = P (dP - delta) = 0), so dQ
    and dK are rounding noise on both sides: held to |x| <= 1e-4 instead."""
    for name, r, g in zip(("dQ", "dK", "dV"), ref, out):
        assert g.dtype == dtype and g.shape == r.shape and bool(torch.isfinite(g).all()), name
        if window == 1 and name != "dV":
            assert float(g.abs().max()) <= 1e-4 and float(r.abs().max()) <= 1e-4, name
            continue
        rep = verify_results(r, g, **GRAD_TOL[dtype])
        assert rep.passed, f"{name}: {rep}"


def window_launches():
    c = launch_counters.read()
    return (c["flash_bwd_fused_window"], c["flash_bwd_dq_window"], c["flash_bwd_dkv_window"])


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(WINDOW_BWD_CASES))
def test_windowed_backward_kernels_match_plain(dev, impl, dtype, case):
    """B3 (fused) and B4 + B5 (split) with a sliding window against their
    plain version: windows of one key, at and beside the 64-row tiles, past
    S, with GQA at D 128, S_q != S_k with a pos_offset, rows that see no
    key (their dQ exactly 0), and MISTRAL_7B's widths."""
    if dtype == torch.float32 and case == "mistral_w4096":
        pytest.skip("the float32 CUDA-core kernels are held at the small shapes")
    args, kw = window_bwd_inputs(case, dtype, dev)
    before = window_launches()
    out = flash_bwd.flash_attention_backward(*args, impl=impl, **kw)
    torch.cuda.synchronize()
    added = tuple(a - b for a, b in zip(window_launches(), before))
    assert added == ((1, 0, 0) if impl == "fused" else (0, 1, 1))
    ref = flash_bwd.flash_attention_backward_reference(*args, **kw)
    assert_grads_match(ref, out, dtype, kw["window"])
    dead = torch.isneginf(args[5])  # rows that see no key
    assert not bool(out[0][dead].any())


def segments(lens, total, dev, k_total=None):
    """Canonical ids of documents of `lens` then padding: (seg_q [1, total]
    with -1, seg_k [1, k_total or total] with -2)."""
    ids = torch.full((total,), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[off:off + n] = i
        off += n
    seg_k = torch.where(ids < 0, -2, ids).to(torch.int32)[:k_total]
    return ids[None].to(dev).contiguous(), seg_k[None].to(dev).contiguous()


SEGMENT_CASES = {
    # name: (Hq, Hkv, S_q, D, causal, window, lens): lengths off the tile
    # multiples, trailing padding
    "causal": (8, 2, 1100, 64, True, None, [300, 37, 500, 119]),
    "noncausal": (8, 2, 1100, 64, False, None, [300, 37, 500, 119]),
    "causal_d128": (8, 2, 1100, 128, True, None, [300, 37, 500, 119]),
    "window100_d128": (8, 2, 1100, 128, True, 100, [300, 37, 500, 119]),
    "window65_one_doc_per_tile": (4, 4, 700, 64, True, 65, [64, 64, 65, 63, 200, 1, 128]),
}


def segment_inputs(case, dtype, dev):
    hq, hkv, s, d, causal, w, lens = SEGMENT_CASES[case]
    q, do = (randn((1, hq, s, d), dtype, dev, seed) for seed in (101, 102))
    k, v = (randn((1, hkv, s, d), dtype, dev, seed) for seed in (103, 104))
    seg = segments(lens, s, dev)
    return (q, k, v, do), dict(is_causal=causal, window=w, segment_ids=seg), sum(lens)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segmented_kernels_match_plain(dev, dtype, case):
    """K1, then B3 and B4 + B5, with segment ids (and a window) against their
    plain versions; padding rows' O and LSE and every gradient of a padding
    position exactly 0 / -inf; each kernel counts its segmented launch."""
    (q, k, v, do), kw, live = segment_inputs(case, dtype, dev)
    before = launch_counters.read()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, kw["is_causal"], window=kw["window"],
                                               segment_ids=kw["segment_ids"])
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
        q, k, v, kw["is_causal"], window=kw["window"], segment_ids=kw["segment_ids"])
    torch.cuda.synchronize()
    assert verify_results(o_ref, o, **TOL[dtype]).passed
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    assert not bool(o[:, :, live:].any()) and bool(torch.isneginf(lse[:, :, live:]).all())
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
    for impl in ("fused", "split"):
        out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl, **kw)
        torch.cuda.synchronize()
        assert_grads_match(ref, out, dtype)
        for g in out:
            assert not bool(g[:, :, live:].any())
    added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
    assert all(added.get(n) == 1 for n in ("flash_fwd_segments", "flash_bwd_fused_segments",
                                           "flash_bwd_dq_segments", "flash_bwd_dkv_segments"))


def test_segment_pair_with_sq_below_sk(dev):
    """A (seg_q, seg_k) pair, S_q 300 against S_k 1000, causal with a
    pos_offset of 600 and not causal: K1 and both backward paths."""
    q, do = (randn((1, 8, 300, 64), torch.bfloat16, dev, seed) for seed in (105, 106))
    k, v = (randn((1, 2, 1000, 64), torch.bfloat16, dev, seed) for seed in (107, 108))
    seg_q = torch.sort(torch.randint(-1, 5, (1, 300), generator=torch.Generator().manual_seed(0)),
                       dim=1).values.to(torch.int32).to(dev)
    _, seg_k = segments([200, 250, 150, 300], 1000, dev)
    for causal, off in ((True, 600), (False, None)):
        kw = dict(is_causal=causal, pos_offset=off, segment_ids=(seg_q, seg_k))
        o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
        o_ref, _ = flash_fwd.flash_attention_forward_reference(q, k, v, **kw)
        assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
        ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
        for impl in ("fused", "split"):
            assert_grads_match(ref, flash_bwd.flash_attention_backward(
                q, k, v, o, do, lse, impl=impl, **kw), torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_split_is_bitwise_deterministic_with_window_and_segments(dev, d):
    (q, k, v, do), kw, _ = segment_inputs("window100_d128", torch.bfloat16, dev)
    q, k, v, do = (x[..., :d].contiguous() for x in (q, k, v, do))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, window=kw["window"],
                                               segment_ids=kw["segment_ids"])
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_segment_ids_must_be_int32_on_the_card(dev):
    (q, k, v, do), kw, _ = segment_inputs("causal", torch.bfloat16, dev)
    seg_q, seg_k = kw["segment_ids"]
    for bad in ((seg_q.long(), seg_k), (seg_q.cpu(), seg_k.cpu()), (seg_q[:, :-1], seg_k)):
        with pytest.raises(ValueError):
            flash_fwd.flash_attention_forward(q, k, v, True, segment_ids=bad)


def test_varlen_and_packed_model_run_the_kernels(dev):
    """flash_attention_varlen, llama.loss_fn(segment_ids=...) and
    train.train_step(segment_ids=...) on CUDA tensors go through K1 and the
    backward kernels with segment ids (and each layer's window), and their
    gradients match the plain route's."""
    from flashattn_tpu_torch.ops.varlen import flash_attention_varlen

    ids = segments([100, 37, 200], 400, dev)[0]
    leaves = [randn((1, h, 400, 64), torch.bfloat16, dev, 110 + i).requires_grad_()
              for i, h in enumerate((8, 2, 2))]
    before = launch_counters.read()
    o = flash_attention_varlen(*leaves, segment_ids=ids, is_causal=True, window=50)
    got = torch.autograd.grad(o, leaves, o.detach())
    added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
    assert added == {"flash_fwd": 1, "flash_fwd_window": 1, "flash_fwd_segments": 1,
                     "flash_bwd_fused": 1, "flash_bwd_fused_window": 1,
                     "flash_bwd_fused_segments": 1}
    seg = (ids, torch.where(ids < 0, -2, ids).to(torch.int32))
    want = torch.autograd.grad(plain_flash_attention(*leaves, is_causal=True, window=50,
                                                     segment_ids=seg), leaves, o.detach())
    for r, g in zip(want, got):
        assert verify_results(r, g, **GRAD_TOL[torch.bfloat16]).passed

    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, attn_window=64,
                      dtype=torch.float32)
    model = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, 256, (2, 301), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    segs = torch.cat([segments([150, 100], 301, dev)[0], segments([301], 301, dev)[0]])
    state = train.init_train_state(model, train.TrainConfig(warmup_steps=1))
    before = launch_counters.read()
    state, metrics = train.train_step(state, tokens, segment_ids=segs)
    added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
    assert added["flash_fwd_segments"] == added["flash_bwd_fused_segments"] == 2
    assert added["flash_fwd_window"] == added["flash_bwd_fused_window"] == 2
    assert torch.isfinite(metrics["loss"])


# ---- the logit soft-cap and head dim 256: K1, K2 dense and paged ----

SOFTCAP_FWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, causal, pos_offset, window, cap)
    "d256_cap50": (1, 4, 2, 700, 700, 256, True, None, None, 50.0),
    "d256_cap50_w300": (1, 4, 2, 700, 700, 256, True, None, 300, 50.0),
    "d256_nocap": (2, 4, 1, 333, 333, 256, True, None, None, None),
    "d256_nocap_w65": (1, 8, 2, 515, 515, 256, True, None, 65, None),
    "d256_cap5_noncausal": (1, 4, 4, 77, 333, 256, False, None, None, 5.0),
    "d256_cap30_sq_below_sk": (1, 8, 2, 130, 700, 256, True, 400, 200, 30.0),
    "d256_cap50_no_key_rows": (1, 4, 2, 256, 256, 256, True, -70, None, 50.0),
    "d256_tile_edges": (1, 2, 1, 129, 129, 256, True, None, 64, 50.0),
    "d64_cap30": (1, 8, 2, 600, 600, 64, True, None, None, 30.0),
    "d64_cap30_w100": (1, 8, 2, 600, 600, 64, True, None, 100, 30.0),
    "d128_cap50": (1, 8, 2, 515, 515, 128, True, None, None, 50.0),
    "d128_cap5_w63_noncausal_gqa": (2, 8, 1, 300, 300, 128, False, None, None, 5.0),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(SOFTCAP_FWD_CASES))
def test_softcap_and_d256_flash_fwd_kernel_match_plain(dev, dtype, case):
    """K1 at D 256 and with the soft-cap against its plain version: caps
    of 5 to 50 on inputs whose logits pass them (q x 8), with and without a
    window, causal or not, S_q != S_k with a pos_offset, rows that see no
    key, a q tile one row past the 128-row tile; the soft-capped launches
    counted."""
    b, hq, hkv, s_q, s_k, d, causal, off, w, cap = SOFTCAP_FWD_CASES[case]
    q = randn((b, hq, s_q, d), dtype, dev, 101) * 8
    k = randn((b, hkv, s_k, d), dtype, dev, 102)
    v = randn((b, hkv, s_k, d), dtype, dev, 103)
    before = flash_fwd.SOFTCAP_LAUNCHES
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, pos_offset=off, window=w,
                                               logit_softcap=cap)
    torch.cuda.synchronize()
    assert flash_fwd.SOFTCAP_LAUNCHES == before + (cap is not None)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
        q, k, v, causal, pos_offset=off, window=w, logit_softcap=cap)
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    rep = verify_results(lse_ref, lse, atol=1e-3)
    assert rep.passed, f"LSE: {rep}"
    dead = torch.isneginf(lse_ref)
    assert torch.equal(torch.isneginf(lse), dead)
    assert not bool(o[dead].any())


SOFTCAP_DECODE_CASES = {
    # name: (Hq, Hkv, T, D, Smax, lengths, window, sink, cap)
    "d256_t1": (16, 8, 1, 256, 1024, [1, 64, 65, 700], None, 0, 50.0),
    "d256_t1_window_sink": (16, 8, 1, 256, 1024, [3, 100, 700, 1024], 100, 4, 50.0),
    "d256_t4_nocap": (8, 2, 4, 256, 512, [4, 90, 300, 512], None, 0, None),
    "d256_t256": (16, 8, 256, 256, 2048, [256, 300, 1500, 2048], 1000, 4, 50.0),
    "d128_t1_cap30": (16, 2, 1, 128, 1024, [1, 64, 65, 1024], 64, 4, 30.0),
    "d64_t4_cap5": (8, 4, 4, 64, 1024, [4, 90, 600, 1024], None, 0, 5.0),
}


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("case", sorted(SOFTCAP_DECODE_CASES))
def test_softcap_and_d256_decode_kernel_match_plain(dev, mode, case):
    """K2 at D 256 and with the soft-cap in all four cache modes against
    its plain version (int8 P requantized per 64-position tile, as the
    kernel does), on q whose logits pass the cap (x 6): lengths on both
    sides of a window, sinks, one row a group and 16 (G 2 and 8), chunks of
    4 and 256."""
    hq, hkv, t, d, s_max, lengths, w, sink, cap = SOFTCAP_DECODE_CASES[case]
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    quant = mode if mode in ("int8", "fp8") else None
    cache = window_cache(quant, dtype, len(lengths), hkv, s_max, d, lengths, dev, 104)
    q = randn((len(lengths), hq, t, d), dtype, dev, 106) * 6
    before = decode.SOFTCAP_LAUNCHES
    o = decode.decode_attention_chunk(q, cache, window=w, sink=sink, logit_softcap=cap)
    torch.cuda.synchronize()
    assert decode.SOFTCAP_LAUNCHES == before + (cap is not None)
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                            window=w, sink=sink, logit_softcap=cap)
    rep = verify_results(ref, o, **(QTOL if quant else TOL[dtype]))
    assert rep.passed, rep
    if t == 1:
        o1 = decode.decode_attention(q[:, :, 0].contiguous(), cache, window=w, sink=sink,
                                     logit_softcap=cap)
        assert torch.equal(o1, o[:, :, 0])


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("d", [64, 256])
def test_int8_decode_kernel_on_peaked_rows_matches_plain(dev, d, t, cap):
    """K2's int8 mode on q x 100, whose rows leave most 64-position tiles
    so far below their maximum that P x v_scale is subnormal or zero there:
    such a tile requantizes to zeros (csrc/decode.cuh kRmaxMin), finite and
    within the quantized gate of the plain version."""
    lengths = [1, 700, 2048]
    cache = window_cache("int8", torch.bfloat16, len(lengths), 2, 2048, d, lengths, dev, 107)
    q = randn((len(lengths), 8, t, d), torch.bfloat16, dev, 108) * 100
    o = decode.decode_attention_chunk(q, cache, logit_softcap=cap)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                            logit_softcap=cap)
    rep = verify_results(ref, o, **QTOL)
    assert rep.passed, rep


@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [1, 256])
def test_softcap_d256_paged_decode_equals_dense(dev, quant, page, t):
    """The paged K2 at D 256 with cap 50, a window and sinks equals the
    dense K2 bit for bit on the same content in scrambled pages."""
    b, hq, hkv, d, s_max = 2, 16, 8, 256, 2048
    lengths = [600, 2048]
    cache = window_cache(quant, torch.bfloat16, b, hkv, s_max, d, lengths, dev, 107)
    pool = paged_copy(cache, page, dev)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 109) * 6
    kw = dict(window=500, sink=4, logit_softcap=50.0)
    before = paged.SOFTCAP_LAUNCHES
    o_paged = paged.paged_decode_attention_chunk(q, pool, **kw)
    o_dense = decode.decode_attention_chunk(q, cache, **kw)
    torch.cuda.synchronize()
    assert paged.SOFTCAP_LAUNCHES == before + 1
    assert torch.equal(o_paged, o_dense)
    ref = paged.paged_decode_reference(q, pool, requant_block=decode.BLOCK_KV, **kw)
    rep = verify_results(ref, o_paged, **(TOL[torch.bfloat16] if quant is None else QTOL))
    assert rep.passed, rep


SOFTCAP_BWD_CASES = {
    # name: (Hq, Hkv, S, D, window, documents, heat, cap): q times `heat`
    # (30: logits of about +-100, the tanh saturated, its derivative near 0)
    "d64_causal_cap30": (8, 2, 700, 64, None, None, 1.0, 30.0),
    "d64_window65_segments_cap5": (8, 2, 700, 64, 65, [300, 37, 250], 1.0, 5.0),
    "d64_hot_window100_cap30": (8, 2, 700, 64, 100, None, 30.0, 30.0),
    "d128_window100_cap30": (8, 2, 700, 128, 100, None, 1.0, 30.0),
    "d128_segments_cap50": (8, 2, 700, 128, None, [300, 37, 250], 1.0, 50.0),
    "d128_hot_cap50": (8, 1, 515, 128, None, None, 30.0, 50.0),
    "d256_causal_cap50": (4, 2, 700, 256, None, None, 1.0, 50.0),
    "d256_window129_cap50": (4, 2, 700, 256, 129, None, 1.0, 50.0),
    "d256_segments_cap50": (4, 2, 700, 256, None, [300, 37, 250], 1.0, 50.0),
    "d256_window65_segments_cap30": (4, 2, 700, 256, 65, [300, 37, 250], 1.0, 30.0),
    "d256_hot_cap50": (4, 2, 515, 256, None, None, 30.0, 50.0),
    "d256_hot_window100_segments_cap50": (8, 2, 515, 256, 100, [200, 1, 250], 30.0, 50.0),
    "d256_nocap": (4, 1, 333, 256, None, None, 1.0, None),
    "d256_nocap_window65_segments": (4, 2, 515, 256, 65, [200, 1, 250], 1.0, None),
}


def softcap_bwd_inputs(case, dtype, dev):
    """(q, k, v, do) and the call's options; O and LSE come from K1."""
    hq, hkv, s, d, w, docs, heat, cap = SOFTCAP_BWD_CASES[case]
    q = (randn((1, hq, s, d), torch.float32, dev, 121) * heat).to(dtype)
    do = randn((1, hq, s, d), dtype, dev, 122)
    k, v = (randn((1, hkv, s, d), dtype, dev, seed) for seed in (123, 124))
    seg = segments(docs, s, dev) if docs is not None else None
    return (q, k, v, do), dict(is_causal=True, window=w, segment_ids=seg, logit_softcap=cap)


def softcap_launches():
    c = launch_counters.read()
    return {n: c[n] for n in ("flash_fwd_softcap", "flash_bwd_fused_softcap",
                              "flash_bwd_dq_softcap", "flash_bwd_dkv_softcap")}


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(SOFTCAP_BWD_CASES))
def test_softcap_and_d256_backward_kernels_match_plain(dev, impl, dtype, case):
    """K1 (with the LSE), then B3 (fused) or B4 + B5 (split), with the
    soft-cap at D 64, 128 and 256 against their plain versions: causal,
    a window, segment ids (documents off the tiles, padding), both, hot
    inputs whose logits saturate the tanh, and D 256 without a cap; the
    soft-capped launches counted, padding's outputs and gradients exactly
    0."""
    (q, k, v, do), kw = softcap_bwd_inputs(case, dtype, dev)
    cap = kw["logit_softcap"]
    before = softcap_launches()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert verify_results(o_ref, o, **TOL[dtype]).passed
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl, **kw)
    torch.cuda.synchronize()
    added = {n: c - before[n] for n, c in softcap_launches().items()}
    on = int(cap is not None)
    assert added == {"flash_fwd_softcap": on, "flash_bwd_fused_softcap": on * (impl == "fused"),
                     "flash_bwd_dq_softcap": on * (impl == "split"),
                     "flash_bwd_dkv_softcap": on * (impl == "split")}
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
    assert_grads_match(ref, out, dtype)
    if kw["segment_ids"] is not None:
        pad = kw["segment_ids"][0][0] < 0
        assert not bool(o[:, :, pad].any())
        assert all(not bool(g[:, :, pad].any()) for g in out)


@pytest.mark.parametrize("case", ["d256_window65_segments_cap30", "d256_hot_cap50"])
def test_split_is_bitwise_deterministic_with_softcap_at_d256(dev, case):
    (q, k, v, do), kw = softcap_bwd_inputs(case, torch.bfloat16, dev)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_softcap_and_d256_gradients_run_the_kernels(dev):
    """A gradient through flash_attention with a cap at D 256 (formerly
    refused) runs K1 and the fused kernel, both soft-capped, and matches
    the plain route; varlen with a cap and segment ids runs them with the
    ids; K1 takes a cap with segment ids."""
    from flashattn_tpu_torch.ops.varlen import flash_attention_varlen

    leaves = [randn((1, h, 400, 256), torch.bfloat16, dev, 130 + i).requires_grad_()
              for i, h in enumerate((4, 2, 2))]
    do = randn((1, 4, 400, 256), torch.bfloat16, dev, 133)
    ids = segments([150, 37, 200], 400, dev)[0]
    for route in ("dense", "varlen"):
        before = launch_counters.read()
        if route == "dense":
            o = flash_attention(*leaves, is_causal=True, logit_softcap=50.0, window=100)
            seg = None
        else:
            o = flash_attention_varlen(*leaves, segment_ids=ids, is_causal=True,
                                       logit_softcap=50.0)
            seg = (ids, torch.where(ids < 0, -2, ids).to(torch.int32))
        got = torch.autograd.grad(o, leaves, do)
        added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
        extra = ("window" if route == "dense" else "segments")
        assert added == {n: 1 for n in ("flash_fwd", "flash_fwd_softcap", f"flash_fwd_{extra}",
                                        "flash_bwd_fused", "flash_bwd_fused_softcap",
                                        f"flash_bwd_fused_{extra}")}, added
        o_ref = plain_flash_attention(*leaves, is_causal=True, logit_softcap=50.0,
                                      window=100 if route == "dense" else None, segment_ids=seg)
        want = torch.autograd.grad(o_ref, leaves, do)
        assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
        assert_grads_match(want, got, torch.bfloat16)


def test_tiny_gemma_trains_on_card_like_cpu(dev):
    """A float32 model with every Gemma-2 field (D 256, alternate window of
    16, caps 50 and 30, post-norms): loss_fn and its gradients on a packed
    row through K1 and the backward kernels, split and fused, against the
    plain versions on the CPU; loss within 1e-4, gradients atol 1e-3, rtol
    1e-3 (float32 kernels: exp2 against exp and sums in another order,
    through 2 layers)."""
    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=256, max_seq_len=256,
                      dtype=torch.float32, norm_eps=1e-6, tie_embeddings=True, attn_window=16,
                      window_pattern="alternate", logit_softcap=50.0, final_logit_softcap=30.0,
                      mlp_activation="gelu_tanh", use_post_norms=True, scale_embeddings=True,
                      attn_scale=256**-0.5, norm_offset=1.0)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    with torch.no_grad():
        for layer in cpu.layers:
            layer.wq.mul_(12.0)  # logits that reach the cap
    card = llama.Llama(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 128, (1, 97), generator=torch.Generator().manual_seed(9))
    ids = torch.full((1, 97), -1, dtype=torch.int32)
    ids[0, :40], ids[0, 40:90] = 0, 1
    cpu.zero_grad()
    want = llama.loss_fn(cpu, tokens, segment_ids=ids)
    want.backward()
    for impl in ("fused", "split"):
        card.zero_grad()
        before = launch_counters.read()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(flash_bwd.IMPL_ENV, impl)
            got = llama.loss_fn(card, tokens.to(dev), segment_ids=ids.to(dev))
            got.backward()
        added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
        kernels = ["flash_bwd_fused"] if impl == "fused" else ["flash_bwd_dq", "flash_bwd_dkv"]
        assert all(added[f"{k}_{x}"] == 2 for k in ["flash_fwd", *kernels]
                   for x in ("softcap", "segments"))
        assert abs(float(got) - float(want)) <= 1e-4
        for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
            rep = verify_results(q.grad, p.grad.cpu(), atol=1e-3, rtol=1e-3)
            assert rep.passed, f"{impl} grad {name}: {rep}"


def test_tiny_gemma_on_card_matches_cpu(dev):
    """A float32 model with every Gemma-2 field (D 256, alternate window of
    16, caps 50 and 30, post-norms) through K1 and K2 on the card against
    the plain versions on the CPU: a prefill past the window and decode
    steps; atol 1e-3, rtol 1e-3 (float32 kernels: exp2 against exp and
    sums in another order, through 3 layers)."""
    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=3,
                      num_heads=2, num_kv_heads=1, head_dim=256, max_seq_len=256,
                      dtype=torch.float32, norm_eps=1e-6, tie_embeddings=True, attn_window=16,
                      window_pattern="alternate", logit_softcap=50.0, final_logit_softcap=30.0,
                      mlp_activation="gelu_tanh", use_post_norms=True, scale_embeddings=True,
                      attn_scale=256**-0.5, norm_offset=1.0)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    with torch.no_grad():
        for layer in cpu.layers:
            layer.wq.mul_(12.0)  # logits that reach the cap
    card = llama.Llama(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(6))
    forced = torch.randint(0, 128, (3, 2), generator=torch.Generator().manual_seed(7))
    outs = []
    for model in (cpu, card):
        caches = generate.init_caches(model, 2, 128)
        logits, caches = generate.prefill(model, prompt.to(model.device), caches,
                                          return_all=True)
        steps = [logits.cpu()]
        for i in range(3):
            pos = torch.full((2,), 40 + i, dtype=torch.int32, device=model.device)
            logits, caches = generate.decode_step(model, forced[i].to(model.device), pos, caches)
            steps.append(logits.cpu())
        outs.append(steps)
    for i, (want, got) in enumerate(zip(*outs)):
        rep = verify_results(want, got, atol=1e-3, rtol=1e-3)
        assert rep.passed, f"step {i}: {rep}"


REMAT_K1 = {False: 1, True: 2, "dots": 2, "attn": 1}  # K1 launches a layer


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("remat", [True, "dots", "attn"])
def test_remat_on_the_kernels(dev, remat, impl, packed):
    """A bf16 model (D 64, GQA 4/2, 3 layers) under remat on the kernels:
    K1 once a layer without remat and under "attn", twice under True and
    "dots"; the backward's kernels once a layer; the loss equal to the loss
    without remat bit for bit, the gradients too with the split backward
    and within the bf16-gradient gate with the fused one (dQ by atomics)."""
    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=3,
                      num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=512,
                      dtype=torch.bfloat16)
    model = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(11), device=dev)
    tokens = torch.randint(0, 256, (2, 301), generator=torch.Generator().manual_seed(12))
    ids = None
    if packed:
        ids = torch.full((2, 301), -1, dtype=torch.int32)
        ids[:, :130], ids[:, 130:290] = 0, 1
        ids = ids.to(dev)
    kernels = ["flash_bwd_fused"] if impl == "fused" else ["flash_bwd_dq", "flash_bwd_dkv"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(flash_bwd.IMPL_ENV, impl)
        for policy in (False, remat):
            model.zero_grad(set_to_none=True)
            before = launch_counters.read()
            loss = llama.loss_fn(model, tokens.to(dev), segment_ids=ids, remat=policy)
            loss.backward()
            added = {n: c - before[n] for n, c in launch_counters.read().items()
                     if c != before[n]}
            want = {"flash_fwd": REMAT_K1[policy] * cfg.num_layers,
                    **{k: cfg.num_layers for k in kernels}}
            if packed:
                want.update({f"{k}_segments": n for k, n in list(want.items())})
            assert added == want, policy
            runs[policy] = (loss.detach(), [p.grad for p in model.parameters()])
    (loss, grads), (ref_loss, ref_grads) = runs[remat], runs[False]
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref_grads):
        if impl == "split":
            assert torch.equal(g, r)
        else:
            assert verify_results(r, g, **GRAD_TOL[torch.bfloat16]).passed


def test_autotune_on_the_card(dev, tmp_path, monkeypatch):
    """autotune times fused and split at the shape, caches the winner in
    the given file and returns it; a cache hit launches nothing, force
    measures again; impl="auto" then launches the winner's kernels and
    FLASHATTN_BWD_IMPL overrides it."""
    from flashattn_tpu_torch.ops import autotune

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune.json"))
    monkeypatch.delenv(flash_bwd.IMPL_ENV, raising=False)
    q = randn((2, 8, 512, 64), torch.bfloat16, dev, 21)
    k = randn((2, 2, 512, 64), torch.bfloat16, dev, 22)
    v = randn((2, 2, 512, 64), torch.bfloat16, dev, 23)
    assert autotune.cached_bwd_impl(2, 8, 2, 512, 512, 64, True, torch.bfloat16) is None
    entry = autotune.autotune(q, k, v, is_causal=True)
    assert entry["bwd_impl"] in ("fused", "split") and entry["fused_ms"] > 0 < entry["split_ms"]
    assert entry["bwd_impl"] == ("fused" if entry["fused_ms"] <= entry["split_ms"] else "split")
    key = autotune._key(2, 8, 2, 512, 512, 64, True, torch.bfloat16)
    assert key.startswith(torch.cuda.get_device_name().replace(" ", "") + "|")
    assert json.loads((tmp_path / "autotune.json").read_text()) == {key: entry}
    assert autotune.cached_bwd_impl(2, 8, 2, 512, 512, 64, True, torch.bfloat16) == \
        entry["bwd_impl"]
    assert autotune.cached_bwd_impl(2, 8, 2, 512, 512, 64, False, torch.bfloat16) is None
    before = launch_counters.read()
    assert autotune.autotune(q, k, v, is_causal=True) == entry
    assert launch_counters.read() == before  # a hit measures nothing
    fresh = autotune.autotune(q, k, v, is_causal=True, force=True)
    assert launch_counters.read() != before  # force measures again
    assert set(fresh) == set(entry) and fresh["bwd_impl"] in ("fused", "split")
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    kernels = {"fused": {"flash_bwd_fused": 1}, "split": {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}}
    winner = autotune.cached_bwd_impl(2, 8, 2, 512, 512, 64, True, torch.bfloat16)
    loser = "split" if winner == "fused" else "fused"
    for env, impl in ((None, winner), (loser, loser)):
        if env:
            monkeypatch.setenv(flash_bwd.IMPL_ENV, env)
        before = launch_counters.read()
        flash_bwd.flash_attention_backward(q, k, v, o, q, lse, True, impl="auto")
        added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
        assert added == kernels[impl], env


# ---- model families, speculative decoding ----

FAMILY_CONFIGS = {
    # Qwen3: q/k RMSNorm; Qwen2: q/k/v biases; Llama-3.1: the llama3 remap
    # (original context 32, past it in the prompt); Phi-3: longrope (original
    # context 48, crossed by the decode steps)
    "qwen3": dict(qk_norm=True, norm_eps=1e-6, rope_theta=1000000.0),
    "qwen2": dict(attn_bias=True),
    "llama31": dict(rope_scaling=(8.0, 1.0, 4.0, 32), rope_theta=500000.0),
    "longrope": dict(rope_longrope=(tuple(1.0 + 0.03 * i for i in range(32)),
                                    tuple(2.0 + 0.2 * i for i in range(32)), 48, 1.19)),
}


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_model_family_on_card_matches_cpu(dev, family):
    """A small float32 model of each family (D 64) through K1 and K2 on the
    card against the plain versions on the CPU, with its biases and q/k norm
    weights perturbed: a 40-token prefill and 12 decode steps, then a chunk
    of 5 (the speculative verifier's T); atol 1e-3, rtol 1e-3."""
    cfg = ModelConfig(**dict(SMALL, dtype=torch.float32, **FAMILY_CONFIGS[family]))
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        for name, p in cpu.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "q_norm", "k_norm"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    card = llama.Llama(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(6))
    forced = torch.randint(0, cfg.vocab_size, (12, 2), generator=torch.Generator().manual_seed(7))
    piece = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(8))
    outs = []
    for model in (cpu, card):
        d = model.device
        caches = generate.init_caches(model, 2, 128)
        logits, caches = generate.prefill(model, prompt.to(d), caches, return_all=True)
        steps = [logits.cpu()]
        for i in range(12):
            pos = torch.full((2,), 40 + i, dtype=torch.int32, device=d)
            logits, caches = generate.decode_step(model, forced[i].to(d), pos, caches)
            steps.append(logits.cpu())
        logits, caches = generate.chunk_step(model, piece.to(d), torch.arange(52, 57, device=d),
                                             caches)
        steps.append(logits.cpu())
        outs.append(steps)
    for i, (want, got) in enumerate(zip(*outs)):
        rep = verify_results(want, got, atol=1e-3, rtol=1e-3)
        assert rep.passed, f"call {i}: {rep}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("family", ["qwen3", "llama31"])
def test_load_hf_dir_on_card_equals_cpu(dev, tmp_path, family, dtype):
    """load_hf_dir onto the card (each tensor copied as stored, then
    transposed and cast there) from a sharded bf16 safetensors checkpoint
    written by chip_smoke.py's writer: the config and every tensor equal
    the CPU load's bit for bit."""
    import chip_smoke
    from flashattn_tpu_torch.models import convert

    cfg = ModelConfig(**dict(SMALL, **FAMILY_CONFIGS[family]))
    hf = chip_smoke.hf_state_dict(cfg, torch.Generator().manual_seed(2), device="cpu")
    chip_smoke.write_hf_checkpoint(tmp_path, hf, cfg, shard_bytes=1 << 20)
    card, card_cfg = convert.load_hf_dir(tmp_path, dtype, device=dev)
    cpu, cpu_cfg = convert.load_hf_dir(tmp_path, dtype, device="cpu")
    assert card_cfg == cpu_cfg == dataclasses.replace(cfg, dtype=dtype)
    want = cpu.state_dict()
    for name, got in card.state_dict().items():
        assert got.device.type == "cuda" and got.dtype == dtype, name
        assert torch.equal(got.cpu(), want[name]), name


@pytest.mark.parametrize("paged_kv", [False, True])
@pytest.mark.parametrize("draft_layers", [2, 1])
def test_speculation_on_card_equals_generate(dev, paged_kv, draft_layers):
    """Greedy speculative_generate on the card (the target verifying k + 1 = 5
    tokens in one chunked K2 call): the target's generate tokens on the card,
    token for token, dense and paged; the self-draft accepts everything."""
    from flashattn_tpu_torch.models.speculate import speculative_generate

    target = small_model(dev)
    draft = (target if draft_layers == 2 else
             llama.init_params(ModelConfig(**dict(SMALL, num_layers=1)),
                               torch.Generator(device=dev).manual_seed(9), device=dev))
    prompt = torch.randint(0, 256, (1, 37), generator=torch.Generator().manual_seed(1)).to(dev)
    want = generate.generate(target, prompt, max_new_tokens=24)
    before = launch_counters.read()
    got, rate = speculative_generate(target, draft, prompt, max_new_tokens=24, k=4,
                                     paged=paged_kv, page_size=128)
    ran = {k: v - before[k] for k, v in launch_counters.read().items() if v != before[k]}
    assert got.tolist() == want.tolist(), (rate, got, want)
    assert (rate == 1.0) == (draft is target)
    assert ran["flash_fwd"] == target.cfg.num_layers + draft.cfg.num_layers
    assert ran["paged_decode" if paged_kv else "decode"] > 0


# ---- mixture-of-experts FFN ----

MOE_CASES = {  # name: (tokens, hidden, expert width, experts, top k, norm_topk)
    "qwen3_moe_decode": (2, 2048, 768, 128, 8, True),
    "qwen3_moe_prefill": (600, 2048, 768, 128, 8, True),
    "qwen15_moe_decode": (2, 2048, 1408, 60, 4, False),
    "mixtral_shape": (77, 512, 1024, 8, 2, True),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_grouped_matches_masked_dense_on_card(dev, case, dtype):
    """The grouped dispatch (torch._grouped_mm over the picked experts)
    against the masked-dense loop on the same card tensors: bf16 atol 2e-2,
    float32 atol 1e-4, rtol 1e-4; bitwise equal across two calls."""
    from flashattn_tpu_torch.parallel import moe

    t, h, f, e, k, norm = MOE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(5)
    params = moe.init_moe_params(g, h, f, e, dtype)
    x = torch.randn((t, h), generator=g, device=dev).to(dtype)
    got = moe.moe_ffn_grouped(x, params, k, "silu", norm)
    want = moe.moe_ffn_dense_reference(x, params, k, "silu", norm)
    rep = verify_results(want, got, **TOL[dtype])
    assert rep.passed, rep
    assert torch.equal(moe.moe_ffn_grouped(x, params, k, "silu", norm), got)


MOE_GRAD_CASES = {"qwen3_moe_train": (2048, 2048, 768, 128, 8, True),
                  "qwen15_moe_train": (600, 2048, 1408, 60, 4, False)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(MOE_GRAD_CASES))
def test_moe_grouped_backward_is_reproducible_on_card(dev, case, dtype):
    """moe_ffn_grouped's forward and backward twice on the same card
    tensors: y, dX and every routed parameter's gradient torch.equal (the
    gather's backward sums each token's k pair gradients in a fixed order,
    with no atomics; index_select's own, index_add_, does not repeat on the
    card); and every gradient against the masked-dense loop's under the
    gradient gates (bf16 rtol 2e-2, atol 5e-2; float32 atol 2e-4, rtol
    1e-4) on a cotangent of standard deviation 0.1."""
    from flashattn_tpu_torch.parallel import moe

    t, h, f, e, k, norm = MOE_GRAD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(6)
    params = moe.init_moe_params(g, h, f, e, dtype)
    x = torch.randn((t, h), generator=g, device=dev).to(dtype)
    dy = (torch.randn((t, h), generator=g, device=dev) * 0.1).to(dtype)

    def run(fn):
        xx = x.clone().requires_grad_()
        pp = {n: p.clone().requires_grad_() for n, p in params.items()}
        y = fn(xx, pp, k, "silu", norm)
        y.backward(dy)
        return [y.detach(), xx.grad] + [pp[n].grad for n in sorted(pp)]

    first, second = run(moe.moe_ffn_grouped), run(moe.moe_ffn_grouped)
    names = ["y", "x"] + sorted(params)
    for name, a, b in zip(names, first, second):
        assert torch.equal(a, b), f"d{name} differs between two runs"
    for name, want, got in zip(names[1:], run(moe.moe_ffn_dense_reference)[1:], first[1:]):
        rep = verify_results(want, got, **GRAD_TOL[dtype])
        assert rep.passed, f"d{name}: {rep}"


def test_moe_decode_step_captures_and_never_syncs(dev):
    """A small MoE model's decode step and chunk step run under
    set_sync_debug_mode("error") (no host read anywhere), and the step
    captured in a CUDA graph gives the eager step's logits exactly."""
    cfg = ModelConfig(**dict(SMALL, num_experts=16, top_k_experts=4, moe_shared_intermediate=128,
                             moe_norm_topk=False))
    model = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(3), device=dev)
    caches = generate.init_caches(model, 2, 256)
    prompt = torch.randint(0, cfg.vocab_size, (2, 30), device=dev)
    _, caches = generate.prefill(model, prompt, caches)
    graph = generate.DecodeGraph(model, [dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                                             length=c.length.clone())
                                         for c in caches])
    token = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    pos = torch.full((2,), 30, dtype=torch.int32, device=dev)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    piece = torch.randint(0, cfg.vocab_size, (2, 16), device=dev)
    generate.chunk_step(model, piece, torch.arange(40, 56, device=dev), generate.init_caches(
        model, 2, 256))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want, caches = generate.decode_step(model, token, pos, caches, active=active)
        generate.chunk_step(model, piece, torch.arange(31, 47, device=dev), caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = graph(token.cpu().pin_memory(), pos.cpu().pin_memory(), active.cpu().pin_memory())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---- ALiBi: K1, K2 dense and paged; K2's LSE output ----

STEEP = [0.8408964276313782]  # default_alibi_slopes(32)[0]: head 0 of 32, 0.84 a position

ALIBI_FWD_CASES = {
    # name: (B, Hq, Hkv, S_q, S_k, D, causal, pos_offset, window, slopes)
    "d64": (1, 8, 2, 600, 600, 64, True, None, None, None),
    "d64_w100": (1, 8, 2, 600, 600, 64, True, None, 100, None),
    "d64_noncausal_sq_below_sk": (1, 4, 4, 77, 333, 64, False, None, None, None),
    "d64_no_key_rows": (1, 4, 2, 256, 256, 64, True, -70, None, None),
    "d128": (1, 8, 2, 515, 515, 128, True, None, None, None),
    "d128_w63_gqa": (2, 8, 1, 300, 300, 128, True, None, 63, None),
    "d128_sq_below_sk_offset_w200": (1, 8, 2, 130, 700, 128, True, 400, 200, None),
    "d128_s16384_steep": (1, 1, 1, 16384, 16384, 128, True, None, None, STEEP),
    "d256": (1, 4, 2, 700, 700, 256, True, None, None, None),
    "d256_w300": (1, 4, 2, 700, 700, 256, True, None, 300, None),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(ALIBI_FWD_CASES))
def test_alibi_flash_fwd_kernel_matches_plain(dev, dtype, case):
    """K1 with ALiBi at D 64, 128 and 256, with and without a window,
    against its plain version: causal or not, S_q != S_k with a pos_offset,
    rows that see no key, and one steep head (0.84 a position) over 16,384
    keys, whose far tiles carry biases near -20,000 in the log2 domain; the
    ALiBi launches counted."""
    b, hq, hkv, s_q, s_k, d, causal, off, w, slopes = ALIBI_FWD_CASES[case]
    if slopes is not None:
        slopes = torch.tensor(slopes, device=dev)
    q = randn((b, hq, s_q, d), dtype, dev, 201)
    k = randn((b, hkv, s_k, d), dtype, dev, 202)
    v = randn((b, hkv, s_k, d), dtype, dev, 203)
    kw = dict(pos_offset=off, window=w, alibi=True, alibi_slopes=slopes)
    before = flash_fwd.ALIBI_LAUNCHES
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.ALIBI_LAUNCHES == before + 1
    assert bool(torch.isfinite(o).all())
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal, **kw)
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    rep = verify_results(lse_ref, lse, atol=1e-3)
    assert rep.passed, f"LSE: {rep}"
    dead = torch.isneginf(lse_ref)
    assert torch.equal(torch.isneginf(lse), dead)
    assert not bool(o[dead].any())


ALIBI_DECODE_CASES = {
    # name: (Hq, Hkv, T, D, Smax, lengths, window, sink)
    "t1_decode_shape": (32, 4, 1, 64, 2048, [1, 77, 1500, 2048], None, 0),
    "t256": (32, 4, 256, 64, 2048, [256, 300, 1500, 2048], None, 0),
    "t1_d128_window_sink": (32, 8, 1, 128, 1024, [3, 100, 700, 1024], 100, 4),
    "t256_d128_window": (32, 8, 256, 128, 2048, [256, 300, 1500, 2048], 1000, 4),
    "t4_d256": (16, 8, 4, 256, 512, [4, 90, 300, 512], None, 0),
}


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("case", sorted(ALIBI_DECODE_CASES))
def test_alibi_decode_kernel_matches_plain(dev, mode, case):
    """K2 with ALiBi in all four cache modes against its plain version
    (int8 P requantized per 64-position tile, as the kernel does): the
    decode shape, chunks of 4 and 256, a window with sinks, D 64, 128 and
    256; the ALiBi launches counted."""
    hq, hkv, t, d, s_max, lengths, w, sink = ALIBI_DECODE_CASES[case]
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    quant = mode if mode in ("int8", "fp8") else None
    cache = window_cache(quant, dtype, len(lengths), hkv, s_max, d, lengths, dev, 204)
    q = randn((len(lengths), hq, t, d), dtype, dev, 206)
    before = decode.ALIBI_LAUNCHES
    o = decode.decode_attention_chunk(q, cache, window=w, sink=sink, alibi=True)
    torch.cuda.synchronize()
    assert decode.ALIBI_LAUNCHES == before + 1
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                            window=w, sink=sink, alibi=True)
    rep = verify_results(ref, o, **(QTOL if quant else TOL[dtype]))
    assert rep.passed, rep
    if t == 1:
        o1 = decode.decode_attention(q[:, :, 0].contiguous(), cache, window=w, sink=sink,
                                     alibi=True)
        assert torch.equal(o1, o[:, :, 0])


@pytest.mark.parametrize("t", [1, 256])
def test_int8_decode_kernel_on_a_steep_alibi_head_matches_plain(dev, t):
    """One head at ALiBi's steepest standard slope (head 0 of 32, 0.84 a
    position) over a cache of 2,048 in int8: a tile one behind the
    diagonal already has P below 2^-100, which requantizes to zeros
    (csrc/decode.cuh kRmaxMin); O finite and within the quantized gate."""
    lengths = [2048]
    cache = window_cache("int8", torch.bfloat16, 1, 1, 2048, 64, lengths, dev, 207)
    q = randn((1, 1, t, 64), torch.bfloat16, dev, 208)
    slopes = torch.tensor(STEEP, device=dev)
    o = decode.decode_attention_chunk(q, cache, alibi=True, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                            alibi=True, alibi_slopes=slopes)
    rep = verify_results(ref, o, **QTOL)
    assert rep.passed, rep


@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("t", [1, 256])
def test_alibi_paged_decode_equals_dense(dev, quant, page, t):
    """The paged K2 with ALiBi (LLAMA_8B's heads, GQA 32/8 at D 128) equals
    the dense K2 bit for bit on the same content in scrambled pages."""
    b, hq, hkv, d, s_max = 2, 32, 8, 128, 2048
    lengths = [600, 2048]
    cache = window_cache(quant, torch.bfloat16, b, hkv, s_max, d, lengths, dev, 209)
    pool = paged_copy(cache, page, dev)
    q = randn((b, hq, t, d), torch.bfloat16, dev, 210)
    before = paged.ALIBI_LAUNCHES
    o_paged = paged.paged_decode_attention_chunk(q, pool, alibi=True)
    o_dense = decode.decode_attention_chunk(q, cache, alibi=True)
    torch.cuda.synchronize()
    assert paged.ALIBI_LAUNCHES == before + 1
    assert torch.equal(o_paged, o_dense)
    ref = paged.paged_decode_reference(q, pool, requant_block=decode.BLOCK_KV, alibi=True)
    rep = verify_results(ref, o_paged, **(TOL[torch.bfloat16] if quant is None else QTOL))
    assert rep.passed, rep


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
def test_decode_lse_output_matches_plain(dev, mode, t, alibi):
    """K2's LSE output (_decode_attention(with_lse=True)) against its plain
    version, atol 1e-3: at T 1 the decode shape's 16 slices merged
    (decode_merge_kernel writes it), at T 256 one slice (the split
    kernel's epilogue writes it); a slot of length 0 gives O 0 and LSE
    -inf; O equals the call without the LSE bit for bit."""
    lengths = [0, 77, 1500, 2048] if t == 1 else [0, 300, 1500, 2048]
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    quant = mode if mode in ("int8", "fp8") else None
    cache = window_cache(quant, dtype, 4, 4, 2048, 64, lengths, dev, 211)
    q = randn((4, 32, t, 64), dtype, dev, 212)
    before = decode.LSE_LAUNCHES
    o, lse = decode._decode_attention(q, cache, with_lse=True, alibi=alibi)
    torch.cuda.synchronize()
    assert decode.LSE_LAUNCHES == before + 1
    assert lse.shape == (4, 32, t) and lse.dtype == torch.float32
    o_ref, lse_ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV,
                                                       alibi=alibi, with_lse=True)
    assert bool(torch.isneginf(lse[0]).all()) and not bool(o[0].any())
    assert bool(torch.isfinite(lse[1:]).all())
    rep = verify_results(lse_ref[1:], lse[1:], atol=1e-3)
    assert rep.passed, f"LSE: {rep}"
    rep = verify_results(o_ref, o, **(QTOL if quant else TOL[dtype]))
    assert rep.passed, f"O: {rep}"
    assert torch.equal(o, decode.decode_attention_chunk(q, cache, alibi=alibi))


def test_alibi_model_on_card_matches_cpu_and_captures(dev):
    """A small float32 ALiBi model (RoPE off): prefill and decode steps
    through K1 and K2 on the card against the plain versions on the CPU,
    atol 1e-3, rtol 1e-3 (test_model_steps_on_card_match_cpu's), its ALiBi
    launches counted; the decode step captured in a CUDA graph gives the
    eager step's logits exactly and builds no slope table at capture."""
    cfg = ModelConfig(**dict(SMALL, use_alibi=True, dtype=torch.float32))
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    model = llama.Llama(cfg, dev)
    model.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(5))
    token = torch.tensor([7, 11], dtype=torch.int32)
    pos = torch.full((2,), 40, dtype=torch.int32)
    before = launch_counters.read()
    caches = generate.init_caches(model, 2, 256)
    logits, caches = generate.prefill(model, prompt.to(dev), caches)
    step, _ = generate.decode_step(model, token.to(dev), pos.to(dev), clone_caches(caches))
    torch.cuda.synchronize()
    after = launch_counters.read()
    assert after["flash_fwd_alibi"] - before["flash_fwd_alibi"] == cfg.num_layers
    assert after["decode_alibi"] - before["decode_alibi"] == cfg.num_layers
    cpu_logits, cpu_caches = generate.prefill(cpu, prompt, generate.init_caches(cpu, 2, 256))
    cpu_step, _ = generate.decode_step(cpu, token, pos, cpu_caches)
    for name, ref, out in (("prefill", cpu_logits, logits), ("decode", cpu_step, step)):
        rep = verify_results(ref, out.cpu(), atol=1e-3, rtol=1e-3)
        assert rep.passed, f"{name}: {rep}"
    tables = flash_fwd.standard_slope_table.cache_info().currsize
    graph = generate.DecodeGraph(model, caches)
    assert flash_fwd.standard_slope_table.cache_info().currsize == tables
    active = torch.ones(2, dtype=torch.bool)
    got = graph(token.pin_memory(), pos.pin_memory(), active.pin_memory())
    torch.cuda.synchronize()
    assert torch.equal(got, step)


# ---- ALiBi in the backward kernels (B3, B4, B5) and with segment ids in K1 ----

ALIBI_BWD_CASES = {
    # name: (Hq, Hkv, S_q, S_k, D, window, documents, pos_offset, slopes)
    "d64_causal": (8, 2, 700, 700, 64, None, None, None, None),
    "d64_window65_segments": (8, 2, 700, 700, 64, 65, [300, 37, 250], None, None),
    "d64_sq_below_sk_offset": (8, 2, 300, 700, 64, None, None, 500, None),
    "d64_no_key_rows": (4, 2, 256, 256, 64, None, None, -70, None),
    "d128_segments": (8, 2, 700, 700, 128, None, [300, 37, 250], None, None),
    "d128_window100_gqa": (8, 1, 515, 515, 128, 100, None, None, None),
    "d128_steep_s4096": (1, 1, 4096, 4096, 128, None, None, None, STEEP),
    "d256_causal": (4, 2, 700, 700, 256, None, None, None, None),
    "d256_window129_segments": (4, 2, 700, 700, 256, 129, [300, 37, 250], None, None),
    "d256_sq_below_sk_offset_w200": (4, 2, 130, 700, 256, 200, None, 400, None),
}


def alibi_bwd_inputs(case, dtype, dev):
    """(q, k, v, do) and the call's options; O and LSE come from K1."""
    hq, hkv, s_q, s_k, d, w, docs, off, slopes = ALIBI_BWD_CASES[case]
    q = randn((1, hq, s_q, d), dtype, dev, 221)
    do = randn((1, hq, s_q, d), dtype, dev, 222)
    k, v = (randn((1, hkv, s_k, d), dtype, dev, seed) for seed in (223, 224))
    seg = segments(docs, s_q, dev) if docs is not None else None
    return (q, k, v, do), dict(is_causal=True, window=w, segment_ids=seg, pos_offset=off,
                               alibi=True,
                               alibi_slopes=None if slopes is None else torch.tensor(
                                   slopes, device=dev))


def alibi_launches():
    c = launch_counters.read()
    return {n: c[n] for n in ("flash_fwd_alibi", "flash_fwd_alibi_segments",
                              "flash_bwd_fused_alibi", "flash_bwd_dq_alibi",
                              "flash_bwd_dkv_alibi")}


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(ALIBI_BWD_CASES))
def test_alibi_backward_kernels_match_plain(dev, impl, dtype, case):
    """K1 with ALiBi (with the LSE; with segment ids where the case has
    documents), then B3 (fused) or B4 + B5 (split) with ALiBi at D 64, 128
    and 256 against their plain versions: no mask, a window, segment ids
    (documents off the tiles, padding) with and without a window, GQA,
    S_q != S_k with a pos_offset, rows that see no key, and one steep head
    (0.84 a position) over 4,096 keys; the ALiBi launches counted; rows
    without keys get dQ = 0, padding's outputs and gradients exactly 0."""
    (q, k, v, do), kw = alibi_bwd_inputs(case, dtype, dev)
    seg = kw["segment_ids"] is not None
    before = alibi_launches()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl, **kw)
    torch.cuda.synchronize()
    added = {n: c - before[n] for n, c in alibi_launches().items()}
    assert added == {"flash_fwd_alibi": 1, "flash_fwd_alibi_segments": int(seg),
                     "flash_bwd_fused_alibi": int(impl == "fused"),
                     "flash_bwd_dq_alibi": int(impl == "split"),
                     "flash_bwd_dkv_alibi": int(impl == "split")}
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
    assert_grads_match(ref, out, dtype)
    dead = torch.isneginf(lse)
    assert torch.equal(dead, torch.isneginf(lse_ref))
    assert not bool(out[0][dead].any())
    if seg:
        pad = kw["segment_ids"][0][0] < 0
        assert not bool(o[:, :, pad].any())
        assert all(not bool(g[:, :, pad].any()) for g in out)


@pytest.mark.parametrize("case", ["d64_window65_segments", "d256_window129_segments",
                                  "d128_steep_s4096"])
def test_split_is_bitwise_deterministic_with_alibi(dev, case):
    (q, k, v, do), kw = alibi_bwd_inputs(case, torch.bfloat16, dev)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split", **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_alibi_gradients_run_the_kernels(dev):
    """A gradient through flash_attention with ALiBi (formerly refused) runs
    K1 and the fused kernel with ALiBi and matches the plain route; varlen
    with ALiBi and segment ids runs K1 with both and the backward with the
    ids; ALiBi with a cap still raises."""
    from flashattn_tpu_torch.ops.varlen import flash_attention_varlen

    leaves = [randn((1, h, 400, 128), torch.bfloat16, dev, 230 + i).requires_grad_()
              for i, h in enumerate((8, 2, 2))]
    do = randn((1, 8, 400, 128), torch.bfloat16, dev, 233)
    ids = segments([150, 37, 200], 400, dev)[0]
    for route in ("dense", "varlen"):
        before = launch_counters.read()
        if route == "dense":
            o = flash_attention(*leaves, is_causal=True, alibi=True, window=100)
            seg = None
        else:
            o = flash_attention_varlen(*leaves, segment_ids=ids, is_causal=True, alibi=True)
            seg = (ids, torch.where(ids < 0, -2, ids).to(torch.int32))
        got = torch.autograd.grad(o, leaves, do)
        added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
        extra = ("window" if route == "dense" else "segments")
        want = {n: 1 for n in ("flash_fwd", "flash_fwd_alibi", f"flash_fwd_{extra}",
                               "flash_bwd_fused", "flash_bwd_fused_alibi",
                               f"flash_bwd_fused_{extra}")}
        if route == "varlen":
            want["flash_fwd_alibi_segments"] = 1
        assert added == want, added
        o_ref = plain_flash_attention(*leaves, is_causal=True, alibi=True,
                                      window=100 if route == "dense" else None, segment_ids=seg)
        want_grads = torch.autograd.grad(o_ref, leaves, do)
        assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
        assert_grads_match(want_grads, got, torch.bfloat16)
    with pytest.raises(ValueError, match="pick one"):
        flash_attention(*leaves, is_causal=True, alibi=True, logit_softcap=30.0)


@pytest.mark.parametrize("packed", [False, True])
def test_tiny_alibi_model_trains_on_card_like_cpu(dev, packed):
    """A float32 ALiBi model (RoPE off; D 64, GQA 8/2): loss_fn and its
    gradients, unpacked and on a packed row, through K1 and the backward
    kernels with ALiBi, split and fused, against the plain versions on the
    CPU; loss within 1e-4, gradients atol 1e-3, rtol 1e-3 (float32 kernels:
    exp2 against exp and sums in another order, through 2 layers)."""
    cfg = ModelConfig(**dict(SMALL, use_alibi=True, dtype=torch.float32, num_layers=2))
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(12), device="cpu")
    card = llama.Llama(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (1, 97),
                           generator=torch.Generator().manual_seed(13))
    ids = None
    if packed:
        ids = torch.full((1, 97), -1, dtype=torch.int32)
        ids[0, :40], ids[0, 40:90] = 0, 1
    cpu.zero_grad()
    want = llama.loss_fn(cpu, tokens, segment_ids=ids)
    want.backward()
    for impl in ("fused", "split"):
        card.zero_grad()
        before = launch_counters.read()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(flash_bwd.IMPL_ENV, impl)
            got = llama.loss_fn(card, tokens.to(dev),
                                segment_ids=None if ids is None else ids.to(dev))
            got.backward()
        added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
        kernels = ["flash_bwd_fused"] if impl == "fused" else ["flash_bwd_dq", "flash_bwd_dkv"]
        assert all(added[f"{k}_alibi"] == cfg.num_layers for k in ["flash_fwd", *kernels])
        assert added.get("flash_fwd_alibi_segments", 0) == cfg.num_layers * packed
        assert abs(float(got) - float(want)) <= 1e-4
        for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
            rep = verify_results(q.grad, p.grad.cpu(), atol=1e-3, rtol=1e-3)
            assert rep.passed, f"{impl} grad {name}: {rep}"


# ---- Attention dropout in K1, B3, B4 and B5 ----

DROP_READ_CASES = {
    # name: (dtype, B, Hq, Hkv, S_q, S_k, D, rate, seed)
    "bf16_d64": (torch.bfloat16, 2, 8, 2, 128, 384, 64, 0.1, -7),
    "bf16_d128": (torch.bfloat16, 1, 8, 2, 128, 384, 128, 0.5, 0),
    "bf16_d256": (torch.bfloat16, 1, 4, 2, 256, 512, 256, 0.1, 2**31 - 1),
    "f32_d64": (torch.float32, 1, 8, 2, 128, 256, 64, 0.5, 2**31 - 1),
    "f32_d128": (torch.float32, 2, 4, 4, 128, 256, 128, 0.1, 0),
    "f32_d256": (torch.float32, 1, 4, 1, 256, 256, 256, 0.5, -7),
}


@pytest.mark.parametrize("kernel", ["k1", "b3", "b4", "b5"])
@pytest.mark.parametrize("case", sorted(DROP_READ_CASES))
def test_dropout_mask_reads_out_bit_for_bit(dev, case, kernel):
    """Each kernel's keep mask, read out of its outputs
    (utils/dropout_readout.py: q = 0, one-hot V, dO or K), equals the plain
    dropout_keep_mask at every element: GQA, several kv tiles, both dtypes,
    D 64, 128 and 256, rates 0.1 and 0.5, seeds -7, 0 and 2^31 - 1."""
    from flashattn_tpu_torch.utils import dropout_readout as readout

    dtype, b, hq, hkv, s_q, s_k, d, rate, seed = DROP_READ_CASES[case]
    args = (b, hq, hkv, s_q, s_k, d, dtype, rate, seed, dev)
    got = {"k1": lambda: readout.forward_mask(*args), "b4": lambda: readout.dq_mask(*args),
           "b3": lambda: readout.dv_mask(*args, impl="fused"),
           "b5": lambda: readout.dv_mask(*args, impl="split")}[kernel]()
    want = readout.plain_mask(b, hq, s_q, s_k, rate, seed, dev)
    assert int((got != want).sum()) == 0
    assert abs(float(want.float().mean()) - (1 - rate)) < 0.02


DROP_CASES = {
    # name: (Hq, Hkv, S_q, S_k, D, causal, window, documents, pos_offset, cap, alibi)
    "d64_causal_gqa": (8, 2, 700, 700, 64, True, None, None, None, None, False),
    "d64_noncausal": (4, 4, 300, 515, 64, False, None, None, None, None, False),
    "d64_window65_segments": (8, 2, 700, 700, 64, True, 65, [300, 37, 250], None, None, False),
    "d64_no_key_rows": (4, 2, 256, 256, 64, True, None, None, -70, None, False),
    "d128_sq_below_sk_offset": (8, 2, 300, 700, 128, True, None, None, 500, None, False),
    "d128_softcap30": (8, 2, 515, 515, 128, True, None, None, None, 30.0, False),
    "d128_alibi_segments": (8, 2, 700, 700, 128, True, None, [300, 37, 250], None, None, True),
    "d256_cap50_window129": (4, 2, 700, 700, 256, True, 129, None, None, 50.0, False),
    "d256_alibi_window": (4, 2, 400, 400, 256, True, 100, None, None, None, True),
}


def dropout_inputs(case, dtype, dev, rate=0.2, seed=1234):
    """(q, k, v, do) and the call's options, dropout among them."""
    hq, hkv, s_q, s_k, d, causal, w, docs, off, cap, alibi = DROP_CASES[case]
    q = randn((1, hq, s_q, d), dtype, dev, 241)
    do = randn((1, hq, s_q, d), dtype, dev, 242)
    k, v = (randn((1, hkv, s_k, d), dtype, dev, seed_) for seed_ in (243, 244))
    seg = segments(docs, s_q, dev) if docs is not None else None
    return (q, k, v, do), dict(is_causal=causal, window=w, segment_ids=seg, pos_offset=off,
                               logit_softcap=cap, alibi=alibi, dropout_rate=rate,
                               dropout_seed=seed)


def dropout_launches():
    c = launch_counters.read()
    return {n: c[n] for n in ("flash_fwd_dropout", "flash_bwd_fused_dropout",
                              "flash_bwd_dq_dropout", "flash_bwd_dkv_dropout")}


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(DROP_CASES))
def test_dropout_kernels_match_plain(dev, impl, dtype, case):
    """K1 with dropout (with the LSE), then B3 (fused) or B4 + B5 (split)
    with dropout against their plain versions on the same mask, beside every
    option: GQA, non-causal, a window, segment ids, rows that see no key,
    S_q != S_k with a pos_offset, the soft-cap, ALiBi, D 64, 128 and 256;
    the LSE is that without dropout; the dropout launches counted."""
    (q, k, v, do), kw = dropout_inputs(case, dtype, dev)
    before = dropout_launches()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    clean = dict(kw, dropout_rate=0.0)
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    assert torch.equal(lse, flash_fwd.flash_attention_forward(q, k, v, **clean)[1])
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl, **kw)
    torch.cuda.synchronize()
    added = {n: c - before[n] for n, c in dropout_launches().items()}
    assert added == {"flash_fwd_dropout": 1, "flash_bwd_fused_dropout": int(impl == "fused"),
                     "flash_bwd_dq_dropout": int(impl == "split"),
                     "flash_bwd_dkv_dropout": int(impl == "split")}
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, **kw)
    assert_grads_match(ref, out, dtype)
    assert not bool(out[0][torch.isneginf(lse)].any())


def test_dropout_rate_zero_and_seeds(dev):
    """Rate 0 gives the bits of the call without dropout (forward and both
    backward paths) and launches no dropout kernel; the same seed gives
    the same bits (an int seed and a seed tensor on the card alike, O and
    the split gradients); another seed another O."""
    (q, k, v, do), kw = dropout_inputs("d64_causal_gqa", torch.bfloat16, dev)
    clean = dict(kw, dropout_rate=0.0, dropout_seed=None)
    before = dropout_launches()
    o0, lse0 = flash_fwd.flash_attention_forward(q, k, v, **clean)
    o1, lse1 = flash_fwd.flash_attention_forward(q, k, v, **dict(kw, dropout_rate=0.0))
    assert torch.equal(o0, o1) and torch.equal(lse0, lse1)
    for impl in ("fused", "split"):
        g0 = flash_bwd.flash_attention_backward(q, k, v, o0, do, lse0, impl=impl, **clean)
        g1 = flash_bwd.flash_attention_backward(q, k, v, o0, do, lse0, impl=impl,
                                                **dict(kw, dropout_rate=0.0))
        # the fused dQ adds by atomics in a changing order: the split path is the bitwise one
        assert all(torch.equal(a, b) for a, b in zip(g0[int(impl == "fused"):],
                                                     g1[int(impl == "fused"):]))
    assert dropout_launches() == before
    seed_t = torch.tensor(kw["dropout_seed"], dtype=torch.int32, device=dev)
    outs = [flash_fwd.flash_attention_forward(q, k, v, **dict(kw, dropout_seed=s))
            for s in (kw["dropout_seed"], kw["dropout_seed"], seed_t)]
    assert all(torch.equal(outs[0][0], o[0]) for o in outs[1:])
    o, lse = outs[0]
    grads = [flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split",
                                                **dict(kw, dropout_seed=s))
             for s in (kw["dropout_seed"], seed_t)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    other = flash_fwd.flash_attention_forward(q, k, v, **dict(kw, dropout_seed=7))[0]
    assert not torch.equal(other, o)


def test_dropout_call_captures_with_either_seed(dev):
    """K1 with dropout captured in a CUDA graph (launches.capture): with an
    int seed (written on the card by a fill kernel inside the graph) each
    replay gives the eager call's bits; with a seed tensor on the card each
    replay reads it anew, so a new value there gives that seed's bits."""
    (q, k, v, _), kw = dropout_inputs("d64_causal_gqa", torch.bfloat16, dev)
    kw.pop("dropout_seed")
    eager = {s: flash_fwd.flash_attention_forward(q, k, v, dropout_seed=s, **kw)[0]
             for s in (11, 12)}
    seed_t = torch.tensor(11, dtype=torch.int32, device=dev)
    for seed in (11, seed_t):
        graph, (o, _), counted = launch_counters.capture(
            lambda: flash_fwd.flash_attention_forward(q, k, v, dropout_seed=seed, **kw))
        assert counted == {"flash_fwd": 1, "flash_fwd_dropout": 1}
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o, eager[11])
        if isinstance(seed, torch.Tensor):
            seed.fill_(12)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(o, eager[12])


def test_dropout_gradients_run_the_kernels(dev):
    """A gradient through flash_attention with dropout runs K1 and the
    fused kernel with dropout, the backward rebuilding the forward's mask
    from the seed (a seed tensor on the card, never read on the host), and
    matches the plain route on the same mask."""
    leaves = [randn((1, h, 400, 128), torch.bfloat16, dev, 250 + i).requires_grad_()
              for i, h in enumerate((8, 2, 2))]
    do = randn((1, 8, 400, 128), torch.bfloat16, dev, 253)
    seed = torch.tensor(-5, dtype=torch.int32, device=dev)
    before = launch_counters.read()
    o = flash_attention(*leaves, is_causal=True, dropout_rate=0.3, dropout_seed=seed)
    got = torch.autograd.grad(o, leaves, do)
    added = {n: c - before[n] for n, c in launch_counters.read().items() if c != before[n]}
    assert added == {n: 1 for n in ("flash_fwd", "flash_fwd_dropout", "flash_bwd_fused",
                                    "flash_bwd_fused_dropout")}, added
    o_ref = plain_flash_attention(*leaves, is_causal=True, dropout_rate=0.3, dropout_seed=-5)
    want = torch.autograd.grad(o_ref, leaves, do)
    assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
    assert_grads_match(want, got, torch.bfloat16)


def test_libraries_without_dropout_hold_no_dropout_kernel(dev):
    """The kernels without dropout still build from their own libraries
    (flash_fwd, flash_bwd, flash_bwd_alibi, flash_bwd_fused,
    flash_bwd_fused_alibi: each kernel's dropout flag false), and the
    dropout libraries hold the dropout instantiations alone, every kind of
    the others: the ptxas report's entry functions. The libraries of the
    offset read on the card (flash_fwd_dynoff, flash_bwd_dynoff,
    flash_bwd_fused_dynoff) hold its instantiations alone (their kDyn flag
    true, dropout's false), those of the offset with dropout
    (flash_fwd_dynoff_dropout, ...) both flags true, and no other library
    holds one."""
    from flashattn_tpu_torch.ops import _build
    from flashattn_tpu_torch.utils import sass

    def flags(lib):
        """{dropout flag + 2 x offset flag: kernel names} of the library's
        kernels, from each kernel's name and template arguments (K1's bf16
        kernel: dropout the 7th; its kernel of the offset read on the
        card, `flash_fwd_dyn_wgmma_kernel`: dropout the 7th; the backward's
        bf16 kernels: dropout the 5th, the offset the 6th; the float32
        kernels: dropout the next to last, the offset the last), the delta
        pre-pass left out."""
        _build.load(lib)
        log = _build.library_path(lib).with_suffix(".log").read_text()
        got = {}
        for name in re.findall(r"Compiling entry function '([^']+)'", log):
            label = sass.kernel_label(name)
            if "<" not in label or "delta" in label:
                continue
            kernel, args = label[:label.index("<")], label[label.index("<") + 1:-1].split(", ")
            if kernel == "flash_fwd_wgmma_kernel":
                drop, dyn = args[6], "false"
            elif kernel == "flash_fwd_dyn_wgmma_kernel":
                drop, dyn = args[6], "true"
            elif kernel.endswith("mma_kernel"):
                drop, dyn = args[4], args[5]
            else:
                drop, dyn = args[-2], args[-1]
            got.setdefault((drop == "true") + 2 * (dyn == "true"), []).append(kernel)
        return got

    for lib, n in (("flash_fwd", 39), ("flash_bwd", 42), ("flash_bwd_alibi", 24),
                   ("flash_bwd_fused", 21), ("flash_bwd_fused_alibi", 12)):
        got = flags(lib)
        assert set(got) == {0} and len(got[0]) == n, (lib, got)
    for lib, n in (("flash_fwd_dropout", 39), ("flash_bwd_dropout", 60),
                   ("flash_bwd_fused_dropout", 30)):
        got = flags(lib)
        assert set(got) == {1} and len(got[1]) == n, (lib, got)
    # K1: 3 D x (window, ALiBi, both, the window with the cap) x (segment ids
    # or not), and the float32 kernel at 3 D; the backward's: 3 D x 7 kinds
    # (ALiBi's 3 masks, the window or segment ids with and without the cap;
    # flash_bwd_split.cuh launch_dq) a kernel and the float32 kernel's 3 D
    for drop, flag in (("", 2), ("_dropout", 3)):
        for lib, n in (("flash_fwd_dynoff", 27), ("flash_bwd_dynoff", 48),
                       ("flash_bwd_fused_dynoff", 24)):
            got = flags(lib + drop)
            assert set(got) == {flag} and len(got[flag]) == n, (lib + drop, got)


# ---- dyn_pos_offset: the q/k alignment read on the card (the zigzag ring's) ----

DYN_CASES = {
    # name: (Hq, Hkv, S_q, S_k, D, offset, window, alibi, documents)
    "d64_window": (4, 2, 256, 256, 64, 768, 600, False, None),
    "d64_alibi": (4, 2, 256, 300, 64, 768, None, True, None),
    "d64_window_alibi_segments": (4, 1, 256, 256, 64, 300, 200, True, ((100, 130), (60, 170))),
    "d128_window_alibi": (8, 2, 384, 384, 128, 1152, 1000, True, None),
    "d128_window_segments": (4, 2, 300, 300, 128, 200, 250, False, ((150, 120), (100, 180))),
    "d128_alibi_segments": (4, 4, 256, 256, 128, 512, None, True, ((200,), (256,))),
    # rows r >= 136 see no key: their window's left edge r + 120 is past S_k
    "d128_window_past_keys": (4, 2, 256, 256, 128, 319, 200, False, None),
}


def dyn_inputs(case, dev, seed=90, cases=None):
    """(q, k, v, dO), the offset and the options of a case of DYN_CASES, or
    of DYN_VARIANT_CASES (`cases`: its dtype first, its other options last)."""
    if cases is None:
        dtype, (hq, hkv, s_q, s_k, d, off, window, alibi, docs), more = \
            torch.bfloat16, DYN_CASES[case], {}
    else:
        dtype, hq, hkv, s_q, s_k, d, off, window, alibi, docs, more = cases[case]
    q, do = (randn((1, hq, s_q, d), dtype, dev, seed + i) for i in (0, 3))
    k, v = (randn((1, hkv, s_k, d), dtype, dev, seed + i) for i in (1, 2))
    segs = None
    if docs is not None:
        from flashattn_tpu_torch.ops.varlen import canonical_segments
        ids = []
        for lens, total in zip(docs, (s_q, s_k)):
            row = torch.full((1, total), -1, dtype=torch.int32)
            at = 0
            for i, n in enumerate(lens):
                row[0, at:at + n] = i
                at += n
            ids.append(row.to(dev))
        segs = canonical_segments(*ids, dev)
    return (q, k, v, do), off, dict(window=window, alibi=alibi, segment_ids=segs, **more)


def dyn_launches() -> dict[str, int]:
    c = launch_counters.read()
    return {n: c[n] for n in ("flash_fwd_dynoff", "flash_bwd_fused_dynoff",
                              "flash_bwd_dq_dynoff", "flash_bwd_dkv_dynoff")}


@pytest.mark.parametrize("offset_type", ["int", "card"])
@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", sorted(DYN_CASES))
def test_dyn_offset_kernels_match_plain(dev, case, impl, offset_type):
    """K1, then B3 (fused) or B4 + B5 (split) with the offset read on the
    card, against their plain versions: the window's left edge, ALiBi,
    both, segment ids with padding, GQA, D 64 and 128, an offset given as an
    int and as an int32 tensor on the card, rows whose window lies past
    every key (O = 0, LSE = -inf, dQ = 0); every launch a dyn launch."""
    (q, k, v, do), off, kw = dyn_inputs(case, dev)
    dyn = off if offset_type == "int" else torch.tensor([off], dtype=torch.int32, device=dev)
    before = dyn_launches()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=dyn, **kw)
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl=impl,
                                             dyn_pos_offset=dyn, **kw)
    torch.cuda.synchronize()
    added = {n: c - before[n] for n, c in dyn_launches().items()}
    assert added == {"flash_fwd_dynoff": 1, "flash_bwd_fused_dynoff": int(impl == "fused"),
                     "flash_bwd_dq_dynoff": int(impl == "split"),
                     "flash_bwd_dkv_dynoff": int(impl == "split")}
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, False,
                                                                 dyn_pos_offset=off, **kw)
    assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, False,
                                                       dyn_pos_offset=off, **kw)
    assert_grads_match(ref, out, torch.bfloat16)
    dead = torch.isneginf(lse)
    assert torch.equal(dead, torch.isneginf(lse_ref))
    assert not bool(o[dead].any()) and not bool(out[0][dead].any())
    if case.endswith("past_keys"):
        assert bool(dead[:, :, 136:].all()) and not bool(dead[:, :, :136].any())


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", ["d64_window_alibi_segments", "d128_window_alibi"])
def test_dyn_offset_equals_causal_static_offset(dev, case, impl):
    """The second oracle: with every pair causally visible (offset >= S_k,
    as on the zigzag's always-visible pair) the kernels with the offset on
    the card equal the causal kernels with pos_offset = offset, forward and
    gradients, within the bf16 gates (another kernel's walk)."""
    (q, k, v, do), off, kw = dyn_inputs(case, dev)
    off = max(off, k.shape[2])
    o_d, lse_d = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=off, **kw)
    o_c, lse_c = flash_fwd.flash_attention_forward(q, k, v, True, pos_offset=off, **kw)
    assert verify_results(o_c, o_d, **TOL[torch.bfloat16]).passed
    assert verify_results(lse_c, lse_d, atol=1e-3).passed
    g_d = flash_bwd.flash_attention_backward(q, k, v, o_d, do, lse_d, False, impl=impl,
                                             dyn_pos_offset=off, **kw)
    g_c = flash_bwd.flash_attention_backward(q, k, v, o_c, do, lse_c, True, impl=impl,
                                             pos_offset=off, **kw)
    assert_grads_match(g_c, g_d, torch.bfloat16)


def test_dyn_offset_split_is_bitwise_deterministic(dev):
    (q, k, v, do), off, kw = dyn_inputs("d128_window_alibi", dev)
    seed = torch.tensor([off], dtype=torch.int32, device=dev)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=seed, **kw)
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl="split",
                                               dyn_pos_offset=seed, **kw)
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl="split",
                                                dyn_pos_offset=seed, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


DYN_DROP = dict(dropout_rate=0.2, dropout_seed=1234)
DYN_VARIANT_CASES = {
    # name: (dtype, Hq, Hkv, S_q, S_k, D, offset, window, alibi, documents,
    # the call's other options): every option the JAX kernels take with the
    # offset, beside the window, ALiBi and segment ids
    "d256_window_softcap": (torch.bfloat16, 4, 2, 256, 320, 256, 300, 250, False, None,
                            dict(logit_softcap=30.0)),
    "d64_window_softcap_segments": (torch.bfloat16, 4, 1, 256, 256, 64, 300, 200, False,
                                    ((100, 130), (60, 170)), dict(logit_softcap=30.0)),
    # rows r >= 136 see no key: their window's left edge r + 120 is past S_k
    "d128_window_softcap_past_keys": (torch.bfloat16, 4, 2, 256, 256, 128, 319, 200, False,
                                      None, dict(logit_softcap=50.0)),
    "d128_window_dropout": (torch.bfloat16, 8, 2, 384, 384, 128, 1152, 1000, False, None,
                            DYN_DROP),
    "d64_alibi_segments_dropout": (torch.bfloat16, 4, 1, 256, 256, 64, 300, None, True,
                                   ((100, 130), (60, 170)), DYN_DROP),
    "d256_window_alibi_dropout": (torch.bfloat16, 4, 2, 256, 256, 256, 300, 200, True, None,
                                  DYN_DROP),
    "d256_window_softcap_dropout": (torch.bfloat16, 4, 2, 256, 256, 256, 300, 250, False, None,
                                    dict(logit_softcap=30.0, **DYN_DROP)),
    "f32_d64_window": (torch.float32, 4, 2, 256, 256, 64, 768, 600, False, None, {}),
    "f32_d128_alibi_segments": (torch.float32, 4, 4, 256, 256, 128, 512, None, True,
                                ((200,), (256,)), {}),
    "f32_d256_window_softcap": (torch.float32, 4, 2, 256, 256, 256, 300, 250, False, None,
                                dict(logit_softcap=30.0)),
    "f32_d64_window_alibi_dropout": (torch.float32, 4, 2, 256, 256, 64, 300, 200, True, None,
                                     DYN_DROP),
}


@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("case", sorted(DYN_VARIANT_CASES))
def test_dyn_offset_variants_match_plain(dev, case, impl):
    """K1, then B3 (fused) or B4 + B5 (split) with the offset read on the
    card and the soft-cap, dropout, D 256 or float32, against their plain
    versions (the same keep mask) under the dtype's gates: each launch a
    launch of the card-offset kernels (and of dropout's with dropout);
    rows whose window lies past every key get O = 0, LSE = -inf, dQ = 0."""
    (q, k, v, do), off, kw = dyn_inputs(case, dev, cases=DYN_VARIANT_CASES)
    dtype = q.dtype
    dyn = torch.tensor([off], dtype=torch.int32, device=dev)
    before = launch_counters.read()
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=dyn, **kw)
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl=impl,
                                             dyn_pos_offset=dyn, **kw)
    torch.cuda.synchronize()
    after = launch_counters.read()
    added = {n: after[n] - before[n] for n in dyn_launches()}
    assert added == {"flash_fwd_dynoff": 1, "flash_bwd_fused_dynoff": int(impl == "fused"),
                     "flash_bwd_dq_dynoff": int(impl == "split"),
                     "flash_bwd_dkv_dynoff": int(impl == "split")}
    rate = kw.get("dropout_rate", 0.0)
    assert after["flash_fwd_dropout"] - before["flash_fwd_dropout"] == int(rate > 0)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, False,
                                                                 dyn_pos_offset=off, **kw)
    assert verify_results(o_ref, o, **TOL[dtype]).passed
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, False,
                                                       dyn_pos_offset=off, **kw)
    assert_grads_match(ref, out, dtype)
    dead = torch.isneginf(lse)
    assert torch.equal(dead, torch.isneginf(lse_ref))
    assert not bool(o[dead].any()) and not bool(out[0][dead].any())
    if case.endswith("past_keys"):
        assert bool(dead[:, :, 136:].all()) and not bool(dead[:, :, :136].any())


DYN_READ_CASES = {
    # name: (dtype, D, rate, seed, options) at B 1, Hq 8, Hkv 2, S_q 128 (256
    # at D 256), S_k 512, the offset 1,000 on the card: a window whose edge
    # lies left of every key, ALiBi with slopes 1e-3 (no P underflows), both
    "bf16_d64_alibi": (torch.bfloat16, 64, 0.5, -7, "alibi"),
    "bf16_d128_window": (torch.bfloat16, 128, 0.1, 0, "window"),
    "bf16_d256_window_alibi": (torch.bfloat16, 256, 0.1, 2**31 - 1, "window, alibi"),
    "f32_d64_window_alibi": (torch.float32, 64, 0.5, 5, "window, alibi"),
}


@pytest.mark.parametrize("kernel", ["k1", "b3", "b4", "b5"])
@pytest.mark.parametrize("case", sorted(DYN_READ_CASES))
def test_dyn_offset_dropout_mask_reads_out_bit_for_bit(dev, case, kernel):
    """Each card-offset kernel's keep mask with dropout, read out of its
    outputs (utils/dropout_readout.py), equals the plain dropout_keep_mask
    at every element: the mask hashes the arrays' rows and columns whatever
    the offset, as the JAX kernels' does."""
    from flashattn_tpu_torch.utils import dropout_readout as readout

    dtype, d, rate, seed, what = DYN_READ_CASES[case]
    b, hq, hkv, s_k, off = 1, 8, 2, 512, 1000
    s_q = 256 if d == 256 else 128
    opts = dict(dyn_pos_offset=torch.tensor([off], dtype=torch.int32, device=dev))
    if "window" in what:
        opts["window"] = off + s_q
    if "alibi" in what:
        opts.update(alibi=True, alibi_slopes=torch.full((hq,), 1e-3, device=dev))
    args = (b, hq, hkv, s_q, s_k, d, dtype, rate, seed, dev)
    before = dyn_launches()
    got = {"k1": lambda: readout.forward_mask(*args, **opts),
           "b4": lambda: readout.dq_mask(*args, **opts),
           "b3": lambda: readout.dv_mask(*args, impl="fused", **opts),
           "b5": lambda: readout.dv_mask(*args, impl="split", **opts)}[kernel]()
    row = {"k1": "flash_fwd_dynoff", "b3": "flash_bwd_fused_dynoff",
           "b4": "flash_bwd_dq_dynoff", "b5": "flash_bwd_dkv_dynoff"}[kernel]
    assert dyn_launches()[row] > before[row]
    want = readout.plain_mask(b, hq, s_q, s_k, rate, seed, dev)
    assert int((got != want).sum()) == 0


# ---- head dims 32, 80 and 96: the true head dim at run time in the 64 and
# 128 tiles (csrc/common.cuh head_tile) ----

HEAD_DIMS_NEW = [32, 80, 96]
HD_OPTIONS = {
    "causal_gqa": (True, {}),
    "noncausal": (False, {}),
    "window": (True, dict(window=65)),
    "alibi": (True, dict(alibi=True)),
    "softcap": (True, dict(logit_softcap=30.0)),
    "dropout": (True, dict(dropout_rate=0.1, dropout_seed=5)),
    "card_offset": (False, dict(dyn_pos_offset=150, window=100)),
}


def hd_inputs(d, dtype, dev, s_q=200, s_k=260):
    return [randn(shape, dtype, dev, 200 + i) for i, shape in
            enumerate([(2, 8, s_q, d), (2, 2, s_k, d), (2, 2, s_k, d), (2, 8, s_q, d)])]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS_NEW)
def test_head_dim_forward_matches_plain(dev, d, dtype):
    """K1 at D 32, 80 and 96, causal over S_q < S_k, GQA 4, ragged: O's
    rows are d wide and end where the plain version's do."""
    q, k, v, _ = hd_inputs(d, dtype, dev)
    before = flash_fwd.LAUNCHES
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_fwd.LAUNCHES == before + 1 and o.shape == q.shape
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, True)
    rep = verify_results(o_ref, o, **TOL[dtype])
    assert rep.passed, f"O: {rep}"
    assert verify_results(lse_ref, lse, atol=1e-3).passed


@pytest.mark.parametrize("option", sorted(HD_OPTIONS))
@pytest.mark.parametrize("d", HEAD_DIMS_NEW)
def test_head_dim_options_forward_and_backward(dev, d, option):
    """Every option of the tiles at the new head dims (bf16): K1, then the
    fused and the split backward, against the plain versions."""
    causal, kw = HD_OPTIONS[option]
    q, k, v, do = hd_inputs(d, torch.bfloat16, dev)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, causal, **kw)
    o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal, **kw)
    assert verify_results(o_ref, o, **TOL[torch.bfloat16]).passed
    assert verify_results(lse_ref, lse, atol=1e-3).passed
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, causal, **kw)
    for impl in ("fused", "split"):
        out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, causal, impl=impl, **kw)
        assert_grads_match(ref, out, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("impl", ["fused", "split"])
@pytest.mark.parametrize("d", HEAD_DIMS_NEW)
def test_head_dim_backward_matches_plain(dev, d, impl, dtype):
    q, k, v, do = hd_inputs(d, dtype, dev, s_q=300, s_k=300)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    before = launches()
    out = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, impl=impl)
    torch.cuda.synchronize()
    after = launches()
    assert after != before
    ref = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, True)
    assert_grads_match(ref, out, dtype)


@pytest.mark.parametrize("d", HEAD_DIMS_NEW)
def test_head_dim_split_is_bitwise_deterministic(dev, d):
    q, k, v, do = hd_inputs(d, torch.bfloat16, dev, s_q=500, s_k=500)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True)
    first = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, impl="split")
    second = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, impl="split")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("d", HEAD_DIMS_NEW)
def test_head_dim_decode_matches_plain(dev, d, mode):
    """K2 at D 32, 80 and 96 on every cache mode, T 1 and 5, lengths 0 to
    Smax with NaN past each; the paged K2 on 64-position pages equal to the
    dense K2 bit for bit."""
    quant = mode if mode in ("int8", "fp8") else None
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    lengths, s_max, hkv = [0, 1, 130, 256], 256, 2
    b = len(lengths)
    cache = kvcache.init_cache(b, hkv, s_max, d, dtype=dtype, quant=quant, device=dev)
    kvcache.update_cache(cache, randn((b, hkv, s_max, d), dtype, dev, 30),
                         randn((b, hkv, s_max, d), dtype, dev, 31), assume_fits=True)
    cache.length.copy_(torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        if quant is None:
            cache.k[i, :, n:] = float("nan")
            cache.v[i, :, n:] = float("nan")
        else:
            cache.k_scale[i, :, :, n:] = float("nan")
            cache.v_scale[i, :, :, n:] = float("nan")
    tol = TOL[dtype] if quant is None else dict(rtol=2e-2, atol=2e-2)
    for t in (1, 5):
        q = randn((b, 8, t, d), dtype, dev, 32 + t)
        o = decode.decode_attention_chunk(q, cache)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(o).all()) and not bool(o[0].any())
        ref = decode.decode_attention_reference(q, cache, requant_block=decode.BLOCK_KV)
        rep = verify_results(ref, o, **tol)
        assert rep.passed, f"T={t}: {rep}"
        if mode in ("bf16", "int8"):
            pool = paged.init_paged_cache(b, hkv, b * 4 + 1, 64, d, 4, dtype=dtype,
                                          quant=quant, device=dev)
            for i, n in enumerate(lengths):
                table = [i * 4 + j + 1 for j in range(4)][::-1]
                row = kvcache.KVCache(k=cache.k[i:i + 1], v=cache.v[i:i + 1],
                                      length=cache.length[i:i + 1],
                                      k_scale=None if quant is None else cache.k_scale[i:i + 1],
                                      v_scale=None if quant is None else cache.v_scale[i:i + 1])
                paged.write_pages(pool, row, table)
                paged.set_block_table(pool, i, table, n)
            assert torch.equal(paged.paged_decode_attention_chunk(q, pool), o)


def test_head_dim_32_model_on_card_matches_cpu(dev):
    """A float32 model at D 32 (the quality gate's config): prefill and
    decode steps through K1 and K2 on the card against the plain path on
    the CPU, same weights and tokens."""
    cfg = ModelConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128,
                      dtype=torch.float32)
    cpu_model = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_model = llama.Llama(cfg, dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(1))
    outs = []
    for model, d in ((cpu_model, "cpu"), (gpu_model, dev)):
        for quant in (None, "int8", "fp8"):
            caches = generate.init_caches(model, 2, 128, quant=quant)
            logits, caches = generate.prefill(model, prompt.to(d), caches)
            steps = [logits.cpu()]
            for i in range(3):
                token = torch.tensor([i + 1, i + 2], dtype=torch.int32, device=d)
                pos = torch.full((2,), 37 + i, dtype=torch.int32, device=d)
                logits, caches = generate.decode_step(model, token, pos, caches)
                steps.append(logits.cpu())
            outs.append(steps)
    for mode, (ref_steps, out_steps) in enumerate(zip(outs[:3], outs[3:])):
        for i, (ref, out) in enumerate(zip(ref_steps, out_steps)):
            if mode == 0:  # the float32 cache
                rep = verify_results(ref, out, atol=1e-3, rtol=1e-3)
                assert rep.passed, f"step {i}: {rep}"
                continue
            # int8 and fp8: chip_smoke.py's logits rule (the card requantizes
            # int8 P per 64-position tile, the CPU's plain version per block)
            cos = float(torch.nn.functional.cosine_similarity(ref.flatten(), out.flatten(), dim=0))
            delta = float((out - ref).abs().max())
            assert cos > 0.999 and delta <= 0.05 * float(ref.abs().max()), (mode, i, cos, delta)
