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
the profiler helper and the roofline's card detection work on the card.

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
