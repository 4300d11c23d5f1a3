#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA libraries from csrc/ (into build/flashattn_tpu_torch/,
one nvcc each, all at once) and runs nine phases, printing one line per
check:

1. environment: torch/CUDA versions, the card's name and power limit, the
   kernels' build time and their compiler report (no spills in the
   tensor-core kernels and the split-K kernel, no wgmma serialized), and
   the tensor-core instructions (HMMA/HGMMA/IMMA) in the SASS of each
   tensor-core kernel, which must be there for K1's bf16 kernel (HGMMA, at
   D 64 and D 128), the bf16 fused, dQ and dK/dV kernels, qmm8's and qmm4's M > 16 kernels and every instantiation of
   K2's;
2. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes and at their edges (K1 also at every
   backward case, where it makes the backward's O and LSE, and timed at the
   prefill, training and D 128 shapes; at D 128, B 4, S 16384 held against
   its plain version on three slices of 256 q rows, two calls bitwise equal,
   and timed with the plain version left out; SDPA's forward kernels at the
   three shapes named by one profiler session; K2 on int8 and
   fp8 caches at T 1 and T 256; the paged K2 against the dense K2, bit for
   bit; qmm8 and qmm4 at M 1 to 1024 on LLAMA_1B's five projection shapes,
   two calls bitwise equal), with the tolerance printed beside each
   result; kernel, plain version and the PyTorch library call (SDPA, on the
   dequantized bf16 cache for the quantized K2, with a length mask at T 1
   and a bottom-right causal mask for K2 int8 at T 256, or torch.matmul on
   the dequantized weight; timed only, never used by the port) timed on
   the card; each bound from utils/roofline.py;
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
9. the `kernels` JSON line: every kernel with its launches on the path that
   runs it, its error against its plain version, its time, bound, plain and
   library times.

Any failed check raises: the script then exits nonzero and does not print
its last line. It needs a CUDA device and never falls back to the CPU. The
JAX package is not imported.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from flashattn_tpu_torch.models import generate, llama, train
from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import (_build, decode, flash_bwd, flash_bwd_fused, flash_fwd,
                                     kvcache, paged, quant_matmul)
from flashattn_tpu_torch.ops import launches as launch_counters
from flashattn_tpu_torch.ops.attention import plain_flash_attention
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.utils import roofline
from flashattn_tpu_torch.utils.timing import cuda_time_ms
from flashattn_tpu_torch.utils.verify import verify_results

SEED = 0
LIBRARIES = ("flash_fwd", "decode", "flash_bwd", "flash_bwd_fused", "quant_matmul")
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[env] device {name} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all(LIBRARIES)
    for lib in LIBRARIES:
        _build.load(lib)
    print(f"[env] kernels built/loaded in {time.perf_counter() - t0:.2f} s "
          f"(compile s: {_build.BUILD_SECONDS})")
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
                kernel = kernel_label(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[env] ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
                if "spill" in line and ("mma_kernel" in kernel
                                        or kernel.startswith("qmm_splitk_kernel")):
                    check("0 bytes spill stores, 0 bytes spill loads" in line,
                          f"{kernel} spills: {line.strip()}")
    mma = {}
    for lib in ("flash_fwd", "flash_bwd", "flash_bwd_fused", "quant_matmul", "decode"):
        for kernel, n in tensor_core_instructions(lib).items():
            if "mma_kernel" in kernel:
                print(f"[env] SASS {kernel}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA, "
                      f"{n['IMMA']} IMMA")
                mma[kernel] = n
    families = {"flash_fwd_wgmma_kernel": 2, "flash_bwd": 6, "qmm_mma_kernel": 4,
                "decode_mma_kernel": 20}
    counted = {f: sum(k.startswith(f) for k in mma) for f in families}
    check(counted == families and all(sum(n.values()) for n in mma.values()),
          "K1's bf16 kernel (D 64 and D 128), the bf16 fused, dQ "
          "and dK/dV kernels (D 64 and 128), qmm8's and qmm4's M > 16 kernels (bf16 and "
          "float32 y) and every K2 tensor-core instantiation (bf16, int8 and fp8 caches, D 64 "
          f"and 128, both row layouts) must run on the tensor cores: {mma}")
    check(all(n["HGMMA"] for k, n in mma.items() if k.startswith("flash_fwd_wgmma_kernel")),
          f"K1's bf16 kernel must run on wgmma (HGMMA): {mma}")
    return name


def tensor_core_instructions(lib: str) -> dict[str, dict[str, int]]:
    """Tensor-core instructions (HMMA, HGMMA, IMMA) by kind in the SASS of
    each kernel of a built library (cuobjdump beside nvcc)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        entry = re.search(r"Function : (\S+)", line)
        if entry:
            kernel = kernel_label(entry.group(1))
            counts[kernel] = dict.fromkeys(("HMMA", "HGMMA", "IMMA"), 0)
        elif kernel is not None:
            op = re.search(r"\b(HMMA|HGMMA|IMMA)\.", line)
            if op:
                counts[kernel][op.group(1)] += 1
    return counts


def kernel_label(mangled: str) -> str:
    """'flash_fwd_mma_kernel<64>' from the mangled name of a kernel in csrc/:
    a name is its length then its characters (it may hold digits, and
    follow other digits, as in an anonymous namespace's), then its template
    arguments."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            name = mangled[run.end():run.end() + int(mangled[i:run.end()])]
            m = re.match(r"I(.*?)E+v", mangled[run.end() + len(name):])
            if name.endswith("_kernel") and m:
                break
        else:
            continue
        break
    else:
        return mangled
    types = {"13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8", "f": "float", "a": "int8"}
    args = []
    for t in re.finditer(r"13__nv_bfloat16|13__nv_fp8_e4m3|S\d*_|Li(\d+)|f|a", m.group(1)):
        # S_, S0_, ... repeat a type already named: the first, in these kernels
        args.append(t.group(1) or (args[0] if t.group(0).startswith("S") else types[t.group(0)]))
    return f"{name}<{', '.join(args)}>"


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
    try:
        flash_fwd.flash_attention_forward(
            *(torch.randn((1, 2, 64, 32), **bf16) for _ in range(3)))
    except ValueError as e:
        print(f"[kernels] K1 refuses D=32 on the card: {e}")
    else:
        raise AssertionError("K1 accepted D=32 on the card")

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
    backward, k1_bwd_err = backward_kernels(gen)
    sdpa_forward_kernels(gen)
    timed = {
        "flash_fwd": dict(max_abs_err=max(k1_err, k1_d128_err, k1_bwd_err), **k1_row),
        "decode": dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                       library_ms=k2_lib, **k2_bound),
    }
    timed.update(backward)
    timed.update(quantized_decode_kernels(gen))
    timed.update(paged_decode_kernel(gen))
    timed.update(quant_matmul_kernels(gen))
    return timed


# K1's three timed shapes (B, Hq, Hkv, S, D), all causal: the serving
# prefill, the LLAMA_1B training forward, and D 128 at 16k tokens.
K1_SHAPES = {"prefill": (1, 32, 4, 256, 64), "D=128 headline": (4, 8, 8, 16384, 128),
             "training shape": (4, 32, 4, 2048, 64)}


def sdpa_forward_kernels(gen: torch.Generator) -> None:
    """Names the kernels SDPA's forward runs at each of K1's timed shapes:
    one torch.profiler session over the three calls (a second session in
    one process may record no device event), device events in launch order;
    fails if a call shows no compute kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inputs = {tag: [randn((b, h, s, d), gen) for h in (hq, hkv, hkv)]
              for tag, (b, hq, hkv, s, d) in K1_SHAPES.items()}

    def run():
        for q, k, v in inputs.values():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
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


def quantized_cache(quant: str, gen: torch.Generator) -> KVCache:
    """The decode step's cache (B 4, Hkv 4, Smax 2048, D 64), filled with
    quantized random tokens, with NaN past every length (fp8 code 0x7f and
    NaN scales), as a recycled slot may hold."""
    shape = (DEC_B, DEC_HKV, DEC_SMAX, DEC_D)
    cache = kvcache.init_cache(DEC_B, DEC_HKV, DEC_SMAX, DEC_D, quant=quant)
    kvcache.update_cache(cache, randn(shape, gen), randn(shape, gen), assume_fits=True)
    cache.length.copy_(torch.tensor(DEC_LENGTHS, dtype=torch.int32))
    for i, n in enumerate(DEC_LENGTHS):
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
        cache = quantized_cache(quant, gen)
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
    for cache in (bf16_cache, quantized_cache("int8", gen)):
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
    return out


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


def time_backward(q, k, v, o, do, lse):
    """Device ms of the three backward kernels, their plain version and SDPA's
    backward (S_q = S_k, causal) at the training shape, with each bound."""
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
    time_k1("training shape", q, k, v, need_lse=True, few=few)
    return out


_ROUTED = {  # generation's kernel entry points -> their plain versions
    (generate, "flash_attention"): (
        lambda q, k, v, is_causal=False, scale=None:
        flash_fwd.flash_attention_forward_reference(q, k, v, is_causal, scale,
                                                    need_lse=False)[0]),
    (generate, "decode_attention"): (
        lambda q, cache, scale=None:
        decode.decode_attention_reference(q[:, :, None], cache, scale)[:, :, 0]),
    (generate, "decode_attention_chunk"): (
        lambda q, cache, scale=None: decode.decode_attention_reference(q, cache, scale)),
    (generate, "paged_decode_attention"): (
        lambda q, cache, scale=None:
        paged.paged_decode_reference(q[:, :, None], cache, scale)[:, :, 0]),
    (generate, "paged_decode_attention_chunk"): (
        lambda q, cache, scale=None: paged.paged_decode_reference(q, cache, scale)),
    (llama, "quant_matmul"): (
        lambda x, qw, out_dtype=None: quant_matmul.quant_matmul_reference(x, qw, out_dtype)),
}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls (attention and quantized projections)
    to their plain versions."""
    saved = {key: getattr(*key) for key in _ROUTED}
    for (module, name), fn in _ROUTED.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def compare_logits(tag: str, kern: list, plain: list, names: list | None = None) -> None:
    """The serving logits rule: cosine > LOGIT_COS and max |delta| <= LOGIT_REL * max |ref|."""
    names = names or ["prefill S=150"] + [f"decode {i}" for i in range(1, len(kern))]
    for step, (a, r, name) in enumerate(zip(kern, plain, names)):
        a, r = a.float().flatten(), r.float().flatten()
        check(bool(torch.isfinite(a).all()), f"{tag} {name}: non-finite logits")
        cos = float(torch.nn.functional.cosine_similarity(a, r, dim=0))
        delta = float((a - r).abs().max())
        lim = LOGIT_REL * float(r.abs().max())
        print(f"[model] LLAMA_1B {tag} {name}: cos {cos:.6f} (> {LOGIT_COS}), "
              f"max|d| {delta:.4f} (<= {lim:.4f}), argmax kernel "
              f"{int(a.argmax())} plain {int(r.argmax())}")
        check(cos > LOGIT_COS and delta <= lim, f"LLAMA_1B {tag} {name} logits disagree")


def generation_run(model, prompt, forced, quant=None) -> list[torch.Tensor]:
    """A 150-token prefill and 4 teacher-forced decode steps; their logits."""
    caches = generate.init_caches(model, 1, 2048, quant=quant)
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
    on a bf16 cache (K2 in every mode, the paged K2, qmm8 and qmm4): from
    equal caches, CAPTURE_STEPS steps with other tokens, positions and
    active rows each step. The logits and every cache byte must be equal
    (the same kernels on the same shapes); where they are not, the logits
    must pass phase 3's rule with equal argmax on the active rows, and the
    lengths must be equal."""
    cfg = model.cfg
    w4 = quantized_copy(model, 4)
    setups = [  # tag, model, KV quant, paged
        ("bf16 weights, bf16 KV", model, None, False),
        ("int8 weights, int8 KV", w8, "int8", False),
        ("bf16 weights, fp8 KV", model, "fp8", False),
        (f"int8 weights, int8 paged KV (pages of {PAGE})", w8, "int8", True),
        ("int4 weights, bf16 KV", w4, None, False),
    ]
    slots = len(CAPTURE_LENGTHS)
    for tag, m, quant, paged_kv in setups:
        eager = capture_caches(m, quant, paged_kv, gen)
        graph = generate.DecodeGraph(m, clone_caches(eager))
        lengths, bitwise = list(CAPTURE_LENGTHS), True
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
            bitwise = False
            compare_logits(f"captured vs eager, {tag}", [out[act]], [ref[act]],
                           [f"step {i}, active rows {active}"])
            check(torch.equal(out[act].argmax(-1), ref[act].argmax(-1)),
                  f"{tag} step {i}: argmax differs between the replay and the eager step")
        want = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        check(all(torch.equal(c.length, want) and torch.equal(g.length, want)
                  for c, g in zip(eager, graph.caches)), f"{tag}: lengths {lengths} not kept")
        print(f"[capture] LLAMA_1B {tag}, {slots} slots max_len 2048, lengths "
              f"{CAPTURE_LENGTHS} + {CAPTURE_STEPS} steps with changing active rows: captured "
              f"step {'bitwise equal to' if bitwise else 'within the logits rule of'} the "
              f"eager step (logits and every cache byte){'' if bitwise else ', NOT bitwise'}; "
              f"{graph.replays} replays, launches a replay {graph.launches}")
        del eager, graph
    del w4


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
    cos = {n: float(F.cosine_similarity(g_k[n].float().flatten(), g_p[n].float().flatten(),
                                        dim=0)) for n in g_k}
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


def main() -> None:
    t_start = time.perf_counter()
    name = phase_environment()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timed = phase_kernels(gen)
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
    launches["flash_bwd_fused"] = phase_train_step(model, gen)["flash_bwd_fused"]
    split = phase_trainer(model, gen)
    launches.update(flash_bwd_dq=split["flash_bwd_dq"], flash_bwd_dkv=split["flash_bwd_dkv"])
    decode_src = ("flashattn_tpu_torch/csrc/decode.cu", "flashattn_tpu/ops/decode.py:351")
    qmm_src = "flashattn_tpu_torch/csrc/quant_matmul.cu"
    sources = {
        "flash_fwd": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                      "flashattn_tpu/ops/flash_fwd.py:469"),
        "decode": decode_src,
        "decode_int8": decode_src,
        "decode_fp8": decode_src,
        "paged_decode": ("flashattn_tpu_torch/csrc/decode.cu",
                         "flashattn_tpu/ops/paged.py:378"),
        "qmm8": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:81"),
        "qmm4": (qmm_src, "flashattn_tpu/ops/quant_matmul.py:123"),
        "flash_bwd_fused": ("flashattn_tpu_torch/csrc/flash_bwd_fused.cu",
                            "flashattn_tpu/ops/flash_bwd_fused.py:336"),
        "flash_bwd_dq": ("flashattn_tpu_torch/csrc/flash_bwd.cu",
                         "flashattn_tpu/ops/flash_bwd.py:138"),
        "flash_bwd_dkv": ("flashattn_tpu_torch/csrc/flash_bwd.cu",
                          "flashattn_tpu/ops/flash_bwd.py:286"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **timed[k]}
        for k, (src, rep) in sources.items()
    ]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on its path: {[k['name'] for k in kernels if not k['launches']]}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
