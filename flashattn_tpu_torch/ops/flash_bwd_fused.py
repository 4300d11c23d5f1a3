"""Fused one-pass flash-attention backward (counterpart of
flashattn_tpu/ops/flash_bwd_fused.py), and the operand checks and launch
arguments that every backward kernel shares.

``flash_attention_backward_fused`` launches B3's port (csrc/flash_bwd_fused.cu)
on CUDA operands that ``flash_attention_backward`` (ops/flash_bwd.py) has
checked; that function dispatches here for impl="fused" and "auto", and
takes CPU tensors to the plain version. The launch is a delta pre-pass, then
one kernel per (kv tile, kv head, batch) that computes S, P, dP and dS once
per tile pair, keeps dK and dV in registers and adds dQ, scale applied,
with fp32 atomics into a zeroed buffer that one cast turns into dQ. The
sums land in another order on every run, so dQ is not bitwise reproducible;
ops/flash_bwd.py's "split" path is. A sliding window, segment ids, a logit
soft-cap and ALiBi run in the kernel's instantiation for them (ALiBi's in a
library of their own, csrc/flash_bwd_fused_alibi.cu); a launch with one
also counts in WINDOW_LAUNCHES, SEGMENT_LAUNCHES, SOFTCAP_LAUNCHES or
ALIBI_LAUNCHES. Dropout (the forward's rate and seed: the kernel rebuilds
its keep mask) runs the instantiations of csrc/flash_bwd_fused_dropout.cu,
every option beside it, and counts in DROPOUT_LAUNCHES; the forward's
dyn_pos_offset with a window or ALiBi those of
csrc/flash_bwd_fused_dynoff.cu (with dropout,
csrc/flash_bwd_fused_dynoff_dropout.cu), every option beside it, counted in
DYNOFF_LAUNCHES.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.flash_fwd import (
    DTYPE_CODES,
    WINDOW_MAX,
    alibi_table,
    check_kernel_operands,
    check_qkv,
    dyn_library,
    extra_args,
    kernel_library,
    kernel_segments,
    logit_factors,
    pointers,
)

# Kernel launches in this process (set to 0 by callers that count a run):
# all, with a sliding window, with segment ids, with a logit soft-cap, with
# ALiBi, with dropout.
LAUNCHES = 0
WINDOW_LAUNCHES = 0
SEGMENT_LAUNCHES = 0
SOFTCAP_LAUNCHES = 0
ALIBI_LAUNCHES = 0
DROPOUT_LAUNCHES = 0
DYNOFF_LAUNCHES = 0  # with the offset read on the card (dyn_pos_offset)


def check_backward_operands(q, k, v, o, do, lse, head_dims: tuple[int, ...]) -> None:
    """Shapes, devices and, on the card, what the backward kernels take:
    o and do shaped like q, lse [B, Hq, S_q] (float32 on the card), D in
    `head_dims` (flash_bwd.HEAD_DIMS), plus the forward's checks. Raises
    ValueError."""
    check_qkv(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
                         f"shaped like q {tuple(q.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse {tuple(lse.shape)} must be {tuple(q.shape[:3])}")
    if not all(t.device == q.device for t in (o, do, lse)):
        raise ValueError("q, k, v, o, do and lse must be on one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_operands(head_dims, q=q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32, got {lse.dtype}")


def require_cuda(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels take CUDA tensors, not {q.device}: "
                         "flash_attention_backward takes CPU tensors to the plain version")


def launch_args(q, k, is_causal, scale, pos_offset, window=None, segs=(None,) * 4,
                cap: float | None = None, slopes: torch.Tensor | None = None) -> tuple:
    """(seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq, Hkv, S_q, S_k, D,
    dtype code, causal, offset, window, scale, pre, cap_log2), the arguments
    every backward launch entry point takes after its tensor pointers; segs
    as flash_fwd.kernel_segments returns them and slopes as
    flash_fwd.alibi_table does (the caller keeps them alive until the launch
    has been issued), cap as common.check_softcap returns it, pre and
    cap_log2 as K1's launcher passes them (flash_fwd.logit_factors)."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d**0.5
    offset = s_k - s_q if pos_offset is None else int(pos_offset)
    return (*pointers(*segs, slopes), b, hq, hkv, s_q, s_k, d, DTYPE_CODES[q.dtype],
            int(is_causal), offset, min(window or 0, WINDOW_MAX), scale,
            *logit_factors(scale, cap))


def flash_attention_backward_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dyn_pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3's port on CUDA operands checked by flash_attention_backward:
    (dQ in q.dtype, dK and dV in k.dtype); logit_softcap as
    common.check_softcap returns it; alibi and alibi_slopes as the forward
    takes them (flash_fwd.alibi_table); dropout_rate as
    common.check_dropout returns it, with the forward's dropout_seed;
    dyn_pos_offset as the forward checks it."""
    require_cuda(q)
    segs = kernel_segments(segment_ids)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, logit_softcap)
    dyn = dyn_library(dyn_pos_offset, window, slopes)
    args = launch_args(q, k, is_causal, scale, pos_offset, window, segs, logit_softcap, slopes)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    held, extra = extra_args(q, dropout_rate, dropout_seed, dyn, dyn_pos_offset)
    lib = _build.load(kernel_library("flash_bwd_fused", dropout_rate, dyn, slopes is not None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_fused_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), *args, *extra, stream)
    del held  # the seed and the offset, kept on the card until the launch
    _build.check(lib, rc, "flash_bwd_fused")
    global LAUNCHES, WINDOW_LAUNCHES, SEGMENT_LAUNCHES, SOFTCAP_LAUNCHES, ALIBI_LAUNCHES
    global DROPOUT_LAUNCHES, DYNOFF_LAUNCHES
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    SEGMENT_LAUNCHES += segment_ids is not None
    SOFTCAP_LAUNCHES += logit_softcap is not None
    ALIBI_LAUNCHES += slopes is not None
    DROPOUT_LAUNCHES += dropout_rate > 0
    DYNOFF_LAUNCHES += dyn
    return dq_acc.to(q.dtype), dk, dv
