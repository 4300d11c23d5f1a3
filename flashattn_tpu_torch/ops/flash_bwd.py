"""Flash-attention backward (counterpart of flashattn_tpu/ops/flash_bwd.py).

``flash_attention_backward`` dispatches on ``impl``:

- ``"fused"``: B3's port (ops/flash_bwd_fused.py, csrc/flash_bwd_fused.cu),
  one pass with dQ added by fp32 atomics; not bitwise reproducible.
- ``"split"``: B4's and B5's ports (csrc/flash_bwd.cu), the dQ kernel, which
  also writes delta = rowsum(dO * O), then the dK/dV kernel, which reads it.
  No atomics: two runs give bitwise-equal gradients. This is the
  deterministic path.
- ``"auto"``: ``FLASHATTN_BWD_IMPL`` from the environment when set (read at
  every call, so one variable selects the path for a whole model), else
  the winner that ops/autotune.py measured at this shape on this card
  (``cached_bwd_impl``), else ``"fused"`` (``resolve_impl``). The JAX
  package also weighs a VMEM estimate, a TPU design that is not ported:
  on the card the fused kernel keeps only one kv tile's dK/dV on chip, so
  it serves every length.

Every path takes the sliding window, packed-document segment ids, the
logit soft-cap and ALiBi (the forward's `window`, `segment_ids`,
`logit_softcap`, `alibi` and `alibi_slopes`, ops/flash_fwd.py), at the
forward's head dims (HEAD_DIMS): with a cap the kernels rebuild P from the
capped logits and multiply dS by the tanh's derivative, 1 - t^2; with
ALiBi they rebuild P from the biased logits, the bias formed as K1 forms
it, and dS keeps its formula (the bias has no gradient). ALiBi's kernels
are libraries of their own (csrc/flash_bwd_alibi.cu,
csrc/flash_bwd_fused_alibi.cu). So are those of the forward's
``dyn_pos_offset`` (csrc/flash_bwd_dynoff.cu, csrc/flash_bwd_fused_dynoff.cu
and, with dropout, csrc/flash_bwd_dynoff_dropout.cu,
csrc/flash_bwd_fused_dynoff_dropout.cu: the offset read on the card, the
window's left edge and the ALiBi distance at it, ops/flash_fwd.py), with
every combination the forward takes (flash_fwd.kernel_library).
"""

from __future__ import annotations

import os

import torch

from flashattn_tpu_torch.ops import _build, autotune
from flashattn_tpu_torch.ops.flash_bwd_fused import (
    check_backward_operands,
    flash_attention_backward_fused,
    launch_args,
    require_cuda,
)
from flashattn_tpu_torch.ops.common import check_dropout, check_softcap
from flashattn_tpu_torch.ops.flash_fwd import (
    alibi_table,
    check_dyn_offset,
    check_segments,
    check_window,
    dyn_library,
    extra_args,
    kernel_library,
    kernel_segments,
    plain_offset,
)
from flashattn_tpu_torch.ops.reference import reference_attention_backward

# Kernel launches in this process (set to 0 by callers that count a run):
# each kernel's, and those with a sliding window, with segment ids, with a
# logit soft-cap, with ALiBi and with dropout.
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
DQ_WINDOW_LAUNCHES = 0
DKV_WINDOW_LAUNCHES = 0
DQ_SEGMENT_LAUNCHES = 0
DKV_SEGMENT_LAUNCHES = 0
DQ_SOFTCAP_LAUNCHES = 0
DKV_SOFTCAP_LAUNCHES = 0
DQ_ALIBI_LAUNCHES = 0
DKV_ALIBI_LAUNCHES = 0
DQ_DROPOUT_LAUNCHES = 0
DKV_DROPOUT_LAUNCHES = 0
DQ_DYNOFF_LAUNCHES = 0  # with the offset read on the card (dyn_pos_offset)
DKV_DYNOFF_LAUNCHES = 0

# Head dims the backward kernels take (the forward's: flash_fwd.HEAD_DIMS):
# 32 in the 64-column tile, 80 and 96 in the 128-column tile, at run time.
HEAD_DIMS = (32, 64, 80, 96, 128, 256)

IMPLS = ("auto", "fused", "split")
IMPL_ENV = "FLASHATTN_BWD_IMPL"


def flash_attention_backward_reference(
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
    """Plain PyTorch version of the backward kernels (B3, B4 and B5), on any
    device."""
    pos_offset = plain_offset(pos_offset, dyn_pos_offset, is_causal)
    check_window(window, is_causal, dyn_pos_offset is not None)
    segment_ids = check_segments(segment_ids, q, k)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, check_softcap(logit_softcap))
    rate = check_dropout(dropout_rate, dropout_seed)
    return reference_attention_backward(q, k, v, o, do, lse, is_causal, scale,
                                        pos_offset, window, segment_ids, logit_softcap, slopes,
                                        rate, dropout_seed)


def resolve_impl(impl: str, shape: tuple | None = None) -> str:
    """"fused" or "split" for an `impl` argument, in the JAX package's
    order: an explicit impl; for "auto" FLASHATTN_BWD_IMPL; then the
    autotune winner for `shape`, (b, hq, hkv, s_q, s_k, d, is_causal,
    dtype) on the card (None: no lookup); then "fused"."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        impl = os.environ.get(IMPL_ENV, "auto")
        if impl not in IMPLS:
            raise ValueError(f"{IMPL_ENV}={impl!r} not in {IMPLS}")
    if impl == "auto" and shape is not None:
        impl = autotune.cached_bwd_impl(*shape) or "auto"
    return "fused" if impl == "auto" else impl


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    impl: str = "auto",
    pos_offset: int | None = None,
    *,
    segment_ids=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
    dyn_pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of flash attention from the forward's O and LSE.

    Args:
      q, o, do: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D]; lse: [B, Hq, S_q]
        float32, natural log, as flash_attention_forward returns it.
      is_causal, scale, pos_offset, window, segment_ids, logit_softcap,
        alibi, alibi_slopes, dropout_rate, dropout_seed, dyn_pos_offset: as
        in the forward call that made o and lse (ALiBi with a soft-cap
        raises ValueError, as there; the same seed rebuilds the forward's
        dropout mask).
      impl: "auto", "fused" or "split" (module docstring; the CPU's plain
        version serves all three).

    Returns:
      (dQ [B, Hq, S_q, D] in q.dtype, dK and dV [B, Hkv, S_k, D] in k.dtype),
      dK and dV summed over the q heads of each kv head. Rows that see no key
      give dQ = 0 and add nothing to dK and dV.

    CPU tensors take the plain version. CUDA tensors launch the kernels and
    must be contiguous, 16-byte aligned bf16 or float32 with D in
    HEAD_DIMS, and lse contiguous float32; anything else raises.
    """
    check_backward_operands(q, k, v, o, do, lse, HEAD_DIMS)
    shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], is_causal, q.dtype)
    impl = resolve_impl(impl, shape if q.is_cuda else None)
    check_dyn_offset(dyn_pos_offset, pos_offset, is_causal)
    check_window(window, is_causal, dyn_pos_offset is not None)
    segment_ids = check_segments(segment_ids, q, k)
    cap = check_softcap(logit_softcap)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, cap)
    rate = check_dropout(dropout_rate, dropout_seed)
    bias = dict(alibi=slopes is not None, alibi_slopes=slopes, dropout_rate=rate,
                dropout_seed=dropout_seed, dyn_pos_offset=dyn_pos_offset)
    if dyn_pos_offset is not None:
        pos_offset = None
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, lse, is_causal, scale,
                                                  pos_offset, window, segment_ids, cap, **bias)
    if impl == "fused":
        return flash_attention_backward_fused(q, k, v, o, do, lse, is_causal, scale,
                                              pos_offset, window, segment_ids, cap, **bias)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, is_causal, scale, pos_offset, window,
                             segment_ids, cap, **bias)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, is_causal, scale, pos_offset, window,
                           segment_ids, cap, **bias)
    return dq, dk, dv


def flash_bwd_dq(q, k, v, o, do, lse, is_causal=False, scale=None, pos_offset=None,
                 window=None, segment_ids=None, logit_softcap=None, alibi=False,
                 alibi_slopes=None, dropout_rate=0.0, dropout_seed=None, dyn_pos_offset=None):
    """B4's port on CUDA operands checked by flash_attention_backward:
    (dQ in q.dtype, delta = rowsum(dO * O) float32 [B, Hq, S_q]);
    logit_softcap as common.check_softcap returns it; alibi and alibi_slopes
    as the forward takes them (flash_fwd.alibi_table); dropout_rate as
    common.check_dropout returns it, with the forward's dropout_seed;
    dyn_pos_offset as the forward checks it."""
    require_cuda(q)
    segs = kernel_segments(segment_ids)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, logit_softcap)
    dyn = dyn_library(dyn_pos_offset, window, slopes)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    held, extra = extra_args(q, dropout_rate, dropout_seed, dyn, dyn_pos_offset)
    lib = _build.load(kernel_library("flash_bwd", dropout_rate, dyn, slopes is not None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            *launch_args(q, k, is_causal, scale, pos_offset, window, segs, logit_softcap,
                         slopes),
            *extra, stream)
    del held  # the seed and the offset, kept on the card until the launch
    _build.check(lib, rc, "flash_bwd_dq")
    global DQ_LAUNCHES, DQ_WINDOW_LAUNCHES, DQ_SEGMENT_LAUNCHES, DQ_SOFTCAP_LAUNCHES
    global DQ_ALIBI_LAUNCHES, DQ_DROPOUT_LAUNCHES, DQ_DYNOFF_LAUNCHES
    DQ_LAUNCHES += 1
    DQ_WINDOW_LAUNCHES += window is not None
    DQ_SEGMENT_LAUNCHES += segment_ids is not None
    DQ_SOFTCAP_LAUNCHES += logit_softcap is not None
    DQ_ALIBI_LAUNCHES += slopes is not None
    DQ_DROPOUT_LAUNCHES += dropout_rate > 0
    DQ_DYNOFF_LAUNCHES += dyn
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, is_causal=False, scale=None, pos_offset=None,
                  window=None, segment_ids=None, logit_softcap=None, alibi=False,
                  alibi_slopes=None, dropout_rate=0.0, dropout_seed=None, dyn_pos_offset=None):
    """B5's port on CUDA operands checked by flash_attention_backward, with
    flash_bwd_dq's delta: (dK, dV) in k.dtype; logit_softcap, alibi,
    alibi_slopes, dropout_rate, dropout_seed and dyn_pos_offset as
    flash_bwd_dq takes them."""
    require_cuda(q)
    segs = kernel_segments(segment_ids)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, logit_softcap)
    dyn = dyn_library(dyn_pos_offset, window, slopes)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    held, extra = extra_args(q, dropout_rate, dropout_seed, dyn, dyn_pos_offset)
    lib = _build.load(kernel_library("flash_bwd", dropout_rate, dyn, slopes is not None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *launch_args(q, k, is_causal, scale, pos_offset, window, segs, logit_softcap,
                         slopes),
            *extra, stream)
    del held
    _build.check(lib, rc, "flash_bwd_dkv")
    global DKV_LAUNCHES, DKV_WINDOW_LAUNCHES, DKV_SEGMENT_LAUNCHES, DKV_SOFTCAP_LAUNCHES
    global DKV_ALIBI_LAUNCHES, DKV_DROPOUT_LAUNCHES, DKV_DYNOFF_LAUNCHES
    DKV_LAUNCHES += 1
    DKV_WINDOW_LAUNCHES += window is not None
    DKV_SEGMENT_LAUNCHES += segment_ids is not None
    DKV_SOFTCAP_LAUNCHES += logit_softcap is not None
    DKV_ALIBI_LAUNCHES += slopes is not None
    DKV_DROPOUT_LAUNCHES += dropout_rate > 0
    DKV_DYNOFF_LAUNCHES += dyn
    return dk, dv
