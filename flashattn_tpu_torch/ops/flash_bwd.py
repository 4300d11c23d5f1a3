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
  ``"fused"``. The JAX package picks by a VMEM estimate and an autotune
  cache; those are TPU designs and are not ported: on the card the fused
  kernel keeps only one kv tile's dK/dV on chip, so it serves every length.
"""

from __future__ import annotations

import os

import torch

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.common import unported
from flashattn_tpu_torch.ops.flash_bwd_fused import (
    check_backward_operands,
    flash_attention_backward_fused,
    launch_args,
    require_cuda,
)
from flashattn_tpu_torch.ops.reference import reference_attention_backward

# Kernel launches in this process (set to 0 by callers that count a run).
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (B3, B4 and B5), on any
    device."""
    return reference_attention_backward(q, k, v, o, do, lse, is_causal, scale,
                                        pos_offset)


def resolve_impl(impl: str) -> str:
    """"fused" or "split" for an `impl` argument (see the module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        impl = os.environ.get(IMPL_ENV, "auto")
        if impl not in IMPLS:
            raise ValueError(f"{IMPL_ENV}={impl!r} not in {IMPLS}")
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
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dyn_pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of flash attention from the forward's O and LSE.

    Args:
      q, o, do: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D]; lse: [B, Hq, S_q]
        float32, natural log, as flash_attention_forward returns it.
      is_causal, scale, pos_offset: as in the forward call that made o and
        lse.
      impl: "auto", "fused" or "split" (module docstring).

    Returns:
      (dQ [B, Hq, S_q, D] in q.dtype, dK and dV [B, Hkv, S_k, D] in k.dtype),
      dK and dV summed over the q heads of each kv head. Rows that see no key
      give dQ = 0 and add nothing to dK and dV.

    CPU tensors take the plain version. CUDA tensors launch the kernels and
    must be contiguous, 16-byte aligned bf16 or float32 with D in
    flash_fwd.HEAD_DIMS, and lse contiguous float32; anything else raises.
    """
    if segment_ids is not None:
        raise unported("segment ids (varlen)", "A4")
    if dropout_rate:
        raise unported("attention dropout", "A4")
    if window is not None:
        raise unported("sliding-window attention", "A4")
    if logit_softcap:
        raise unported("logit soft-capping", "A4")
    if alibi:
        raise unported("ALiBi", "A4")
    if dyn_pos_offset is not None:
        raise unported("dyn_pos_offset", "A4")
    impl = resolve_impl(impl)
    check_backward_operands(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, do, lse, is_causal,
                                                  scale, pos_offset)
    if impl == "fused":
        return flash_attention_backward_fused(q, k, v, o, do, lse, is_causal, scale,
                                              pos_offset)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, is_causal, scale, pos_offset)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, is_causal, scale, pos_offset)
    return dq, dk, dv


def flash_bwd_dq(q, k, v, o, do, lse, is_causal=False, scale=None, pos_offset=None):
    """B4's port on CUDA operands checked by flash_attention_backward:
    (dQ in q.dtype, delta = rowsum(dO * O) float32 [B, Hq, S_q])."""
    require_cuda(q)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            *launch_args(q, k, is_causal, scale, pos_offset), stream)
    _build.check(lib, rc, "flash_bwd_dq")
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, is_causal=False, scale=None, pos_offset=None):
    """B5's port on CUDA operands checked by flash_attention_backward, with
    flash_bwd_dq's delta: (dK, dV) in k.dtype."""
    require_cuda(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *launch_args(q, k, is_causal, scale, pos_offset), stream)
    _build.check(lib, rc, "flash_bwd_dkv")
    global DKV_LAUNCHES
    DKV_LAUNCHES += 1
    return dk, dv
