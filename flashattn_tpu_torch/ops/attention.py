"""Public flash-attention entry point with autograd (counterpart of
flashattn_tpu/ops/attention.py).

``flash_attention`` is differentiable: a ``torch.autograd.Function`` (the
JAX package's ``custom_vjp``) whose forward runs K1 with the LSE and keeps
(q, k, v, o, lse) as residuals, and whose backward runs the backward kernels
(ops/flash_bwd.py). Without a gradient to take, the primal runs K1 without
writing the LSE, as the JAX primal does. A sliding window runs in K1
without a gradient (prefill, a no-grad forward); its backward is not
ported, so a windowed call that needs a gradient raises before any kernel
runs.

``plain_flash_attention`` is the same Function over the plain versions of
the forward and backward, the route the kernels are held against. It never
lets autograd record the plain attention's [S_q, S_k] intermediates.
"""

from __future__ import annotations

from typing import Callable

import torch

from flashattn_tpu_torch.ops.common import unported
from flashattn_tpu_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_reference,
)
from flashattn_tpu_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_reference,
)


class FlashAttentionFunction(torch.autograd.Function):
    """O = attention(q, k, v) with residuals (q, k, v, o, lse); the forward
    and backward functions are arguments, so the kernels and the plain
    versions share this Function."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal: bool, scale: float | None,
                pos_offset: int | None, forward_fn: Callable, backward_fn: Callable):
        o, lse = forward_fn(q, k, v, is_causal, scale, pos_offset, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = (is_causal, scale, pos_offset, backward_fn)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        is_causal, scale, pos_offset, backward_fn = ctx.options
        dq, dk, dv = backward_fn(q, k, v, o, do.contiguous(), lse, is_causal=is_causal,
                                 scale=scale, pos_offset=pos_offset)
        return dq, dk, dv, None, None, None, None, None


def _attention(q, k, v, is_causal, scale, pos_offset, window, forward_fn, backward_fn):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if window is not None:
            raise unported("sliding-window backward", "A4")
        return FlashAttentionFunction.apply(q, k, v, is_causal, scale, pos_offset,
                                            forward_fn, backward_fn)
    o, _ = forward_fn(q, k, v, is_causal, scale, pos_offset, need_lse=False, window=window)
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Fused flash attention -> O [B, Hq, S_q, D] in q.dtype, differentiable.

    q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq. The
    causal mask aligns bottom-right unless pos_offset says otherwise. The
    backward's implementation follows flash_attention_backward's "auto"
    (FLASHATTN_BWD_IMPL=split selects the deterministic path). `window`
    (needs is_causal) is forward-only: with an input that requires grad it
    raises NotImplementedError (ROADMAP A4)."""
    return _attention(q, k, v, is_causal, scale, pos_offset, window,
                      flash_attention_forward, flash_attention_backward)


def plain_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """flash_attention through the plain PyTorch forward and backward, on
    any device: the reference route for checking the kernels' route."""
    return _attention(q, k, v, is_causal, scale, pos_offset, window,
                      flash_attention_forward_reference,
                      flash_attention_backward_reference)
