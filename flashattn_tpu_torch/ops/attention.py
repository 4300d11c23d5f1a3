"""Public flash-attention entry point with autograd (counterpart of
flashattn_tpu/ops/attention.py).

``flash_attention`` is differentiable: a ``torch.autograd.Function`` (the
JAX package's ``custom_vjp``) whose forward runs K1 with the LSE and keeps
(q, k, v, o, lse), the segment ids, ALiBi's (Hq,) float32 slope table and
the dropout seed as residuals, and whose backward runs the backward kernels
(ops/flash_bwd.py) with the same causal mask, window, segment ids, logit
soft-cap, ALiBi slopes and dropout rate and seed, so that it rebuilds the
forward's dropout mask. The slopes and the seed get no gradient (the JAX
package returns zeros for them). Without a gradient to take, the primal
runs K1 without writing the LSE, as the JAX primal does.

Under a gradient the Function's forward calls K1 through a registered
operator, ``torch.ops.flashattn_tpu_torch.flash_fwd`` (the plain route's is
``flash_fwd_plain``): an operator the dispatcher sees, so that selective
activation checkpointing (models/llama.py, remat="attn") can keep its
outputs, the residuals the JAX package tags ``flash_resid``, and its
recompute launches no K1. Each operator returns (O, LSE) as new tensors
and has a fake implementation for shape propagation.

``plain_flash_attention`` is the same Function over the plain versions of
the forward and backward, the route the kernels are held against. It never
lets autograd record the plain attention's [S_q, S_k] intermediates.
"""

from __future__ import annotations

from typing import Callable

import torch

from flashattn_tpu_torch.ops.common import check_dropout, check_softcap
from flashattn_tpu_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_reference,
)
from flashattn_tpu_torch.ops.flash_fwd import (
    alibi_table,
    flash_attention_forward,
    flash_attention_forward_reference,
)


# The forward routes as operators: (q, k, v, seg_q, seg_k, is_causal, scale,
# pos_offset, window, logit_softcap, alibi_slopes, dropout_rate,
# dropout_seed) -> (O, LSE); ALiBi is on when alibi_slopes, the (Hq,)
# float32 table, is given, dropout when dropout_rate > 0 (the seed a
# one-element int32 tensor, on the card or the host).
_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor? seg_q, Tensor? seg_k, bool is_causal, "
               "float? scale, int? pos_offset, int? window, float? logit_softcap, "
               "Tensor? alibi_slopes=None, float dropout_rate=0.0, "
               "Tensor? dropout_seed=None) -> (Tensor, Tensor)")


def _forward_op(name: str, forward_fn: Callable):
    """Register forward_fn (need_lse=True) as flashattn_tpu_torch::<name>."""
    def impl(q, k, v, seg_q, seg_k, is_causal, scale, pos_offset, window, logit_softcap,
             alibi_slopes=None, dropout_rate=0.0, dropout_seed=None):
        return forward_fn(q, k, v, is_causal, scale, pos_offset, need_lse=True, window=window,
                          segment_ids=None if seg_q is None else (seg_q, seg_k),
                          logit_softcap=logit_softcap, alibi=alibi_slopes is not None,
                          alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
                          dropout_seed=dropout_seed)

    op = torch.library.custom_op(f"flashattn_tpu_torch::{name}", impl, mutates_args=(),
                                 schema=_FWD_SCHEMA)

    @op.register_fake
    def _(q, k, v, seg_q, seg_k, is_causal, scale, pos_offset, window, logit_softcap,
          alibi_slopes=None, dropout_rate=0.0, dropout_seed=None):
        return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)

    return op


flash_fwd_op = _forward_op("flash_fwd", flash_attention_forward)
flash_fwd_plain_op = _forward_op("flash_fwd_plain", flash_attention_forward_reference)


class FlashAttentionFunction(torch.autograd.Function):
    """O = attention(q, k, v) with residuals (q, k, v, o, lse), the segment
    ids, the ALiBi slopes and the dropout seed; the forward operator and the
    backward function are arguments, so the kernels and the plain versions
    share this Function. The options (the causal mask, scale, pos_offset,
    window, logit soft-cap, ALiBi slopes, dropout rate and seed) reach both
    alike. The segment ids (int32), the slopes and the seed get no
    gradient: None."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, is_causal: bool, scale: float | None,
                pos_offset: int | None, window: int | None, logit_softcap: float | None,
                alibi_slopes: torch.Tensor | None, dropout_rate: float,
                dropout_seed: torch.Tensor | None, forward_op: Callable, backward_fn: Callable):
        o, lse = forward_op(q, k, v, seg_q, seg_k, is_causal, scale, pos_offset, window,
                            logit_softcap, alibi_slopes, dropout_rate, dropout_seed)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_k, alibi_slopes, dropout_seed)
        ctx.options = (is_causal, scale, pos_offset, window, logit_softcap, dropout_rate,
                       backward_fn)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_k, slopes, seed = ctx.saved_tensors
        is_causal, scale, pos_offset, window, logit_softcap, rate, backward_fn = ctx.options
        dq, dk, dv = backward_fn(q, k, v, o, do.contiguous(), lse, is_causal=is_causal,
                                 scale=scale, pos_offset=pos_offset, window=window,
                                 segment_ids=None if seg_q is None else (seg_q, seg_k),
                                 logit_softcap=logit_softcap, alibi=slopes is not None,
                                 alibi_slopes=slopes, dropout_rate=rate, dropout_seed=seed)
        return (dq, dk, dv) + (None,) * 12


def _attention(q, k, v, is_causal, scale, pos_offset, window, segment_ids, logit_softcap,
               alibi, alibi_slopes, dropout_rate, dropout_seed, forward_fn, forward_op,
               backward_fn):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        seg_q, seg_k = (None, None) if segment_ids is None else segment_ids
        slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device,
                             check_softcap(logit_softcap))
        rate = check_dropout(dropout_rate, dropout_seed)
        seed = None
        if rate:  # the operators take the seed as a tensor: an int's is a host tensor
            seed = (dropout_seed if isinstance(dropout_seed, torch.Tensor)
                    else torch.tensor(dropout_seed, dtype=torch.int32))
        return FlashAttentionFunction.apply(q, k, v, seg_q, seg_k, is_causal, scale,
                                            pos_offset, window, logit_softcap, slopes, rate,
                                            seed, forward_op, backward_fn)
    o, _ = forward_fn(q, k, v, is_causal, scale, pos_offset, need_lse=False, window=window,
                      segment_ids=segment_ids, logit_softcap=logit_softcap, alibi=alibi,
                      alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
                      dropout_seed=dropout_seed)
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
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
) -> torch.Tensor:
    """Fused flash attention -> O [B, Hq, S_q, D] in q.dtype, differentiable.

    q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq. The
    causal mask aligns bottom-right unless pos_offset says otherwise;
    `window` (needs is_causal) and `segment_ids` ((seg_q [B, S_q], seg_k
    [B, S_k]) int32, as flash_attention_forward takes them; packed
    documents go through ops/varlen.py) restrict it further, in the forward
    and the backward. The backward's implementation follows
    flash_attention_backward's "auto" (FLASHATTN_BWD_IMPL=split selects the
    deterministic path). `logit_softcap` (cap * tanh(s / cap) on the
    scaled logits, before the mask) and `alibi` (with `alibi_slopes`, as
    flash_attention_forward takes them; not with a cap) reach the forward
    and the backward alike; the slopes get no gradient. `dropout_rate` in
    [0, 1) with `dropout_seed` (needed above 0: an int32 int or a
    one-element int32 tensor; vary it from step to step) drops attention
    probabilities as flash_attention_forward does, beside every option
    above; the backward rebuilds the same mask from the seed."""
    return _attention(q, k, v, is_causal, scale, pos_offset, window, segment_ids,
                      logit_softcap, alibi, alibi_slopes, dropout_rate, dropout_seed,
                      flash_attention_forward, flash_fwd_op, flash_attention_backward)


def plain_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
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
) -> torch.Tensor:
    """flash_attention through the plain PyTorch forward and backward, on
    any device: the reference route for checking the kernels' route."""
    return _attention(q, k, v, is_causal, scale, pos_offset, window, segment_ids,
                      logit_softcap, alibi, alibi_slopes, dropout_rate, dropout_seed,
                      flash_attention_forward_reference, flash_fwd_plain_op,
                      flash_attention_backward_reference)
