"""Ulysses sequence parallelism: all-to-all head redistribution (counterpart
of flashattn_tpu/parallel/ulysses.py).

Instead of rotating K/V shards around a ring, two all-to-all exchanges
re-shard sequence -> heads, so that each rank runs full-sequence attention
(K1 and the backward kernels, through ops/attention.py) over a slice of the
heads, and heads -> sequence after it. The exchanges are autograd Functions
whose backward is the inverse exchange, the JAX all_to_all's transpose.
Exact: no partial merges. Over gloo with tensors on the card each exchange
is staged through host memory (parallel/distributed.py).
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.flash_fwd import default_alibi_slopes
from flashattn_tpu_torch.ops.varlen import flash_attention_varlen
from flashattn_tpu_torch.parallel.distributed import all_gather, all_reduce, all_to_all
from flashattn_tpu_torch.parallel.ring import _fold_seed, _seed_tensor, group_size_rank


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H, S/n, D] sequence shards -> [B, H/n, S, D]: this rank's head
    slice over the whole sequence."""
    n, _ = group_size_rank(group)
    b, h, s, d = x.shape
    parts = all_to_all(x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous(), group)
    return parts.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse: [B, H/n, S, D] -> [B, H, S/n, D]."""
    n, _ = group_size_rank(group)
    b, h, s, d = x.shape
    parts = all_to_all(x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous(), group)
    return parts.transpose(0, 1).reshape(b, n * h, s // n, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, H, S/n, D] -> [B, H, S, D], the shards in rank order."""
    parts = all_gather(x.contiguous(), group)  # [n, B, H, S/n, D]
    n, b, h, s, d = parts.shape
    return parts.permute(1, 2, 0, 3, 4).reshape(b, h, n * s, d)


class _GatherSeq(torch.autograd.Function):
    """All-gather of the sequence; its backward sums every rank's gradient
    and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        n, idx = group_size_rank(ctx.group)
        s = g.shape[2] // n
        return all_reduce(g.contiguous(), ctx.group)[:, :, idx * s:(idx + 1) * s].contiguous(), None


def ulysses_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    is_causal: bool = False,
    scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    segment_ids=None,
) -> torch.Tensor:
    """Sequence-parallel attention by head all-to-all; every rank of `group`
    calls it with its contiguous sequence shards.

    Args:
      q: [B, Hq, S/n, D]; k, v: [B, Hkv, S/n, D]. n must divide Hq. Where it
        does not divide Hkv (GQA with fewer kv heads than ranks) K and V are
        all-gathered over the sequence and each rank takes the kv heads its
        q heads read.
      alibi_slopes: the GLOBAL (Hq,) table (each rank takes its heads'
        entries); None: the standard table.
      dropout_seed: folded with the rank (the in-kernel head index is the
        slice's own), as the JAX function folds it.
      segment_ids: (seg_q [B, S/n], seg_k [B, S/n]) shards, all-gathered to
        the whole sequence (varlen attention); not with dropout (as in JAX).
      is_causal, scale, window, logit_softcap, alibi, dropout_rate: as
        flash_attention takes them, applied to the whole sequence.

    Returns O [B, Hq, S/n, D], differentiable in q, k and v.
    """
    n, idx = group_size_rank(group)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % n:
        raise ValueError(f"Ulysses needs the group's size ({n}) to divide Hq={hq}: use "
                         "ring_flash_attention")
    hq_local = hq // n
    q_h = _SeqToHeads.apply(q, group)
    if hkv % n == 0:
        k_h, v_h = _SeqToHeads.apply(k, group), _SeqToHeads.apply(v, group)
    else:
        if not (hq_local % hkv == 0 or hkv % hq_local == 0):
            raise ValueError(f"Hq={hq}, Hkv={hkv} and {n} ranks give no kv head slice")
        group_q = hq // hkv  # q heads a kv head
        start, span = idx * hq_local // group_q, max(hq_local // group_q, 1)
        k_h = _GatherSeq.apply(k, group)[:, start:start + span]
        v_h = _GatherSeq.apply(v, group)[:, start:start + span]
    slopes = None
    if alibi:
        table = default_alibi_slopes(hq) if alibi_slopes is None else alibi_slopes
        slopes = table.detach().to(q.device, torch.float32)[idx * hq_local:(idx + 1) * hq_local]
    seed = _seed_tensor(dropout_rate, dropout_seed, q.device)
    if segment_ids is not None:
        if dropout_rate:
            raise ValueError("Ulysses takes segment ids or dropout, not both (as in the JAX "
                             "package)")
        seg_q, seg_k = (all_gather(s.to(torch.int32).contiguous(), group).transpose(0, 1)
                        .reshape(s.shape[0], -1) for s in segment_ids)
        o_h = flash_attention_varlen(q_h, k_h.contiguous(), v_h.contiguous(),
                                     segment_ids=(seg_q, seg_k), is_causal=is_causal,
                                     scale=scale, window=window, logit_softcap=logit_softcap,
                                     alibi=alibi, alibi_slopes=slopes)
    else:
        o_h = flash_attention(q_h, k_h.contiguous(), v_h.contiguous(), is_causal, scale,
                              window=window, logit_softcap=logit_softcap, alibi=alibi,
                              alibi_slopes=slopes, dropout_rate=dropout_rate,
                              dropout_seed=None if seed is None else _fold_seed(seed, idx, 0))
    return _HeadsToSeq.apply(o_h.contiguous(), group)
