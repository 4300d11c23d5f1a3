"""Ring flash attention: context parallelism over a process group
(counterpart of flashattn_tpu/parallel/ring.py).

Each rank of the group holds a shard of the sequence: its queries, keys and
values. The online-softmax merge is associative, so partial attention
results against disjoint key shards merge exactly (``_merge_partial``, the
kernels' own correction algebra across ranks instead of tiles). The JAX
functions run inside ``shard_map``; these run in every rank's process and
exchange shards over ``torch.distributed`` (parallel/distributed.py: one
``Hop`` a ring step, posted before the step's compute and waited on after
it; over gloo with tensors on the card each hop is staged through host
memory and the first hop prints "gloo-host").

- ``ring_flash_attention``: the contiguous layout, rank i holding rows
  [i S/n, (i+1) S/n). Each hop calls K1 with the static alignment
  ``pos_offset = step * S/n``; with the causal mask a hop whose shard lies
  after this rank's (step > rank) is skipped on the host, while the ranks
  still rotate. A window prunes whole hops (``_ring_steps``).
- ``zigzag_ring_flash_attention``: the load-balanced causal layout, rank i
  holding chunks i and 2n-1-i of 2n (``zigzag_shard``). Every hop runs two
  equal chunk calls: (q_hi, k_lo), always visible, and one of (q_lo, k_lo)
  or (q_hi, k_hi). The first's alignment depends on the rank and the hop,
  ((2n-1) - rank - src) C, and with a window or ALiBi reaches the kernels as
  ``dyn_pos_offset``, read on the card (ops/flash_fwd.py).

The backward (each ring is a ``torch.autograd.Function``) calls the backward
kernels a hop with the global O, dO and LSE, so each hop's dQ, dK and dV are
exact partial sums of the true gradients: dQ accumulates locally in float32,
the float32 dK and dV accumulators travel with their K/V shard and a last
hop brings them home. Dropout seeds are folded per (rank, hop, sub-call) in
int32 as the JAX functions fold them (``_fold_seed``), so the keep masks are
the JAX package's bit for bit.

Not ported: ``_rotate``'s anchor, which orders XLA's permutes after the
previous hop's compute; here the program order does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from flashattn_tpu_torch.ops.common import check_dropout
from flashattn_tpu_torch.ops.flash_bwd import flash_attention_backward
from flashattn_tpu_torch.ops.flash_fwd import default_alibi_slopes, flash_attention_forward
from flashattn_tpu_torch.parallel.distributed import Hop

NEG_INF = float("-inf")


def group_size_rank(group) -> tuple[int, int]:
    """(size, this process's rank) of a process group (None: the default
    one); (1, 0) when no process group is up."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _merge_partial(m, l, acc, o_p, lse_p):
    """Fold a normalized partial (o_p, lse_p) into the running (m, l, acc),
    in natural-log units; a partial with lse_p = -inf (no key) changes
    nothing."""
    m_new = torch.maximum(m, lse_p)
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    gamma = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    w_p = torch.where(torch.isneginf(lse_p), 0.0, torch.exp(lse_p - m_safe))
    return m_new, l * gamma + w_p, acc * gamma[..., None] + o_p.float() * w_p[..., None]


def _finish(m, l, acc, dtype):
    """(O in `dtype`, LSE) of the merged stats; a row with no key: O = 0,
    LSE = -inf."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(dtype)
    return o, torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 x wrapped to int32, as JAX's int32 arithmetic wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _fold_seed(seed: torch.Tensor, idx: int, step: int, subid: int = 0) -> torch.Tensor:
    """The dropout seed of (rank idx, hop step, sub-call subid):
    seed * 1000003 + idx * 7919 + step (+ subid * 424243 for the zigzag's
    sub-calls), each operation wrapping in int32 as in the JAX package, on
    the seed's device (no host read)."""
    # One wrap of the int64 sum: wrapping each step on the way gives the same
    # residue mod 2^32 (|seed| * 1000003 stays far inside int64).
    return _wrap32(seed.to(torch.int64) * 1000003 + (idx * 7919 + step + subid * 424243))


def _ring_steps(n: int, is_causal: bool, window, s_local: int) -> int:
    """Ring hops that can hold a visible (q, k) pair: a causal window prunes
    whole hops (at hop t >= 1 the shard is (t-1) L + 1 .. (t+1) L - 1
    positions back, visible iff (t-1) L + 1 <= window - 1)."""
    if not (is_causal and window is not None):
        return n
    if window < 2:
        return 1
    return min(n, (window - 2) // s_local + 2)


def _seed_tensor(rate: float, seed, device):
    """dropout_seed as a one-element int32 tensor on `device` (None without
    dropout)."""
    if not check_dropout(rate, seed):
        return None
    return torch.as_tensor(seed, dtype=torch.int32).reshape(1).to(device)


def _canonical(segment_ids):
    """Segment ids with padding never matching: q ids < 0 -> -1, k ids < 0
    -> -2 (ops/varlen.py's rule), int32 and contiguous."""
    if segment_ids is None:
        return None, None
    seg_q, seg_k = segment_ids
    return (torch.where(seg_q < 0, -1, seg_q).to(torch.int32).contiguous(),
            torch.where(seg_k < 0, -2, seg_k).to(torch.int32).contiguous())


def _slopes(alibi: bool, alibi_slopes, hq: int, device):
    if alibi_slopes is not None and not alibi:
        raise ValueError("alibi_slopes needs alibi=True")
    if not alibi:
        return None
    table = default_alibi_slopes(hq) if alibi_slopes is None else alibi_slopes
    return table.detach().to(device=device, dtype=torch.float32)


# ---------------- the contiguous ring ----------------


def _ring_forward(q, k, v, seed, slopes, seg_q, seg_k, group, is_causal, scale, window, cap,
                  rate):
    n, idx = group_size_rank(group)
    b, hq, s_local, d = q.shape
    m = torch.full((b, hq, s_local), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s_local), device=q.device)
    acc = torch.zeros((b, hq, s_local, d), device=q.device)
    steps = _ring_steps(n, is_causal, window, s_local)
    k_cur, v_cur, sk_cur = k, v, seg_k
    for step in range(steps):
        hop = (Hop([x for x in (k_cur, v_cur, sk_cur) if x is not None], group)
               if step < steps - 1 else None)
        # Causal: the shard from src = idx - step is visible iff step <= idx.
        if not is_causal or step <= idx:
            o_p, lse_p = flash_attention_forward(
                q, k_cur, v_cur, is_causal, scale,
                pos_offset=step * s_local if is_causal else None,
                window=window if is_causal else None, logit_softcap=cap,
                alibi=slopes is not None, alibi_slopes=slopes, dropout_rate=rate,
                dropout_seed=_fold_seed(seed, idx, step) if rate else None,
                segment_ids=None if seg_q is None else (seg_q, sk_cur))
            m, l, acc = _merge_partial(m, l, acc, o_p, lse_p)
        if hop is not None:
            received = hop.wait()
            k_cur, v_cur = received[:2]
            sk_cur = received[2] if sk_cur is not None else None
    return _finish(m, l, acc, q.dtype)


def _ring_backward(q, k, v, o, do, lse, seed, slopes, seg_q, seg_k, group, is_causal, scale,
                   window, cap, rate):
    n, idx = group_size_rank(group)
    s_local = q.shape[2]
    steps = _ring_steps(n, is_causal, window, s_local)
    dq_acc = torch.zeros(q.shape, device=q.device)
    dk_cur = torch.zeros(k.shape, device=k.device)
    dv_cur = torch.zeros(v.shape, device=v.device)
    k_cur, v_cur, sk_cur = k, v, seg_k
    for step in range(steps):
        hop = (Hop([x for x in (k_cur, v_cur, sk_cur) if x is not None], group)
               if step < steps - 1 else None)
        if not is_causal or step <= idx:
            dq_p, dk_p, dv_p = flash_attention_backward(
                q, k_cur, v_cur, o, do, lse, is_causal, scale,
                pos_offset=step * s_local if is_causal else None,
                window=window if is_causal else None, logit_softcap=cap,
                alibi=slopes is not None, alibi_slopes=slopes, dropout_rate=rate,
                dropout_seed=_fold_seed(seed, idx, step) if rate else None,
                segment_ids=None if seg_q is None else (seg_q, sk_cur))
            dq_acc += dq_p.float()
            dk_cur += dk_p.float()
            dv_cur += dv_p.float()
        # dK and dV travel with their K/V shard: they rotate with it.
        if hop is not None:
            received = hop.wait()
            k_cur, v_cur = received[:2]
            sk_cur = received[2] if sk_cur is not None else None
            dk_cur, dv_cur = Hop([dk_cur, dv_cur], group).wait()
    # After steps - 1 hops the accumulators are that far from home: one hop
    # of the complementary shift returns them (none when no hop ran).
    shift = (n - (steps - 1)) % n
    if shift:
        dk_cur, dv_cur = Hop([dk_cur, dv_cur], group, shift).wait()
    return dq_acc.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, slopes, seg_q, seg_k, group, is_causal, scale, window, cap,
                rate):
        o, lse = _ring_forward(q, k, v, seed, slopes, seg_q, seg_k, group, is_causal, scale,
                               window, cap, rate)
        ctx.save_for_backward(q, k, v, o, lse, seed, slopes, seg_q, seg_k)
        ctx.cfg = (group, is_causal, scale, window, cap, rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed, slopes, seg_q, seg_k = ctx.saved_tensors
        grads = _ring_backward(q, k, v, o, do.contiguous(), lse, seed, slopes, seg_q, seg_k,
                               *ctx.cfg)
        return (*grads,) + (None,) * 10


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    is_causal: bool = False,
    scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    alibi_slopes: torch.Tensor | None = None,
    segment_ids=None,
) -> torch.Tensor:
    """Context-parallel flash attention of this rank's shards; every rank of
    `group` calls it.

    Args:
      q: [B, Hq, S/n, D], this rank's rows of the sequence (contiguous
        shards, rank order); k, v: [B, Hkv, S/n, D].
      group: the process group of the sequence axis (None: the default).
      is_causal: the global causal mask.
      window, logit_softcap, alibi, dropout_rate, dropout_seed: as the
        kernels take them, globally exact across shards (every hop carries
        pos_offset = step * S/n). window and alibi need is_causal, as in the
        JAX function. A window prunes whole hops.
      dropout_seed: an int32 int or one-element tensor, folded per (rank,
        hop).
      alibi_slopes: this rank's (Hq,) table (shard a global one with the
        heads); None: the standard table of Hq heads.
      segment_ids: (seg_q [B, S/n], seg_k [B, S/n]) this rank's ids; seg_k
        travels with its K/V shard. Padding (ids < 0) is canonicalised.

    Returns O [B, Hq, S/n, D] in q.dtype, differentiable in q, k and v.
    """
    if (window is not None or alibi) and not is_causal:
        raise ValueError("the ring's window and ALiBi need is_causal (non-causal hop "
                         "offsets depend on the rank: use the zigzag ring or Ulysses)")
    seed = _seed_tensor(dropout_rate, dropout_seed, q.device)
    seg_q, seg_k = _canonical(segment_ids)
    return _Ring.apply(q, k, v, seed, _slopes(alibi, alibi_slopes, q.shape[1], q.device),
                       seg_q, seg_k, group, is_causal, scale, window, logit_softcap,
                       float(dropout_rate))


# ---------------- the zigzag (load-balanced causal) layout ----------------


def zigzag_permutation(s: int, n: int, inverse: bool = False) -> np.ndarray:
    """Row permutation from natural order to the zigzag order: the sequence
    cut into 2n chunks, ordered (chunk i, chunk 2n-1-i) for i in 0..n-1, so
    that contiguous shards give rank i its pair."""
    if s % (2 * n):
        raise ValueError(f"S={s} is not a multiple of 2n={2 * n}")
    c = s // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    perm = np.asarray(order, dtype=np.int64)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(s)
        return inv
    return perm


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """`axis` of a global-view x reordered into zigzag order for an n-rank
    ring."""
    idx = torch.as_tensor(zigzag_permutation(x.shape[axis], n), device=x.device)
    return x.index_select(axis, idx)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """The inverse of zigzag_shard."""
    idx = torch.as_tensor(zigzag_permutation(x.shape[axis], n, inverse=True), device=x.device)
    return x.index_select(axis, idx)


def _zz_pairs(step: int, n: int, idx: int, c: int, window, alibi: bool):
    """The sub-calls of hop `step` on rank idx: (q half, k half, is_causal,
    pos_offset, dyn_pos_offset, subid). (hi, lo) is always visible, its
    alignment ((2n-1) - idx - src) C read on the card when a window or ALiBi
    needs it; then at step 0 the two diagonal pairs, else (lo, lo) with
    step C when step <= idx, or (hi, hi) with (n - step) C."""
    src = (idx - step) % n
    dyn = ((2 * n - 1) - idx - src) * c if (window is not None or alibi) else None
    pairs = [("hi", "lo", False, None, dyn, 0)]
    if step == 0:
        pairs += [("lo", "lo", True, None, None, 1), ("hi", "hi", True, None, None, 2)]
    elif step <= idx:
        pairs.append(("lo", "lo", True, step * c, None, 1))
    else:
        pairs.append(("hi", "hi", True, (n - step) * c, None, 2))
    return pairs


def _halves(x, c: int, axis: int = 2) -> dict:
    """{"lo": the first c rows of `axis`, "hi": the next c}, contiguous (the
    kernels' operands); {} for None."""
    if x is None:
        return {}
    return {"lo": x.narrow(axis, 0, c).contiguous(), "hi": x.narrow(axis, c, c).contiguous()}


def _zz_kwargs(window, cap, slopes, rate, seed, idx, step, subid):
    return dict(window=window, logit_softcap=cap, alibi=slopes is not None,
                alibi_slopes=slopes, dropout_rate=rate,
                dropout_seed=_fold_seed(seed, idx, step, subid) if rate else None)


def _zz_forward(q, k, v, seed, slopes, seg_q, seg_k, group, scale, window, cap, rate):
    n, idx = group_size_rank(group)
    b, hq, s_local, d = q.shape
    if s_local % 2:
        raise ValueError(f"the zigzag shard S/n={s_local} must be even")
    c = s_local // 2
    stats = {h: (torch.full((b, hq, c), NEG_INF, device=q.device),
                 torch.zeros((b, hq, c), device=q.device),
                 torch.zeros((b, hq, c, d), device=q.device)) for h in ("lo", "hi")}
    qs, sqs = _halves(q, c), _halves(seg_q, c, 1)
    k_cur, v_cur, sk_cur = k, v, seg_k
    for step in range(n):
        hop = (Hop([x for x in (k_cur, v_cur, sk_cur) if x is not None], group)
               if step < n - 1 else None)
        ks, vs, sks = _halves(k_cur, c), _halves(v_cur, c), _halves(sk_cur, c, 1)
        for qh, kh, causal, off, dyn, subid in _zz_pairs(step, n, idx, c, window,
                                                          slopes is not None):
            o_p, lse_p = flash_attention_forward(
                qs[qh], ks[kh], vs[kh], causal, scale, pos_offset=off, dyn_pos_offset=dyn,
                segment_ids=(sqs[qh], sks[kh]) if sqs else None,
                **_zz_kwargs(window, cap, slopes, rate, seed, idx, step, subid))
            stats[qh] = _merge_partial(*stats[qh], o_p, lse_p)
        if hop is not None:
            received = hop.wait()
            k_cur, v_cur = received[:2]
            sk_cur = received[2] if sk_cur is not None else None
    parts = [_finish(*stats[h], q.dtype) for h in ("lo", "hi")]
    return (torch.cat([parts[0][0], parts[1][0]], dim=2),
            torch.cat([parts[0][1], parts[1][1]], dim=2))


def _zz_backward(q, k, v, o, do, lse, seed, slopes, seg_q, seg_k, group, scale, window, cap,
                 rate):
    n, idx = group_size_rank(group)
    c = q.shape[2] // 2
    qs, os_, dos, lses = _halves(q, c), _halves(o, c), _halves(do, c), _halves(lse, c)
    sqs = _halves(seg_q, c, 1)
    dq = {h: torch.zeros(qs[h].shape, device=q.device) for h in ("lo", "hi")}
    dk_cur = torch.zeros(k.shape, device=k.device)
    dv_cur = torch.zeros(v.shape, device=v.device)
    k_cur, v_cur, sk_cur = k, v, seg_k
    for step in range(n):
        hop = (Hop([x for x in (k_cur, v_cur, sk_cur) if x is not None], group)
               if step < n - 1 else None)
        ks, vs, sks = _halves(k_cur, c), _halves(v_cur, c), _halves(sk_cur, c, 1)
        for qh, kh, causal, off, dyn, subid in _zz_pairs(step, n, idx, c, window,
                                                          slopes is not None):
            dq_p, dk_p, dv_p = flash_attention_backward(
                qs[qh], ks[kh], vs[kh], os_[qh], dos[qh], lses[qh], causal, scale,
                pos_offset=off, dyn_pos_offset=dyn,
                segment_ids=(sqs[qh], sks[kh]) if sqs else None,
                **_zz_kwargs(window, cap, slopes, rate, seed, idx, step, subid))
            dq[qh] += dq_p.float()
            lo = 0 if kh == "lo" else c
            dk_cur[:, :, lo:lo + c] += dk_p.float()
            dv_cur[:, :, lo:lo + c] += dv_p.float()
        if hop is not None:
            received = hop.wait()
            k_cur, v_cur = received[:2]
            sk_cur = received[2] if sk_cur is not None else None
            dk_cur, dv_cur = Hop([dk_cur, dv_cur], group).wait()
    if n > 1:  # the n-th hop brings the accumulators home
        dk_cur, dv_cur = Hop([dk_cur, dv_cur], group).wait()
    return (torch.cat([dq["lo"], dq["hi"]], dim=2).to(q.dtype), dk_cur.to(k.dtype),
            dv_cur.to(v.dtype))


class _Zigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, slopes, seg_q, seg_k, group, scale, window, cap, rate):
        o, lse = _zz_forward(q, k, v, seed, slopes, seg_q, seg_k, group, scale, window, cap,
                             rate)
        ctx.save_for_backward(q, k, v, o, lse, seed, slopes, seg_q, seg_k)
        ctx.cfg = (group, scale, window, cap, rate)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed, slopes, seg_q, seg_k = ctx.saved_tensors
        grads = _zz_backward(q, k, v, o, do.contiguous(), lse, seed, slopes, seg_q, seg_k,
                             *ctx.cfg)
        return (*grads,) + (None,) * 9


def zigzag_ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    alibi_slopes: torch.Tensor | None = None,
    segment_ids=None,
) -> torch.Tensor:
    """Load-balanced causal ring attention of this rank's zigzag shards
    (chunks idx and 2n-1-idx of the sequence in 2n: zigzag_shard, then
    contiguous shards); every rank of `group` calls it. The arguments are
    ring_flash_attention's, always causal; segment_ids in zigzag layout
    too. The (q_hi, k_lo) pair's alignment depends on the rank and the hop:
    with a window or ALiBi it reaches the kernels as dyn_pos_offset."""
    seed = _seed_tensor(dropout_rate, dropout_seed, q.device)
    seg_q, seg_k = _canonical(segment_ids)
    return _Zigzag.apply(q, k, v, seed, _slopes(alibi, alibi_slopes, q.shape[1], q.device),
                         seg_q, seg_k, group, scale, window, logit_softcap, float(dropout_rate))
