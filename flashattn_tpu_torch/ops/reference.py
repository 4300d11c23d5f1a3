"""Plain PyTorch attention oracle (counterpart of flashattn_tpu/ops/reference.py),
forward and backward.

All math runs in float32 whatever the input dtype, so the oracle is a
high-precision reference for bf16 kernel outputs. Both functions work one
kv head (and the q heads of its GQA group) at a time: the same arithmetic
as one batched call, with [B, Hq / Hkv, S_q, S_k] temporaries, so that the
plain versions run at a packed training row of 8192 tokens beside a model
on one card.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.common import (
    check_softcap,
    dropout_keep_mask,
    dropout_scale,
    softcap,
)

# Query rows of a dropout mask hashed at a time: the hash's int64
# temporaries stay [B, Hq / Hkv, 256, S_k], a few hundred MB at a training
# shape, beside the [B, Hq / Hkv, S_q, S_k] bool mask.
DROPOUT_ROWS = 256


def visible(s_q: int, s_k: int, is_causal: bool = False, pos_offset: int | None = None,
            window: int | None = None, segment_ids=None,
            device: torch.device | str = "cpu") -> torch.Tensor | None:
    """The [B or 1, 1, S_q, S_k] bool mask of the (row, column) pairs that
    attend, or None when every pair does.

    Row r sees column c iff all of: c <= r + pos_offset when is_causal
    (pos_offset defaults to S_k - S_q); c >= r + pos_offset - window + 1
    with a window (without is_causal its left edge alone: the
    dyn_pos_offset calls of the zigzag ring); seg_q[b, r] == seg_k[b, c]
    with segment_ids = (seg_q [B, S_q], seg_k [B, S_k])."""
    mask = None
    if is_causal or window is not None:
        off = s_k - s_q if pos_offset is None else pos_offset
        qi = torch.arange(s_q, device=device)[:, None]
        kj = torch.arange(s_k, device=device)[None, :]
        mask = kj <= qi + off if is_causal else None
        if window is not None:
            left = kj >= qi + off - window + 1
            mask = left if mask is None else mask & left
        mask = mask[None, None]
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        same = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    return mask


def alibi_bias(slopes: torch.Tensor, s_q: int, s_k: int,
               pos_offset: int | None = None) -> torch.Tensor:
    """[1, H, S_q, S_k] float32 ALiBi bias slope_h * (col - row - pos_offset)
    (pos_offset defaults to S_k - S_q): 0 on the causal diagonal, falling
    linearly into the past, as the JAX oracle adds it to the scaled logits."""
    off = s_k - s_q if pos_offset is None else pos_offset
    dist = (torch.arange(s_k, device=slopes.device)[None, :]
            - torch.arange(s_q, device=slopes.device)[:, None] - off).float()
    return slopes.float()[None, :, None, None] * dist[None, None]


def dropout_keep(seed, rate: float, b: int, hq: int, heads: slice, s_q: int, s_k: int,
                 device, row0: int = 0) -> torch.Tensor:
    """The [B, len(heads), S_q, S_k] bool keep mask of the q heads `heads`
    (common.dropout_keep_mask: bh = b * Hq + h, the arrays' rows and
    columns; the rows start at row0, where q is rows [row0, row0 + S_q) of
    a larger call), hashed DROPOUT_ROWS query rows at a time."""
    bh = (torch.arange(b, device=device)[:, None] * hq
          + torch.arange(heads.start, heads.stop, device=device)[None, :])[:, :, None, None]
    cols = torch.arange(s_k, device=device)
    keep = torch.empty((b, heads.stop - heads.start, s_q, s_k), dtype=torch.bool, device=device)
    for r0 in range(0, s_q, DROPOUT_ROWS):
        rows = row0 + torch.arange(r0, min(s_q, r0 + DROPOUT_ROWS), device=device)[:, None]
        keep[:, :, r0:r0 + DROPOUT_ROWS] = dropout_keep_mask(seed, bh, rows, cols, rate)
    return keep


def reference_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_row0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused attention returning (O, LSE).

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq (GQA).
      is_causal: query row i sees key column j iff j <= i + pos_offset.
      scale: softmax scale, default 1/sqrt(D).
      pos_offset: q/k alignment; defaults to S_k - S_q (bottom-right, the
        JAX package's convention, not SDPA's top-left one).
      window: sliding window: row i also needs
        j >= i + pos_offset - window + 1 (without is_causal the left edge
        alone, as dyn_pos_offset calls take it).
      segment_ids: (seg_q [B, S_q], seg_k [B, S_k]) packed-document ids:
        row i also needs seg_q[b, i] == seg_k[b, j].
      logit_softcap: cap * tanh(s / cap) on the scaled logits, before any
        mask (Gemma-2); None or 0 is off.
      alibi_slopes: (Hq,) slopes of ALiBi (alibi_bias: slope_h * (j - i -
        pos_offset) added to the scaled logits, the query head's slope
        under GQA), or None for none.
      dropout_rate, dropout_seed: attention dropout (rate in [0, 1), 0 off,
        checked by the callers): the unnormalised probabilities that meet V
        keep dropout_keep's elements, times dropout_scale(rate), the
        others 0; the row sums, and so the LSE, stay those without
        dropout, as in the JAX kernels.
      dropout_row0: the array row of q's first row, where q is a slice of
        the rows of a larger call (the mask keys on the arrays' rows; with
        is_causal pass that call's pos_offset + dropout_row0 as pos_offset).

    Returns:
      O [B, Hq, S_q, D] in q.dtype and LSE [B, Hq, S_q] float32 in natural
      log. A row that sees no key gets O = 0 and LSE = -inf.
    """
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    cap = check_softcap(logit_softcap)
    mask = visible(s_q, s_k, is_causal, pos_offset, window, segment_ids, q.device)
    outs, lses = [], []
    for h in range(hkv):
        qf = q[:, h * g:(h + 1) * g].float()
        kf, vf = k[:, h:h + 1].float(), v[:, h:h + 1].float()
        s = softcap(torch.matmul(qf, kf.transpose(-1, -2)) * scale, cap)
        if alibi_slopes is not None:
            s = s + alibi_bias(alibi_slopes[h * g:(h + 1) * g], s_q, s_k, pos_offset)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m_safe)
        del s
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        if dropout_rate:
            keep = dropout_keep(dropout_seed, dropout_rate, b, hq, slice(h * g, (h + 1) * g),
                                s_q, s_k, q.device, dropout_row0)
            p = torch.where(keep, p * dropout_scale(dropout_rate), 0.0)
            del keep
        outs.append(torch.matmul(p / l_safe, vf).to(q.dtype))
        lses.append((m_safe + torch.log(l))[..., 0])
        del p
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """Unfused attention, O only."""
    return reference_attention_with_lse(q, k, v, is_causal, scale, pos_offset, window,
                                        segment_ids, logit_softcap, alibi_slopes,
                                        dropout_rate, dropout_seed)[0]


def reference_attention_backward(
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
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_row0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention gradients from the forward's O and LSE, computed the
    backward kernels' way (a plain version of all three at once):

        P = exp(S*scale - LSE), delta = rowsum(dO*O), dS = P*(dO.V^T - delta),
        dQ = scale*dS.K, dK = scale*dS^T.Q, dV = P^T.dO,

    over the pairs that attend (`visible`: causal, window, segment ids), with
    dK and dV summed over the q heads of each kv head (GQA). With a logit
    soft-cap the logit is cap*t for t = tanh(S*scale/cap), P = exp(cap*t -
    LSE), and dS takes the tanh's derivative, times 1 - t^2 (computed as
    (1 - t)(1 + t)); dQ and dK keep the factor scale, since
    d(cap*tanh(x*scale/cap))/dx = scale*(1 - t^2). With alibi_slopes (Hq,)
    the logit also takes alibi_bias, as reference_attention_with_lse adds
    it; the bias has no gradient, so dS, dQ, dK and dV keep their formulas.
    With dropout (dropout_rate > 0) the forward's keep mask M is rebuilt
    (dropout_keep) and c = dropout_scale(rate): dV = c (M*P)^T.dO, dP
    becomes c M*dP, and dS = P*(c M*dP - delta) with the clean P; delta
    comes from the dropped O; dropout_row0 as the forward takes it (on a
    slice of q's rows, dQ is those rows' and dK, dV their share). P (M*P
    with dropout, c applied after the product) and dS are rounded to the
    input dtype before the products that consume them, as the kernels feed
    their matrix units. A row whose LSE is -inf (it sees no key)
    contributes exactly 0.

    Returns (dQ in q.dtype, dK and dV in k.dtype), shaped like q, k, v.
    """
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    cap = check_softcap(logit_softcap)
    mask = visible(s_q, s_k, is_causal, pos_offset, window, segment_ids, q.device)
    dqs, dks, dvs = [], [], []
    for h in range(hkv):
        heads = slice(h * g, (h + 1) * g)
        qf, dof = q[:, heads].float(), do[:, heads].float()
        kf, vf = k[:, h:h + 1].float(), v[:, h:h + 1].float()
        lse_h = lse[:, heads, :, None]
        live = torch.isfinite(lse_h)  # [B, g, S_q, 1]
        if mask is not None:
            live = live & mask
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        t = None
        if cap is not None:
            t = torch.tanh(s / cap)
            s = cap * t
        if alibi_slopes is not None:
            s = s + alibi_bias(alibi_slopes[heads], s_q, s_k, pos_offset)
        p = torch.where(live, torch.exp(s - lse_h.masked_fill(~torch.isfinite(lse_h), 0.0)),
                        0.0)
        del s, live
        delta = (dof * o[:, heads].float()).sum(dim=-1, keepdim=True)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        if dropout_rate:
            keep = dropout_keep(dropout_seed, dropout_rate, b, hq, heads, s_q, s_k, q.device,
                                dropout_row0)
            c = dropout_scale(dropout_rate)
            dp = torch.where(keep, dp * c, 0.0)
        ds = p * (dp - delta)
        del dp
        if t is not None:
            ds = ds * ((1.0 - t) * (1.0 + t))
            del t
        if dropout_rate:
            p = torch.where(keep, p, 0.0)  # dV sees the dropped P; c after the product
            del keep
        p = p.to(q.dtype).float()
        ds = ds.to(q.dtype).float()
        dqs.append((torch.matmul(ds, kf) * scale).to(q.dtype))
        dks.append((torch.matmul(ds.transpose(-1, -2), qf) * scale).sum(dim=1, keepdim=True))
        dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=1, keepdim=True)
        dvs.append(dv * c if dropout_rate else dv)
        del p, ds
    return (torch.cat(dqs, dim=1), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(k.dtype))
