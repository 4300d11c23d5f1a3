"""Variable-length (packed / cu_seqlens) flash attention (counterpart of
flashattn_tpu/ops/varlen.py).

Documents packed along the sequence carry an int32 id per token, and the
kernels mask on seg_q[i] == seg_k[j]: K1 in the forward, the backward
kernels in the gradient (ops/attention.py's autograd Function carries the
ids). ``cu_seqlens`` converts to ids.

Conventions, as in the JAX package: query padding gets id -1 and key
padding -2, so padded rows match nothing (O = 0, LSE = -inf, zero
gradients) and padded keys are invisible.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.attention import flash_attention


def segment_ids_from_cu_seqlens(cu_seqlens: torch.Tensor, total_len: int) -> torch.Tensor:
    """cu_seqlens [N+1] (monotone prefix sums, cu[0] = 0) -> segment ids
    [total_len] int32 on cu_seqlens' device; positions at or after cu[-1]
    get -1 (padding). An empty sequence takes no position, so its id is
    skipped."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total_len, dtype=torch.int32, device=cu.device)
    ids = torch.searchsorted(cu, pos, right=True).to(torch.int32) - 1
    return torch.where(pos < cu[-1], ids, torch.full_like(ids, -1))


def canonical_segments(seg_q: torch.Tensor, seg_k: torch.Tensor, device: torch.device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg_q, seg_k) as int32 contiguous tensors on `device`, q-side ids < 0
    set to -1 and k-side ids < 0 to -2, so that a padding row sees no key."""
    seg_q = torch.as_tensor(seg_q, device=device)
    seg_k = torch.as_tensor(seg_k, device=device)
    seg_q = torch.where(seg_q < 0, -1, seg_q).to(torch.int32).contiguous()
    seg_k = torch.where(seg_k < 0, -2, seg_k).to(torch.int32).contiguous()
    return seg_q, seg_k


def flash_attention_varlen(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids=None,
    cu_seqlens: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable packed-sequence flash attention -> O [B, Hq, S_q, D].

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] (usually B = 1, everything
        packed along S).
      segment_ids: [B, S] ids shared by q and k, or a (seg_q [B, S_q],
        seg_k [B, S_k]) pair for packed cross-attention. Ids < 0 are padding.
      cu_seqlens: instead of segment_ids, [N+1] prefix sums over the packed
        length (B == 1 and S_q == S_k).
      is_causal: causal within each document (positions are monotone
        inside a packed document, so the global causal mask restricted by
        the ids is each document's).
      window: sliding window (needs is_causal). It depends only on q_pos -
        k_pos, so the global window restricted by the ids is each
        document's.
      logit_softcap: cap * tanh(s / cap) on the scaled logits, before the
        mask (Gemma-2), in the forward and the backward.
      alibi, alibi_slopes: ALiBi (as flash_attention takes them; None
        slopes take the standard table), in the forward and the backward.
        The bias slope_h * (k_pos - q_pos) uses the global packed positions:
        it depends only on their difference, so within a document it is the
        document's own bias, and pairs of two documents are masked by the
        ids.

    Fully padded rows get O = 0 and gradients 0.
    """
    if (segment_ids is None) == (cu_seqlens is None):
        raise ValueError("pass exactly one of segment_ids / cu_seqlens")
    if cu_seqlens is not None:
        if q.shape[0] != 1 or q.shape[2] != k.shape[2]:
            raise ValueError("cu_seqlens mode packs one batch row with S_q == S_k")
        seg_q = seg_k = segment_ids_from_cu_seqlens(cu_seqlens, q.shape[2])[None]
    elif isinstance(segment_ids, (tuple, list)):
        seg_q, seg_k = segment_ids
    else:
        seg_q = seg_k = segment_ids
    segs = canonical_segments(seg_q, seg_k, q.device)
    return flash_attention(q, k, v, is_causal=is_causal, scale=scale, window=window,
                           segment_ids=segs, logit_softcap=logit_softcap, alibi=alibi,
                           alibi_slopes=alibi_slopes)
