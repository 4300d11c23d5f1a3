"""Plain PyTorch attention oracle (counterpart of flashattn_tpu/ops/reference.py),
forward and backward.

All math runs in float32 whatever the input dtype, so the oracle is a
high-precision reference for bf16 kernel outputs.
"""

from __future__ import annotations

import torch


def reference_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused attention returning (O, LSE).

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq (GQA).
      is_causal: query row i sees key column j iff j <= i + pos_offset.
      scale: softmax scale, default 1/sqrt(D).
      pos_offset: q/k alignment; defaults to S_k - S_q (bottom-right, the
        JAX package's convention, not SDPA's top-left one).
      window: sliding window (needs is_causal): row i also needs
        j >= i + pos_offset - window + 1.

    Returns:
      O [B, Hq, S_q, D] in q.dtype and LSE [B, Hq, S_q] float32 in natural
      log. A row that sees no key gets O = 0 and LSE = -inf.
    """
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = 1.0 / d**0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    if hkv != hq:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if is_causal:
        off = s_k - s_q if pos_offset is None else pos_offset
        qi = torch.arange(s_q, device=q.device)[:, None]
        kj = torch.arange(s_k, device=q.device)[None, :]
        hidden = kj > qi + off
        if window is not None:
            hidden |= kj < qi + off - window + 1
        s = s.masked_fill(hidden, float("-inf"))
    elif window is not None:
        raise ValueError("a sliding window needs is_causal")
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p / l_safe, vf)
    lse = (m_safe + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Unfused attention, O only."""
    return reference_attention_with_lse(q, k, v, is_causal, scale, pos_offset, window)[0]


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention gradients from the forward's O and LSE, computed the
    backward kernels' way (a plain version of all three at once):

        P = exp(S*scale - LSE), delta = rowsum(dO*O), dS = P*(dO.V^T - delta),
        dQ = scale*dS.K, dK = scale*dS^T.Q, dV = P^T.dO,

    with dK and dV summed over the q heads of each kv head (GQA). P and dS
    are rounded to the input dtype before the products that consume them,
    as the kernels feed their matrix units. A row whose LSE is -inf (it
    sees no key) contributes exactly 0.

    Returns (dQ in q.dtype, dK and dV in k.dtype), shaped like q, k, v.
    """
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=1)
        vf = vf.repeat_interleave(g, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    live = torch.isfinite(lse)[..., None]  # [B, Hq, S_q, 1]
    if is_causal:
        off = s_k - s_q if pos_offset is None else pos_offset
        qi = torch.arange(s_q, device=q.device)[:, None]
        kj = torch.arange(s_k, device=q.device)[None, :]
        live = live & (kj <= qi + off)
    p = torch.where(live, torch.exp(s - lse[..., None].masked_fill(
        ~torch.isfinite(lse[..., None]), 0.0)), 0.0)
    del s
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    if g > 1:
        dk = dk.view(b, hkv, g, s_k, d).sum(dim=2)
        dv = dv.view(b, hkv, g, s_k, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(k.dtype)
