"""Public flash-attention entry point (counterpart of flashattn_tpu/ops/attention.py).

Forward only: the backward kernels (B3-B5) and the autograd Function that
keeps (q, k, v, o, lse) as residuals come with their port.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash_fwd import flash_attention_forward


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
) -> torch.Tensor:
    """Fused flash attention -> O [B, Hq, S_q, D] in q.dtype.

    q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq. The
    causal mask aligns bottom-right unless pos_offset says otherwise. As the
    JAX primal does when no gradient is taken, the LSE is not written.
    """
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError("backward kernels B3-B5: ROADMAP A3")
    o, _ = flash_attention_forward(q, k, v, is_causal=is_causal, scale=scale,
                                   pos_offset=pos_offset, need_lse=False)
    return o
