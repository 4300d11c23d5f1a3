"""Dense KV cache (counterpart of flashattn_tpu/ops/kvcache.py, bf16/f32 only).

Unlike the JAX cache, which every update returns anew, this cache is updated
in place: an append writes its T new rows into the existing buffers, which
saves a full copy of the cache on every step. The semantics are otherwise
the JAX package's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattn_tpu_torch.ops.common import card_device, unported


@dataclasses.dataclass
class KVCache:
    """KV cache of one layer."""

    k: torch.Tensor  # [B, Hkv, Smax, D]
    v: torch.Tensor  # [B, Hkv, Smax, D]
    length: torch.Tensor  # [B] int32: valid tokens per sequence

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(
    batch: int,
    num_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quant: str | None = None,
    device: torch.device | str = "cuda",
) -> KVCache:
    if quant is not None:
        raise unported(f"{quant} KV cache", "A5")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"cache dtype {dtype}: need bfloat16 or float32")
    device = card_device(device)
    shape = (batch, num_kv_heads, max_len, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def update_cache(
    cache: KVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    active: torch.Tensor | None = None,
    assume_fits: bool = False,
) -> KVCache:
    """Append T new tokens per sequence at its current length, IN PLACE.

    k_new/v_new: [B, Hkv, T, D]. `active` [B] bool: inactive rows neither
    write nor advance. An append past capacity is dropped: the row keeps its
    buffer and its length. `assume_fits=True` (prefill into a fresh cache)
    skips that guard and the read-back it needs. As in the JAX cache the
    write starts at min(length, Smax - T). Returns `cache`, now updated.
    """
    b, hkv, t, d = k_new.shape
    s_max = cache.k.shape[2]
    if t > s_max:
        raise ValueError(f"append of {t} tokens exceeds max_len {s_max}")
    length = cache.length
    if not assume_fits:
        fits = length + t <= s_max
        active = fits if active is None else (active & fits)
    start = length.clamp(max=s_max - t).long()
    pos = start[:, None] + torch.arange(t, device=length.device)  # [B, T]
    idx = pos[:, None, :, None].expand(b, hkv, t, d)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        new = new.to(buf.dtype)
        if active is not None:
            # Rows that do not write put back what is there.
            cur = buf.gather(2, idx)
            new = torch.where(active[:, None, None, None], new, cur)
        buf.scatter_(2, idx, new)
    advance = t if active is None else t * active.to(torch.int32)
    cache.length += advance
    return cache


def write_slot(batch: KVCache, single: KVCache, slot: int) -> KVCache:
    """Install a B=1 cache into row `slot` of a batch cache, IN PLACE.

    The whole buffer row is copied and the slot's length set to the single
    cache's (continuous-batching admission). Returns `batch`."""
    if single.k.shape[0] != 1 or single.k.shape[1:] != batch.k.shape[1:]:
        raise ValueError(
            f"single cache {tuple(single.k.shape)} does not fit a row of "
            f"{tuple(batch.k.shape)}")
    batch.k[slot].copy_(single.k[0])
    batch.v[slot].copy_(single.v[0])
    batch.length[slot] = single.length[0]
    return batch
