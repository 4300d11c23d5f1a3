"""Dense KV cache with optional int8/fp8 quantization (counterpart of
flashattn_tpu/ops/kvcache.py).

Unlike the JAX cache, which every update returns anew, this cache is updated
in place: an append writes its T new rows into the existing buffers, which
saves a full copy of the cache on every step. The semantics are otherwise
the JAX package's, bit for bit.

Quantized caches store per-token, per-kv-head symmetric scales
(scale = amax(|x_t|) / qmax) as [B, Hkv, 1, Smax] float32 beside int8 or
float8_e4m3fn values; flash-decode folds k_scale into the logits and v_scale
into P, as the JAX kernel does.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattn_tpu_torch.ops.common import card_device

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
INT8_MAX = 127.0


@dataclasses.dataclass
class KVCache:
    """KV cache of one layer."""

    k: torch.Tensor  # [B, Hkv, Smax, D]: bf16 | f32 | int8 | fp8
    v: torch.Tensor  # [B, Hkv, Smax, D]
    length: torch.Tensor  # [B] int32: valid tokens per sequence
    k_scale: torch.Tensor | None = None  # [B, Hkv, 1, Smax] f32 (None unquantized)
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def store_dtype_for(quant: str | None, dtype: torch.dtype) -> tuple[torch.dtype, bool]:
    """(storage dtype, has_scales) of a quant mode: the one dispatch shared by
    the dense and paged cache constructors."""
    if quant is None:
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"cache dtype {dtype}: need bfloat16 or float32")
        return dtype, False
    if quant == "int8":
        return torch.int8, True
    if quant == "fp8":
        return FP8_DTYPE, True
    raise ValueError(f"unknown quant mode {quant!r}")


def init_cache(
    batch: int,
    num_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quant: str | None = None,  # None | "int8" | "fp8"
    device: torch.device | str = "cuda",
) -> KVCache:
    store_dtype, scales = store_dtype_for(quant, dtype)
    device = card_device(device)
    shape = (batch, num_kv_heads, max_len, head_dim)

    def ones():
        return torch.ones((batch, num_kv_heads, 1, max_len), dtype=torch.float32,
                          device=device)

    return KVCache(
        k=torch.zeros(shape, dtype=store_dtype, device=device),
        v=torch.zeros(shape, dtype=store_dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ones() if scales else None,
        v_scale=ones() if scales else None,
    )


def quantize_tokens(x: torch.Tensor, store_dtype: torch.dtype
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, Hkv, T, D] -> (values [B, Hkv, T, D], scales [B, Hkv, 1, T] f32).

    The JAX arithmetic as its jitted steps run it: f32 amax over D, scale =
    max(amax * f32(1 / qmax), 1e-8) (XLA compiles the package's division by
    the constant qmax into that product), x / scale as an f32 division, then
    round half to even and clip (int8) or the round-to-nearest-even cast
    (e4m3)."""
    xf = x.float()
    qmax = INT8_MAX if store_dtype == torch.int8 else FP8_MAX
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * (1.0 / qmax), 1e-8)  # [B, Hkv, T]
    scaled = xf / scale[..., None]
    if store_dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = scaled.to(store_dtype)
    return q, scale[:, :, None, :]


def dequantize(values: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    """Plain dequant: [B, Hkv, S, D] x [B, Hkv, 1, S] -> bf16 (JAX's oracle)."""
    if scales is None:
        return values
    return (values.float() * scales.transpose(2, 3)).to(torch.bfloat16)


def update_cache(
    cache: KVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    active: torch.Tensor | None = None,
    assume_fits: bool = False,
) -> KVCache:
    """Append T new tokens per sequence at its current length, IN PLACE.

    k_new/v_new: [B, Hkv, T, D] in the compute dtype; a quantized cache
    quantizes them on insert. `active` [B] bool: inactive rows neither write
    nor advance. An append past capacity is dropped: the row keeps its
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
    if cache.quantized:
        k_q, k_s = quantize_tokens(k_new, cache.k.dtype)
        v_q, v_s = quantize_tokens(v_new, cache.v.dtype)
        writes = ((cache.k, k_q, 2), (cache.v, v_q, 2),
                  (cache.k_scale, k_s, 3), (cache.v_scale, v_s, 3))
    else:
        writes = ((cache.k, k_new, 2), (cache.v, v_new, 2))
    start = length.clamp(max=s_max - t).long()
    pos = start[:, None] + torch.arange(t, device=length.device)  # [B, T]
    for buf, new, dim in writes:
        new = new.to(buf.dtype)
        # Positions on `dim` (2 for values, 3 for scales), broadcast over the rest.
        shape = [b, 1, 1, 1]
        shape[dim] = t
        idx = pos.view(shape).expand(new.shape)
        if active is not None:
            # Rows that do not write put back what is there.
            cur = _raw(buf).gather(dim, idx)
            new = torch.where(active.view(b, 1, 1, 1), _raw(new), cur)
        _raw(buf).scatter_(dim, idx, _raw(new))
    advance = t if active is None else t * active.to(torch.int32)
    cache.length += advance
    return cache


def _raw(x: torch.Tensor) -> torch.Tensor:
    """float8 bytes as uint8: fp8 has no gather, scatter, where or indexed
    copy kernels of its own on every device, and the bytes move bit for bit."""
    return x.view(torch.uint8) if x.dtype == FP8_DTYPE else x


def write_slot(batch: KVCache, single: KVCache, slot: int) -> KVCache:
    """Install a B=1 cache into row `slot` of a batch cache, IN PLACE.

    The whole buffer row (and its scales) is copied and the slot's length
    set to the single cache's (continuous-batching admission). Returns
    `batch`."""
    if single.k.shape[0] != 1 or single.k.shape[1:] != batch.k.shape[1:]:
        raise ValueError(
            f"single cache {tuple(single.k.shape)} does not fit a row of "
            f"{tuple(batch.k.shape)}")
    if single.quantized != batch.quantized or single.k.dtype != batch.k.dtype:
        raise ValueError("single and batch caches differ in quantization")
    batch.k[slot].copy_(single.k[0])
    batch.v[slot].copy_(single.v[0])
    if batch.quantized:
        batch.k_scale[slot].copy_(single.k_scale[0])
        batch.v_scale[slot].copy_(single.v_scale[0])
    batch.length[slot] = single.length[0]
    return batch
