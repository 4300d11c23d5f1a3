"""Flash-decode (counterpart of flashattn_tpu/ops/decode.py, bf16/f32 cache).

``decode_attention`` and ``decode_attention_chunk`` launch kernel K2
(csrc/decode.cu) on CUDA tensors: split-KV over the cache's positions, then
a merge of the slices. The new tokens' K/V must already be in the cache
(kvcache.update_cache): token t of a T-token chunk sits at position
length - T + t and attends the positions <= its own.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.common import LOG2E, cdiv, round_up, unported
from flashattn_tpu_torch.ops.flash_fwd import DTYPE_CODES, HEAD_DIMS
from flashattn_tpu_torch.ops.kvcache import KVCache

# Kernel launches in this process (set to 0 by callers that count a run).
LAUNCHES = 0

BLOCK_KV = 64  # cache positions per tile in the kernel
# Aim for this many CTAs in the split pass: two per SM of an H100.
TARGET_CTAS = 264


def _check_unported(window, sink, logit_softcap, alibi) -> None:
    if window is not None or sink:
        raise unported("decode window / attention sinks", "A5")
    if logit_softcap:
        raise unported("decode logit soft-capping", "A5")
    if alibi:
        raise unported("decode ALiBi", "A5")


def decode_attention_reference(
    q: torch.Tensor, cache: KVCache, scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: q [B, Hq, T, D] -> [B, Hq, T, D].

    fp32 math. Cache rows at or past a sequence's length are zeroed before
    use, so garbage (even NaN) there cannot reach the result."""
    b, hq, t, d = q.shape
    hkv, s_max = cache.k.shape[1], cache.k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / d**0.5
    length = cache.length.long()
    pos = torch.arange(s_max, device=q.device)
    in_cache = pos[None, :] < length[:, None]  # [B, Smax]
    keep = in_cache[:, None, :, None]
    kf = torch.where(keep, cache.k.float(), 0.0)
    vf = torch.where(keep, cache.v.float(), 0.0)
    # [B, Hq, T, D] -> [B, Hkv, G*T, D]: row r is head r // T, token r % T.
    qf = q.float().reshape(b, hkv, group * t, d)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, Hkv, R, Smax]
    row_pos = (length[:, None] - t
               + torch.arange(group * t, device=q.device)[None, :] % t)  # [B, R]
    visible = in_cache[:, None, :] & (pos[None, None, :] <= row_pos[:, :, None])
    s = s.masked_fill(~visible[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / torch.where(l == 0.0, torch.ones_like(l), l), vf)
    return o.reshape(b, hq, t, d).to(q.dtype)


def _num_splits(b: int, hkv: int, s_max: int) -> tuple[int, int]:
    """(split_len, num_splits): slices of a multiple of BLOCK_KV positions,
    enough of them for TARGET_CTAS blocks where the cache is long enough."""
    want = max(1, cdiv(TARGET_CTAS, b * hkv))
    split_len = round_up(cdiv(s_max, want), BLOCK_KV)
    return split_len, cdiv(s_max, split_len)


def _decode(q: torch.Tensor, cache: KVCache, scale: float | None) -> torch.Tensor:
    b, hq, t, d = q.shape
    if cache.k.dim() != 4 or cache.k.shape != cache.v.shape:
        raise ValueError("cache k/v must be [B, Hkv, Smax, D] of one shape")
    _, hkv, s_max, dk = cache.k.shape
    if cache.k.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(cache.k.shape)}")
    if not (q.device == cache.k.device == cache.v.device == cache.length.device):
        raise ValueError("q and the cache must be on one device")
    if q.device.type == "cpu":
        return decode_attention_reference(q, cache, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if (q.dtype not in DTYPE_CODES or cache.k.dtype != q.dtype
            or cache.v.dtype != q.dtype):
        raise ValueError(f"q {q.dtype} and cache {cache.k.dtype}: need one "
                         f"of {list(DTYPE_CODES)} for both")
    if cache.length.dtype != torch.int32:
        raise ValueError(f"cache length must be int32, got {cache.length.dtype}")
    if not (q.is_contiguous() and cache.k.is_contiguous()
            and cache.v.is_contiguous() and cache.length.is_contiguous()):
        raise ValueError("q and the cache tensors must be contiguous")
    if cache.k.data_ptr() % 16 or cache.v.data_ptr() % 16:
        raise ValueError("cache k and v must start 16-byte aligned")
    if scale is None:
        scale = 1.0 / d**0.5
    rows = (hq // hkv) * t
    split_len, num_splits = _num_splits(b, hkv, s_max)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hkv, num_splits, rows), **f32)
    part_l = torch.empty((b, hkv, num_splits, rows), **f32)
    part_acc = torch.empty((b, hkv, num_splits, rows, d), **f32)
    o = torch.empty_like(q)
    lib = _build.load("decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_launch(
            q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
            cache.length.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), o.data_ptr(), b, hq, hkv, t, s_max, d,
            DTYPE_CODES[q.dtype], split_len, num_splits, scale * LOG2E, stream)
    _build.check(lib, rc, "decode")
    global LAUNCHES
    LAUNCHES += 1
    return o


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
) -> torch.Tensor:
    """One new token per sequence: q [B, Hq, D] -> [B, Hq, D].

    CPU tensors take the plain version. CUDA tensors launch K2 and must be
    contiguous (cache k and v 16-byte aligned), with q and the cache in one
    dtype (bf16 or float32) and D in HEAD_DIMS; anything else raises."""
    _check_unported(window, sink, logit_softcap, alibi)
    return _decode(q[:, :, None], cache, scale)[:, :, 0]


def decode_attention_chunk(
    q: torch.Tensor,
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
) -> torch.Tensor:
    """T new tokens per sequence, causal within the chunk:
    q [B, Hq, T, D] -> [B, Hq, T, D]. Same rules as decode_attention."""
    _check_unported(window, sink, logit_softcap, alibi)
    return _decode(q, cache, scale)
