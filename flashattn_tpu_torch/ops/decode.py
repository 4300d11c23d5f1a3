"""Flash-decode (counterpart of flashattn_tpu/ops/decode.py).

``decode_attention`` and ``decode_attention_chunk`` launch kernel K2
(csrc/decode.cuh; built as csrc/decode.cu, csrc/decode_alibi.cu for ALiBi,
and csrc/decode_d256.cu and csrc/decode_alibi_d256.cu at D 256) on CUDA
tensors: split-KV over the cache's positions, the
query rows tiled over the grid, the products on the tensor cores (an f32
cache's on the CUDA cores), then a second kernel merging the slices. The
cache may be bf16/f32 or quantized (int8, fp8); no PyTorch kernel runs
around the two. The new tokens' K/V must already be in the cache
(kvcache.update_cache): token t of a T-token chunk sits at position
length - T + t and attends the positions <= its own.

A sliding window (and attention sinks inside it) narrows what a row sees:
the row at cache position row_pos sees position pos iff pos <= row_pos and
(pos > row_pos - window or pos < sink). The kernel reads only the sink
tiles and the tiles from the earliest row's window on, found from the
device-side length, so a long cache streams O(window + T + sink) bytes.

In the int8 mode both products run on integers, as in the JAX kernel: q is
quantized per row (inside the kernel, with ``prep_decode_q``'s arithmetic),
the logits are int(q·k) x q_scale x k_scale, and P x v_scale is requantized
per row and 64-position tile to int8 before P·V. The fp8 mode converts k
and v exactly and folds k_scale into the logits and v_scale into P.

A logit soft-cap (Gemma-2) goes on the dequantized, scaled logits before
any mask, as in the JAX kernel: q is pre-scaled by `scale` alone (in the
int8 mode before it is quantized), and the logits become
tanh(s * (1 / cap)) * cap * log2(e) in the exp2 domain.

ALiBi adds slope_h * (pos - row_pos) to the scaled logits before the masks
(in the exp2 domain slope_h * log2(e) * (pos - row_pos), as in the JAX
kernel), h the row's query head; the slopes come from
flash_fwd.alibi_table. ``_decode_attention(with_lse=True)`` also returns
the rows' natural-log LSE, -inf for a row that sees no key.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.common import LN2, LOG2E, cdiv, check_softcap, round_up, softcap
from flashattn_tpu_torch.ops.flash_fwd import DTYPE_CODES, HEAD_DIMS, alibi_table, head_tile
from flashattn_tpu_torch.ops.kvcache import FP8_DTYPE, INT8_MAX, KVCache

# Kernel launches in this process, by the cache's mode (set to 0 by callers
# that count a run), and those with a sliding window, a logit soft-cap,
# ALiBi or the LSE output in any mode (counted in both). Paged launches
# count in ops/paged.py.
LAUNCHES = 0  # bf16/f32 cache
INT8_LAUNCHES = 0
FP8_LAUNCHES = 0
WINDOW_LAUNCHES = 0
SOFTCAP_LAUNCHES = 0
ALIBI_LAUNCHES = 0
LSE_LAUNCHES = 0

BLOCK_KV = 64  # cache positions per tile in the kernel (and int8 P requantization block)
# A requantization block whose largest P x v_scale is below this becomes zeros
# (csrc/decode.cuh kRmaxMin): 127 / rmax must stay finite.
RMAX_MIN = 2.0**-100
# Query rows per CTA, and tiles a CTA takes at a time (csrc/decode.cuh
# launch_rows): up to FEW_ROWS rows (a decode step's group), the 4 warps
# share the rows and take a tile each; more rows, a warp owns 16 of 64 and
# the warps walk the same tiles.
FEW_ROWS = 16
ROW_BLOCK = 64
# Aim for this many CTAs in the split pass: two per SM of an H100.
TARGET_CTAS = 264
# Storage dtype -> the kernel's cache-type code (csrc/common.cuh DType).
CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, FP8_DTYPE: 3}


def pre_scale(scale: float, cap: float | None) -> float:
    """What q is scaled by before the products (prep_decode_q's `pre`):
    scale * log2(e), or `scale` alone under a soft-cap, whose tanh takes
    the true logits (the JAX launcher's rule)."""
    return scale * LOG2E if cap is None else scale


def softcap_log2(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    """The JAX kernel's soft-cap of true logits into the exp2 domain:
    tanh(s * (1 / cap)) * (cap * log2(e)); identity without a cap."""
    return s if cap is None else torch.tanh(s * (1.0 / cap)) * (cap * LOG2E)


def check_window(window: int | None, sink: int) -> None:
    """A window is a positive int or None; sink, the always-visible first
    positions, a non-negative int that needs a window (as in the JAX
    launcher)."""
    if window is not None and (isinstance(window, bool) or not isinstance(window, int)
                               or window < 1):
        raise ValueError(f"window must be a positive int or None, got {window!r}")
    if isinstance(sink, bool) or not isinstance(sink, int) or sink < 0:
        raise ValueError(f"sink must be a non-negative int, got {sink!r}")
    if sink and window is None:
        raise ValueError("attention sinks need a window")


def visible_positions(length: torch.Tensor, s_max: int, t: int, rows: int,
                      window: int | None = None, sink: int = 0) -> torch.Tensor:
    """[B, R, Smax] bool: row r (token r % T, at cache position
    length - T + r % T) sees position pos iff pos < length, pos <= its
    own and, with a window, pos > its own - window or pos < sink."""
    length = length.long()
    pos = torch.arange(s_max, device=length.device)[None, None, :]
    row_pos = row_positions(length, t, rows)
    seen = (pos < length[:, None, None]) & (pos <= row_pos)
    if window is not None:
        seen &= (pos > row_pos - window) | (pos < sink)
    return seen


def row_positions(length: torch.Tensor, t: int, rows: int) -> torch.Tensor:
    """[B, R, 1] int64: row r's cache position, length - T + r % T."""
    length = length.long()
    return (length[:, None] - t
            + torch.arange(rows, device=length.device)[None, :] % t)[:, :, None]


def row_distances(length: torch.Tensor, s_max: int, t: int, rows: int) -> torch.Tensor:
    """[B, 1, R, Smax] float32 pos - row_pos, ALiBi's distance."""
    pos = torch.arange(s_max, device=length.device)[None, None, :]
    return (pos - row_positions(length, t, rows)).float()[:, None]


def row_slopes(slopes: torch.Tensor, hkv: int, t: int) -> torch.Tensor:
    """(Hq,) slopes -> [1, Hkv, R, 1], row r of group hk taking its query
    head's, hk * G + r // T."""
    return slopes.reshape(hkv, -1).repeat_interleave(t, dim=1)[None, :, :, None]


def prep_decode_q(q: torch.Tensor, hkv: int, int8_mode: bool, pre: float):
    """q [B, Hq, T, D] -> grouped [B, Hkv, G*T, D] rows scaled by `pre`, and
    in the int8 mode quantized per row: (int8 rows, q_scale [B, Hkv, R, 1]),
    with the arithmetic of the JAX launcher as XLA compiles it (the amax
    times f32(1 / 127), as in kvcache.quantize_tokens)."""
    b, hq, t, d = q.shape
    q_pre = (q.float() * pre).reshape(b, hkv, (hq // hkv) * t, d)
    if int8_mode:
        q_scale = torch.clamp_min(
            q_pre.abs().amax(dim=-1, keepdim=True) * (1.0 / INT8_MAX), 1e-8)
        q8 = torch.clamp(torch.round(q_pre / q_scale), -INT8_MAX, INT8_MAX)
        return q8.to(torch.int8), q_scale
    return q_pre.to(q.dtype), None


def jax_int8_block(s_max: int) -> int:
    """The block over which the JAX kernel requantizes P in the int8 mode:
    its default block_kv (4096), clamped to Smax and stepped down by 128
    until it divides Smax (flashattn_tpu/ops/decode.py:382-392)."""
    block = min(4096, s_max)
    while s_max % block:
        block -= 128
    return block


def decode_attention_reference(
    q: torch.Tensor, cache: KVCache, scale: float | None = None,
    requant_block: int | None = None, window: int | None = None, sink: int = 0,
    logit_softcap: float | None = None, alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None, with_lse: bool = False,
):
    """Plain PyTorch version of K2: q [B, Hq, T, D] -> [B, Hq, T, D], and
    with `with_lse` (o, the rows' LSE [B, Hq, T] float32 in natural log,
    -inf for a row that sees no key).

    fp32 math. Cache rows at or past a sequence's length are zeroed before
    use, so garbage (even NaN) there cannot reach the result. An int8 cache
    requantizes P over blocks of `requant_block` positions: by default the
    JAX kernel's block (jax_int8_block), which makes this the JAX kernel's
    arithmetic; BLOCK_KV gives the CUDA kernel's. `window` and `sink` as in
    visible_positions; `logit_softcap` caps the scaled logits before the
    masks; `alibi` (with `alibi_slopes`, as flash_fwd.alibi_table takes
    them) adds slope_h * (pos - row_pos) to them."""
    check_window(window, sink)
    cap = check_softcap(logit_softcap)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, cap)
    if cache.quantized:
        o, lse = _quantized_reference(q, cache, scale, requant_block, window, sink, cap,
                                      slopes)
        return (o, lse) if with_lse else o
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
    s = softcap(s, cap)
    if slopes is not None:
        s = s + row_slopes(slopes, hkv, t) * row_distances(length, s_max, t, group * t)
    visible = visible_positions(length, s_max, t, group * t, window, sink)
    s = s.masked_fill(~visible[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / torch.where(l == 0.0, torch.ones_like(l), l), vf)
    o = o.reshape(b, hq, t, d).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.where(l > 0.0, m + torch.log(l), float("-inf"))
    return o, lse.reshape(b, hq, t)


def _quantized_reference(q: torch.Tensor, cache: KVCache, scale: float | None,
                         requant_block: int | None, window: int | None,
                         sink: int, cap: float | None, slopes: torch.Tensor | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's int8 and fp8 modes, in the JAX kernel's order of
    operations (log2 domain, k_scale on the logits, v_scale on P, ALiBi's
    slope * log2(e) * distance added after the scales). In the int8 mode the
    row streams in blocks, as in the kernels: each block's P x v_scale (P
    against the running row maximum) is requantized to int8 over the block,
    and the partial sums merge online. Returns (o, natural-log LSE)."""
    b, hq, t, d = q.shape
    hkv, s_max = cache.k.shape[1], cache.k.shape[2]
    rows = (hq // hkv) * t
    if scale is None:
        scale = 1.0 / d**0.5
    int8_mode = cache.k.dtype == torch.int8
    length = cache.length.long()
    pos = torch.arange(s_max, device=q.device)
    in_cache = pos[None, :] < length[:, None]  # [B, Smax]
    keep = in_cache[:, None, :, None]
    kf = torch.where(keep, cache.k.float(), 0.0)
    vf = torch.where(keep, cache.v.float(), 0.0)
    k_scale = torch.where(in_cache[:, None, None, :], cache.k_scale, 0.0)  # [B,Hkv,1,Smax]
    v_scale = torch.where(in_cache[:, None, None, :], cache.v_scale, 0.0)
    q_rows, q_scale = prep_decode_q(q, hkv, int8_mode, pre_scale(scale, cap))
    s = torch.matmul(q_rows.float(), kf.transpose(-1, -2))  # [B, Hkv, R, Smax]
    s = softcap_log2(s * (q_scale * k_scale) if int8_mode else s * k_scale, cap)
    if slopes is not None:
        s = s + (row_slopes(slopes, hkv, t) * LOG2E) * row_distances(length, s_max, t, rows)
    visible = visible_positions(length, s_max, t, rows, window, sink)
    s = s.masked_fill(~visible[:, None], float("-inf"))
    block = (requant_block or jax_int8_block(s_max)) if int8_mode else s_max
    m_run = torch.full(s.shape[:-1] + (1,), float("-inf"), device=q.device)
    l = torch.zeros_like(m_run)
    acc = torch.zeros(s.shape[:-1] + (d,), device=q.device)
    for n0 in range(0, s_max, block):
        sj = s[..., n0:n0 + block]
        m_new = torch.maximum(m_run, sj.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha = torch.exp2(m_run - m_safe)
        p = torch.exp2(sj - m_safe)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pvs = p * v_scale[..., n0:n0 + block]
        if int8_mode:
            rmax = pvs.amax(dim=-1, keepdim=True)
            rmax = torch.where(rmax < RMAX_MIN, torch.ones_like(rmax), rmax)
            p8 = torch.round(pvs * (127.0 / rmax))
            pv = torch.matmul(p8, vf[:, :, n0:n0 + block]) * (rmax / 127.0)
        else:
            pv = torch.matmul(pvs, vf[:, :, n0:n0 + block])
        acc = acc * alpha + pv
        m_run = m_new
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, (m_run + torch.log2(l)) * LN2, float("-inf"))
    return o.reshape(b, hq, t, d).to(q.dtype), lse.reshape(b, hq, t)


def _layout(rows: int, halves: bool = False) -> tuple[int, int]:
    """(query rows a CTA, tiles it takes at a time) for `rows` rows a group.
    With up to FEW_ROWS rows the 4 warps take 4 tiles at a time, with more
    a warp owns 16 of ROW_BLOCK rows. With `halves` (split_dims: D 256) two
    warps share each 16 rows and tile, each with half of O's dims: 2 tiles
    at a time, or ROW_BLOCK / 2 rows (csrc/decode.cuh MmaLayout)."""
    if rows <= FEW_ROWS:
        return FEW_ROWS, (2 if halves else 4)
    return (ROW_BLOCK // 2 if halves else ROW_BLOCK), 1


def split_dims(cache_dtype: torch.dtype, d: int) -> bool:
    """Whether K2's tensor-core kernel splits O's dims between two warps
    (_layout's `halves`): at D 256; the float32 kernel tiles its own way."""
    return cache_dtype != torch.float32 and d > 128


def live_span(s_max: int, t: int, window: int | None, sink: int) -> int:
    """The most positions a sequence's rows can see, as the kernel walks
    them: the sink tiles, then the tiles from the one holding the earliest
    row's window edge to the length (at most window + T - 1 positions and
    the edge tile's 63 before them); the whole cache without a window.
    csrc/decode.cuh::live_span computes the same."""
    if window is None:
        return s_max
    return min(s_max, round_up(sink, BLOCK_KV) + round_up(window + t - 1, BLOCK_KV) + BLOCK_KV)


def _num_splits(b: int, hkv: int, rows: int, s_max: int, t: int = 1,
                window: int | None = None, sink: int = 0,
                halves: bool = False) -> tuple[int, int]:
    """(split_len, num_splits): slices of a multiple of the BLOCK_KV
    positions a CTA takes at a time over the live span (live_span), enough
    of them for TARGET_CTAS blocks where the span is long enough. A
    function of the shapes, the window and the sink alone, so a paged and a
    dense cache of one max_len take the same slices (and give the same
    bits), and a captured call stays right as the lengths grow."""
    row_block, tiles = _layout(rows, halves)
    span = live_span(s_max, t, window, sink)
    want = max(1, cdiv(TARGET_CTAS, b * hkv * cdiv(rows, row_block)))
    split_len = round_up(cdiv(span, want), BLOCK_KV * tiles)
    return split_len, cdiv(span, split_len)


def _check_cuda_operands(q, k, v, k_scale, v_scale, length, table) -> None:
    d = q.shape[-1]
    tensors = [t for t in (q, k, v, k_scale, v_scale, length, table) if t is not None]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"q and the cache must be on one CUDA device, got {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q {q.dtype}: need one of {list(DTYPE_CODES)}")
    quantized = k_scale is not None
    if k.dtype != v.dtype or (not quantized and k.dtype != q.dtype) or (
            quantized and k.dtype not in (torch.int8, FP8_DTYPE)):
        raise ValueError(f"q {q.dtype} and cache {k.dtype}/{v.dtype}: an unquantized "
                         "cache must match q, a quantized one be int8 or fp8")
    if quantized and (v_scale is None or k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise ValueError("a quantized cache needs float32 k_scale and v_scale")
    if length.dtype != torch.int32 or (table is not None and table.dtype != torch.int32):
        raise ValueError("cache length and block table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q and the cache tensors must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("cache k and v must start 16-byte aligned")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
           length: torch.Tensor, table: torch.Tensor | None, s_max: int,
           scale: float, window: int | None = None, sink: int = 0,
           cap: float | None = None, slopes: torch.Tensor | None = None,
           with_lse: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K2 on CUDA tensors: q [B, Hq, T, D]; k/v [B, Hkv, Smax, D]
    (dense, table None) or pages [P, Hkv, page, D] read through
    table [B, max_pages] (paged, s_max = max_pages * page; an entry outside
    [0, P) is never read, its block holds no key); `window` and `sink` as
    in visible_positions; `cap` a checked soft-cap (check_softcap) or None;
    `slopes` the (Hq,) float32 ALiBi table on q's device (alibi_table) or
    None. Returns (o, the LSE [B, Hq, T] float32 with `with_lse`, else
    None)."""
    _check_cuda_operands(q, k, v, k_scale, v_scale, length, table)
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    rows = (hq // hkv) * t
    split_len, splits = _num_splits(b, hkv, rows, s_max, t, window, sink,
                                    split_dims(k.dtype, d))
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hkv, splits, rows), **f32)
    part_l = torch.empty((b, hkv, splits, rows), **f32)
    part_acc = torch.empty((b, hkv, splits, rows, d), **f32)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, t), **f32) if with_lse else None
    page = k.shape[2] if table is not None else 0
    max_pages = table.shape[1] if table is not None else 0
    num_pages = k.shape[0] if table is not None else 0

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    # ALiBi's instantiations are a library of their own (csrc/decode_alibi.cu),
    # and so are D 256's (csrc/decode_d256.cu, csrc/decode_alibi_d256.cu).
    lib = _build.load(("decode" if slopes is None else "decode_alibi")
                      + ("_d256" if head_tile(d) == 256 else ""))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
            length.data_ptr(), ptr(table), ptr(slopes), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), o.data_ptr(), ptr(lse), b, hq, hkv, t, s_max,
            d, DTYPE_CODES[q.dtype], CACHE_CODES[k.dtype], max_pages, page, num_pages,
            split_len, splits, min(window or 0, s_max), min(sink, s_max),
            pre_scale(scale, cap), 0.0 if cap is None else 1.0 / cap,
            0.0 if cap is None else cap * LOG2E, stream)
    _build.check(lib, rc, "decode")
    return o, lse


def _decode_attention(q: torch.Tensor, cache: KVCache, scale: float | None = None,
                      window: int | None = None, sink: int = 0, with_lse: bool = False,
                      logit_softcap: float | None = None, alibi: bool = False,
                      alibi_slopes: torch.Tensor | None = None):
    """K2 on a dense cache, q [B, Hq, T, D] -> o [B, Hq, T, D], and with
    `with_lse` (o, LSE [B, Hq, T] float32, natural log, -inf for a row that
    sees no key): the JAX launcher _decode_attention, which the public
    functions below call. The options as in decode_attention_chunk."""
    check_window(window, sink)
    cap = check_softcap(logit_softcap)
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
        return decode_attention_reference(q, cache, scale, window=window, sink=sink,
                                          logit_softcap=cap, alibi=alibi,
                                          alibi_slopes=alibi_slopes, with_lse=with_lse)
    slopes = alibi_table(alibi, alibi_slopes, hq, q.device, cap)
    if scale is None:
        scale = 1.0 / d**0.5
    o, lse = launch(q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.length, None,
                    s_max, scale, window, sink, cap, slopes, with_lse)
    global LAUNCHES, INT8_LAUNCHES, FP8_LAUNCHES, WINDOW_LAUNCHES, SOFTCAP_LAUNCHES, \
        ALIBI_LAUNCHES, LSE_LAUNCHES
    WINDOW_LAUNCHES += window is not None
    SOFTCAP_LAUNCHES += cap is not None
    ALIBI_LAUNCHES += slopes is not None
    LSE_LAUNCHES += with_lse
    if cache.k.dtype == torch.int8:
        INT8_LAUNCHES += 1
    elif cache.k.dtype == FP8_DTYPE:
        FP8_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return (o, lse) if with_lse else o


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """One new token per sequence: q [B, Hq, D] -> [B, Hq, D].

    CPU tensors take the plain version. CUDA tensors launch K2 and must be
    contiguous (cache k and v 16-byte aligned), with q bf16 or float32, the
    cache in q's dtype or quantized (int8/fp8 with float32 scales), and D
    in HEAD_DIMS; anything else raises. With a `window` the new token sees
    the last `window` positions and, with `sink`, the first `sink` ones.
    `logit_softcap` caps the scaled logits (cap * tanh(s / cap)) before the
    masks; None or 0 is off. `alibi` adds slope_h * (pos - row_pos) to them
    (the (Hq,) `alibi_slopes`, None for default_alibi_slopes; not with a
    soft-cap)."""
    return _decode_attention(q[:, :, None], cache, scale, window, sink,
                             logit_softcap=logit_softcap, alibi=alibi,
                             alibi_slopes=alibi_slopes)[:, :, 0]


def decode_attention_chunk(
    q: torch.Tensor,
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """T new tokens per sequence, causal within the chunk:
    q [B, Hq, T, D] -> [B, Hq, T, D]. Same rules as decode_attention; with a
    window, token t sees the positions in (its own - window, its own] and
    those below `sink`; ALiBi's distance is from the token's own position."""
    return _decode_attention(q, cache, scale, window, sink, logit_softcap=logit_softcap,
                             alibi=alibi, alibi_slopes=alibi_slopes)
