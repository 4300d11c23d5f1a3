"""Flash-attention forward (counterpart of flashattn_tpu/ops/flash_fwd.py).

``flash_attention_forward`` launches kernel K1 (csrc/flash_fwd.cu) on CUDA
tensors. It serves what the JAX package splits between the wavefront kernel
(flash_fwd.py::_fwd_kernel) and the grid4 kernel
(flash_fwd_grid4.py::_grid4_kernel): both compute one function on the plain
subset, and the port has one grid for it, which also takes the sliding
window, packed-document segment ids, the logit soft-cap and ALiBi (the JAX
package sends those to _fwd_kernel).

ALiBi adds slope_h * (col - row - pos_offset) to the scaled logits (the
query head's slope under GQA). The kernels read the (Hq,) float32 slope
table from device memory (``alibi_table``); the standard table is built
once per head count and device, so a captured call reads a buffer that
outlives it.

Attention dropout (``dropout_rate`` > 0 with ``dropout_seed``) keeps the
unnormalised probabilities that meet V where common.dropout_keep_mask
keeps them, times 1 / (1 - rate), and zeroes the others; the LSE stays
that without dropout. Its kernels are a library of their own
(csrc/flash_fwd_dropout.cu), every option beside it; a rate of 0 runs the
library without dropout.

``dyn_pos_offset`` (the zigzag ring's, parallel/ring.py) is the q/k
alignment as an int32 int or a one-element int32 tensor, read on the card:
a CUDA tensor by pointer, an int or a CPU tensor written into a one-element
card tensor by a fill kernel (``device_offset``), so one launch shape serves
every rank and hop. The call is not causal; only the window's left edge,
c >= r + offset - window + 1, and the ALiBi distance c - r - offset read
it. Its kernels are libraries of their own (csrc/flash_fwd_dynoff.cu: a
window, ALiBi or both, or the window with the soft-cap, with or without
segment ids, bf16 at every head dim and float32; csrc/flash_fwd_dynoff_dropout.cu:
the same with dropout); with neither a window nor ALiBi the offset changes
nothing and the call runs the libraries without it (``kernel_library``).
"""

from __future__ import annotations

import functools
import numbers

import torch

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.common import (
    LOG2E,
    cdiv,
    check_dropout,
    check_softcap,
    dropout_scale,
    dropout_threshold,
)
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse

# Kernel launches in this process (set to 0 by callers that count a run):
# all of them, those with a sliding window, those with segment ids, those
# with a logit soft-cap, those with ALiBi, those with ALiBi and segment
# ids and those with dropout (a launch counts in each that applies).
LAUNCHES = 0
WINDOW_LAUNCHES = 0
SEGMENT_LAUNCHES = 0
SOFTCAP_LAUNCHES = 0
ALIBI_LAUNCHES = 0
ALIBI_SEGMENT_LAUNCHES = 0
DROPOUT_LAUNCHES = 0
DYNOFF_LAUNCHES = 0  # with the offset read on the card (dyn_pos_offset)

# Head dims K1, K2 and the backward kernels take. The kernels are compiled
# for tiles of 64, 128 and 256 columns and take the true head dim at run
# time inside the tile that holds it (HEAD_TILES): 32 in the 64 tile, 80
# and 96 in the 128 tile (csrc/common.cuh head_tile). The tensors stay d
# wide: nothing is padded here.
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
HEAD_TILES = (64, 128, 256)


def head_tile(d: int) -> int:
    """The compiled tile of head dim d (csrc/common.cuh head_tile)."""
    return next(t for t in HEAD_TILES if d <= t)


# A window at least this wide reaches every key of an int32-indexed call:
# the kernels take it so.
WINDOW_MAX = 1 << 30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_alibi_slopes(num_heads: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The standard ALiBi slope table, 2^(-8 (h + 1) / H) for h in [0, H),
    float32 (the JAX package's default_alibi_slopes: no other rule for a
    head count that is not a power of two)."""
    h = torch.arange(num_heads, dtype=torch.float32, device=device)
    return torch.exp2(-8.0 * (h + 1) / num_heads)


@functools.lru_cache(maxsize=None)
def standard_slope_table(hq: int, device: torch.device) -> torch.Tensor:
    """default_alibi_slopes(hq) on `device`, made once (at the first, eager
    call: a captured call then reads the same buffer)."""
    with torch.inference_mode(False):  # an ordinary tensor, whatever the caller's mode
        return default_alibi_slopes(hq).to(device)


def alibi_table(alibi: bool, alibi_slopes, hq: int, device: torch.device,
                cap: float | None = None) -> torch.Tensor | None:
    """The (Hq,) float32 slopes of a call on `device`, None without ALiBi.

    alibi_slopes None takes the standard table, made once per (Hq, device)
    (standard_slope_table); given slopes must be an (Hq,) tensor, moved to `device`
    as float32 (no copy when they are already so). ALiBi with a logit
    soft-cap raises ValueError, as the JAX kernels' assert does, and so do
    slopes without alibi."""
    if not alibi:
        if alibi_slopes is not None:
            raise ValueError("alibi_slopes needs alibi=True")
        return None
    if cap is not None:
        raise ValueError("ALiBi and a logit soft-cap together: pick one (as in the JAX "
                         "package)")
    if alibi_slopes is None:
        return standard_slope_table(hq, torch.device(device))
    if not isinstance(alibi_slopes, torch.Tensor) or tuple(alibi_slopes.shape) != (hq,):
        raise ValueError(f"alibi_slopes must be an ({hq},) tensor, got "
                         f"{tuple(getattr(alibi_slopes, 'shape', ()))}")
    return alibi_slopes.to(device=device, dtype=torch.float32).contiguous()


def flash_attention_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    need_lse: bool = True,
    window: int | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dyn_pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of K1, on any device."""
    pos_offset = plain_offset(pos_offset, dyn_pos_offset, is_causal)
    check_window(window, is_causal, dyn_pos_offset is not None)
    segment_ids = check_segments(segment_ids, q, k)
    slopes = alibi_table(alibi, alibi_slopes, q.shape[1], q.device, check_softcap(logit_softcap))
    rate = check_dropout(dropout_rate, dropout_seed)
    o, lse = reference_attention_with_lse(q, k, v, is_causal, scale, pos_offset, window,
                                          segment_ids, logit_softcap, slopes, rate,
                                          dropout_seed)
    return o, (lse if need_lse else None)


def check_window(window: int | None, is_causal: bool, dynamic: bool = False) -> None:
    """A sliding window is a positive int and needs the causal mask, or
    with `dynamic` (a dyn_pos_offset call) is its left edge alone."""
    if window is None:
        return
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")
    if not is_causal and not dynamic:
        raise ValueError("a sliding window needs is_causal=True (or a dyn_pos_offset)")


def check_dyn_offset(dyn_pos_offset, pos_offset, is_causal: bool) -> None:
    """dyn_pos_offset, when given, is an int32 int or a one-element int32
    tensor, without pos_offset and without the causal mask (as the JAX
    kernels assert: the causal walk cannot prune on an offset read on the
    card). Raises ValueError."""
    if dyn_pos_offset is None:
        return
    if pos_offset is not None:
        raise ValueError("pos_offset and dyn_pos_offset are mutually exclusive")
    if is_causal:
        raise ValueError("dyn_pos_offset needs is_causal=False: the caller guarantees "
                         "every pair is causally visible")
    if isinstance(dyn_pos_offset, torch.Tensor):
        if dyn_pos_offset.dtype != torch.int32 or dyn_pos_offset.numel() != 1:
            raise ValueError(f"dyn_pos_offset must be a one-element int32 tensor, got "
                             f"{dyn_pos_offset.dtype} of shape {tuple(dyn_pos_offset.shape)}")
    elif isinstance(dyn_pos_offset, bool) or not isinstance(dyn_pos_offset, numbers.Integral) \
            or not -2**31 <= dyn_pos_offset < 2**31:
        raise ValueError(f"dyn_pos_offset must be an int32 or an int32 tensor, got "
                         f"{dyn_pos_offset!r}")


def plain_offset(pos_offset, dyn_pos_offset, is_causal: bool):
    """The plain versions' pos_offset: dyn_pos_offset's value when given
    (checked by check_dyn_offset; a tensor is read on the host), else
    pos_offset."""
    check_dyn_offset(dyn_pos_offset, pos_offset, is_causal)
    if dyn_pos_offset is None:
        return pos_offset
    return int(dyn_pos_offset.item() if isinstance(dyn_pos_offset, torch.Tensor)
               else dyn_pos_offset)


def dyn_library(dyn_pos_offset, window, slopes) -> bool:
    """Whether a checked card call runs the kernels that read the offset on
    the card: a dyn_pos_offset with a window or ALiBi (without either the
    offset changes nothing), whatever else the call takes (the soft-cap,
    dropout, segment ids, any head dim, bf16 or float32)."""
    return dyn_pos_offset is not None and (window is not None or slopes is not None)


def kernel_library(family: str, rate: float, dyn: bool, alibi: bool = False) -> str:
    """The library (csrc/<name>.cu) of a card call of a kernel family
    ("flash_fwd", "flash_bwd" or "flash_bwd_fused"): "_dynoff" for the
    offset read on the card (dyn_library), then "_dropout" for a rate above
    0; else, for ALiBi where the family builds it apart (`alibi`: the
    backward's), "_alibi"."""
    if dyn or rate:
        return family + ("_dynoff" if dyn else "") + ("_dropout" if rate else "")
    return family + ("_alibi" if alibi else "")


def check_segments(segment_ids, q, k) -> tuple[torch.Tensor, torch.Tensor] | None:
    """Packed-document ids as the kernels take them: None, or the pair
    (seg_q [B, S_q], seg_k [B, S_k]), int32 and contiguous, on q's device.
    Raises ValueError on anything else."""
    if segment_ids is None:
        return None
    if not isinstance(segment_ids, (tuple, list)) or len(segment_ids) != 2:
        raise ValueError("segment_ids must be a (seg_q [B, S_q], seg_k [B, S_k]) pair")
    seg_q, seg_k = segment_ids
    for name, seg, x in (("seg_q", seg_q, q), ("seg_k", seg_k, k)):
        if not isinstance(seg, torch.Tensor) or tuple(seg.shape) != (x.shape[0], x.shape[2]):
            raise ValueError(f"{name} must be a [B, S] = {[x.shape[0], x.shape[2]]} tensor, got "
                             f"{tuple(getattr(seg, 'shape', ()))}")
        if seg.dtype != torch.int32 or not seg.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32, got {seg.dtype}")
        if seg.device != q.device:
            raise ValueError(f"{name} is on {seg.device}, q on {q.device}")
    return seg_q, seg_k


# Positions a block of segment-id ranges covers (csrc/common.cuh kRangeRows).
RANGE_ROWS = 32


def id_ranges(ids: torch.Tensor) -> torch.Tensor:
    """[B, S] ids -> [B, ceil(S / RANGE_ROWS), 2] int32: each block's (min,
    max) id, the ragged last block over its positions alone."""
    b, s = ids.shape
    pad = cdiv(s, RANGE_ROWS) * RANGE_ROWS - s
    if pad:  # repeat the last id: it widens no range
        ids = torch.cat([ids, ids[:, -1:].expand(b, pad)], dim=1)
    blocks = ids.view(b, -1, RANGE_ROWS)
    return torch.stack([blocks.amin(-1), blocks.amax(-1)], dim=-1).contiguous()


def kernel_segments(segment_ids) -> tuple:
    """The kernels' (seg_q, seg_k, ranges_q, ranges_k) for checked segment
    ids (check_segments), all None without them: the ids, and their block
    ranges (id_ranges), with which the kernels skip the tile pairs of two
    documents and the id mask on tiles of one."""
    if segment_ids is None:
        return None, None, None, None
    seg_q, seg_k = segment_ids
    return seg_q, seg_k, id_ranges(seg_q), id_ranges(seg_k)


def device_seed(seed, device: torch.device, name: str = "dropout_seed") -> torch.Tensor:
    """The dropout seed (checked by common.check_dropout) as the kernels
    read it, a one-element int32 tensor on the card: a seed tensor there
    as it is (never read on the host: a captured call reads it at each
    replay); an int, or a tensor on the CPU, written by a fill kernel (no
    host-to-device copy, so a captured call takes it too)."""
    if isinstance(seed, torch.Tensor) and seed.device.type == "cuda":
        if seed.device != device:
            raise ValueError(f"{name} is on {seed.device}, q on {device}")
        return seed
    return torch.full((1,), int(seed), dtype=torch.int32, device=device)


def device_offset(dyn_pos_offset, device: torch.device) -> torch.Tensor:
    """dyn_pos_offset (checked by check_dyn_offset) as the kernels read it,
    a one-element int32 tensor on the card, as device_seed makes the seed."""
    return device_seed(dyn_pos_offset, device, "dyn_pos_offset")


def dropout_args(rate: float, seed: torch.Tensor) -> tuple:
    """(seed pointer, threshold, scale), the dropout libraries' last
    arguments before the stream, for a rate checked by common.check_dropout
    and device_seed's tensor, which the caller holds until the launch."""
    return seed.data_ptr(), dropout_threshold(rate), dropout_scale(rate)


def extra_args(q, rate: float, dropout_seed, dyn: bool, dyn_pos_offset) -> tuple:
    """(the tensors to hold until the launch, the arguments a dropout or
    card-offset library takes before the stream): dropout's (dropout_args)
    for a rate above 0, then the offset's pointer (device_offset) for a
    dyn_library call."""
    held, args = [], ()
    if rate:
        held.append(device_seed(dropout_seed, q.device))
        args += dropout_args(rate, held[-1])
    if dyn:
        held.append(device_offset(dyn_pos_offset, q.device))
        args += (held[-1].data_ptr(),)
    return held, args


def pointers(*tensors) -> tuple:
    """Device pointers of the tensors, NULL for None."""
    return tuple(None if t is None else t.data_ptr() for t in tensors)


def check_qkv(q, k, v) -> None:
    """Shapes and device of attention operands (any device)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected [B, H, S, D] tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def check_kernel_operands(head_dims: tuple[int, ...] = HEAD_DIMS, /,
                          **tensors: torch.Tensor) -> None:
    """What the attention kernels take on the card: one dtype of
    DTYPE_CODES, D in `head_dims` (the forward's HEAD_DIMS by default),
    contiguous, 16-byte aligned; raise ValueError on anything else."""
    names = "/".join(tensors)
    ts = list(tensors.values())
    d = ts[0].shape[-1]
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims}")
    if ts[0].dtype not in DTYPE_CODES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"dtypes {'/'.join(str(t.dtype) for t in ts)} of {names}: "
                         f"need one of {list(DTYPE_CODES)} for all")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{names} must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{names} must start 16-byte aligned")


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    pos_offset: int | None = None,
    need_lse: bool = True,
    *,
    segment_ids=None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
    dyn_pos_offset=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fused attention forward.

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv dividing Hq.
      is_causal: row r sees column c iff c <= r + pos_offset.
      scale: softmax scale, default 1/sqrt(D).
      pos_offset: q/k alignment, default S_k - S_q (bottom-right).
      need_lse: also return the LSE; False skips writing it.
      window: sliding window, needs is_causal: row r also needs
        c >= r + pos_offset - window + 1. K1 walks only the kv tiles it
        reaches.
      segment_ids: (seg_q [B, S_q], seg_k [B, S_k]) int32 packed-document
        ids: row r also needs seg_q[b, r] == seg_k[b, c]
        (ops/varlen.py canonicalises padding ids).
      logit_softcap: cap * tanh(s / cap) on the scaled logits s, before
        any mask (Gemma-2); None or 0 is off.
      alibi: add slope_h * (c - r - pos_offset) to the scaled logits
        (ALiBi), h the query head; with `window` and `segment_ids` too
        (packed documents: the global positions' distance, which within a
        document is its own), not with a soft-cap (ValueError).
      alibi_slopes: the (Hq,) slopes; None takes default_alibi_slopes.
      dropout_rate: attention dropout in [0, 1) (module docstring), beside
        every option above; 0 is off.
      dropout_seed: needed when dropout_rate > 0: an int32 int or a
        one-element int32 tensor (on the card: read there, never on the
        host). The mask keys on bh = b * Hq + h and the arrays' row and
        column, so the backward, given the same seed, rebuilds it.
      dyn_pos_offset: the q/k alignment read on the card (module
        docstring), an int32 int or a one-element int32 tensor; needs
        is_causal=False and no pos_offset. A window then masks its left
        edge alone, c >= r + offset - window + 1, and ALiBi takes
        c - r - offset.

    Returns:
      (O [B, Hq, S_q, D] in q.dtype, LSE [B, Hq, S_q] float32 natural log or
      None). Rows that see no key get O = 0 and LSE = -inf.

    CPU tensors take the plain version. CUDA tensors launch K1 and must be
    contiguous, 16-byte aligned bf16 or float32 with D in HEAD_DIMS;
    anything else raises. bf16 runs the wgmma kernel, float32 the CUDA-core
    kernel.
    """
    check_qkv(q, k, v)
    check_dyn_offset(dyn_pos_offset, pos_offset, is_causal)
    check_window(window, is_causal, dyn_pos_offset is not None)
    segment_ids = check_segments(segment_ids, q, k)
    cap = check_softcap(logit_softcap)
    rate = check_dropout(dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, is_causal, scale, pos_offset,
                                                 need_lse, window, segment_ids, cap, alibi,
                                                 alibi_slopes, rate, dropout_seed,
                                                 dyn_pos_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    check_kernel_operands(q=q, k=k, v=v)
    slopes = alibi_table(alibi, alibi_slopes, hq, q.device, cap)
    dyn = dyn_library(dyn_pos_offset, window, slopes)
    if scale is None:
        scale = 1.0 / d**0.5
    offset = 0 if dyn_pos_offset is not None else (
        s_k - s_q if pos_offset is None else int(pos_offset))

    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, s_q), dtype=torch.float32, device=q.device)
           if need_lse else None)
    segs = kernel_segments(segment_ids)
    pre, cap_log2 = logit_factors(scale, cap)
    held, extra = extra_args(q, rate, dropout_seed, dyn, dyn_pos_offset)
    lib = _build.load(kernel_library("flash_fwd", rate, dyn))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if need_lse else None, *pointers(*segs, slopes),
            b, hq, hkv, s_q, s_k, d, DTYPE_CODES[q.dtype], int(is_causal),
            offset, min(window or 0, WINDOW_MAX), pre, cap_log2, *extra, stream)
    del held  # the seed and the offset, kept on the card until the launch
    _build.check(lib, rc, "flash_fwd")
    global LAUNCHES, WINDOW_LAUNCHES, SEGMENT_LAUNCHES, SOFTCAP_LAUNCHES, ALIBI_LAUNCHES
    global ALIBI_SEGMENT_LAUNCHES, DROPOUT_LAUNCHES, DYNOFF_LAUNCHES
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    SEGMENT_LAUNCHES += segment_ids is not None
    SOFTCAP_LAUNCHES += cap is not None
    ALIBI_LAUNCHES += slopes is not None
    ALIBI_SEGMENT_LAUNCHES += slopes is not None and segment_ids is not None
    DROPOUT_LAUNCHES += rate > 0
    DYNOFF_LAUNCHES += dyn
    return o, lse


def logit_factors(scale: float, cap: float | None) -> tuple[float, float]:
    """(pre, cap_log2): the kernels' logits in the exp2 domain are s * pre
    (pre = scale * log2(e)), or with a cap tanh(s * pre) * cap_log2 (pre =
    scale / cap, cap_log2 = cap * log2(e): only `scale` folds before the
    tanh, as in the JAX launcher). K1 and the backward kernels take both."""
    return (scale * LOG2E, 0.0) if cap is None else (scale / cap, cap * LOG2E)
