"""Per-kernel roofline on an NVIDIA card: the bytes a call must move and
the operations it must do, against the card's peak rates (counterpart of
flashattn_tpu/utils/roofline.py).

A call's bound is the larger of two times: its bytes over the memory rate,
each input read once and each output written once, and its operations over
the peak rate for their type. The FLOP counts are the JAX package's. Its
bytes model and its ``mxu_depth_frac`` describe the TPU (K/V re-read for
every q block, a 128-wide systolic array) and are not carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattn_tpu_torch.ops.reference import visible
from flashattn_tpu_torch.utils.timing import attention_flops


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float  # dense tensor-core peak, bf16 and fp16
    int8_tops: float
    fp8_tflops: float
    f32_tflops: float  # outside the tensor cores
    hbm_gbps: float  # device memory, GB/s
    hbm_gib: float

    def peak_ops(self, dtype: torch.dtype) -> float:
        """Dense operations a second on inputs of `dtype`."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.bf16_tflops * 1e12
        if dtype == torch.int8:
            return self.int8_tops * 1e12
        if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return self.fp8_tflops * 1e12
        if dtype == torch.float32:
            return self.f32_tflops * 1e12
        raise ValueError(f"no peak rate for {dtype}")


# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
H100_SXM = ChipSpec(name="H100 SXM", bf16_tflops=989.0, int8_tops=1979.0,
                    fp8_tflops=1979.0, f32_tflops=67.0, hbm_gbps=3350.0, hbm_gib=80.0)


def detect_chip() -> ChipSpec:
    """The spec of card 0, matched by its name, with its memory size from
    the device's properties. Raises without a card and for a card it does
    not know (the JAX function falls back to a v5e): a wrong spec would
    print wrong bounds."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a roofline needs the card's spec")
    name = torch.cuda.get_device_name(0)
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        props = torch.cuda.get_device_properties(0)
        return dataclasses.replace(H100_SXM, hbm_gib=props.total_memory / 2**30)
    raise ValueError(f"no roofline spec for {name!r}: add its data sheet's rates to "
                     "utils/roofline.py")


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    sol_seconds: float  # the bound: the larger of the two times below
    compute_seconds: float
    memory_seconds: float
    bound: str  # "compute" | "memory"

    @property
    def bound_ms(self) -> float:
        return self.sol_seconds * 1e3

    @property
    def bound_by(self) -> str:
        """"operations" or "bytes", the words of chip_smoke.py's JSON line."""
        return "operations" if self.bound == "compute" else "bytes"


def roofline(flops: float, hbm_bytes: float, dtype: torch.dtype,
             chip: ChipSpec | None = None) -> RooflineReport:
    """The bound of `flops` operations on `dtype` inputs that must move
    `hbm_bytes`; ties go to the bytes."""
    chip = chip or detect_chip()
    compute_s = flops / chip.peak_ops(dtype)
    memory_s = hbm_bytes / (chip.hbm_gbps * 1e9)
    return RooflineReport(
        flops=flops, hbm_bytes=hbm_bytes, sol_seconds=max(compute_s, memory_s), compute_seconds=compute_s,
        memory_seconds=memory_s, bound="compute" if compute_s > memory_s else "memory")


def _float_dtype(dtype_bytes: int) -> torch.dtype:
    return {2: torch.bfloat16, 4: torch.float32}[dtype_bytes]


def window_pairs(s_q: int, s_k: int, window: int, pos_offset: int | None = None) -> int:
    """The (row, column) pairs a causal sliding window lets one head see:
    row r sees the columns in [r + offset - window + 1, r + offset] inside
    [0, S_k)."""
    off = s_k - s_q if pos_offset is None else pos_offset
    return sum(max(0, min(s_k, r + off + 1) - max(0, r + off - window + 1))
               for r in range(s_q))


def segment_pairs(seg_q: torch.Tensor, seg_k: torch.Tensor, is_causal: bool = False,
                  window: int | None = None, pos_offset: int | None = None) -> int:
    """The (batch row, row, column) pairs one head sees under packed-document
    ids seg_q [B, S_q] and seg_k [B, S_k] (row r sees column c only if
    seg_q[b, r] == seg_k[b, c]), with or without the causal mask and a
    window: counted on the ids' device, 1024 rows at a time."""
    s_q, s_k = seg_q.shape[1], seg_k.shape[1]
    off = s_k - s_q if pos_offset is None else pos_offset
    total = 0
    for r0 in range(0, s_q, 1024):
        r1 = min(s_q, r0 + 1024)
        mask = visible(r1 - r0, s_k, is_causal, off + r0, window, (seg_q[:, r0:r1], seg_k),
                       seg_q.device)
        total += int(mask.sum())
    return total


def _attention_work(b, hq, s_q, s_k, d, is_causal, window, pos_offset, segment_ids):
    """(the forward's operations, the segment ids' bytes): the JAX package's
    count (half the square when causal) on the plain subset, else 4 D for
    each pair a head sees (window_pairs, segment_pairs; a window without the
    causal mask is its left edge alone, as dyn_pos_offset calls take it)."""
    if segment_ids is not None:
        pairs = segment_pairs(*segment_ids, is_causal, window, pos_offset)
        return 4.0 * hq * d * pairs, 4 * b * (s_q + s_k)
    if window is not None and not is_causal:  # a left edge alone (dyn_pos_offset calls)
        ids = torch.zeros((1, s_q), dtype=torch.int32), torch.zeros((1, s_k), dtype=torch.int32)
        return 4.0 * b * hq * d * segment_pairs(*ids, False, window, pos_offset), 0
    if window is not None:
        return 4.0 * b * hq * d * window_pairs(s_q, s_k, window, pos_offset), 0
    return attention_flops(b, hq, s_q, s_k, d, is_causal), 0


def attention_fwd_roofline(
    b: int, hq: int, hkv: int, s_q: int, s_k: int, d: int,
    is_causal: bool, dtype_bytes: int = 2, chip: ChipSpec | None = None,
    need_lse: bool = True, window: int | None = None, pos_offset: int | None = None,
    segment_ids=None,
) -> RooflineReport:
    """The flash forward (K1): Q, K and V read once, O written once, the
    float32 LSE when `need_lse`, and the int32 segment ids when given.
    Operations: the JAX package's count (half the square when causal), or
    with a window (causal) or segment ids (seg_q, seg_k) 4 D for each pair a
    head sees (window_pairs, segment_pairs). A logit soft-cap adds nothing
    to the count: its tanh, like the exponentials, runs beside the products
    on the special-function units, so the bound stays the products' and the
    bytes' (decode_roofline too). Nor does ALiBi: it masks no pair, and its
    bias is FMAs beside the products; its (Hq,) slope table, 4 Hq bytes, is
    left out of the bytes. Any head dim (64 to 256) counts alike."""
    q_bytes = b * hq * s_q * d * dtype_bytes
    kv_bytes = 2 * b * hkv * s_k * d * dtype_bytes
    lse_bytes = 4 * b * hq * s_q if need_lse else 0
    flops, seg_bytes = _attention_work(b, hq, s_q, s_k, d, is_causal, window, pos_offset,
                                       segment_ids)
    return roofline(flops, 2 * q_bytes + kv_bytes + lse_bytes + seg_bytes,
                    _float_dtype(dtype_bytes), chip)


# The backward's kernels by the matrix products each runs over the score
# square (one product is half the forward's FLOPs).
_BWD_KERNELS = {
    "fused": 5,  # S, dP, dV, dK, dQ; writes dQ, dK, dV
    "dq": 3,  # S, dP, dQ; writes dQ and the float32 delta
    "dkv": 4,  # S, dP, dV, dK; reads delta in place of O, writes dK, dV
}


def attention_bwd_roofline(
    b: int, hq: int, hkv: int, s_q: int, s_k: int, d: int,
    is_causal: bool, dtype_bytes: int = 2, chip: ChipSpec | None = None,
    kernel: str = "fused", window: int | None = None, pos_offset: int | None = None,
    segment_ids=None,
) -> RooflineReport:
    """The flash backward. ``kernel="fused"`` (B3, the default) is the whole
    backward, 2.5 x the forward's FLOPs as in the JAX package; the split
    path's kernels recompute S: ``"dq"`` (B4) 1.5 x, ``"dkv"`` (B5) 2 x; the
    forward's FLOPs as attention_fwd_roofline counts them (the pairs a head
    sees under a window or segment ids). A logit soft-cap adds nothing, as
    in the forward: its tanh and the derivative's (1 - t)(1 + t) run beside
    the products, on the special-function units and the FMA pipes, so the
    bound stays the products' and the bytes'; nor does ALiBi, as in the
    forward (the bias has no gradient); any head dim (64 to 256) counts
    alike. Bytes: every operand the kernel reads once (the segment
    ids too), every result written once."""
    if kernel not in _BWD_KERNELS:
        raise ValueError(f"kernel must be one of {sorted(_BWD_KERNELS)}: {kernel!r}")
    q = b * hq * s_q * d * dtype_bytes  # Q, O, dO and dQ each
    kv = b * hkv * s_k * d * dtype_bytes  # K, V, dK and dV each
    row = 4 * b * hq * s_q  # the LSE, delta
    reads = 3 * q + 2 * kv + row  # Q, O, dO, K, V, LSE
    hbm = {"fused": reads + q + 2 * kv,
           "dq": reads + q + row,
           "dkv": reads - q + row + 2 * kv}[kernel]
    fwd_flops, seg_bytes = _attention_work(b, hq, s_q, s_k, d, is_causal, window, pos_offset,
                                           segment_ids)
    return roofline(_BWD_KERNELS[kernel] / 2 * fwd_flops, hbm + seg_bytes,
                    _float_dtype(dtype_bytes), chip)


def decode_visible(n: int, t: int, window: int | None = None, sink: int = 0) -> tuple[int, int]:
    """A sequence of length n with T new tokens: (the (row, position) pairs
    its T rows see, the positions some row sees). Row i sits at position
    p = n - T + i and sees [0, p], or with a window (p - window, p] and the
    positions below `sink`."""
    pairs, lo_all = 0, n
    for i in range(t):
        p = n - t + i
        if p < 0:
            continue
        lo = 0 if window is None else max(0, p - window + 1)
        pairs += p + 1 - lo + min(sink, lo)
        lo_all = min(lo_all, lo)
    live = n - lo_all + min(sink, lo_all) if window is not None else n
    return pairs, live


def decode_roofline(
    b: int, hq: int, hkv: int, d: int, lengths: list[int], t: int = 1,
    cache_dtype: torch.dtype = torch.bfloat16, q_dtype_bytes: int = 2,
    chip: ChipSpec | None = None, window: int | None = None, sink: int = 0,
) -> RooflineReport:
    """Flash-decode (K2, dense or paged): T new tokens a sequence against
    caches of `lengths` tokens, with an optional window and sinks. Bytes:
    each live K and V value once (the positions some row sees; one byte a
    value when quantized, plus two float32 scales a token and kv head), q
    read and O written once, the lengths. Operations: 4 D a q head for each
    (row, position) pair a row sees (decode_visible), against the peak of
    the cache's type."""
    esize = torch.empty((), dtype=cache_dtype).element_size()
    seen = [decode_visible(n, t, window, sink) for n in lengths]
    live = sum(n for _, n in seen)
    hbm = 2 * hkv * live * (d * esize + (4 if esize == 1 else 0))
    hbm += 2 * b * hq * t * d * q_dtype_bytes + 4 * b
    return roofline(4.0 * hq * d * sum(p for p, _ in seen), hbm, cache_dtype, chip)


def quant_matmul_roofline(m: int, k: int, n: int, bits: int, a8: bool = False,
                          chip: ChipSpec | None = None) -> RooflineReport:
    """qmm8/qmm4 on bf16 x: x [M, K] and the weights (K N bytes at 8 bits,
    half at 4) and their float32 scales read once, y [M, N] in bf16 written
    once; 2 M K N operations against the bf16 peak (the kernels widen the
    weights to bf16 for the products). a8 (the a8 mode): the same bytes,
    the function's own (x_q and x_scale are the kernels' intermediates, and
    their traffic is part of the kernels' time, not of the bound), and the
    operations against the int8 peak."""
    hbm = 2 * m * k + k * n * bits // 8 + 4 * n + 2 * m * n
    return roofline(2.0 * m * k * n, hbm, torch.int8 if a8 else torch.bfloat16, chip)


def quantize_rows_roofline(m: int, k: int, x_bytes: int = 2,
                           chip: ChipSpec | None = None) -> RooflineReport:
    """The a8 mode's row quantization (quantize_rows): x [M, K] read once
    (x_bytes an element), x_q [M, K] int8 and x_scale [M] f32 written once;
    3 M K float32 operations (the amax, the division, the rounding) outside
    the tensor cores."""
    return roofline(3.0 * m * k, m * k * (x_bytes + 1) + 4 * m, torch.float32, chip)


def moe_roofline(t: int, hidden: int, intermediate: int, num_experts: int, top_k: int,
                 experts_touched: int, dtype: torch.dtype = torch.bfloat16,
                 chip: ChipSpec | None = None) -> RooflineReport:
    """The mixture-of-experts FFN of T tokens (parallel/moe.py): the float32
    router product and three SwiGLU products over each token's top_k
    experts. Bytes: x read and the output written once, the router and
    the weights of the experts this call's routing touches
    (`experts_touched`, counted from its ids: what these inputs need, not
    all E). Operations: 2 T H E for the router, 6 T k H F for the experts,
    against the peak of the weights' type."""
    esize = torch.empty((), dtype=dtype).element_size()
    hbm = esize * (2 * t * hidden + hidden * num_experts
                   + experts_touched * 3 * hidden * intermediate)
    flops = 2.0 * t * hidden * num_experts + 6.0 * t * top_k * hidden * intermediate
    return roofline(flops, hbm, dtype, chip)


def moe_bwd_roofline(t: int, hidden: int, intermediate: int, num_experts: int, top_k: int,
                     experts_touched: int, dtype: torch.dtype = torch.bfloat16,
                     chip: ChipSpec | None = None) -> RooflineReport:
    """The backward of moe_roofline's call: the gradients of x, the router
    and the touched experts from dY. Operations: twice the forward's, a
    product for the input's gradient and one for the weight's of each
    forward product (2 x 2 T H E for the router, 2 x 6 T k H F for the
    experts). Bytes: x and dY read and dX written once, the router read and
    its gradient written, and the touched experts' weights read and their
    gradients written; the activations the forward saved are the call's own
    and not counted."""
    esize = torch.empty((), dtype=dtype).element_size()
    hbm = esize * (3 * t * hidden + 2 * hidden * num_experts
                   + 2 * experts_touched * 3 * hidden * intermediate)
    flops = 2 * (2.0 * t * hidden * num_experts + 6.0 * t * top_k * hidden * intermediate)
    return roofline(flops, hbm, dtype, chip)
