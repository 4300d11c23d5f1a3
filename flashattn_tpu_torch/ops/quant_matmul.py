"""Weight-only int8/int4 quantized matmuls (counterpart of
flashattn_tpu/ops/quant_matmul.py).

Decode-time projections stream their weights from device memory once per
step, so storing them in 8 or 4 bits cuts the bytes the step moves.
``quant_matmul`` launches the ``qmm8``/``qmm4`` kernels
(csrc/quant_matmul.cu) on CUDA tensors. With ``quantize_activations=True``
(the a8 mode, W8A8 / W4A8) x is quantized per row to int8 first
(``quantize_rows``) and the products run on int8 with int32 sums.

The layout is the JAX package's, byte for byte, so a quantized JAX tree
converts with a plain copy (models/convert.py):
  - scales are per output channel, f32 [1, N], applied to the fp32
    accumulator once at the end;
  - int4 is nibble-packed along the contraction dim with a half split: byte
    row r holds row r (low nibble) and row r + K/2 (high nibble).
"""

from __future__ import annotations

import torch
from torch import nn

from flashattn_tpu_torch.ops import _build
from flashattn_tpu_torch.ops.flash_fwd import DTYPE_CODES

INT8_MAX = 127.0
INT4_MAX = 7.0
# f32(1 / 127): XLA compiles the JAX package's amax / INT8_MAX into amax
# times this f32 constant inside the jitted quant_matmul.
INV_INT8_MAX = float(torch.tensor(1.0, dtype=torch.float32) / INT8_MAX)
X_SCALE_FLOOR = 1e-10
# The a8 mode's int32 sums hold K * 127 * 127 up to K 133,144.
A8_K_MAX = 133_000

# Kernel launches in this process (set to 0 by callers that count a run). An
# a8 call counts its product in its kernel's counter and in the matching
# "_A8" one, and its quantization in QUANTIZE_ROWS_LAUNCHES.
QMM8_LAUNCHES = 0
QMM4_LAUNCHES = 0
QMM8_A8_LAUNCHES = 0
QMM4_A8_LAUNCHES = 0
QUANTIZE_ROWS_LAUNCHES = 0

K_MULTIPLE = 64  # contraction rows per kernel tile (csrc/quant_matmul.cu kBK)
N_MULTIPLE = 16  # output columns per 16-byte weight load

# The split-K decode kernel of qmm8 and qmm4 (csrc/quant_matmul.cu
# qmm_splitk_kernel).
SPLIT_M_MAX = 16  # rows of x it takes; more go to the tensor-core kernel
SPLIT_COLS = 128  # output columns of one CTA (kSplitCols)
SPLIT_ROWS_MAX = 512  # x columns of one split's slice in shared memory
SPLIT_CTAS_PER_SM = 8  # the grid the split count aims for, per SM
H100_SMS = 132


class QuantizedLinear(nn.Module):
    """Weight-only quantized [K, N] projection: buffers ``w`` (int8 [K, N],
    or nibble-packed int8 [K/2, N] for bits=4) and ``scale`` ([1, N] f32),
    so it sits in a model's state dict as ``<name>.w`` and ``<name>.scale``."""

    def __init__(self, w: torch.Tensor, scale: torch.Tensor, bits: int, k: int):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.register_buffer("w", w)
        self.register_buffer("scale", scale)
        self.bits = bits
        self.k = k

    @property
    def out_features(self) -> int:
        return self.w.shape[1]

    def extra_repr(self) -> str:
        return f"k={self.k}, n={self.out_features}, bits={self.bits}"


def quantize_weights(w: torch.Tensor, bits: int = 8) -> QuantizedLinear:
    """Symmetric per-output-channel quantization of w [K, N], bit for bit the
    JAX package's (f32 amax over K, round half to even, clip)."""
    k, n = w.shape
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)  # [1, N]
    if bits == 8:
        scale = torch.clamp_min(amax / INT8_MAX, 1e-10)
        q = torch.clamp(torch.round(wf / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
        return QuantizedLinear(q, scale, 8, k)
    if bits == 4:
        if k % 2:
            raise ValueError("int4 packing needs an even K")
        scale = torch.clamp_min(amax / INT4_MAX, 1e-10)
        q = torch.clamp(torch.round(wf / scale), -INT4_MAX - 1, INT4_MAX).to(torch.int32)
        lo = q[: k // 2] & 0xF  # rows [0, K/2)
        hi = q[k // 2:] & 0xF  # rows [K/2, K)
        packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
        return QuantizedLinear(packed, scale, 4, k)
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def integer_weights(qw: QuantizedLinear) -> torch.Tensor:
    """The quantized values as int32 [K, N] (int4 nibbles sign-extended)."""
    if qw.bits == 8:
        return qw.w.to(torch.int32)
    raw = qw.w.view(torch.uint8).to(torch.int32)
    lo = ((raw & 0xF) ^ 8) - 8
    hi = ((raw >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=0)


def dequantize_weights(qw: QuantizedLinear) -> torch.Tensor:
    """Plain dequant -> f32 [K, N]."""
    return integer_weights(qw).float() * qw.scale


def quantize_rows_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the a8 mode's row quantization: x [M, K] ->
    (x_q int8 [M, K], x_scale f32 [M, 1]), bit for bit the JAX package's
    jitted arithmetic (flashattn_tpu/ops/quant_matmul.py:226-229): f32 amax
    over K, x_scale = max(amax * f32(1/127), 1e-10), round half to even of
    an f32 division, clip to +-127."""
    xf = x.float()
    x_scale = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True) * INV_INT8_MAX,
                              X_SCALE_FLOOR)
    x_q = torch.clamp(torch.round(xf / x_scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, x_scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] bf16/f32 -> (x_q int8 [M, K], x_scale f32 [M, 1]), the a8
    mode's quantization. CPU tensors take the plain version; CUDA tensors
    launch csrc/quant_matmul.cu's quantize_rows_kernel (K a multiple of 4)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    m, k = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device or the CPU, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x {x.dtype}: need {list(DTYPE_CODES)}")
    x = x.contiguous()
    if x.data_ptr() % 16 or k % 4:
        raise ValueError(f"x must be 16-byte aligned and K={k} a multiple of 4")
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return x_q, x_scale
    lib = _build.load("quant_matmul")
    with torch.cuda.device(x.device):
        rc = lib.quantize_rows_launch(x.data_ptr(), x_q.data_ptr(), x_scale.data_ptr(), m, k,
                                      DTYPE_CODES[x.dtype],
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "quantize_rows")
    global QUANTIZE_ROWS_LAUNCHES
    QUANTIZE_ROWS_LAUNCHES += 1
    return x_q, x_scale


def quant_matmul_reference(x: torch.Tensor, qw: QuantizedLinear,
                           out_dtype: torch.dtype | None = None,
                           quantize_activations: bool = False) -> torch.Tensor:
    """Plain PyTorch version of qmm8/qmm4: (x @ w) in fp32, times the
    per-channel scale at the end, cast to out_dtype. The a8 mode: x through
    quantize_rows_reference, the exact integer product (a float64 product of
    the int8 values, exact below 2^53, then int32), then
    (sum.f32 * scale) * x_scale, the JAX finalize's order."""
    out_dtype = out_dtype or x.dtype
    if quantize_activations:
        x_q, x_scale = quantize_rows_reference(x)
        acc = torch.matmul(x_q.double(), integer_weights(qw).double()).to(torch.int32)
        return (acc.float() * qw.scale * x_scale).to(out_dtype)
    y = torch.matmul(x.float(), integer_weights(qw).float()) * qw.scale
    return y.to(out_dtype)


def _split(byte_rows: int, n: int, sms: int, rows_max: int) -> tuple[int, int]:
    blocks = -(-byte_rows // K_MULTIPLE)
    col_tiles = -(-n // SPLIT_COLS)
    want = -(-SPLIT_CTAS_PER_SM * sms // col_tiles)
    per = min(max(1, -(-blocks // want)), rows_max // K_MULTIPLE)
    rows = per * K_MULTIPLE
    return rows, -(-byte_rows // rows)


def qmm8_split(m: int, k: int, n: int, sms: int = H100_SMS) -> tuple[int, int] | None:
    """(rows per split, splits) of qmm8's split-K kernel for x [m, k] and
    weights [k, n], or None when m > SPLIT_M_MAX (one pass on the tensor
    cores, no workspace). The splits give the grid about SPLIT_CTAS_PER_SM
    CTAs on each of `sms` SMs, each split a multiple of K_MULTIPLE rows and
    at most SPLIT_ROWS_MAX; the kernel writes fp32 partial sums to a
    workspace [splits, m, n] that a second kernel adds in split order. The
    rule depends on the shapes and the SM count only, so two calls on one
    card sum in one order and give bitwise-equal results."""
    if m > SPLIT_M_MAX:
        return None
    return _split(k, n, sms, SPLIT_ROWS_MAX)


def qmm4_split(m: int, k: int, n: int, sms: int = H100_SMS) -> tuple[int, int] | None:
    """qmm8_split's rule for qmm4's packed weights [k/2, n]: (byte rows per
    split, splits) over the k/2 byte rows, or None when m > SPLIT_M_MAX. A
    split of r byte rows reads x's columns [k0, k0 + r) and
    [k/2 + k0, k/2 + k0 + r) (the half-split pairing), so r is at most
    SPLIT_ROWS_MAX / 2 to keep that slice in shared memory."""
    if m > SPLIT_M_MAX:
        return None
    return _split(k // 2, n, sms, SPLIT_ROWS_MAX // 2)


def quant_matmul(x: torch.Tensor, qw: QuantizedLinear,
                 out_dtype: torch.dtype | None = None,
                 quantize_activations: bool = False) -> torch.Tensor:
    """y = x @ dequant(qw): x [M, K] bf16/f32 -> [M, N] in out_dtype
    (default x's dtype). quantize_activations=True is the a8 mode (W8A8,
    W4A8): x quantized per row to int8 (quantize_rows), int8 products with
    int32 sums, then times the channel scale and x's row scale; K at most
    A8_K_MAX.

    CPU tensors take the plain version. CUDA tensors launch qmm8 or qmm4 and
    need K a multiple of 64 and N of 16 (every LLAMA_1B and LLAMA_8B
    projection), with the weights 16-byte aligned; anything else raises. At
    M <= 16 it also allocates the split-K workspace (qmm8_split, qmm4_split;
    int32 in the a8 mode); a call counts one launch, the workspace's
    reduction included, and in the a8 mode also quantize_rows' launch."""
    m, k = x.shape
    if k != qw.k:
        raise ValueError(f"x has K={k}, the weights K={qw.k}")
    a8 = quantize_activations
    if a8 and k > A8_K_MAX:
        raise ValueError(f"K={k}: the a8 mode's int32 sums hold K <= {A8_K_MAX}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_reference(x, qw, out_dtype, a8)
    n = qw.out_features
    if x.device.type != "cuda" or qw.w.device != x.device or qw.scale.device != x.device:
        raise ValueError(f"x ({x.device}) and the weights ({qw.w.device}) must be on "
                         "one CUDA device")
    if x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise ValueError(f"x {x.dtype} -> {out_dtype}: need {list(DTYPE_CODES)}")
    if (qw.w.dtype != torch.int8 or qw.scale.dtype != torch.float32
            or qw.scale.shape != (1, n)):
        raise ValueError("weights must be int8 with float32 scale [1, N]")
    if k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(f"K={k} must be a multiple of {K_MULTIPLE} and N={n} of "
                         f"{N_MULTIPLE}")
    x = x.contiguous()
    if not (qw.w.is_contiguous() and qw.scale.is_contiguous()) or qw.w.data_ptr() % 16:
        raise ValueError("weights must be contiguous and 16-byte aligned")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    split = (qmm8_split if qw.bits == 8 else qmm4_split)(m, k, n, sms)
    split_rows, ws = 0, None
    if split is not None:
        split_rows, splits = split
        ws = torch.empty((splits, m, n), dtype=torch.int32 if a8 else torch.float32,
                         device=x.device)
    ws_ptr = None if ws is None else ws.data_ptr()
    lib = _build.load("quant_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if a8:
            x_q, x_scale = quantize_rows(x)
            rc = lib.quant_matmul_a8_launch(
                x_q.data_ptr(), x_scale.data_ptr(), qw.w.data_ptr(), qw.scale.data_ptr(),
                y.data_ptr(), ws_ptr, m, k, n, qw.bits, DTYPE_CODES[out_dtype], split_rows,
                stream)
        else:
            rc = lib.quant_matmul_launch(
                x.data_ptr(), qw.w.data_ptr(), qw.scale.data_ptr(), y.data_ptr(), ws_ptr,
                m, k, n, qw.bits, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], split_rows,
                stream)
    _build.check(lib, rc, "quant_matmul")
    global QMM8_LAUNCHES, QMM4_LAUNCHES, QMM8_A8_LAUNCHES, QMM4_A8_LAUNCHES
    if qw.bits == 8:
        QMM8_LAUNCHES += 1
        QMM8_A8_LAUNCHES += a8
    else:
        QMM4_LAUNCHES += 1
        QMM4_A8_LAUNCHES += a8
    return y
