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


def attention_fwd_roofline(
    b: int, hq: int, hkv: int, s_q: int, s_k: int, d: int,
    is_causal: bool, dtype_bytes: int = 2, chip: ChipSpec | None = None,
    need_lse: bool = True,
) -> RooflineReport:
    """The flash forward (K1): Q, K and V read once, O written once, and the
    float32 LSE when `need_lse`."""
    q_bytes = b * hq * s_q * d * dtype_bytes
    kv_bytes = 2 * b * hkv * s_k * d * dtype_bytes
    lse_bytes = 4 * b * hq * s_q if need_lse else 0
    return roofline(attention_flops(b, hq, s_q, s_k, d, is_causal),
                    2 * q_bytes + kv_bytes + lse_bytes, _float_dtype(dtype_bytes), chip)


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
    kernel: str = "fused",
) -> RooflineReport:
    """The flash backward. ``kernel="fused"`` (B3, the default) is the whole
    backward, 2.5 x the forward's FLOPs as in the JAX package; the split
    path's kernels recompute S: ``"dq"`` (B4) 1.5 x, ``"dkv"`` (B5) 2 x.
    Bytes: every operand the kernel reads once, every result written once."""
    if kernel not in _BWD_KERNELS:
        raise ValueError(f"kernel must be one of {sorted(_BWD_KERNELS)}: {kernel!r}")
    q = b * hq * s_q * d * dtype_bytes  # Q, O, dO and dQ each
    kv = b * hkv * s_k * d * dtype_bytes  # K, V, dK and dV each
    row = 4 * b * hq * s_q  # the LSE, delta
    reads = 3 * q + 2 * kv + row  # Q, O, dO, K, V, LSE
    hbm = {"fused": reads + q + 2 * kv,
           "dq": reads + q + row,
           "dkv": reads - q + row + 2 * kv}[kernel]
    flops = _BWD_KERNELS[kernel] / 2 * attention_flops(b, hq, s_q, s_k, d, is_causal)
    return roofline(flops, hbm, _float_dtype(dtype_bytes), chip)


def decode_roofline(
    b: int, hq: int, hkv: int, d: int, lengths: list[int], t: int = 1,
    cache_dtype: torch.dtype = torch.bfloat16, q_dtype_bytes: int = 2,
    chip: ChipSpec | None = None,
) -> RooflineReport:
    """Flash-decode (K2, dense or paged): T new tokens a sequence against
    caches of `lengths` tokens. Bytes: each live K and V value once (one
    byte a value when quantized, plus two float32 scales a token and kv
    head), q read and O written once, the lengths. Operations: 4 D a q head
    for each (row, position) pair the causal chunk sees, against the peak
    of the cache's type."""
    esize = torch.empty((), dtype=cache_dtype).element_size()
    live = sum(lengths)
    hbm = 2 * hkv * live * (d * esize + (4 if esize == 1 else 0))
    hbm += 2 * b * hq * t * d * q_dtype_bytes + 4 * b
    seen = sum(max(0, min(n, n - t + i + 1)) for n in lengths for i in range(t))
    return roofline(4.0 * hq * d * seen, hbm, cache_dtype, chip)


def quant_matmul_roofline(m: int, k: int, n: int, bits: int,
                          chip: ChipSpec | None = None) -> RooflineReport:
    """qmm8/qmm4 on bf16 x: x [M, K] and the weights (K N bytes at 8 bits,
    half at 4) and their float32 scales read once, y [M, N] in bf16 written
    once; 2 M K N operations against the bf16 peak (the kernels widen the
    weights to bf16 for the products)."""
    hbm = 2 * m * k + k * n * bits // 8 + 4 * n + 2 * m * n
    return roofline(2.0 * m * k * n, hbm, torch.bfloat16, chip)
