"""Constants and integer helpers shared by the attention operators."""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

# Large-negative logit used for masking instead of -inf, so that a
# (masked - max) difference never forms -inf - -inf. The CUDA kernels use the
# same constant (csrc/common.cuh).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def card_device(device: torch.device | str = "cuda") -> torch.device:
    """`device` as a torch.device; the card unless the caller names another.

    Constructors default to the card: without one they raise here instead
    of quietly building on the CPU, where only the plain versions run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: flashattn_tpu_torch runs its kernels on the "
            "card; pass device='cpu' to run the plain PyTorch versions")
    return device


def check_softcap(logit_softcap) -> float | None:
    """A logit soft-cap as the kernels take it: None (also for 0 or None:
    off, as the JAX package's falsy test reads it) or a positive finite
    float. Raises ValueError on anything else."""
    if not logit_softcap:
        return None
    if isinstance(logit_softcap, bool) or not isinstance(logit_softcap, numbers.Real) \
            or not math.isfinite(logit_softcap) or logit_softcap < 0:
        raise ValueError(f"logit_softcap must be a positive number or None, got "
                         f"{logit_softcap!r}")
    return float(logit_softcap)


def softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(s / cap) on the scaled logits (identity without a cap):
    the plain versions' soft-cap, before any mask."""
    return s if cap is None else cap * torch.tanh(s / cap)


# Attention dropout's counter-based keep mask (the JAX package's
# flashattn_tpu/ops/common.py::dropout_keep_mask): a pure function of the
# int32 seed, bh = b * Hq + the query head, the query's row and the key's
# column in the arrays, so the forward and the backward regenerate it and
# never store it. The kernels hash alike (csrc/common.cuh dropout_keep).
_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for int64 a in [0, 2^32) and c < 2^32, without an int64
    product past 2^63: a's high and low 16 bits apart."""
    return (((a >> 16) * c & 0xFFFF) << 16) + (a & 0xFFFF) * c & _U32


def check_dropout(rate, seed) -> float:
    """The dropout rate as the kernels take it, a float in [0, 1): 0 is off.
    A rate above 0 needs a seed: an int in int32's range or a one-element
    int32 tensor (the JAX package asserts one too). Raises ValueError."""
    if isinstance(rate, bool) or not isinstance(rate, numbers.Real) \
            or not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be a number in [0, 1), got {rate!r}")
    rate = float(rate)
    if rate > 0.0:
        if seed is None:
            raise ValueError("dropout_rate > 0 needs a dropout_seed")
        if isinstance(seed, torch.Tensor):
            if seed.dtype != torch.int32 or seed.numel() != 1:
                raise ValueError(f"dropout_seed must be a one-element int32 tensor, got "
                                 f"{seed.dtype} of shape {tuple(seed.shape)}")
        elif isinstance(seed, bool) or not isinstance(seed, numbers.Integral) \
                or not -2**31 <= seed < 2**31:
            raise ValueError(f"dropout_seed must be an int32 or an int32 tensor, got {seed!r}")
    return rate


def dropout_threshold(rate: float) -> int:
    """The hash's keep threshold: an element is kept iff its hash >= this,
    uint32(rate * 2^32) as the JAX package computes it."""
    return int(rate * 4294967296.0)


def dropout_scale(rate: float) -> float:
    """1 / (1 - rate) as a float32 (a Python float holding its value): the
    factor of the kept probabilities, as the JAX kernels multiply P by it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_hash(seed, bh, rows, cols) -> torch.Tensor:
    """The keep mask's uint32 hash (int64 in [0, 2^32)) of the elements at
    (rows, cols), broadcast together with bh. seed: an int or a
    one-element integer tensor (a negative int32 wraps as uint32); bh: an
    int or an integer tensor, b * Hq + the query head; rows, cols: integer
    tensors of query rows and key columns in the arrays (no pos_offset).
    Plain PyTorch in int64, each product and sum taken mod 2^32 (the hash
    is on uint32), on the tensors' device."""
    rows = torch.as_tensor(rows).to(torch.int64)
    dev = rows.device
    seed = torch.as_tensor(seed, device=dev).to(torch.int64).reshape(()) & _U32
    bh = torch.as_tensor(bh, device=dev).to(torch.int64)
    h = _mul32(rows & _U32, 0x9E3779B1) ^ _mul32(torch.as_tensor(cols, device=dev)
                                               .to(torch.int64) & _U32, 0x85EBCA77)
    h = h ^ ((seed + _mul32(bh & _U32, 0x27D4EB2F)) & _U32)
    # xxhash's avalanche: two multiply-xorshift rounds.
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    return h ^ (h >> 15)


def dropout_keep_mask(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """The keep mask of the elements at (rows, cols), dropout_hash's
    arguments: True keeps (hash >= dropout_threshold(rate))."""
    return dropout_hash(seed, bh, rows, cols) >= dropout_threshold(rate)
