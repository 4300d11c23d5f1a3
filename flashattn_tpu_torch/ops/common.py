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


def unported(feature: str, item: str) -> NotImplementedError:
    """The error an option of the JAX package raises until its port lands."""
    return NotImplementedError(
        f"{feature} is not ported to flashattn_tpu_torch yet: ROADMAP {item}")
