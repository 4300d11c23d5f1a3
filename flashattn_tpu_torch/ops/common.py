"""Constants and integer helpers shared by the attention operators."""

from __future__ import annotations

import math

import numpy as np

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


def unported(feature: str, item: str) -> NotImplementedError:
    """The error an option of the JAX package raises until its port lands."""
    return NotImplementedError(
        f"{feature} is not ported to flashattn_tpu_torch yet: ROADMAP {item}")
