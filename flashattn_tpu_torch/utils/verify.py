"""Numerical verification (counterpart of flashattn_tpu/utils/verify.py).

Same metrics and pass rule: allclose(rtol, atol) AND cosine > cos_threshold,
computed in float32 on the host, with matching non-finite positions (+-inf,
e.g. LSE = -inf of rows that see no key) counted as zero error.

One difference, for operands narrower than float32 (bf16, fp16): the JAX
version zeroes every exactly-equal position before the cosine, so its
cosine covers only the positions that differ. Two bf16 outputs that agree
bit for bit almost everywhere then get the cosine of their few rounding
differences, near 0, and fail. For such operands only the matching
non-finite positions are zeroed: equal entries count toward the cosine.
float32 operands get the JAX rule unchanged.

Two torch tensors of which one lies on the card are compared there, by the
same rule (the cosine's sums in float64): the host's single-threaded pass
over a copy costs seconds at a training shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class VerifyReport:
    passed: bool
    allclose: bool
    cosine: float
    max_abs_err: float
    mean_abs_err: float
    max_rel_err: float
    max_normalized_err: float

    def __str__(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        return (
            f"[{status}] allclose={self.allclose} cos={self.cosine:.6f} "
            f"max_abs={self.max_abs_err:.3e} mean_abs={self.mean_abs_err:.3e} "
            f"max_rel={self.max_rel_err:.3e} max_norm={self.max_normalized_err:.3f}"
        )


def _is_narrow(x) -> bool:
    """A floating type of fewer than 32 bits (bf16, fp16)."""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and x.element_size() < 4
    dtype = np.asarray(x).dtype
    return dtype.kind not in "biu" and dtype.itemsize < 4


def _to_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def verify_results(
    reference,
    output,
    rtol: float = 1e-2,
    atol: float = 1e-3,
    cos_threshold: float = 0.999,
    name: str = "",
    verbose: bool = False,
) -> VerifyReport:
    """Compare `output` against `reference` (numpy arrays or torch tensors)."""
    if (isinstance(reference, torch.Tensor) and isinstance(output, torch.Tensor)
            and (reference.is_cuda or output.is_cuda)):
        report = _verify_on_card(reference, output, rtol, atol, cos_threshold)
        if verbose:
            print(f"{name}: {report}")
        return report
    ref = _to_f32(reference)
    out = _to_f32(output)
    if ref.shape != out.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {out.shape}")

    eq = ref == out
    if _is_narrow(reference) or _is_narrow(output):
        eq &= ~np.isfinite(ref)
    ref = np.where(eq, 0.0, ref)
    out = np.where(eq, 0.0, out)

    abs_err = np.abs(out - ref)
    max_abs = float(abs_err.max())
    mean_abs = float(abs_err.mean())
    max_rel = float((abs_err / (np.abs(ref) + 1e-5)).max())
    max_norm = float((abs_err / (atol + rtol * np.abs(ref))).max())

    denom = np.linalg.norm(ref.ravel()) * np.linalg.norm(out.ravel())
    if denom == 0.0:
        cosine = 1.0 if not abs_err.any() else 0.0
    else:
        cosine = float(np.dot(ref.ravel(), out.ravel()) / denom)

    ok_allclose = bool(np.allclose(out, ref, rtol=rtol, atol=atol))
    report = VerifyReport(
        passed=ok_allclose and cosine > cos_threshold,
        allclose=ok_allclose,
        cosine=cosine,
        max_abs_err=max_abs,
        mean_abs_err=mean_abs,
        max_rel_err=max_rel,
        max_normalized_err=max_norm,
    )
    if verbose:
        print(f"{name}: {report}")
    return report


def _verify_on_card(reference: torch.Tensor, output: torch.Tensor, rtol: float, atol: float,
                    cos_threshold: float) -> VerifyReport:
    """verify_results' rule on the card that holds one of the two tensors."""
    dev = reference.device if reference.is_cuda else output.device
    ref = reference.detach().to(dev, torch.float32)
    out = output.detach().to(dev, torch.float32)
    if ref.shape != out.shape:
        raise ValueError(f"shape mismatch {tuple(ref.shape)} vs {tuple(out.shape)}")

    eq = ref == out
    if _is_narrow(reference) or _is_narrow(output):
        eq &= ~torch.isfinite(ref)
    ref = torch.where(eq, 0.0, ref)
    out = torch.where(eq, 0.0, out)

    abs_err = (out - ref).abs()
    max_abs = float(abs_err.max())
    mean_abs = float(abs_err.mean())
    max_rel = float((abs_err / (ref.abs() + 1e-5)).max())
    max_norm = float((abs_err / (atol + rtol * ref.abs())).max())

    r64, o64 = ref.flatten().double(), out.flatten().double()
    denom = float(r64.norm() * o64.norm())
    if denom == 0.0:
        cosine = 1.0 if not bool(abs_err.any()) else 0.0
    else:
        cosine = float(r64 @ o64) / denom

    ok_allclose = bool(torch.allclose(out, ref, rtol=rtol, atol=atol))
    return VerifyReport(
        passed=ok_allclose and cosine > cos_threshold,
        allclose=ok_allclose,
        cosine=cosine,
        max_abs_err=max_abs,
        mean_abs_err=mean_abs,
        max_rel_err=max_rel,
        max_normalized_err=max_norm,
    )
