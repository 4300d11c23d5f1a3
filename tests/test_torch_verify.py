"""utils/verify.py's rule on the card, run here on CPU tensors: the same
report as the host's numpy pass, and for float32 operands the JAX
package's, on outputs that pass, fail by a margin, hold matching -inf
(rows without keys) and hold a NaN."""

import numpy as np
import pytest
import torch

from flashattn_tpu.utils.verify import verify_results as jax_verify_results
from flashattn_tpu_torch.utils import verify

torch.set_num_threads(1)

FIELDS = ("max_abs_err", "mean_abs_err", "max_rel_err", "max_normalized_err")


def pair(case: str, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((4, 8, 33)).astype(np.float32)
    noise = {"pass": 1e-4, "fail": 3e-2}.get(case, 1e-4)
    out = ref + noise * rng.standard_normal(ref.shape).astype(np.float32)
    if case == "-inf":
        ref[1, 2, :] = out[1, 2, :] = -np.inf
    if case == "nan":
        out[0, 0, 5] = np.nan
    return torch.from_numpy(ref).to(dtype), torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["pass", "fail", "-inf", "nan", "equal"])
def test_card_rule_equals_host_rule(case, dtype):
    ref, out = pair(case, dtype)
    if case == "equal":
        out = ref.clone()
    tol = dict(rtol=1e-2, atol=1e-3, cos_threshold=0.999)
    host = verify.verify_results(ref, out, **tol)
    card = verify._verify_on_card(ref, out, **tol)
    assert (card.passed, card.allclose) == (host.passed, host.allclose)
    assert host.passed == (case in ("pass", "-inf", "equal"))
    # the cosine's sums are float64 here, float32 on the host
    np.testing.assert_allclose(card.cosine, host.cosine, rtol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(card, f), getattr(host, f), rtol=1e-6)
    if dtype == torch.float32:
        jax = jax_verify_results(ref.numpy(), out.numpy(), **tol)
        assert (card.passed, card.allclose) == (jax.passed, jax.allclose)
        np.testing.assert_allclose(card.cosine, jax.cosine, rtol=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(card, f), getattr(jax, f), rtol=1e-6)
