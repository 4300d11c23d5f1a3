"""utils/grad_oracle.py::float64_backward, the float64 gradients the
card-offset backward gate is held against: equal to autograd through a
float64 softmax attention, and to the JAX package's attention gradient on
float32 inputs within float32's noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.reference import reference_attention
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.reference import alibi_bias, visible
from flashattn_tpu_torch.utils.grad_oracle import float64_backward

torch.set_num_threads(1)

B, HQ, HKV, S, D = 1, 4, 2, 64, 16
# (is_causal, pos_offset, window, alibi): the card-offset gate's geometry
# (the window's left edge alone, offset S) and a causal one.
CASES = {"left_edge_alibi": (False, S, S, True), "causal_window": (True, None, 24, False),
         "left_edge": (False, S // 2, S, False)}


def draw(seed: int):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, HQ, S, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, HKV, S, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", CASES)
def test_float64_backward_equals_autograd(case):
    causal, off, window, alibi = CASES[case]
    q, k, v, do = (torch.from_numpy(a) for a in draw(0))
    slopes = flash_fwd.default_alibi_slopes(HQ) if alibi else None
    got = float64_backward(q, k, v, do, causal, pos_offset=off, window=window,
                           alibi_slopes=slopes)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    ke, ve = (t.repeat_interleave(HQ // HKV, dim=1) for t in leaves[1:])
    s = leaves[0] @ ke.transpose(-1, -2) / D**0.5
    if alibi:
        s = s + alibi_bias(slopes, S, S, off).double()
    mask = visible(S, S, causal, off, window)
    live = mask.any(dim=-1, keepdim=True)  # a row without a key contributes 0
    s = s.masked_fill(~mask, float("-inf")).masked_fill(~live, 0.0)
    o = torch.where(live, torch.softmax(s, dim=-1), 0.0) @ ve
    want = torch.autograd.grad(o, leaves, do.double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("window,alibi,cap", [(None, False, None), (24, True, None),
                                               (24, False, 2.0)])
def test_float64_backward_matches_jax_gradient(window, alibi, cap):
    """Causal GQA, alone, with a window and ALiBi, and with a window and a
    soft-cap that bends the logits (the JAX oracle's own alignment): the
    float64 gradients against jax.grad of the JAX reference_attention on
    the same float32 inputs (float32's noise, atol 1e-5, rtol 1e-4)."""
    q, k, v, do = draw(1)
    slopes = flash_fwd.default_alibi_slopes(HQ) if alibi else None
    got = float64_backward(*(torch.from_numpy(a) for a in (q, k, v, do)), True, window=window,
                           alibi_slopes=slopes, logit_softcap=cap)

    def loss(q, k, v):
        o = reference_attention(q, k, v, is_causal=True, window=window, logit_softcap=cap,
                                alibi=alibi)
        return jnp.sum(o * do)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_rounded_oracle_rounds_p_and_ds():
    """round_to=bf16 moves dV by about P's bf16 rounding and no more."""
    q, k, v, do = (torch.from_numpy(a) for a in draw(2))
    exact = float64_backward(q, k, v, do, True)
    rounded = float64_backward(q, k, v, do, True, round_to=torch.bfloat16)
    for e, r in zip(exact, rounded):
        diff = (e - r).abs().max().item()
        assert 0.0 < diff < 2e-2 * e.abs().max().item()


@pytest.mark.parametrize("alibi", [False, True])
def test_float64_backward_with_dropout_equals_the_plain_version(alibi):
    """Dropout at the card offset's left edge: the float64 gradients against
    the port's plain backward (ops/reference.py, whose dropout the JAX
    comparisons of tests/test_torch_dropout*.py hold) on float32 inputs,
    where it rounds nothing (float32's noise, atol 1e-5, rtol 1e-4)."""
    q, k, v, do = (torch.from_numpy(a) for a in draw(3))
    opts = dict(window=S, dropout_rate=0.25, dropout_seed=7, alibi=alibi)
    o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=S // 2, **opts)
    want = flash_bwd.flash_attention_backward_reference(q, k, v, o, do, lse, False,
                                                        dyn_pos_offset=S // 2, **opts)
    got = float64_backward(q, k, v, do, pos_offset=S // 2, window=S,
                           alibi_slopes=flash_fwd.default_alibi_slopes(HQ) if alibi else None,
                           dropout_rate=0.25, dropout_seed=7)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=1e-4, atol=1e-5)
