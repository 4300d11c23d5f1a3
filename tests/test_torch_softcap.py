"""The logit soft-cap (Gemma-2's s = cap * tanh(s / cap) on the scaled
logits, before any mask) in the port's flash forward glue (K1's plain
version on the CPU) against the JAX package's kernel in interpret mode on
the same numpy inputs, at D 64 and D 256, causal or not, with a window and
with S_q != S_k and a pos_offset; the int8 decode mode's q scales under a
cap, bit for bit (the decode kernels' parity: tests/
test_torch_softcap_decode.py). Training with a cap (the backward):
tests/test_torch_softcap_bwd.py.

Tolerance: atol 1e-4, rtol 1e-4 in float32 (tests/test_softcap.py's gate:
the JAX kernel folds the scale into q before the dot, the plain version
scales after, and the tanh's slope carries that rounding at the inputs'
large magnitudes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu_torch.ops import decode, flash_fwd
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
CAP = 30.0
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128)


def make_qkv(hq, hkv, s_q, s_k, d, scale_up=4.0, seed=0):
    """Inputs large enough that the tanh bends the logits (as
    tests/test_softcap.py makes them)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, s, d), dtype=np.float32) * scale_up
                 for h, s in ((hq, s_q), (hkv, s_k), (hkv, s_k)))


def port_forward(q, k, v, **kw):
    """K1's CPU path with the LSE, and flash_attention's primal, which must
    give the same O."""
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = flash_fwd.flash_attention_forward(tq, tk, tv, kw.pop("is_causal"), **kw)
    return o, lse


FWD_CASES = {
    # name: (Hq, Hkv, S_q, S_k, D, is_causal, cap, window, pos_offset)
    "d64_cap5": (2, 2, 256, 256, 64, False, 5.0, None, None),
    "d64_cap30_causal": (2, 2, 256, 256, 64, True, 30.0, None, None),
    "d64_cap8_window100": (2, 1, 256, 256, 64, True, 8.0, 100, None),
    "d256_cap5_causal_gqa": (4, 2, 160, 160, 256, True, 5.0, None, None),
    "d256_cap30": (2, 2, 160, 160, 256, False, 30.0, None, None),
    "d256_cap50_window100": (2, 1, 256, 256, 256, True, 50.0, 100, None),
    "d64_cap5_sq_below_sk_pos_offset": (2, 1, 96, 256, 64, True, 5.0, None, 60),
    "d256_cap30_sq_below_sk_window": (2, 2, 64, 200, 256, True, 30.0, 40, None),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_softcapped_forward_matches_jax(case):
    hq, hkv, s_q, s_k, d, causal, cap, w, off = FWD_CASES[case]
    q, k, v = make_qkv(hq, hkv, s_q, s_k, d, seed=s_q + d)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              is_causal=causal, logit_softcap=cap, window=w,
                              pos_offset=off, block_sizes=BS)
    o, lse = port_forward(q, k, v, is_causal=causal, logit_softcap=cap, window=w,
                          pos_offset=off)
    rep = verify_results(np.asarray(ref), o, **FWD_TOL)
    assert rep.passed, rep
    assert bool(torch.isfinite(lse).all())
    # flash_attention without a gradient: the same forward, no LSE
    o2 = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal,
                         pos_offset=off, window=w, logit_softcap=cap)
    assert torch.equal(o2, o)


def test_softcap_actually_caps():
    """Mirrors tests/test_softcap.py::test_softcap_actually_caps: a cap of
    5 moves the output of inputs whose logits pass it."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(2, 2, 384, 384, 64, scale_up=8.0,
                                                     seed=5))
    capped, _ = flash_fwd.flash_attention_forward(q, k, v, True, logit_softcap=5.0)
    free, _ = flash_fwd.flash_attention_forward(q, k, v, True)
    assert not torch.allclose(capped, free, atol=1e-3)
    # a cap of 0 or None is off, as the JAX package's falsy test reads it
    for off in (0, 0.0, None):
        assert torch.equal(flash_fwd.flash_attention_forward(q, k, v, True,
                                                             logit_softcap=off)[0], free)


@pytest.mark.parametrize("bad", [-1.0, float("inf"), float("nan"), "30", True])
def test_bad_softcap_raises(bad):
    q, k, v = (torch.from_numpy(x) for x in make_qkv(2, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="logit_softcap"):
        flash_fwd.flash_attention_forward(q, k, v, True, logit_softcap=bad)


jax_prep_decode_q = jax.jit(jax_decode.prep_decode_q, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("d", [64, 256])
def test_int8_q_scales_under_a_cap_bit_equal_to_jax(d):
    """Under a cap q is pre-scaled by `scale` alone before its int8
    quantization (the JAX launcher's `pre`): the q rows and scales equal
    JAX's bit for bit."""
    rng = np.random.default_rng(12 + d)
    q = rng.standard_normal((2, 8, 3, d), dtype=np.float32) * 4
    scale = d**-0.5
    pre = decode.pre_scale(scale, CAP)
    assert pre == scale and decode.pre_scale(scale, None) == scale * decode.LOG2E
    ref_q, ref_s = jax_prep_decode_q(jnp.asarray(q), 2, True, scale)
    out_q, out_s = decode.prep_decode_q(torch.from_numpy(q), 2, True, pre)
    np.testing.assert_array_equal(out_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
