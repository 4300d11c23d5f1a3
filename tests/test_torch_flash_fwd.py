"""The port's flash forward (plain path on the CPU) against the JAX package's
flash_attention_forward, run in interpret mode through both of its grids
(wavefront and grid4), on the same numpy inputs.

Tolerance in float32: atol 2e-5, rtol 1e-5 (exp2 against exp and a
different summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import flash_fwd
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
IMPLS = ["wavefront", "grid4"]


def make_qkv(hq, hkv, s_q, s_k, d=64, b=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s_q, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s_k, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s_k, d), dtype=np.float32)
    return q, k, v


def both(q, k, v, impl, is_causal, pos_offset=None):
    bs = BlockSizes(block_q=128, block_kv=128, fwd_impl=impl)
    o_j, lse_j = jax_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             is_causal=is_causal, block_sizes=bs,
                             pos_offset=pos_offset)
    o_t, lse_t = flash_fwd.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=is_causal, pos_offset=pos_offset)
    return (np.asarray(o_j), np.asarray(lse_j)), (o_t, lse_t)


def assert_close(jax_out, port_out):
    for name, ref, out in zip(("O", "LSE"), jax_out, port_out):
        rep = verify_results(ref, out, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"{name}: {rep}"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("s", [128, 200])
def test_forward_matches_jax(impl, is_causal, hq, hkv, s):
    q, k, v = make_qkv(hq, hkv, s, s)
    assert_close(*both(q, k, v, impl, is_causal))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("is_causal", [False, True])
def test_forward_sq_below_sk_matches_jax(impl, is_causal):
    """S_q < S_k: the causal mask aligns bottom-right."""
    q, k, v = make_qkv(4, 2, 64, 256)
    assert_close(*both(q, k, v, impl, is_causal))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_rows_without_keys(impl):
    """A negative pos_offset leaves the first rows with no visible key:
    O = 0 and LSE = -inf there, in both packages."""
    q, k, v = make_qkv(4, 2, 128, 128)
    jax_out, port_out = both(q, k, v, impl, True, pos_offset=-64)
    assert_close(jax_out, port_out)
    o, lse = port_out
    assert torch.equal(o[:, :, :64], torch.zeros_like(o[:, :, :64]))
    assert bool(torch.isneginf(lse[:, :, :64]).all())
    assert bool(torch.isfinite(lse[:, :, 64:]).all())


def test_need_lse_false_returns_no_lse():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(4, 2, 64, 64))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, need_lse=False)
    assert lse is None
    assert torch.equal(o, flash_fwd.flash_attention_forward(q, k, v, True)[0])


def test_reference_matches_jax_oracle():
    """The torch oracle against the JAX package's jnp oracle."""
    from flashattn_tpu.ops.reference import reference_attention_with_lse as jax_ref

    q, k, v = make_qkv(8, 2, 96, 160, d=32)
    o_j, lse_j = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True)
    o_t, lse_t = reference_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=True)
    assert_close((np.asarray(o_j), np.asarray(lse_j)), (o_t, lse_t))


@pytest.mark.parametrize("option", [dict(alibi=True, dyn_pos_offset=0), dict(dyn_pos_offset=0)])
def test_unported_options_raise(option):
    """dyn_pos_offset (the zigzag ring passes it), which raised naming
    ROADMAP A4, runs in the plain forward, also beside ALiBi (against JAX:
    tests/test_torch_dyn_offset.py): without a window it equals the static
    alignment pos_offset = offset; on the card its left-out combinations
    raise naming ROADMAP A9 (test_torch_dyn_offset.py). The options that
    raised beside it before run too (test_dropout_options_match_jax)."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 1, 8, 8, d=8))
    o, lse = flash_fwd.flash_attention_forward(q, k, v, **option)
    static = dict(option, pos_offset=option["dyn_pos_offset"])
    del static["dyn_pos_offset"]
    o_s, lse_s = flash_fwd.flash_attention_forward(q, k, v, **static)
    assert torch.equal(o, o_s) and torch.equal(lse, lse_s)


@pytest.mark.parametrize("option", [
    dict(segment_ids="ids", dropout_rate=0.1), dict(dropout_rate=0.1),
    dict(window=16, alibi=True, dropout_rate=0.1),
    dict(logit_softcap=30.0, dropout_rate=0.1), dict(alibi=True, segment_ids="ids", dropout_rate=0.1),
], ids=["segments", "alone", "window_alibi", "softcap", "alibi_segments"])
def test_dropout_options_match_jax(option):
    """Attention dropout (ported: tests/test_torch_dropout.py), alone and
    beside segment ids, a window with ALiBi, the soft-cap and ALiBi with
    segment ids, the option sets that raised before: O and the LSE of the
    plain forward against the JAX forward (its wavefront kernel; grid4
    takes no dropout) with the same rate and seed."""
    q, k, v = make_qkv(4, 2, 128, 128, seed=3)
    jopts, topts = dict(option, dropout_seed=-21), dict(option, dropout_seed=-21)
    if option.get("segment_ids") == "ids":
        ids = np.repeat(np.arange(3, dtype=np.int32), [50, 40, 38])[None]
        jopts["segment_ids"] = (jnp.asarray(ids),) * 2
        topts["segment_ids"] = (torch.from_numpy(ids),) * 2
    o_j, lse_j = jax_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
                             block_sizes=BlockSizes(block_q=128, block_kv=128), **jopts)
    o_t, lse_t = flash_fwd.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=True, **topts)
    assert_close((np.asarray(o_j), np.asarray(lse_j)), (o_t, lse_t))


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "gqa"])
def test_bad_shapes_raise(bad):
    q, k, v = (torch.from_numpy(a) for a in make_qkv(4, 2, 8, 8, d=8))
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :, :4]
    else:
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    with pytest.raises(ValueError):
        flash_fwd.flash_attention_forward(q, k, v)


def test_flash_attention_is_forward_only():
    """Without a gradient to take, flash_attention runs the forward alone (no
    LSE, nothing recorded); with one it records the flash autograd Function,
    whose primal output is the same."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 1, 8, 8, d=8))
    o = flash_attention(q, k, v, is_causal=True)
    assert o.grad_fn is None
    assert torch.equal(o, flash_fwd.flash_attention_forward_reference(q, k, v, True)[0])
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(), k, v, True).grad_fn is None
    o_grad = flash_attention(q, k, v, is_causal=True)
    assert type(o_grad.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.equal(o_grad.detach(), o)
