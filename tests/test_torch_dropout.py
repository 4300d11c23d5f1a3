"""Attention dropout in the port (the kernels' plain versions on the CPU)
against the JAX package's, on the same numpy inputs.

The keep mask is a pure function of (seed, b * Hq + h, row, column), so
the port's ops/common.py::dropout_keep_mask is held bit for bit to
flashattn_tpu.ops.common.dropout_keep_mask over seeds, heads, coordinates
and rates; the plain forward to JAX's flash_attention with dropout (its
Pallas kernel in interpret mode), causal or not, with GQA, and its
gradients to jax.grad of it; with a window, segment ids (through the JAX
flash_attention_forward and flash_attention_backward), the soft-cap and
ALiBi. Mirrors tests/test_dropout.py (rate 0, seeds, the keep fraction)
and tests/test_determinism.py::test_dropout_deterministic_given_seed; the
autograd Function and the registered operators carry the seed, so the
backward's mask is the forward's. The kernels' readouts on the card:
tests/test_torch_cuda.py.

Tolerance: float32, atol 1e-5 and rtol 1e-5 for O, rtol 1e-4 for the
gradients (the JAX kernels use exp2 on pre-scaled operands and sum in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.common import dropout_keep_mask as jax_keep_mask
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd, launches, reference
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.ops.common import (
    dropout_hash,
    dropout_keep_mask,
    dropout_scale,
    dropout_threshold,
)
from flashattn_tpu_torch.ops.reference import dropout_keep
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

O_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)


def make_inputs(hq, hkv, s_q, s_k, d=64, b=1, seed=0):
    """q, k, v and dO from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s_q, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s_k, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s_k, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, s_q, d), dtype=np.float32)
    return q, k, v, do


def assert_close(refs, outs, names, tol):
    for name, ref, out in zip(names, refs, outs):
        rep = verify_results(np.asarray(ref), out.detach(), **tol)
        assert rep.passed, f"{name}: {rep}"


# ---- the mask ----

@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("seed", [-1, 0, 7, 2**31 - 1])
def test_keep_mask_is_jax_bit_for_bit(seed, rate):
    """Rows and columns 0..64 and random ones up to 2^16, bh 0, 5, 31 and
    2^16: every element as the JAX hash gives it."""
    rng = np.random.default_rng(seed & 0xFFFF)
    rows = np.concatenate([np.arange(65), rng.integers(0, 2**16, 63), [2**16]])
    cols = np.concatenate([np.arange(65), rng.integers(0, 2**16, 63), [2**16 - 1]])
    rows = rows.astype(np.int32)[:, None]
    cols = cols.astype(np.int32)[None, :]
    for bh in (0, 5, 31, 2**16):
        want = np.asarray(jax_keep_mask(jnp.int32(seed), jnp.int32(bh), jnp.asarray(rows),
                                        jnp.asarray(cols), rate))
        got = dropout_keep_mask(seed, bh, torch.from_numpy(rows), torch.from_numpy(cols), rate)
        assert np.array_equal(got.numpy(), want), (seed, bh, rate)
    # A seed tensor and a [B, H, 1, 1] bh tensor broadcast to the same bits.
    bh = torch.tensor([[3, 4], [40, 41]])[:, :, None, None]
    got = dropout_keep_mask(torch.tensor(seed, dtype=torch.int32), bh,
                            torch.from_numpy(rows), torch.from_numpy(cols), rate)
    for i in range(2):
        for j in range(2):
            want = dropout_keep_mask(seed, int(bh[i, j]), torch.from_numpy(rows),
                                     torch.from_numpy(cols), rate)
            assert torch.equal(got[i, j], want)


def test_threshold_and_scale():
    """uint32(rate * 2^32) and float32(1 / (1 - rate)), as the JAX kernels
    take them."""
    for rate in (0.1, 0.25, 0.5, 0.9, 1 - 2**-30):
        assert dropout_threshold(rate) == int(np.uint32(int(rate * 4294967296.0)))
        assert dropout_scale(rate) == float(np.float32(1.0 / (1.0 - rate)))


def test_keep_fraction():
    """tests/test_dropout.py::test_dropout_keep_fraction: a 4096 x 4096
    tile keeps 1 - rate of its elements within 5e-3; the plain mask of
    several heads is built in row chunks and equals the whole."""
    h = dropout_hash(42, 3, torch.arange(4096)[:, None], torch.arange(4096)[None, :])
    for rate in (0.1, 0.5):
        frac = float((h >= dropout_threshold(rate)).float().mean())
        assert abs(frac - (1.0 - rate)) < 5e-3, (rate, frac)
    keep = dropout_keep(9, 0.3, 2, 6, slice(2, 5), 300, 70, "cpu")
    bh = (torch.arange(2)[:, None] * 6 + torch.arange(2, 5)[None, :])[:, :, None, None]
    assert torch.equal(keep, dropout_keep_mask(9, bh, torch.arange(300)[:, None],
                                               torch.arange(70)[None, :], 0.3))


@pytest.mark.parametrize("bad", [
    dict(dropout_rate=1.0, dropout_seed=0), dict(dropout_rate=-0.1, dropout_seed=0),
    dict(dropout_rate=0.1), dict(dropout_rate=0.1, dropout_seed=2**31),
    dict(dropout_rate=0.1, dropout_seed=torch.tensor(3)),
    dict(dropout_rate=0.1, dropout_seed=1.5), dict(dropout_rate=True, dropout_seed=0),
])
def test_bad_dropout_arguments_raise(bad):
    """A rate outside [0, 1), a rate without a seed (the JAX launcher
    asserts one), a seed outside int32 or a seed tensor not int32: ValueError,
    from every entry point."""
    q, k, v, do = (torch.from_numpy(a) for a in make_inputs(2, 1, 8, 8, d=8))
    with pytest.raises(ValueError, match="dropout"):
        flash_fwd.flash_attention_forward(q, k, v, **bad)
    o, lse = flash_fwd.flash_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="dropout"):
        flash_bwd.flash_attention_backward(q, k, v, o, do, lse, **bad)
    with pytest.raises(ValueError, match="dropout"):
        flash_attention(q.requires_grad_(), k, v, **bad)


# ---- forward and gradients against JAX's flash_attention ----

CASES = {
    # name: (B, Hq, Hkv, S, causal, rate, seed)
    "causal": (2, 2, 2, 160, True, 0.15, 1234),
    "non_causal": (1, 2, 2, 200, False, 0.5, -7),
    "gqa_causal": (1, 4, 2, 128, True, 0.25, 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    """tests/test_dropout.py's forward, gradient and GQA tests: O of the
    port's flash_attention (and of the plain route) against JAX's
    flash_attention with the same rate and seed, the gradients of sum(O dO)
    against jax.grad; no kernel launches on the CPU."""
    b, hq, hkv, s, causal, rate, seed = CASES[case]
    q, k, v, do = make_inputs(hq, hkv, s, s, b=b, seed=len(case))

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, is_causal=causal, block_sizes=BS, dropout_rate=rate,
                                dropout_seed=seed)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, o_ref), g_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    before = launches.read()
    for fn in (flash_attention, plain_flash_attention):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fn(qt, kt, vt, is_causal=causal, dropout_rate=rate, dropout_seed=seed)
        assert_close([o_ref], [o], ["O"], O_TOL)
        grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
        assert_close(g_ref, grads, ("dQ", "dK", "dV"), GRAD_TOL)
    assert launches.read() == before


OPTION_CASES = {
    # name: (Hq, Hkv, S_q, S_k, options, the JAX backward's impl)
    "window40_gqa": (4, 2, 192, 192, dict(is_causal=True, window=40), "split"),
    "segments_window30": (4, 2, 200, 200, dict(is_causal=True, window=30,
                                               segment_ids=[70, 50, 80]), "split"),
    "segments_noncausal_alibi": (2, 1, 200, 200, dict(is_causal=False, alibi=True,
                                                      segment_ids=[90, 110]), "fused"),
    "softcap30": (4, 2, 192, 192, dict(is_causal=True, logit_softcap=30.0), "fused"),
    "alibi_sq_below_sk": (2, 1, 96, 256, dict(is_causal=True, alibi=True, pos_offset=60),
                          "fused"),
}


def ids_of(lens, total):
    ids = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)])
    assert ids.size == total
    return ids[None]


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_with_dropout_match_jax(case):
    """Dropout beside a window, segment ids, the soft-cap and ALiBi: the
    plain forward against JAX's flash_attention_forward, then the plain
    backward on that O and LSE against JAX's flash_attention_backward
    (split or fused), both in interpret mode."""
    hq, hkv, s_q, s_k, opts, impl = OPTION_CASES[case]
    opts = dict(opts, dropout_rate=0.2, dropout_seed=-31)
    q, k, v, do = make_inputs(hq, hkv, s_q, s_k, seed=len(case))
    jopts, topts = dict(opts), dict(opts)
    if "segment_ids" in opts:
        ids = ids_of(opts["segment_ids"], s_q)
        jopts["segment_ids"] = (jnp.asarray(ids), jnp.asarray(ids))
        topts["segment_ids"] = (torch.from_numpy(ids), torch.from_numpy(ids))
    o_ref, lse_ref = jax_forward(*map(jnp.asarray, (q, k, v)), block_sizes=BS, **jopts)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_fwd.flash_attention_forward(tq, tk, tv, **topts)
    assert_close([o_ref, lse_ref], [o, lse], ["O", "LSE"], O_TOL)
    g_ref = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                         block_sizes=BS, impl=impl, **jopts)
    grads = flash_bwd.flash_attention_backward(tq, tk, tv, o, tdo, lse, impl=impl, **topts)
    assert_close(g_ref, grads, ("dQ", "dK", "dV"), GRAD_TOL)


def test_lse_stays_clean():
    """The LSE with dropout is the LSE without it: dropout acts on the P
    that meets V, not on the row sums."""
    q, k, v, _ = (torch.from_numpy(a) for a in make_inputs(2, 1, 130, 130))
    _, lse = flash_fwd.flash_attention_forward(q, k, v, True, dropout_rate=0.4, dropout_seed=3)
    assert torch.equal(lse, flash_fwd.flash_attention_forward(q, k, v, True)[1])


@pytest.mark.parametrize("is_causal", [True, False])
def test_row_slices_of_the_plain_versions(is_causal):
    """The plain forward and backward on q rows [r0, r0 + n) of a call,
    with dropout_row0=r0 (and pos_offset=r0 when causal, S_q = S_k), give
    that call's O, LSE and dQ rows; GQA 4/2."""
    q, k, v, do = (torch.from_numpy(a) for a in make_inputs(4, 2, 300, 300, seed=6))
    drop = dict(dropout_rate=0.3, dropout_seed=11)
    o, lse = reference.reference_attention_with_lse(q, k, v, is_causal, **drop)
    dq = reference.reference_attention_backward(q, k, v, o, do, lse, is_causal, **drop)[0]
    for r0, n in ((0, 64), (117, 100), (236, 64)):
        rows = slice(r0, r0 + n)
        off = dict(pos_offset=r0) if is_causal else {}
        o_s, lse_s = reference.reference_attention_with_lse(q[:, :, rows], k, v, is_causal,
                                                            dropout_row0=r0, **off, **drop)
        dq_s = reference.reference_attention_backward(
            q[:, :, rows], k, v, o[:, :, rows], do[:, :, rows], lse_s, is_causal,
            dropout_row0=r0, **off, **drop)[0]
        assert_close((o[:, :, rows], lse[:, :, rows], dq[:, :, rows]), (o_s, lse_s, dq_s),
                     ("O", "LSE", "dQ"), O_TOL)


# ---- tests/test_dropout.py's and tests/test_determinism.py's ----

def test_zero_rate_is_identity():
    """Rate 0 with a seed gives the bits of the call without dropout,
    forward and gradients."""
    q, k, v, do = make_inputs(2, 2, 256, 256, seed=1)
    outs = []
    for kw in (dict(), dict(dropout_rate=0.0, dropout_seed=7)):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = flash_attention(qt, kt, vt, is_causal=True, **kw)
        outs.append((o, *torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_seed_changes_mask():
    q, k, v, _ = (torch.from_numpy(a) for a in make_inputs(2, 2, 256, 256, seed=2))
    o1 = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=1)
    o2 = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=2)
    assert not torch.allclose(o1, o2)


def test_deterministic_given_seed():
    """tests/test_determinism.py::test_dropout_deterministic_given_seed,
    with the gradients too; a one-element int32 seed tensor gives the int
    seed's bits."""
    q, k, v, do = make_inputs(2, 2, 256, 256, seed=1)
    runs = []
    for seed in (7, 7, torch.tensor([7], dtype=torch.int32)):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = flash_attention(qt, kt, vt, is_causal=True, dropout_rate=0.3, dropout_seed=seed)
        runs.append((o, *torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


# ---- the autograd Function and the registered operators carry the seed ----

def test_function_and_operators_carry_the_seed():
    """The forward operators take the rate and the seed (a tensor) and give
    the plain forward's O and LSE; the Function keeps the seed, so its
    gradients are the plain backward's with the forward's mask (and not
    with another seed's); the fake implementation shapes the outputs."""
    q, k, v, do = (torch.from_numpy(a) for a in make_inputs(4, 2, 100, 100, seed=4))
    seed = torch.tensor(-9, dtype=torch.int32)
    ops = torch.ops.flashattn_tpu_torch
    for op in (ops.flash_fwd, ops.flash_fwd_plain):
        o, lse = op(q, k, v, None, None, True, None, None, None, None, None, 0.35, seed)
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(
            q, k, v, True, dropout_rate=0.35, dropout_seed=-9)
        assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        o, lse = ops.flash_fwd(fq, fk, fv, None, None, True, None, None, None, None, None, 0.35,
                               mode.from_tensor(seed))
        assert o.shape == q.shape and lse.shape == q.shape[:3]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, is_causal=True, dropout_rate=0.35, dropout_seed=seed)
    got = torch.autograd.grad(o, leaves, do)
    o_ref, lse = flash_fwd.flash_attention_forward_reference(q, k, v, True, dropout_rate=0.35,
                                                             dropout_seed=-9)
    want = flash_bwd.flash_attention_backward_reference(q, k, v, o_ref, do, lse, True,
                                                        dropout_rate=0.35, dropout_seed=-9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = flash_bwd.flash_attention_backward_reference(q, k, v, o_ref, do, lse, True,
                                                         dropout_rate=0.35, dropout_seed=-8)
    assert not torch.allclose(got[2], other[2])
