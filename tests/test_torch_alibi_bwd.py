"""ALiBi in the port's backward (the kernels' plain versions on the CPU)
against the JAX package's, on the same numpy inputs: the plain backward
(P rebuilt from the biased logits, dS unchanged: the bias has no gradient)
against the JAX package's flash_attention_backward in interpret mode
through both of its implementations ("split" and "fused"), causal or not,
with GQA, a window, segment ids with padding, S_q != S_k with a
pos_offset, custom slopes and rows that see no key; gradients through the
port's flash_attention (kernel and plain routes) against jax.grad through
JAX's flash_attention(alibi=True); the varlen forward and gradients with
ALiBi against JAX's varlen, and packed documents against each document
alone (the bias's global positions are each document's own distance); the
slopes get no gradient. Mirrors tests/test_alibi.py::test_alibi_grads,
tests/test_flash_bwd_fused.py::test_fused_alibi and
tests/test_varlen.py::test_varlen_alibi_composition. An ALiBi model's
training: tests/test_torch_alibi_train.py.

Tolerance: float32, atol 1e-5 and rtol 1e-4 (the JAX kernels fold the
scale into q before the dot and add the bias in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.varlen import flash_attention_varlen as jax_varlen
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd, launches
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse
from flashattn_tpu_torch.ops.varlen import canonical_segments, flash_attention_varlen
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)


def ids_of(lens, total):
    """[1, total] int32 ids of documents of `lens`, then padding (-1)."""
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[0, off:off + n] = i
        off += n
    return ids


def make_inputs(hq, hkv, s_q, s_k, d, seed=0):
    """q, k, v and dO from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    k = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    v = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    do = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    return q, k, v, do


def assert_close(refs, outs, tol=TOL):
    for name, ref, out in zip(("dQ", "dK", "dV"), refs, outs):
        rep = verify_results(np.asarray(ref), out, **tol)
        assert rep.passed, f"{name}: {rep}"


# Custom slopes: one steep head (the steepest standard slope of 32 heads,
# 0.84 a position), one of 0, two mild ones.
CUSTOM = np.asarray([0.8408964, 0.0, 0.125, 0.02], np.float32)

BWD_CASES = {
    # name: (Hq, Hkv, S_q, S_k, causal, window, pos_offset, documents, slopes)
    "causal": (2, 2, 128, 128, True, None, None, None, None),
    "non_causal_gqa": (4, 2, 128, 128, False, None, None, None, None),
    "causal_gqa_window40": (4, 1, 256, 256, True, 40, None, None, None),
    "sq_below_sk_pos_offset": (2, 1, 96, 256, True, None, 60, None, None),
    "custom_slopes_gqa": (4, 2, 160, 160, True, None, None, None, CUSTOM),
    "no_key_rows": (2, 1, 128, 128, True, None, -50, None, None),
    "segments_padding_window": (4, 2, 200, 200, True, 30, None, [70, 50, 60], None),
}


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_alibi_backward_matches_jax(case, impl):
    """The port's backward (the plain version) and the JAX kernels on one O
    and LSE, the plain forward's with ALiBi; rows that see no key and
    padding positions get exactly 0 on the port's side."""
    hq, hkv, s_q, s_k, causal, w, off, docs, slopes = BWD_CASES[case]
    q, k, v, do = make_inputs(hq, hkv, s_q, s_k, 64, seed=len(case))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    segs = None
    if docs is not None:
        ids = torch.from_numpy(ids_of(docs, s_q))
        segs = canonical_segments(ids, ids, torch.device("cpu"))
    table = flash_fwd.alibi_table(True, None if slopes is None else torch.from_numpy(slopes),
                                  hq, torch.device("cpu"))
    o, lse = reference_attention_with_lse(tq, tk, tv, causal, None, off, w, segs,
                                          alibi_slopes=table)
    ref = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                       is_causal=causal, block_sizes=BS, impl=impl, pos_offset=off, window=w,
                       alibi=True, alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                       segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)))
    out = flash_bwd.flash_attention_backward(
        tq, tk, tv, o, tdo, lse, is_causal=causal, impl=impl, pos_offset=off, window=w,
        segment_ids=segs, alibi=True,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    assert_close(ref, out)
    dead = torch.isneginf(lse)
    if case == "no_key_rows":
        assert bool(dead.any())
    assert not bool(out[0][dead].any())
    if segs is not None:
        pad = segs[0][0] < 0
        assert bool(pad.any()) and all(not bool(g[:, :, pad].any()) for g in out)


def test_alibi_changes_the_gradient():
    """The bias matters in the backward: ALiBi's gradients differ from the
    plain ones on the same inputs, and slopes of 0 give the plain ones."""
    q, k, v, do = (torch.from_numpy(x) for x in make_inputs(2, 1, 64, 64, 64, seed=9))
    o, lse = reference_attention_with_lse(q, k, v, True, alibi_slopes=flash_fwd.alibi_table(
        True, None, 2, torch.device("cpu")))
    biased = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, alibi=True)
    free = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True)
    assert not any(torch.allclose(a, b, atol=1e-2) for a, b in zip(biased, free))
    o, lse = reference_attention_with_lse(q, k, v, True)
    zero = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, alibi=True,
                                              alibi_slopes=torch.zeros(2))
    free = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True)
    assert all(torch.equal(a, b) for a, b in zip(zero, free))


GRAD_CASES = {
    # name: (Hq, Hkv, S, causal, window, slopes)
    "causal_gqa": (4, 2, 128, True, None, None),
    "window48_custom": (4, 2, 128, True, 48, CUSTOM),
    "non_causal": (2, 2, 96, False, None, None),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_alibi_autograd_matches_jax_grad(case):
    """torch.autograd.grad through flash_attention (and the plain route)
    with ALiBi against jax.grad through JAX's flash_attention(alibi=True);
    the slopes get no gradient; no kernel launches on the CPU."""
    hq, hkv, s, causal, w, slopes = GRAD_CASES[case]
    q, k, v, do = make_inputs(hq, hkv, s, s, 64, seed=3)
    jslopes = None if slopes is None else jnp.asarray(slopes)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, is_causal=causal, block_sizes=BS, window=w, alibi=True,
                                alibi_slopes=jslopes)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    before = launches.read()
    for fn in (flash_attention, plain_flash_attention):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        st = None if slopes is None else torch.from_numpy(slopes.copy()).requires_grad_()
        o = fn(qt, kt, vt, is_causal=causal, window=w, alibi=True, alibi_slopes=st)
        grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do), retain_graph=True)
        assert_close(ref, grads)
        if st is not None:  # the slopes are an input without a gradient
            assert torch.autograd.grad(o, st, torch.from_numpy(do), allow_unused=True)[0] is None
    assert launches.read() == before


def test_alibi_varlen_matches_jax():
    """flash_attention_varlen with ALiBi and a window on three documents and
    padding: O and the gradients of sum(O * dO) against JAX's varlen;
    padding rows' O and gradients exactly 0."""
    lens, total = [70, 33, 61], 180
    q, k, v, do = make_inputs(4, 2, total, total, 64, seed=5)
    ids = ids_of(lens, total)
    kw = dict(is_causal=True, alibi=True, window=40)
    o_ref, vjp = jax.vjp(lambda q, k, v: jax_varlen(q, k, v, segment_ids=jnp.asarray(ids),
                                                    block_sizes=BS, **kw),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_varlen(qt, kt, vt, segment_ids=torch.from_numpy(ids), **kw)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    rep = verify_results(np.asarray(o_ref), o.detach(), **TOL)
    assert rep.passed, rep
    assert_close(ref, grads)
    pad = torch.from_numpy(ids[0] < 0)
    assert not bool(o[:, :, pad].any()) and all(not bool(g[:, :, pad].any()) for g in grads)


def test_alibi_varlen_composition():
    """Packed documents with ALiBi (global packed positions) against each
    document attended alone, forward and gradients: the bias depends on
    k_pos - q_pos alone, and pairs of two documents are masked
    (tests/test_varlen.py::test_varlen_alibi_composition, with gradients)."""
    lens = [100, 75, 81]
    s = sum(lens)
    q, k, v, do = (torch.from_numpy(a) for a in make_inputs(4, 4, s, s, 64, seed=11))
    ids = torch.from_numpy(ids_of(lens, s))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    packed = flash_attention_varlen(*leaves, segment_ids=ids, is_causal=True, alibi=True)
    g_packed = torch.autograd.grad(packed, leaves, do)
    off = 0
    for n in lens:
        part = [t[:, :, off:off + n].clone().requires_grad_() for t in (q, k, v)]
        alone = flash_attention(*part, is_causal=True, alibi=True)
        g_alone = torch.autograd.grad(alone, part, do[:, :, off:off + n])
        rows = slice(off, off + n)
        assert verify_results(alone.detach(), packed.detach()[:, :, rows], **TOL).passed
        for a, b in zip(g_alone, g_packed):
            rep = verify_results(a, b[:, :, rows], **TOL)
            assert rep.passed, rep
        off += n


def test_forward_operators_take_the_slopes():
    """The registered forward operators (remat="attn" keeps their outputs)
    take ALiBi's slope table: torch.library.opcheck of the schema and the
    fake implementation with slopes, the fake shapes, and the operator's
    O and LSE equal to the plain forward's with ALiBi."""
    ops = torch.ops.flashattn_tpu_torch
    q, k, v, _ = (torch.from_numpy(a) for a in make_inputs(4, 2, 24, 24, 32, seed=2))
    slopes = flash_fwd.default_alibi_slopes(4)
    for op in (ops.flash_fwd, ops.flash_fwd_plain):
        torch.library.opcheck(op.default, (q, k, v, None, None, True, None, None, 8, None, slopes),
                              test_utils=("test_schema", "test_faketensor"))
        o, lse = op(q, k, v, None, None, True, None, None, None, None, slopes)
        want = reference_attention_with_lse(q, k, v, True, alibi_slopes=slopes)
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    with FakeTensorMode():
        fq, fk = torch.empty(2, 8, 40, 64), torch.empty(2, 2, 56, 64)
        o, lse = ops.flash_fwd(fq, fk, fk, None, None, True, None, None, None, None,
                               torch.empty(8))
        assert o.shape == fq.shape and lse.shape == (2, 8, 40)
