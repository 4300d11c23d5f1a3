"""The plain per-hop kernels of the parallel layer's CPU tests
(tests/_jax_plain_attention.py) against the JAX package's kernels in
interpret mode, one call at a time: the checks and the helpers of
tests/test_torch_ring_hops.py, tests/test_torch_zigzag_hops.py,
tests/test_torch_ring_4ranks_hops.py and tests/test_torch_ulysses_hops.py,
which hold the calls that the JAX rings and Ulysses make in
tests/test_torch_ring.py and tests/test_torch_ring_4ranks.py (S 64 over 2
or 4 ranks, D 16).

The backward takes O and LSE from the kernel's forward, as the rings pass
them. Tolerance: float32, atol 1e-5 and rtol 1e-4, the port's
dyn_pos_offset tests' (the kernels fold the scale into q before the dot and
add the bias in another order); rows that see no key give LSE -inf on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np

from _jax_plain_attention import plain_attention, plain_backward, plain_forward, plain_varlen
from flashattn_tpu.ops.attention import flash_attention
from flashattn_tpu.ops.flash_bwd import flash_attention_backward
from flashattn_tpu.ops.flash_fwd import default_alibi_slopes, flash_attention_forward
from flashattn_tpu.ops.varlen import flash_attention_varlen
from flashattn_tpu.parallel.ring import _fold_seed

TOL = dict(atol=1e-5, rtol=1e-4)
D = 16


def ids(spans, total):
    """[1, total] int32 ids: (id, length) spans in order, the rest id -1."""
    out = np.full((1, total), -1, np.int32)
    at = 0
    for i, n in spans:
        out[0, at:at + n] = i
        at += n
    return out


def k_ids(spans, total):
    """ids() of a K shard, its padding canonical (-2) as the rings make it."""
    out = ids(spans, total)
    return np.where(out < 0, -2, out).astype(np.int32)


def seed(base, idx, step, subid=0):
    """The seed of a ring hop (subid 0) or zigzag sub-call, folded in int32
    by the JAX package's _fold_seed as its rings fold it."""
    return (_fold_seed(jnp.int32(base), jnp.int32(idx), step)
            + jnp.int32(subid) * jnp.int32(424243))


def slopes(hq, lo, n):
    """Heads lo .. lo + n of the standard table of hq heads."""
    return default_alibi_slopes(hq)[lo:lo + n]


def close(what, ref, out):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), err_msg=what, **TOL)


def randn(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32))


def check_hop(case, rng_seed):
    """One hop's call, case = (Hq, Hkv, S_q, S_k, the call's keywords,
    (seg_q, seg_k) or None): plain_forward's (O, LSE) and plain_backward's
    (dQ, dK, dV) against flash_attention_forward and
    flash_attention_backward."""
    hq, hkv, s_q, s_k, kw, segs = case
    rng = np.random.default_rng(rng_seed)
    q, do = randn(rng, 1, hq, s_q, D), randn(rng, 1, hq, s_q, D)
    k, v = randn(rng, 1, hkv, s_k, D), randn(rng, 1, hkv, s_k, D)
    if segs is not None:
        kw = dict(kw, segment_ids=tuple(map(jnp.asarray, segs)))
    o, lse = flash_attention_forward(q, k, v, interpret=True, **kw)
    o_p, lse_p = plain_forward(q, k, v, **kw)
    close("O", o, o_p)
    close("LSE", lse, lse_p)
    grads = flash_attention_backward(q, k, v, o, do, lse, interpret=True, **kw)
    for what, ref, out in zip(("dQ", "dK", "dV"), grads,
                              plain_backward(q, k, v, o, do, lse, **kw)):
        close(what, ref, out)


def check_attention(case, rng_seed, s=64):
    """A rank's head slice over the whole sequence, case = (Hq, Hkv, the
    call's keywords, documents' (id, length) spans or None): plain_attention
    (plain_varlen with documents) against flash_attention
    (flash_attention_varlen), O and the gradients of sum(O * dO)."""
    hq, hkv, kw, docs = case
    rng = np.random.default_rng(rng_seed)
    q, do = randn(rng, 1, hq, s, D), randn(rng, 1, hq, s, D)
    k, v = randn(rng, 1, hkv, s, D), randn(rng, 1, hkv, s, D)
    if docs is None:
        def kernel(q, k, v):
            return flash_attention(q, k, v, interpret=True, **kw)

        def plain(q, k, v):
            return plain_attention(q, k, v, **kw)
    else:
        seg = jnp.asarray(ids(docs, s))

        def kernel(q, k, v):
            return flash_attention_varlen(q, k, v, segment_ids=(seg, seg), interpret=True, **kw)

        def plain(q, k, v):
            return plain_varlen(q, k, v, segment_ids=(seg, seg), **kw)
    results = []
    for fn in (kernel, plain):
        o, vjp = jax.vjp(fn, q, k, v)
        results.append((o, *vjp(do)))
    for what, ref, out in zip(("O", "dQ", "dK", "dV"), *results):
        close(what, ref, out)
