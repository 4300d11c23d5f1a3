"""The logit soft-cap in the port's backward (the kernels' plain versions on
the CPU) against the JAX package's, on the same numpy inputs: the plain
backward (dS times the tanh's derivative 1 - t^2) against the JAX
package's flash_attention_backward in interpret mode through both of its
implementations ("split" and "fused"), at D 64 and D 256, causal or not,
with GQA, a window, segment ids with padding, S_q != S_k with a pos_offset
and caps 5 and 30; gradients through the port's flash_attention and
flash_attention_varlen with a cap against jax.grad through JAX's. A
soft-capped model's training: tests/test_torch_gemma_train.py.

Tolerance: atol 1e-4, rtol 1e-4 in float32 (tests/test_softcap.py's gate:
the JAX kernels fold the scale into q before the dot and the tanh's slope
carries that rounding at the inputs' large magnitudes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.varlen import flash_attention_varlen as jax_varlen
from flashattn_tpu_torch.models import config
from flashattn_tpu_torch.ops import flash_bwd, launches
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse
from flashattn_tpu_torch.ops.varlen import canonical_segments, flash_attention_varlen
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)
SCALE_UP = 4.0  # q, k, v's factor: logits large enough that the tanh bends them


def ids_of(lens, total):
    """[1, total] int32 ids of documents of `lens`, then padding (-1)."""
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[0, off:off + n] = i
        off += n
    return ids


def make_inputs(hq, hkv, s_q, s_k, d, seed=0):
    """q, k, v (times SCALE_UP) and dO from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, s_q, d), dtype=np.float32) * SCALE_UP
    k = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32) * SCALE_UP
    v = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32) * SCALE_UP
    do = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    return q, k, v, do


def assert_close(refs, outs, tol=TOL):
    for name, ref, out in zip(("dQ", "dK", "dV"), refs, outs):
        rep = verify_results(np.asarray(ref), out, **tol)
        assert rep.passed, f"{name}: {rep}"


BWD_CASES = {
    # name: (Hq, Hkv, S_q, S_k, D, causal, cap, window, pos_offset, documents)
    "d64_cap5": (2, 2, 128, 128, 64, False, 5.0, None, None, None),
    "d64_cap30_causal_gqa": (4, 2, 128, 128, 64, True, 30.0, None, None, None),
    "d64_cap5_window40": (2, 1, 256, 256, 64, True, 5.0, 40, None, None),
    "d64_cap30_segments_padding": (2, 1, 200, 200, 64, True, 30.0, None, None, [70, 50, 60]),
    "d64_cap5_sq_below_sk_pos_offset": (2, 1, 96, 256, 64, True, 5.0, None, 60, None),
    "d256_cap5_causal_gqa": (4, 2, 128, 128, 256, True, 5.0, None, None, None),
    "d256_cap30": (2, 2, 128, 128, 256, False, 30.0, None, None, None),
    "d256_cap30_window_segments_padding": (2, 1, 160, 160, 256, True, 30.0, 50, None,
                                           [90, 41]),
}


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_softcapped_backward_matches_jax(case, impl):
    """The port's backward (the plain version) and the JAX kernels on one O
    and LSE, the plain forward's; padding rows' and keys' gradients exactly
    0 on the port's side."""
    hq, hkv, s_q, s_k, d, causal, cap, w, off, docs = BWD_CASES[case]
    q, k, v, do = make_inputs(hq, hkv, s_q, s_k, d, seed=len(case))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    segs = None
    if docs is not None:
        ids = torch.from_numpy(ids_of(docs, s_q))
        segs = canonical_segments(ids, ids, torch.device("cpu"))
    o, lse = reference_attention_with_lse(tq, tk, tv, causal, None, off, w, segs, cap)
    ref = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                       is_causal=causal, block_sizes=BS, impl=impl, pos_offset=off, window=w,
                       logit_softcap=cap,
                       segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)))
    out = flash_bwd.flash_attention_backward(tq, tk, tv, o, tdo, lse, is_causal=causal,
                                             impl=impl, pos_offset=off, window=w,
                                             segment_ids=segs, logit_softcap=cap)
    assert_close(ref, out)
    if segs is not None:
        pad = segs[0][0] < 0
        assert bool(pad.any()) and all(not bool(g[:, :, pad].any()) for g in out)


def test_softcap_changes_the_gradient():
    """The tanh's derivative matters: the capped backward differs from the
    uncapped one on the same O and LSE, and a cap of 1e6 (tanh linear over
    these logits) gives the uncapped gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in make_inputs(2, 1, 64, 64, 64, seed=9))
    o, lse = reference_attention_with_lse(q, k, v, True, logit_softcap=5.0)
    capped = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, logit_softcap=5.0)
    free = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True)
    assert not any(torch.allclose(a, b, atol=1e-2) for a, b in zip(capped, free))
    o, lse = reference_attention_with_lse(q, k, v, True)
    wide = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True, logit_softcap=1e6)
    free = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, True)
    assert_close(free, wide, dict(atol=1e-4, rtol=1e-3))


GRAD_CASES = {
    # name: (Hq, Hkv, S, D, causal, cap, window)
    "d64_cap5_causal_gqa": (4, 2, 128, 64, True, 5.0, None),
    "d256_cap30_window": (2, 1, 128, 256, True, 30.0, 48),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_softcapped_autograd_matches_jax_grad(case):
    """torch.autograd.grad through flash_attention (and the plain route)
    with a cap against jax.grad through JAX's flash_attention; no kernel
    launches on the CPU."""
    hq, hkv, s, d, causal, cap, w = GRAD_CASES[case]
    q, k, v, do = make_inputs(hq, hkv, s, s, d, seed=3)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, is_causal=causal, block_sizes=BS, window=w,
                                logit_softcap=cap)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    before = launches.read()
    for fn in (flash_attention, plain_flash_attention):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fn(qt, kt, vt, is_causal=causal, window=w, logit_softcap=cap)
        assert_close(ref, torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do)))
    assert launches.read() == before


def test_softcapped_varlen_matches_jax():
    """flash_attention_varlen with cap 30 and a window on three documents
    and padding: O and the gradients of sum(O * dO) against JAX's varlen;
    padding rows' O and gradients exactly 0."""
    lens, total = [70, 33, 61], 180
    q, k, v, do = make_inputs(4, 2, total, total, 64, seed=5)
    ids = ids_of(lens, total)
    kw = dict(is_causal=True, logit_softcap=30.0, window=40)
    o_ref, vjp = jax.vjp(lambda q, k, v: jax_varlen(q, k, v, segment_ids=jnp.asarray(ids),
                                                    block_sizes=BS, **kw),
                         *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_varlen(qt, kt, vt, segment_ids=torch.from_numpy(ids), **kw)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert verify_results(np.asarray(o_ref), o.detach(), **TOL).passed
    assert_close(ref, grads)
    pad = torch.from_numpy(ids[0] < 0)
    assert not bool(o[:, :, pad].any()) and all(not bool(g[:, :, pad].any()) for g in grads)


def test_backward_kernels_take_head_dim_256():
    """GEMMA2_9B's head dim is one the backward kernels take, as K1's: the
    kernel-operand check passes D 256 for them (the CPU paths are the plain
    versions, which take any D), and refuses a head dim outside the set."""
    assert flash_bwd.HEAD_DIMS == (32, 64, 80, 96, 128, 256) and config.GEMMA2_9B.head_dim == 256
    q = torch.zeros((1, 2, 8, 256), dtype=torch.bfloat16)
    from flashattn_tpu_torch.ops import flash_fwd
    flash_fwd.check_kernel_operands(flash_bwd.HEAD_DIMS, q=q, k=q, v=q, o=q, do=q)
    with pytest.raises(ValueError, match="head_dim 48"):
        x = torch.zeros((1, 2, 8, 48), dtype=torch.bfloat16)
        flash_fwd.check_kernel_operands(flash_bwd.HEAD_DIMS, q=x, k=x, v=x, o=x, do=x)
