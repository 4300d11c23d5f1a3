"""Packed documents (segment ids, cu_seqlens) through the port's
flash_attention_varlen (the kernels' plain versions on the CPU) against the
JAX package's flash_attention_varlen (its kernels in interpret mode), on
the same numpy inputs: tests/test_varlen.py (its ALiBi case with the
gradients in tests/test_torch_alibi_bwd.py), plus the window with segment
ids, a (seg_q, seg_k) pair with S_q != S_k, and the ids' canonical
padding.

Tolerances: float32 atol 1e-5, rtol 1e-5 (tests/test_varlen.py's gate);
bf16 atol 2e-2, rtol 2e-2 against the float32 unpacked oracle, as there.
Padding rows' O and gradients are exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.varlen import flash_attention_varlen as jax_varlen
from flashattn_tpu.ops.varlen import segment_ids_from_cu_seqlens as jax_ids_from_cu
from flashattn_tpu_torch.ops import launches
from flashattn_tpu_torch.ops.reference import reference_attention
from flashattn_tpu_torch.ops.varlen import (
    canonical_segments,
    flash_attention_varlen,
    segment_ids_from_cu_seqlens,
)
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)
# Deliberately not multiples of a tile (tests/test_varlen.py).
LENS = [200, 37, 300, 119]


def pack_inputs(lens, hq, hkv, d=64, total=None, seed=0):
    """q, do [1, Hq, total, D], k, v [1, Hkv, total, D] and ids [1, total]
    (padding -1) as numpy."""
    total = sum(lens) if total is None else total
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, hq, total, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, total, d), dtype=np.float32) for _ in range(2))
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[0, off:off + n] = i
        off += n
    return q, k, v, do, ids


def jax_run(q, k, v, do, **kw):
    """JAX O and (dQ, dK, dV) of sum(O * do)."""
    o, vjp = jax.vjp(lambda q, k, v: jax_varlen(q, k, v, block_sizes=BS, **kw),
                     *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def port_run(q, k, v, do, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention_varlen(*leaves, **kw)
    o.backward(torch.from_numpy(do))
    return o.detach(), [x.grad for x in leaves]


def assert_close(ref, out, tol=TOL):
    (o_j, g_j), (o, g) = ref, out
    for name, r, x in zip(("O", "dQ", "dK", "dV"), [o_j, *g_j], [o, *g]):
        rep = verify_results(r, x, **tol)
        assert rep.passed, f"{name}: {rep}"


def unpacked(q, k, v, lens, is_causal):
    """Each document alone through the plain oracle; padding rows 0."""
    q, k, v = map(torch.from_numpy, (q, k, v))
    outs, off = [], 0
    for n in lens:
        sl = slice(off, off + n)
        outs.append(reference_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], is_causal))
        off += n
    if q.shape[2] > off:
        outs.append(torch.zeros((1, q.shape[1], q.shape[2] - off, q.shape[3])))
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("is_causal", [False, True])
def test_varlen_forward_vs_unpacked_and_jax(is_causal):
    q, k, v, do, ids = pack_inputs(LENS, 2, 2)
    o = flash_attention_varlen(*map(torch.from_numpy, (q, k, v)),
                               segment_ids=torch.from_numpy(ids), is_causal=is_causal)
    rep = verify_results(unpacked(q, k, v, LENS, is_causal), o, **TOL)
    assert rep.passed, rep
    o_j = jax_varlen(*map(jnp.asarray, (q, k, v)), segment_ids=jnp.asarray(ids),
                     is_causal=is_causal, block_sizes=BS)
    rep = verify_results(np.asarray(o_j), o, **TOL)
    assert rep.passed, rep


@pytest.mark.parametrize("is_causal", [False, True])
def test_varlen_grads_match_jax(is_causal):
    """GQA 4/2: O and the three gradients against jax.vjp of the JAX varlen."""
    q, k, v, do, ids = pack_inputs(LENS, 4, 2, seed=5)
    kw = dict(segment_ids=ids, is_causal=is_causal)
    assert_close(jax_run(q, k, v, do, **{**kw, "segment_ids": jnp.asarray(ids)}),
                 port_run(q, k, v, do, **{**kw, "segment_ids": torch.from_numpy(ids)}))


def test_varlen_with_trailing_padding():
    """73 padding positions past the documents: O, dQ, dK and dV exactly 0
    there, and the rest against the JAX package and the unpacked oracle."""
    total = sum(LENS) + 73
    q, k, v, do, ids = pack_inputs(LENS, 2, 2, total=total, seed=2)
    ref = jax_run(q, k, v, do, segment_ids=jnp.asarray(ids), is_causal=True)
    out = port_run(q, k, v, do, segment_ids=torch.from_numpy(ids), is_causal=True)
    assert_close(ref, out)
    o, grads = out
    rep = verify_results(unpacked(q, k, v, LENS, True), o, **TOL)
    assert rep.passed, rep
    pad = sum(LENS)
    for x in (o, *grads):
        assert bool((x[:, :, pad:] == 0.0).all())


def test_cu_seqlens_api():
    cu = np.cumsum([0] + LENS).astype(np.int32)
    total = int(cu[-1]) + 40
    q, k, v, do, _ = pack_inputs(LENS, 2, 2, total=total, seed=7)
    ref = jax_run(q, k, v, do, cu_seqlens=jnp.asarray(cu), is_causal=True)
    out = port_run(q, k, v, do, cu_seqlens=torch.from_numpy(cu), is_causal=True)
    assert_close(ref, out)
    rep = verify_results(unpacked(q, k, v, LENS, True), out[0], **TOL)
    assert rep.passed, rep
    with pytest.raises(ValueError, match="cu_seqlens"):  # one batch row only
        flash_attention_varlen(*(torch.zeros((2, 2, 8, 16)) for _ in range(3)),
                               cu_seqlens=torch.tensor([0, 8]))
    with pytest.raises(ValueError, match="exactly one"):
        flash_attention_varlen(*(torch.zeros((1, 2, 8, 16)) for _ in range(3)))


def test_segment_ids_from_cu_seqlens():
    cu = np.asarray([0, 3, 3, 7], np.int32)  # includes an empty sequence
    ids = segment_ids_from_cu_seqlens(torch.from_numpy(cu), 9)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, 0, 0, 2, 2, 2, 2, -1, -1]
    assert ids.tolist() == np.asarray(jax_ids_from_cu(jnp.asarray(cu), 9)).tolist()


def test_varlen_bf16():
    q, k, v, _, ids = pack_inputs(LENS, 4, 4, seed=9)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o = flash_attention_varlen(qb, kb, vb, segment_ids=torch.from_numpy(ids), is_causal=True)
    assert o.dtype == torch.bfloat16
    rep = verify_results(unpacked(q, k, v, LENS, True), o.float(), atol=2e-2, rtol=2e-2)
    assert rep.passed, rep
    o_j = jax_varlen(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     segment_ids=jnp.asarray(ids), is_causal=True, block_sizes=BS)
    rep = verify_results(np.asarray(o_j.astype(jnp.float32)), o.float(), atol=2e-2, rtol=2e-2)
    assert rep.passed, rep


@pytest.mark.parametrize("window", [16, 150])
def test_varlen_window_with_segments(window):
    """The window restricted by the ids is each document's window: against
    the JAX varlen with the same window, and each document alone."""
    q, k, v, do, ids = pack_inputs(LENS, 4, 2, total=sum(LENS) + 20, seed=11)
    ref = jax_run(q, k, v, do, segment_ids=jnp.asarray(ids), is_causal=True, window=window)
    out = port_run(q, k, v, do, segment_ids=torch.from_numpy(ids), is_causal=True,
                   window=window)
    assert_close(ref, out)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    off = 0
    for n in LENS:
        sl = slice(off, off + n)
        solo = reference_attention(qt[:, :, sl], kt[:, :, sl], vt[:, :, sl], True,
                                   window=window)
        rep = verify_results(solo, out[0][:, :, sl], **TOL)
        assert rep.passed, rep
        off += n


def test_varlen_pair_with_sq_below_sk():
    """Packed cross-attention: a (seg_q, seg_k) pair, S_q 300 against S_k
    656, not causal; q rows of a document absent from k see nothing."""
    _, k, v, _, ids_k = pack_inputs(LENS, 4, 2, seed=13)
    rng = np.random.default_rng(14)
    q, do = (rng.standard_normal((1, 4, 300, 64), dtype=np.float32) for _ in range(2))
    ids_q = np.sort(rng.integers(-1, 5, (1, 300)).astype(np.int32), axis=1)  # 4: absent
    ref = jax_run(q, k, v, do, segment_ids=(jnp.asarray(ids_q), jnp.asarray(ids_k)))
    out = port_run(q, k, v, do, segment_ids=(torch.from_numpy(ids_q), torch.from_numpy(ids_k)))
    assert_close(ref, out)
    unseen = torch.from_numpy((ids_q[0] < 0) | (ids_q[0] == 4))
    assert bool((out[0][:, :, unseen] == 0).all()) and bool((out[1][0][:, :, unseen] == 0).all())


def test_padding_ids_are_canonical():
    """Any id < 0 is padding: -1 on the q side, -2 on the k side, so two
    padding positions never see each other; the kernels get int32."""
    seg_q, seg_k = canonical_segments(torch.tensor([[0, -5, 3]]), torch.tensor([[-7, 0, 3]]),
                                      torch.device("cpu"))
    assert seg_q.dtype == seg_k.dtype == torch.int32
    assert seg_q.tolist() == [[0, -1, 3]] and seg_k.tolist() == [[-2, 0, 3]]


def test_unported_options_raise():
    """ALiBi is ported in varlen attention, its gradient too; slopes
    without alibi and ALiBi with a cap raise ValueError, and the backward's
    dyn_pos_offset beside ALiBi and segment ids, which raised naming
    ROADMAP A4, runs (tests/test_torch_dyn_offset.py) and equals the static
    alignment; nothing launches on the CPU."""
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    before = launches.read()
    o = flash_attention_varlen(q, q, q, segment_ids=ids, is_causal=True, alibi=True)
    (grad,) = torch.autograd.grad(o.sum(), q)
    assert bool(torch.isfinite(grad).all())
    with pytest.raises(ValueError, match="needs alibi=True"):
        flash_attention_varlen(q, q, q, segment_ids=ids, is_causal=True,
                               alibi_slopes=torch.ones(2))
    with pytest.raises(ValueError, match="pick one"):
        flash_attention_varlen(q, q, q, segment_ids=ids, is_causal=True, alibi=True,
                               logit_softcap=30.0)
    from flashattn_tpu_torch.ops import flash_bwd
    x = q.detach()
    got = flash_bwd.flash_attention_backward(x, x, x, x, x, x[..., 0], segment_ids=(ids, ids),
                                             alibi=True, dyn_pos_offset=0)
    want = flash_bwd.flash_attention_backward(x, x, x, x, x, x[..., 0], segment_ids=(ids, ids),
                                              alibi=True, pos_offset=0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launches.read() == before


def test_segment_ids_are_checked():
    """The kernels' segment_ids: a (seg_q [B, S_q], seg_k [B, S_k]) pair of
    contiguous int32 tensors on q's device; anything else raises before a
    launch (flash_attention_varlen casts and canonicalises for its caller)."""
    from flashattn_tpu_torch.ops import flash_fwd

    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 6, 16))
    good = (torch.zeros((1, 8), dtype=torch.int32), torch.zeros((1, 6), dtype=torch.int32))
    flash_fwd.flash_attention_forward(q, k, k, segment_ids=good)
    for bad in (good[0], (good[0], good[0]), (good[0].long(), good[1]),
                (good[0], torch.zeros((1, 12), dtype=torch.int32)[:, ::2])):
        with pytest.raises(ValueError, match="seg|segment"):
            flash_fwd.flash_attention_forward(q, k, k, segment_ids=bad)


def test_id_ranges_cover_each_block():
    """The kernels' block ranges (ops/flash_fwd.py::id_ranges): each
    32-position block's (min, max) id, the ragged last block over its own
    positions; unsorted ids and padding alike."""
    from flashattn_tpu_torch.ops import flash_fwd

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(-2, 6, (2, 75)).astype(np.int32))
    ranges = flash_fwd.id_ranges(ids)
    assert ranges.shape == (2, 3, 2) and ranges.dtype == torch.int32
    for b in range(2):
        for t in range(3):
            block = ids[b, 32 * t:32 * (t + 1)]
            assert ranges[b, t].tolist() == [int(block.min()), int(block.max())]
