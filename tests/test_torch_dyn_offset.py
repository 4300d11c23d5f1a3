"""dyn_pos_offset in the port (the kernels' plain versions on the CPU)
against the JAX package's, on the same numpy inputs: the plain forward
against JAX's flash_attention_forward(dyn_pos_offset=) and the plain
backward against JAX's flash_attention_backward(dyn_pos_offset=) through
both of its implementations ("split" and "fused"), all in interpret mode,
with the window's left edge, ALiBi, both, segment ids with padding, GQA,
the window with the soft-cap at D 256 (Gemma-2's local layer), the window
and ALiBi with dropout, an offset given as an int and as an int32 tensor,
and rows whose window lies past every key. The zigzag ring passes it
(parallel/ring.py; the rings against JAX: tests/test_torch_ring.py).

Tolerance: float32, atol 1e-5 and rtol 1e-4 (the JAX kernels fold the
scale into q before the dot and add the bias in another order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd, launches
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)

CASES = {
    # name: (Hq, Hkv, S_q, S_k, offset, window, alibi, documents[, the call's
    # other options, "d" the head dim (64 without it)])
    # The zigzag ring's (q_hi, k_lo) pair at n = 2: offset (2n - 1 - 0 - 0) C.
    "window": (2, 2, 128, 128, 384, 300, False, None),
    "alibi_gqa": (4, 2, 128, 128, 384, None, True, None),
    "window_alibi": (4, 1, 128, 256, 200, 150, True, None),
    # rows r >= 56 see no key: their window's left edge, r + 200, is past S_k
    "window_past_keys": (2, 1, 128, 256, 399, 200, False, None),
    "segments_window_alibi": (4, 2, 128, 256, 64, 100, True, ((50, 70), (30, 150, 40))),
    "segments_alibi": (2, 2, 128, 128, 256, None, True, ((100,), (90,))),
    # the left edge cuts the pair: row r sees c >= r + 57; the cap at 5
    # bends the logits of these inputs
    "window_softcap_d256": (2, 1, 128, 128, 256, 200, False, None,
                            dict(d=256, logit_softcap=5.0)),
    "window_alibi_dropout": (4, 2, 128, 256, 200, 150, True, None,
                             dict(dropout_rate=0.2, dropout_seed=-7)),
}


def ids_of(lens, total):
    """[1, total] int32 ids of documents of `lens`, then padding (-1)."""
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[0, off:off + n] = i
        off += n
    return ids


def case_inputs(name, seed=0):
    """q, k, v, dO, the offset and the keyword arguments of one case."""
    hq, hkv, s_q, s_k, off, window, alibi, docs, *more = CASES[name]
    opts = dict(more[0]) if more else {}
    d = opts.pop("d", 64)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    k = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    v = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    do = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    segs = None
    if docs is not None:
        seg_q = ids_of(docs[0], s_q)
        seg_k = ids_of(docs[1], s_k)
        # canonical padding (ops/varlen.py): q pads -1, k pads -2
        seg_k = np.where(seg_k < 0, -2, seg_k).astype(np.int32)
        segs = (seg_q, seg_k)
    return (q, k, v, do), off, dict(window=window, alibi=alibi, **opts), segs


def jax_kw(kw):
    """The case's options as the JAX functions take them (the seed an int32)."""
    if kw.get("dropout_rate"):
        return dict(kw, dropout_seed=jnp.int32(kw["dropout_seed"]))
    return kw


@functools.lru_cache(maxsize=None)
def jax_forward_of(name):
    """JAX's O and LSE of a case, computed once for both offset types."""
    (q, k, v, _), off, kw, segs = case_inputs(name)
    o, lse = jax_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=False,
                         block_sizes=BS, interpret=True, dyn_pos_offset=jnp.int32(off),
                         segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)),
                         **jax_kw(kw))
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("offset_type", ["int", "tensor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, offset_type):
    (q, k, v, _), off, kw, segs = case_inputs(name)
    o_j, lse_j = jax_forward_of(name)
    dyn = off if offset_type == "int" else torch.tensor(off, dtype=torch.int32)
    before = launches.read()
    o_t, lse_t = flash_fwd.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)), False, dyn_pos_offset=dyn,
        segment_ids=None if segs is None else tuple(map(torch.from_numpy, segs)), **kw)
    assert launches.read() == before  # the CPU runs the plain version
    for what, ref, out in (("O", o_j, o_t), ("LSE", lse_j, lse_t)):
        rep = verify_results(ref, out, **TOL)
        assert rep.passed, f"{what}: {rep}"
    if name == "window_past_keys":  # no key: O = 0, LSE = -inf
        assert bool((o_t[:, :, 56:] == 0).all()) and bool(torch.isneginf(lse_t[:, :, 56:]).all())
        assert bool(torch.isfinite(lse_t[:, :, :56]).all())


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax(name, impl):
    (q, k, v, do), off, kw, segs = case_inputs(name)
    tsegs = None if segs is None else tuple(map(torch.from_numpy, segs))
    o, lse = reference_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), False, None, off, kw["window"], tsegs,
        kw.get("logit_softcap"),
        alibi_slopes=flash_fwd.default_alibi_slopes(q.shape[1]) if kw["alibi"] else None,
        dropout_rate=kw.get("dropout_rate", 0.0), dropout_seed=kw.get("dropout_seed"))
    refs = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                        is_causal=False, block_sizes=BS, interpret=True, impl=impl,
                        dyn_pos_offset=jnp.int32(off),
                        segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)),
                        **jax_kw(kw))
    outs = flash_bwd.flash_attention_backward(
        *map(torch.from_numpy, (q, k, v)), o, torch.from_numpy(do), lse, False, impl=impl,
        dyn_pos_offset=off, segment_ids=tsegs, **kw)
    for what, ref, out in zip(("dQ", "dK", "dV"), refs, outs):
        rep = verify_results(np.asarray(ref), out, **TOL)
        assert rep.passed, f"{what}: {rep}"


def test_offset_equals_static_alignment():
    """A call with the offset read on the card computes what the causal
    call with pos_offset = offset does when every pair is causally visible
    (r + offset >= S_k - 1 for every row r: the zigzag pair's case), window
    and ALiBi included: forward and gradients."""
    (q, k, v, do), _, kw, _ = case_inputs("window_alibi")
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    off = 300  # every row r sees c <= r + 300, past S_k = 256
    o_d, lse_d = flash_fwd.flash_attention_forward(*t[:3], False, dyn_pos_offset=off, **kw)
    o_c, lse_c = flash_fwd.flash_attention_forward(*t[:3], True, pos_offset=off, **kw)
    assert torch.equal(o_d, o_c) and torch.equal(lse_d, lse_c)
    g_d = flash_bwd.flash_attention_backward(*t[:3], o_d, t[3], lse_d, False,
                                             dyn_pos_offset=off, **kw)
    g_c = flash_bwd.flash_attention_backward(*t[:3], o_c, t[3], lse_c, True, pos_offset=off,
                                             **kw)
    assert all(torch.equal(a, b) for a, b in zip(g_d, g_c))


def test_offset_is_checked():
    """dyn_pos_offset needs is_causal=False and no pos_offset, and is an
    int32 int or a one-element int32 tensor: ValueError otherwise; a window
    without the causal mask needs it."""
    x = torch.zeros((1, 2, 8, 64))
    fwd = flash_fwd.flash_attention_forward
    with pytest.raises(ValueError, match="is_causal=False"):
        fwd(x, x, x, True, dyn_pos_offset=0, window=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fwd(x, x, x, False, pos_offset=0, dyn_pos_offset=0, window=4)
    with pytest.raises(ValueError, match="int32"):
        fwd(x, x, x, False, dyn_pos_offset=torch.zeros(2, dtype=torch.int32), window=4)
    with pytest.raises(ValueError, match="int32"):
        fwd(x, x, x, False, dyn_pos_offset=2**31, window=4)
    with pytest.raises(ValueError, match="needs is_causal"):
        fwd(x, x, x, False, window=4)
    with pytest.raises(ValueError, match="is_causal=False"):
        flash_bwd.flash_attention_backward(x, x, x, x, x, x[..., 0], True, dyn_pos_offset=0)


@pytest.mark.parametrize("variant", ["softcap", "dropout", "d256", "float32"])
def test_card_offset_routes_every_variant_to_its_kernels(variant):
    """On the card the kernels that read the offset take every variant the
    JAX kernels take: the soft-cap, dropout, D 256 and float32 each route a
    dyn_pos_offset call with a window or ALiBi to them (flash_fwd.dyn_library),
    in the library of every family that flash_fwd.kernel_library names:
    one that _build declares with the offset's pointer last before the
    stream, after dropout's three arguments with dropout, whose source
    builds the kDyn instantiations. Without a window or ALiBi the offset
    changes nothing and no kernel of its own is needed; ALiBi with a
    soft-cap raises ValueError, as in the JAX package."""
    import ctypes

    from flashattn_tpu_torch.ops import _build

    d = 256 if variant == "d256" else 64
    q = torch.zeros((1, 2, 8, d), dtype=torch.float32 if variant == "float32"
                    else torch.bfloat16)
    cap = 30.0 if variant == "softcap" else None
    rate = 0.1 if variant == "dropout" else 0.0
    slopes = torch.ones(2)
    assert flash_fwd.dyn_library(0, 16, None)
    assert flash_fwd.dyn_library(torch.tensor(0, dtype=torch.int32), None, slopes)
    assert not flash_fwd.dyn_library(0, None, None)
    assert not flash_fwd.dyn_library(None, 16, slopes)
    held, args = flash_fwd.extra_args(q, rate, 5 if rate else None, True, 3)
    assert [int(t.item()) for t in held] == ([5] if rate else []) + [3]
    assert len(args) == (4 if rate else 1)
    for family, impl in (("flash_fwd", "fwd_launch_impl"), ("flash_bwd", "dq_launch_impl"),
                         ("flash_bwd_fused", "fused_launch_impl")):
        lib = flash_fwd.kernel_library(family, rate, True, alibi=cap is None)
        assert lib == family + "_dynoff" + ("_dropout" if rate else "")
        for fn, argtypes in _build.ENTRY_POINTS[lib].items():
            base = _build.ENTRY_POINTS[family + ("_dropout" if rate else "")][fn]
            assert argtypes == base[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
        src = (_build.CSRC / f"{lib}.cu").read_text()
        assert f"{impl}<true, {'true' if rate else 'false'}, true>" in src or \
            f"{impl}<{'true' if rate else 'false'}, true>" in src
        assert flash_fwd.kernel_library(family, rate, False, alibi=False) == \
            family + ("_dropout" if rate else "")
    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="soft-cap"):
        flash_fwd.flash_attention_forward(x, x, x, False, dyn_pos_offset=0, window=4,
                                          alibi=True, logit_softcap=30.0)
