"""The port's paged KV cache and paged decode against the JAX package's
(tests/test_paged.py's harness: a deliberately scrambled page assignment,
sequences appended one at a time under `active` masks).

Pool, table, length and scale updates must be bit-equal to JAX's. Paged
decode on the CPU (the plain version through the table) must equal the
port's dense plain decode bit for bit (an int8 cache requantizing P per
page in both, as the JAX paged kernel does), and the JAX paged kernel in
interpret mode within atol 2e-5, rtol 1e-5 for a float32 cache (exp2
against exp, another summation order) and atol 2e-3, rtol 1e-3 for int8/fp8
caches (one exp2 ulp can move one requantized int8 P entry by a step; the
JAX kernel's fast fp8 converter differs on subnormal codes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu_torch.ops import decode, kvcache, paged
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

B, HQ, HKV, D = 2, 4, 2, 64
PAGE = 128  # the JAX pool takes multiples of 128
MAX_PAGES = 4
NUM_PAGES = B * MAX_PAGES + 3
TOL = {None: dict(atol=2e-5, rtol=1e-5), "int8": dict(atol=2e-3, rtol=1e-3),
       "fp8": dict(atol=2e-3, rtol=1e-3)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.dtype == kvcache.FP8_DTYPE else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == jnp.float8_e4m3fn else x


def assert_same(port, ref, names):
    for name in names:
        a, r = getattr(port, name), getattr(ref, name)
        if r is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(_np(a), _np(r), err_msg=name)


PAGED_FIELDS = ("k_pages", "v_pages", "k_scale", "v_scale", "block_table", "length")
DENSE_FIELDS = ("k", "v", "k_scale", "v_scale", "length")


# JAX's dense update runs jitted, as in its generation steps (XLA's product
# with f32(1 / qmax) for the scales: tests/test_torch_decode.py).
jax_update_cache = jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",))


def make_all(lengths, quant=None, seed=0):
    """JAX dense, JAX paged, port dense and port paged caches holding the
    same float32 tokens; the paged copies live in scrambled pages."""
    rng = np.random.default_rng(seed)
    s_max = PAGE * MAX_PAGES
    jd = jax_kv.init_cache(B, HKV, s_max, D, dtype=jnp.float32, quant=quant)
    jp = jax_paged.init_paged_cache(B, HKV, NUM_PAGES, PAGE, D, MAX_PAGES,
                                    dtype=jnp.float32, quant=quant)
    pd = kvcache.init_cache(B, HKV, s_max, D, dtype=torch.float32, quant=quant,
                            device="cpu")
    pp = paged.init_paged_cache(B, HKV, NUM_PAGES, PAGE, D, MAX_PAGES,
                                dtype=torch.float32, quant=quant, device="cpu")
    perm = np.arange(3, 3 + B * MAX_PAGES, dtype=np.int32)[::-1].reshape(B, MAX_PAGES)
    for bi in range(B):
        jp = jax_paged.set_block_table(jp, bi, jnp.asarray(perm[bi]), 0)
        assert paged.set_block_table(pp, bi, perm[bi].tolist(), 0) is pp
    for bi, ln in enumerate(lengths):
        k_new = rng.standard_normal((1, HKV, ln, D), dtype=np.float32)
        v_new = rng.standard_normal((1, HKV, ln, D), dtype=np.float32)
        mask = np.arange(B) == bi
        kb = np.where(mask[:, None, None, None], np.broadcast_to(k_new, (B, HKV, ln, D)), 0)
        vb = np.where(mask[:, None, None, None], np.broadcast_to(v_new, (B, HKV, ln, D)), 0)
        kb, vb = kb.astype(np.float32), vb.astype(np.float32)
        jd = jax_update_cache(jd, jnp.asarray(kb), jnp.asarray(vb), active=jnp.asarray(mask))
        jp = jax_paged.append_paged(jp, jnp.asarray(kb), jnp.asarray(vb),
                                    active=jnp.asarray(mask))
        kvcache.update_cache(pd, torch.from_numpy(kb), torch.from_numpy(vb),
                             active=torch.from_numpy(mask))
        assert paged.append_paged(pp, torch.from_numpy(kb), torch.from_numpy(vb),
                                  active=torch.from_numpy(mask)) is pp
    return jd, jp, pd, pp


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_paged_cache_bit_equal_to_jax(quant):
    jd, jp, pd, pp = make_all([300, 170], quant)
    assert_same(pp, jp, PAGED_FIELDS)
    assert_same(pd, jd, DENSE_FIELDS)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_paged_decode_matches_jax_and_dense(quant):
    jd, jp, pd, pp = make_all([300, 170], quant, seed=1)
    q = np.random.default_rng(7).standard_normal((B, HQ, D), dtype=np.float32)
    ref = jax_paged.paged_decode_attention(jnp.asarray(q), jp)
    out = paged.paged_decode_attention(torch.from_numpy(q), pp)
    dense = decode.decode_attention_reference(torch.from_numpy(q)[:, :, None], pd,
                                              requant_block=PAGE)[:, :, 0]
    assert torch.equal(out, dense)
    rep = verify_results(np.asarray(ref), out, **TOL[quant])
    assert rep.passed, rep


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_decode_chunk_matches_jax_and_dense(quant):
    t = 8
    jd, jp, pd, pp = make_all([256 + t, 130 + t], quant, seed=2)
    q = np.random.default_rng(8).standard_normal((B, HQ, t, D), dtype=np.float32)
    ref = jax_paged.paged_decode_attention_chunk(jnp.asarray(q), jp)
    out = paged.paged_decode_attention_chunk(torch.from_numpy(q), pp)
    assert torch.equal(out, decode.decode_attention_reference(torch.from_numpy(q), pd,
                                                              requant_block=PAGE))
    rep = verify_results(np.asarray(ref), out, **TOL[quant])
    assert rep.passed, rep


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_append_across_page_boundary_bit_equal(quant):
    """A 7-token append straddling a page boundary lands split across the
    two pages the table names."""
    _, jp, _, pp = make_all([PAGE - 3, 10], quant, seed=3)
    rng = np.random.default_rng(9)
    k_new = rng.standard_normal((B, HKV, 7, D), dtype=np.float32)
    v_new = rng.standard_normal((B, HKV, 7, D), dtype=np.float32)
    jp = jax_paged.append_paged(jp, jnp.asarray(k_new), jnp.asarray(v_new))
    paged.append_paged(pp, torch.from_numpy(k_new), torch.from_numpy(v_new))
    assert_same(pp, jp, PAGED_FIELDS)


@pytest.mark.parametrize("active", [[False, True], None])
def test_append_inactive_and_past_capacity_bit_equal(active):
    """Slot 0 is full: inactive or past its table, its tokens are dropped
    and the pool it owns keeps its bytes."""
    _, jp, _, pp = make_all([PAGE * MAX_PAGES, 100], "int8", seed=4)
    before = pp.k_pages.clone()
    rng = np.random.default_rng(10)
    k_new = rng.standard_normal((B, HKV, 64, D), dtype=np.float32)
    v_new = rng.standard_normal((B, HKV, 64, D), dtype=np.float32)
    act = None if active is None else np.asarray(active)
    jp = jax_paged.append_paged(jp, jnp.asarray(k_new), jnp.asarray(v_new),
                                active=None if act is None else jnp.asarray(act))
    paged.append_paged(pp, torch.from_numpy(k_new), torch.from_numpy(v_new),
                       active=None if act is None else torch.from_numpy(act))
    assert_same(pp, jp, PAGED_FIELDS)
    slot0 = pp.block_table[0].long()
    assert torch.equal(pp.k_pages[slot0], before[slot0])
    assert int(pp.length[1]) == 164


@pytest.mark.parametrize("active", [None, [True, False], [False, True], [False, False]])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_append_dead_tokens_of_every_kind_bit_equal(quant, active):
    """One append holding every token the JAX scatter drops beside live
    ones: slot 0 runs past its table's last block, slot 1's second block is
    the sentinel (unowned), and a row may be inactive, or both. The port
    writes in fixed shapes, each dead token repeating a live token's write
    (or, with none live, a cell's own bytes); the pool, table, lengths and
    scales must equal JAX's."""
    _, jp, _, pp = make_all([PAGE * MAX_PAGES - 20, 100], quant, seed=12)
    table = [int(pp.block_table[1, 0]), NUM_PAGES] + pp.block_table[1, 2:].tolist()
    jp = jax_paged.set_block_table(jp, 1, jnp.asarray(table, jnp.int32), 100)
    paged.set_block_table(pp, 1, table, 100)
    rng = np.random.default_rng(13)
    k_new = rng.standard_normal((B, HKV, 64, D), dtype=np.float32)
    v_new = rng.standard_normal((B, HKV, 64, D), dtype=np.float32)
    act = None if active is None else np.asarray(active)
    jp = jax_paged.append_paged(jp, jnp.asarray(k_new), jnp.asarray(v_new),
                                active=None if act is None else jnp.asarray(act))
    paged.append_paged(pp, torch.from_numpy(k_new), torch.from_numpy(v_new),
                       active=None if act is None else torch.from_numpy(act))
    assert_same(pp, jp, PAGED_FIELDS)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_write_pages_with_sentinels_and_slot_install_bit_equal(as_tensor):
    """A host list drops the unowned entries on the host; a tensor on the
    cache's device scatters in fixed shapes (capturable). Both bit-equal to
    JAX."""

    def arg(entries):
        return torch.tensor(entries, dtype=torch.int32) if as_tensor else entries

    _, jp, _, pp = make_all([200, 100], "int8", seed=5)
    rng = np.random.default_rng(11)
    n = PAGE * MAX_PAGES
    x = rng.standard_normal((1, HKV, n, D), dtype=np.float32)
    y = rng.standard_normal((1, HKV, n, D), dtype=np.float32)
    jsingle = jax_update_cache(
        jax_kv.init_cache(1, HKV, n, D, dtype=jnp.float32, quant="int8"),
        jnp.asarray(x), jnp.asarray(y))
    psingle = kvcache.update_cache(
        kvcache.init_cache(1, HKV, n, D, dtype=torch.float32, quant="int8", device="cpu"),
        torch.from_numpy(x), torch.from_numpy(y))
    pages = [5, NUM_PAGES, 2]  # the middle block is unowned: dropped
    jp = jax_paged.write_pages(jp, jsingle, jnp.asarray(pages, jnp.int32), first_block=1)
    assert paged.write_pages(pp, psingle, arg(pages), first_block=1) is pp
    assert_same(pp, jp, PAGED_FIELDS)
    table = [1, 0, NUM_PAGES, NUM_PAGES]
    jp = jax_paged.write_slot_paged(jp, jsingle, 1, jnp.asarray(table, jnp.int32))
    paged.write_slot_paged(pp, psingle, 1, arg(table))
    assert_same(pp, jp, PAGED_FIELDS)
    assert int(pp.length[1]) == n and pp.block_table[1].tolist() == table


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_pages_to_dense_bit_equal(quant):
    _, jp, _, pp = make_all([300, 170], quant, seed=6)
    pages = np.asarray(pp.block_table[0, :2])
    ref = jax_paged.pages_to_dense(jp, jnp.asarray(pages), max_len=768, length=256)
    out = paged.pages_to_dense(pp, pages.tolist(), 768, length=256)
    assert_same(out, ref, DENSE_FIELDS)
    assert out.max_len == 768


def test_allocator_reuse_and_refcounts_match_jax():
    ja, pa = jax_paged.PageAllocator(8), paged.PageAllocator(8)
    for a in (ja, pa):
        p1 = a.alloc(paged.pages_needed(300, PAGE))  # 3 pages
        p2 = a.alloc(2)
        a.retain(p1[:1])  # a shared page: two references
        a.release(p1)
        assert a.free_pages == 5
        p3 = a.alloc(4)
        assert set(p3) & set(p1) and not set(p3) & set(p2)
        with pytest.raises(MemoryError):
            a.alloc(2)
        a.release(p1[:1])
        assert a.free_pages == 2
    assert pa._free == ja._free and pa._rc == ja._rc
    with pytest.raises(ValueError, match="double free"):
        pa.release([p2[0], p2[0]])
    with pytest.raises(ValueError, match="retain of free page"):
        pa.retain([pa._free[0]])


def test_page_size_rule_and_no_cpu_launch():
    c = paged.init_paged_cache(2, 1, 4, 64, 32, 2, dtype=torch.float32, device="cpu")
    assert c.page_size == 64 and c.max_len == 128 and not c.quantized
    with pytest.raises(ValueError, match="multiple of 64"):
        paged.init_paged_cache(2, 1, 4, 96, 32, 2, device="cpu")
    before = paged.LAUNCHES
    paged.paged_decode_attention(torch.zeros((2, 2, 32)), c)
    assert paged.LAUNCHES == before
