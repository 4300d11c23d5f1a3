"""Decode against caches split over gloo ranks on the CPU
(parallel/serving.py), mirroring the five tests of
tests/test_decode_sharded.py: the int8 cache split over kv heads, a bf16
cache split over the sequence with ragged lengths, an int8 cache split
over the sequence, the paged pool split over heads, ALiBi split over heads
(each rank its heads' slopes); plus a split whose second rank holds none
of a sequence (local length 0: LSE -inf, weight 0). Every cache is built by
the JAX package's functions and copied, byte for byte, into the port's,
so both sides read the same cache; the JAX side runs its kernels in
interpret mode (the sequence cases through its own
sharded_decode_attention), the port its plain versions.

Tolerances: split over heads, the port's output bit for bit its unsplit
decode (K2 is oblivious to the heads it gets); against the JAX kernel,
and split over the sequence against both, the bf16 gate of the JAX test,
atol 2e-2 (bf16 outputs, partials merged in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_harness import Ranks
from flashattn_tpu.ops.decode import decode_attention as jax_decode
from flashattn_tpu.ops.flash_fwd import default_alibi_slopes as jax_slopes
from flashattn_tpu.ops.kvcache import init_cache, update_cache
from flashattn_tpu.ops.paged import (append_paged, init_paged_cache, paged_decode_attention,
                                     set_block_table)
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu.parallel.serving import sharded_decode_attention as jax_sharded
from flashattn_tpu_torch.ops import decode, paged
from flashattn_tpu_torch.ops.flash_fwd import default_alibi_slopes
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.ops.paged import PagedKVCache
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

BF16_GATE = dict(atol=2e-2, rtol=2e-2)


def t(x) -> torch.Tensor:
    """A JAX array as a tensor of the same dtype and bytes."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x.copy())


def port_cache(c) -> KVCache:
    return KVCache(k=t(c.k), v=t(c.v), length=t(c.length),
                   k_scale=None if c.k_scale is None else t(c.k_scale),
                   v_scale=None if c.v_scale is None else t(c.v_scale))


def normal(key, shape):
    return jax.random.normal(jax.random.PRNGKey(key), shape, jnp.bfloat16)


def sharded_jit(q, cache, n: int):
    """The JAX package's sharded_decode_attention over sp n, jitted."""
    mesh = jax_make_mesh({"sp": n})
    return jax.jit(lambda q, c: jax_sharded(q, c, mesh))(q, cache)


def dense_case(b, hq, hkv, d, s, quant=None, lengths=None, seed=0):
    cache = init_cache(b, hkv, s, d, quant=quant)
    kn, vn = normal(seed, (b, hkv, s, d)), normal(seed + 1, (b, hkv, s, d))
    cache = jax.jit(update_cache)(cache, kn, vn)
    if lengths is not None:
        cache = cache.__class__(**{**cache.__dict__, "length": jnp.asarray(lengths, jnp.int32)})
    return cache, normal(seed + 2, (b, hq, d))


def build():
    """{name: (port case, a thunk of JAX's output)}: the JAX test's shapes
    and keys."""
    cases = {}
    cache, q = dense_case(2, 8, 4, 64, 512, quant="int8")
    cases["tp_heads_int8"] = (dict(mode="heads", mesh={"model": 4}, paged=False),
                              q, cache, lambda q=q, c=cache: jax_decode(q, c))
    cache, q = dense_case(3, 4, 2, 64, 1024, lengths=[1000, 512, 100])
    cases["sequence"] = (dict(mode="sequence", mesh={"sp": 4}), q, cache,
                         lambda q=q, c=cache: sharded_jit(q, c, 4))
    cache, q = dense_case(2, 4, 2, 64, 512, quant="int8", lengths=[400, 300], seed=3)
    cases["sequence_int8"] = (dict(mode="sequence", mesh={"data": 2, "sp": 2}), q, cache,
                              lambda q=q, c=cache: sharded_jit(q, c, 2))
    cache, q = dense_case(2, 4, 2, 64, 512, lengths=[100, 300], seed=7)
    cases["sequence_empty_shard"] = (
        dict(mode="sequence", mesh={"data": 2, "sp": 2}), q, cache,
        lambda q=q, c=cache: sharded_jit(q, c, 2))
    cache, q = dense_case(2, 8, 4, 64, 512)
    cases["tp_heads_alibi"] = (dict(mode="heads", mesh={"model": 4}, paged=False, alibi=True,
                                    slopes=default_alibi_slopes(8)),
                               q, cache, lambda q=q, c=cache: jax_decode(
                                   q, c, alibi=True, alibi_slopes=jax_slopes(8)))
    b, hkv, d, page, maxp = 2, 4, 64, 128, 4
    pool = init_paged_cache(b, hkv, num_pages=b * maxp + 2, page_size=page, head_dim=d,
                            max_pages_per_seq=maxp, dtype=jnp.bfloat16)
    perm = np.arange(2, 2 + b * maxp)[::-1].reshape(b, maxp)
    for bi in range(b):
        pool = set_block_table(pool, bi, jnp.asarray(perm[bi], jnp.int32), 0)
    pool = jax.jit(append_paged)(pool, normal(0, (b, hkv, 500, d)), normal(1, (b, hkv, 500, d)))
    q = normal(2, (b, 8, d))
    port_pool = PagedKVCache(k_pages=t(pool.k_pages), v_pages=t(pool.v_pages),
                             block_table=t(pool.block_table), length=t(pool.length))
    cases["tp_heads_paged"] = (dict(mode="heads", mesh={"model": 4}, paged=True), q, port_pool,
                               lambda: paged_decode_attention(q, pool))
    out = {}
    for name, (case, q, cache, ref) in cases.items():
        if not isinstance(cache, PagedKVCache):
            cache = port_cache(cache)
        out[name] = (dict(case, q=t(q), cache=cache), ref)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (case, JAX's output, every rank's output)}."""
    built = build()
    started = Ranks("decode", 4, {n: c for n, (c, _) in built.items()},
                    tmp_path_factory.mktemp("ranks"))
    refs = {n: np.asarray(ref().astype(jnp.float32)) for n, (_, ref) in built.items()}
    ranks = started.results()
    return {n: (c, refs[n], [r[n] for r in ranks]) for n, (c, _) in built.items()}


def unsplit(case) -> torch.Tensor:
    """The port's decode of the whole cache in one process."""
    if case.get("paged"):
        return paged.paged_decode_attention(case["q"], case["cache"])
    kw = dict(alibi=True, alibi_slopes=case["slopes"]) if case.get("alibi") else {}
    return decode.decode_attention(case["q"], case["cache"], **kw)


def check(runs, name):
    case, ref, outs = runs[name]
    whole = unsplit(case)
    for r, o in enumerate(outs):
        assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all()), r
        if case["mode"] == "heads":
            assert torch.equal(o, whole), f"rank {r}: the split decode differs from the unsplit"
        else:
            rep = verify_results(whole.float(), o, **BF16_GATE)
            assert rep.passed, f"rank {r} against the unsplit decode: {rep}"
        rep = verify_results(ref, o, **BF16_GATE)
        assert rep.passed, f"rank {r} against JAX: {rep}"


def test_decode_tp_heads_sharded(runs):
    check(runs, "tp_heads_int8")


def test_decode_sequence_sharded(runs):
    check(runs, "sequence")


def test_decode_sequence_sharded_quantized(runs):
    check(runs, "sequence_int8")


def test_paged_decode_tp_heads_sharded(runs):
    check(runs, "tp_heads_paged")


def test_decode_tp_heads_sharded_alibi(runs):
    check(runs, "tp_heads_alibi")


def test_decode_sequence_sharded_empty_shard(runs):
    """Sequence 0's 100 positions lie in rank 0's half of 256: rank 1's K2
    sees no key of it (LSE -inf, O 0), and the merge (lse_merge, the rule
    of merge_partials in one process) weighs that part 0."""
    from flashattn_tpu_torch.parallel import serving

    check(runs, "sequence_empty_shard")
    case, _, _ = runs["sequence_empty_shard"]
    c, q = case["cache"], case["q"][:, :, None]
    lengths = serving.local_cache_lengths(c.length, 2, 256)
    assert lengths.tolist() == [[100, 256], [0, 44]]
    parts = [decode._decode_attention(q, KVCache(k=c.k[:, :, i * 256:(i + 1) * 256].contiguous(),
                                                 v=c.v[:, :, i * 256:(i + 1) * 256].contiguous(),
                                                 length=lengths[i]), with_lse=True)
             for i in range(2)]
    o1, lse1 = parts[1]
    assert bool(torch.isneginf(lse1[0]).all()) and not bool(o1[0].any())
    merged, _ = serving.lse_merge(parts)
    rep = verify_results(unsplit(case).float(), merged[:, :, 0], **BF16_GATE)
    assert rep.passed, rep
