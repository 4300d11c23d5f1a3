"""Flash-decode (K2) with the logit soft-cap (Gemma-2's cap * tanh(s / cap)
on the dequantized, scaled logits, before the length, window and sink
masks) in the port's glue, on the CPU paths (the plain versions), against
the JAX package's decode and paged kernels in interpret mode on the same
numpy inputs: dense and paged, with a window and sinks, in every cache
mode at T 1 and T 4, at D 64 and D 256. The paged plain version equals the
dense one bit for bit.

Tolerances as tests/test_torch_window.py: float32 atol 2e-5, rtol 1e-5,
int8 and fp8 caches atol 2e-3, rtol 1e-3, a bf16 cache atol 2e-2, rtol
1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu_torch.ops import decode, kvcache, launches, paged
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=1e-2),
       "int8": dict(atol=2e-3, rtol=1e-3), "fp8": dict(atol=2e-3, rtol=1e-3)}

B, HQ, HKV, S_MAX = 2, 4, 2, 256
CAP, WINDOW, SINK = 30.0, 48, 4
LENGTHS = [40, 230]  # one shorter than the window, one long past it
PAGE, MAX_PAGES = 128, 2  # the JAX pool takes multiples of 128
DECODE_SCALE_UP = 3.0  # q x 3: logits to about +-30 at D 64, where the cap bends


def _update(quant):
    # JAX's quantizing update runs jitted, as in its generation steps
    # (tests/test_torch_decode.py).
    return jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",)) if quant else \
        jax_kv.update_cache


def filled(mode: str, d: int, seed: int):
    """JAX and port dense caches, and JAX and port paged pools in reversed
    pages, holding the same tokens (appended a sequence at a time)."""
    quant = mode if mode in ("int8", "fp8") else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32,
                                                                      torch.float32)
    rng = np.random.default_rng(seed)
    jd = jax_kv.init_cache(B, HKV, S_MAX, d, dtype=jdt, quant=quant)
    pd = kvcache.init_cache(B, HKV, S_MAX, d, dtype=tdt, quant=quant, device="cpu")
    num_pages = B * MAX_PAGES + 1
    jp = jax_paged.init_paged_cache(B, HKV, num_pages, PAGE, d, MAX_PAGES, dtype=jdt,
                                    quant=quant)
    pp = paged.init_paged_cache(B, HKV, num_pages, PAGE, d, MAX_PAGES, dtype=tdt, quant=quant,
                                device="cpu")
    table = np.arange(1, num_pages, dtype=np.int32)[::-1].reshape(B, MAX_PAGES)
    for bi in range(B):
        jp = jax_paged.set_block_table(jp, bi, jnp.asarray(table[bi]), 0)
        paged.set_block_table(pp, bi, table[bi].tolist(), 0)
    update = _update(quant)
    for bi, n in enumerate(LENGTHS):
        mask = np.arange(B) == bi
        kv = [np.where(mask[:, None, None, None],
                       rng.standard_normal((1, HKV, n, d), dtype=np.float32), 0
                       ).astype(np.float32) for _ in range(2)]
        jk, jv = (jnp.asarray(x, jdt) for x in kv)
        tk, tv = (torch.from_numpy(x).to(tdt) for x in kv)
        jd = update(jd, jk, jv, active=jnp.asarray(mask))
        jp = jax_paged.append_paged(jp, jk, jv, active=jnp.asarray(mask))
        kvcache.update_cache(pd, tk, tv, active=torch.from_numpy(mask))
        paged.append_paged(pp, tk, tv, active=torch.from_numpy(mask))
    return jd, jp, pd, pp


def query(mode, t, d, seed):
    q = np.random.default_rng(seed).standard_normal((B, HQ, t, d), dtype=np.float32)
    q *= DECODE_SCALE_UP * (d / 64) ** 0.5  # the same logit range at every D
    if mode == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def call(fns, q, cache, t, **kw):
    one, chunk = fns
    return one(q[:, :, 0], cache, **kw)[:, :, None] if t == 1 else chunk(q, cache, **kw)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "fp8"])
def test_softcapped_decode_matches_jax(mode, t, d):
    jd, _, pd, _ = filled(mode, d, seed=10 + t + d)
    jq, tq = query(mode, t, d, seed=20 + t + d)
    kw = dict(window=WINDOW, sink=SINK, logit_softcap=CAP)
    ref = call((jax_decode.decode_attention, jax_decode.decode_attention_chunk), jq, jd, t, **kw)
    out = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t, **kw)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref.astype(jnp.float32)), out.float(), **TOL[mode])
    assert rep.passed, rep
    # the cap changes the result (the logits pass it)
    free = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t,
                window=WINDOW, sink=SINK)
    assert not torch.allclose(free.float(), out.float(), atol=1e-3)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
def test_softcapped_paged_decode_matches_jax_and_dense(mode, t, d):
    """Through the table (pages in reversed order). An int8 pool
    requantizes P per page in both packages."""
    _, jp, pd, pp = filled(mode, d, seed=30 + t + d)
    jq, tq = query(mode, t, d, seed=40 + t + d)
    kw = dict(window=WINDOW, sink=SINK, logit_softcap=CAP)
    ref = call((jax_paged.paged_decode_attention, jax_paged.paged_decode_attention_chunk),
               jq, jp, t, **kw)
    out = call((paged.paged_decode_attention, paged.paged_decode_attention_chunk), tq, pp, t,
               **kw)
    dense = decode.decode_attention_reference(tq, pd, requant_block=PAGE, **kw)
    assert torch.equal(out, dense)
    rep = verify_results(np.asarray(ref), out, **TOL[mode])
    assert rep.passed, rep


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("t", [1, 4])
def test_int8_requantization_of_peaked_rows_matches_jax(t, cap):
    """q x 100: most 64-position tiles lie so far below a row's maximum
    that their P x v_scale is subnormal or zero (a cap of 50 allows a gap
    of 144 in the exp2 domain). Requantized per 64-position tile, as the
    kernel does, such a tile contributes zeros and never 0 * inf; the
    result stays within the quantized gate of chip_smoke.py (atol and rtol
    2e-2) of the JAX kernel, which requantizes over the whole cache."""
    jd, _, pd, _ = filled("int8", 64, seed=5)
    q = np.random.default_rng(6).standard_normal((B, HQ, t, 64), dtype=np.float32) * 100
    ref = jax_decode.decode_attention_chunk(jnp.asarray(q), jd, logit_softcap=cap)
    out = decode.decode_attention_reference(torch.from_numpy(q), pd,
                                            requant_block=decode.BLOCK_KV, logit_softcap=cap)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref), out, atol=2e-2, rtol=2e-2)
    assert rep.passed, rep


def test_decode_cpu_call_with_a_cap_counts_no_launch():
    _, _, pd, pp = filled("f32", 64, seed=3)
    before = launches.read()
    q = torch.zeros((B, HQ, 64))
    decode.decode_attention(q, pd, logit_softcap=CAP)
    paged.paged_decode_attention(q, pp, logit_softcap=CAP)
    assert launches.read() == before
    assert {"flash_fwd_softcap", "decode_softcap", "paged_decode_softcap"} <= set(before)


@pytest.mark.parametrize("b,hq,hkv,t,s_max,want", [
    (2, 16, 8, 1, 8192, (512, 16)),  # GEMMA2_9B's decode step: 16 rows a CTA, 2 tiles at a time
    (2, 16, 8, 256, 8192, (4096, 2)),  # its 256-token admission chunk: 16 row blocks of 32
    (1, 16, 8, 128, 8192, (1664, 5)),  # a prefix admission's 128-token suffix
])
def test_d256_split_rule(b, hq, hkv, t, s_max, want):
    """At D 256 two warps share each 16 rows and tile (csrc/decode.cuh
    MmaLayout::kHalves): up to 16 rows a group take 2 tiles at a time, more
    take 32 rows a CTA; slices of a multiple of the tiles a CTA takes,
    covering Smax, a function of the shapes alone (the float32 kernel's
    cache tiles its own way)."""
    rows = (hq // hkv) * t
    assert decode.split_dims(torch.bfloat16, 256) and decode.split_dims(torch.int8, 256)
    assert not decode.split_dims(torch.float32, 256) and not decode.split_dims(torch.bfloat16, 128)
    row_block, tiles = decode._layout(rows, halves=True)
    assert (row_block, tiles) == ((16, 2) if rows <= 16 else (32, 1))
    got = decode._num_splits(b, hkv, rows, s_max, t, halves=True)
    assert got == want
    split_len, splits = got
    assert split_len % (decode.BLOCK_KV * tiles) == 0 and split_len * splits >= s_max
