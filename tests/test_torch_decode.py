"""The port's flash-decode (plain path on the CPU) against the JAX package's
decode_attention / decode_attention_chunk in interpret mode, and the port's
in-place KV cache against the JAX cache's functional updates.

Decode tolerance in float32: atol 2e-5, rtol 1e-5 (exp2 against exp and a
different summation order). Quantized (int8, fp8) decode: atol 2e-3, rtol
1e-3 (a one-ulp difference in exp2 can move one requantized int8 P entry by
one step, and the JAX kernel's fast fp8 converter differs from the exact
one on subnormal codes). Cache updates and quantization must be bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu_torch.ops import decode, kvcache, paged
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy (fp8 through uint8, compared as codes)."""
    return x.view(torch.uint8).numpy() if x.dtype == kvcache.FP8_DTYPE else x.numpy()


def _jnp(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == jnp.float8_e4m3fn else x


def assert_caches_equal(port, ref):
    for name in ("k", "v", "length", "k_scale", "v_scale"):
        a, r = getattr(port, name), getattr(ref, name)
        if r is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(_np(a), _jnp(r), err_msg=name)


def make_cache(b, hkv, s_max, d, lengths, rng, nan_tail=True):
    k = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s_max, d), dtype=np.float32)
    if nan_tail:  # recycled slots may hold garbage past their length
        for i, n in enumerate(lengths):
            k[i, :, n:] = np.nan
            v[i, :, n:] = np.nan
    lengths = np.asarray(lengths, np.int32)
    jax_cache = jax_kv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=None,
                               v_scale=None, length=jnp.asarray(lengths))
    # The port updates in place: give it buffers of its own.
    port_cache = kvcache.KVCache(k=torch.tensor(k), v=torch.tensor(v),
                                 length=torch.tensor(lengths))
    return jax_cache, port_cache


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1)])
def test_decode_matches_jax(t, hq, hkv):
    rng = np.random.default_rng(t * 10 + hq)
    b, d, s_max = 3, 64, 256
    lengths = [7, 130, 256]
    jax_cache, port_cache = make_cache(b, hkv, s_max, d, lengths, rng)
    q = rng.standard_normal((b, hq, t, d), dtype=np.float32)
    if t == 1:
        ref = jax_decode.decode_attention(jnp.asarray(q[:, :, 0]), jax_cache)
        out = decode.decode_attention(torch.from_numpy(q[:, :, 0]).contiguous(),
                                      port_cache)
    else:
        ref = jax_decode.decode_attention_chunk(jnp.asarray(q), jax_cache)
        out = decode.decode_attention_chunk(torch.from_numpy(q), port_cache)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref), out, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep


def test_decode_empty_row_is_zero():
    rng = np.random.default_rng(1)
    _, cache = make_cache(2, 2, 128, 32, [0, 50], rng)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32), dtype=np.float32))
    o = decode.decode_attention(q, cache)
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert bool(torch.isfinite(o[1]).all())


@pytest.mark.parametrize("option,error", [
    # ALiBi is ported (tests/test_torch_alibi.py) beside the window and the
    # sinks; beside a soft-cap it raises, as the JAX launcher's assert does.
    (dict(window=64, logit_softcap=30.0, alibi=True), "pick one"),
    (dict(window=64, sink=4, alibi=True), None),
    (dict(logit_softcap=30.0, alibi=True), "pick one"), (dict(alibi=True), None),
])
def test_decode_unported_options_raise(option, error):
    rng = np.random.default_rng(2)
    _, cache = make_cache(1, 1, 64, 8, [10], rng)
    q = torch.zeros((1, 2, 8))
    if error is None:  # computed: the plain version's output, finite
        o = decode.decode_attention_chunk(q[:, :, None], cache, **option)
        assert torch.equal(decode.decode_attention(q, cache, **option), o[:, :, 0])
        assert bool(torch.isfinite(o).all())
        return
    with pytest.raises(ValueError, match=error):
        decode.decode_attention(q, cache, **option)
    with pytest.raises(ValueError, match=error):
        decode.decode_attention_chunk(q[:, :, None], cache, **option)


def test_decode_cpu_call_does_not_count_a_launch():
    rng = np.random.default_rng(3)
    _, cache = make_cache(1, 1, 64, 8, [10], rng)
    before = decode.LAUNCHES
    decode.decode_attention(torch.zeros((1, 2, 8)), cache)
    assert decode.LAUNCHES == before


# ---- KV cache: in-place updates must equal the JAX cache bit for bit ----

UPDATE_CASES = {
    # name: (lengths, T, active, assume_fits)
    "append_all": ([0, 5, 9], 3, None, False),
    "inactive_rows": ([2, 5, 9], 3, [True, False, True], False),
    "drop_past_capacity": ([4, 14, 16], 3, None, False),
    "inactive_and_full": ([4, 14, 13], 3, [False, True, True], False),
    "assume_fits_prefill": ([0, 0, 0], 5, None, True),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_cache_bit_equal_to_jax(case):
    lengths, t, active, assume_fits = UPDATE_CASES[case]
    rng = np.random.default_rng(4)
    b, hkv, s_max, d = 3, 2, 16, 8
    jax_cache, port_cache = make_cache(b, hkv, s_max, d, lengths, rng, nan_tail=False)
    k_new = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    v_new = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    ref = jax_kv.update_cache(
        jax_cache, jnp.asarray(k_new), jnp.asarray(v_new),
        active=None if active is None else jnp.asarray(active),
        assume_fits=assume_fits)
    out = kvcache.update_cache(
        port_cache, torch.from_numpy(k_new), torch.from_numpy(v_new),
        active=None if active is None else torch.tensor(active),
        assume_fits=assume_fits)
    assert out is port_cache  # updated in place
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(ref.v))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))


def test_write_slot_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    jax_batch, port_batch = make_cache(3, 2, 16, 8, [3, 4, 5], rng, nan_tail=False)
    jax_single, port_single = make_cache(1, 2, 16, 8, [7], rng, nan_tail=False)
    ref = jax_kv.write_slot(jax_batch, jax_single, 1)
    out = kvcache.write_slot(port_batch, port_single, 1)
    assert out is port_batch
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(ref.v))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))


def test_init_cache_matches_jax():
    ref = jax_kv.init_cache(2, 3, 32, 8, dtype=jnp.float32)
    out = kvcache.init_cache(2, 3, 32, 8, dtype=torch.float32, device="cpu")
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert out.length.dtype == torch.int32 and out.max_len == 32


def test_decode_step_after_update_matches_jax():
    """Append then decode, as one decode step does, in both packages."""
    rng = np.random.default_rng(6)
    jax_cache, port_cache = make_cache(2, 2, 128, 32, [10, 60], rng)
    k_new = rng.standard_normal((2, 2, 1, 32), dtype=np.float32)
    v_new = rng.standard_normal((2, 2, 1, 32), dtype=np.float32)
    active = np.array([True, False])
    q = rng.standard_normal((2, 4, 32), dtype=np.float32)
    jax_cache = jax_kv.update_cache(jax_cache, jnp.asarray(k_new), jnp.asarray(v_new),
                                    active=jnp.asarray(active))
    ref = jax_decode.decode_attention(jnp.asarray(q), jax_cache)
    kvcache.update_cache(port_cache, torch.from_numpy(k_new), torch.from_numpy(v_new),
                         active=torch.from_numpy(active))
    out = decode.decode_attention(torch.from_numpy(q), port_cache)
    rep = verify_results(np.asarray(ref), out, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep


# ---- quantized caches (int8, fp8): bit-equal updates, numerical decode ----

QUANTS = ["int8", "fp8"]
# The JAX package quantizes inside its jitted steps, where XLA turns the
# division of the amax by a constant qmax into a product with its f32
# reciprocal: the port follows the compiled arithmetic, so the references
# here run jitted too.
jax_quantize_tokens = jax.jit(jax_kv.quantize_tokens, static_argnums=1)
jax_update_cache = jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",))
jax_prep_decode_q = jax.jit(jax_decode.prep_decode_q, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_tokens_bit_equal_to_jax(quant):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 5, 16), dtype=np.float32) * 3
    x[0, 1, 2] = 0.0  # an all-zero token takes the 1e-8 scale floor
    x[1, 0, 0, :4] = [1e-30, -1e-20, 5e-3, -7e-4]  # subnormal fp8 codes
    jdtype = jnp.int8 if quant == "int8" else jnp.float8_e4m3fn
    ref_q, ref_s = jax_quantize_tokens(jnp.asarray(x), jdtype)
    store, scales = kvcache.store_dtype_for(quant, torch.float32)
    assert scales
    q, s = kvcache.quantize_tokens(torch.from_numpy(x), store)
    assert q.dtype == store and s.shape == (2, 3, 1, 5)
    np.testing.assert_array_equal(_np(q), _jnp(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(
        kvcache.dequantize(q, s).float().numpy(),
        np.asarray(jax_kv.dequantize(ref_q, ref_s)).astype(np.float32))


@pytest.mark.parametrize("quant", QUANTS)
def test_init_quantized_cache_matches_jax(quant):
    ref = jax_kv.init_cache(2, 3, 32, 8, dtype=jnp.float32, quant=quant)
    out = kvcache.init_cache(2, 3, 32, 8, dtype=torch.float32, quant=quant, device="cpu")
    assert out.quantized and out.k_scale.shape == (2, 3, 1, 32)
    assert_caches_equal(out, ref)


def make_quantized_pair(b, hkv, s_max, d, lengths, quant, rng):
    """A JAX and a port cache filled from the same float32 tokens."""
    ref = jax_kv.init_cache(b, hkv, s_max, d, dtype=jnp.float32, quant=quant)
    port = kvcache.init_cache(b, hkv, s_max, d, dtype=torch.float32, quant=quant,
                              device="cpu")
    t = max(lengths)
    k = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, t, d), dtype=np.float32)
    ref = jax_update_cache(ref, jnp.asarray(k), jnp.asarray(v))
    kvcache.update_cache(port, torch.from_numpy(k), torch.from_numpy(v))
    lengths = np.asarray(lengths, np.int32)
    ref = jax_kv.KVCache(k=ref.k, v=ref.v, k_scale=ref.k_scale, v_scale=ref.v_scale,
                         length=jnp.asarray(lengths))
    port.length.copy_(torch.from_numpy(lengths))
    return ref, port


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_quantized_update_cache_bit_equal_to_jax(case, quant):
    lengths, t, active, assume_fits = UPDATE_CASES[case]
    rng = np.random.default_rng(8)
    ref, port = make_quantized_pair(3, 2, 16, 8, lengths, quant, rng)
    k_new = rng.standard_normal((3, 2, t, 8), dtype=np.float32)
    v_new = rng.standard_normal((3, 2, t, 8), dtype=np.float32)
    ref = jax_update_cache(
        ref, jnp.asarray(k_new), jnp.asarray(v_new),
        active=None if active is None else jnp.asarray(active), assume_fits=assume_fits)
    out = kvcache.update_cache(
        port, torch.from_numpy(k_new), torch.from_numpy(v_new),
        active=None if active is None else torch.tensor(active), assume_fits=assume_fits)
    assert out is port
    assert_caches_equal(out, ref)


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_write_slot_bit_equal_to_jax(quant):
    rng = np.random.default_rng(9)
    ref_b, port_b = make_quantized_pair(3, 2, 16, 8, [3, 4, 5], quant, rng)
    ref_1, port_1 = make_quantized_pair(1, 2, 16, 8, [7], quant, rng)
    ref = jax_kv.write_slot(ref_b, ref_1, 2)
    out = kvcache.write_slot(port_b, port_1, 2)
    assert out is port_b
    assert_caches_equal(out, ref)


QDEC_ATOL, QDEC_RTOL = 2e-3, 1e-3


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("t", [1, 4])
def test_quantized_decode_matches_jax(quant, t):
    """Smax 256 <= the JAX kernel's block (4096 int8, 8192 fp8), so it
    requantizes P over one block, as the plain version does."""
    rng = np.random.default_rng(10 + t)
    b, hq, hkv, d, s_max = 3, 8, 2, 64, 256
    lengths = [5, 130, 256]
    ref_cache, port_cache = make_quantized_pair(b, hkv, s_max, d, lengths, quant, rng)
    q = rng.standard_normal((b, hq, t, d), dtype=np.float32)
    if t == 1:
        ref = jax_decode.decode_attention(jnp.asarray(q[:, :, 0]), ref_cache)
        out = decode.decode_attention(torch.from_numpy(q[:, :, 0]).contiguous(), port_cache)
    else:
        ref = jax_decode.decode_attention_chunk(jnp.asarray(q), ref_cache)
        out = decode.decode_attention_chunk(torch.from_numpy(q), port_cache)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref), out, atol=QDEC_ATOL, rtol=QDEC_RTOL)
    assert rep.passed, rep


def test_fp8_nan_codes_past_length_stay_out():
    """A recycled fp8 slot may hold NaN codes past its length: the plain
    version, like the kernel, never lets them reach the output."""
    rng = np.random.default_rng(11)
    _, cache = make_quantized_pair(2, 2, 128, 32, [40, 128], "fp8", rng)
    cache.k.view(torch.uint8)[0, :, 40:] = 0x7F
    cache.v.view(torch.uint8)[0, :, 40:] = 0x7F
    cache.k_scale[0, :, :, 40:] = float("nan")
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, 32), dtype=np.float32))
    assert bool(torch.isfinite(decode.decode_attention_chunk(q, cache)).all())


def test_prep_decode_q_matches_jax():
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 8, 3, 16), dtype=np.float32)
    for int8_mode in (False, True):
        ref_q, ref_s = jax_prep_decode_q(jnp.asarray(q), 2, int8_mode, 0.37)
        out_q, out_s = decode.prep_decode_q(torch.from_numpy(q), 2, int8_mode, 0.37)
        np.testing.assert_array_equal(out_q.numpy(), np.asarray(ref_q))
        if int8_mode:
            np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
        else:
            assert out_s is None and ref_s is None


@pytest.mark.parametrize("b,hq,hkv,t,s_max,want", [
    (4, 32, 4, 1, 2048, (256, 8)),  # the 4-slot decode step: 16 rows a CTA, 4 tiles at a time
    (4, 32, 4, 256, 2048, (2048, 1)),  # a 256-token chunk: 32 row blocks of 64, one slice
    (1, 32, 4, 128, 2048, (448, 5)),  # a prefix admission's 128-token suffix
    (2, 8, 2, 1, 512, (256, 2)),
    (4, 16, 2, 8, 1024, (64, 16)),  # 64 rows: one row block, tiles one at a time
    (1, 4, 4, 3, 100, (256, 1)),  # Smax not a multiple of 64
])
def test_decode_split_rule(b, hq, hkv, t, s_max, want):
    """K2's slices: each a multiple of the 64-position tiles a CTA takes at a
    time (4 with up to 16 query rows a group, 1 above), covering Smax once,
    about TARGET_CTAS CTAs where the cache is long enough; and a function of
    the shapes alone, so a paged pool and a dense cache of one max_len take
    the same slices."""
    rows = (hq // hkv) * t
    row_block, tiles = decode._layout(rows)
    assert (row_block, tiles) == ((16, 4) if rows <= 16 else (64, 1))
    got = decode._num_splits(b, hkv, rows, s_max)
    assert got == want
    split_len, splits = got
    assert split_len % (decode.BLOCK_KV * tiles) == 0
    assert (splits - 1) * split_len < s_max <= splits * split_len
    ctas = b * hkv * -(-rows // row_block) * splits
    assert ctas >= min(decode.TARGET_CTAS // 2, b * hkv * -(-rows // row_block)
                       * -(-s_max // (decode.BLOCK_KV * tiles)))
    page = 64
    pool = paged.init_paged_cache(b, hkv, b * (-(-s_max // page)), page, 64,
                                  -(-s_max // page), dtype=torch.float32, device="cpu")
    dense = kvcache.init_cache(b, hkv, pool.max_len, 64, dtype=torch.float32, device="cpu")
    assert (decode._num_splits(b, hkv, rows, pool.max_len)
            == decode._num_splits(b, hkv, rows, dense.k.shape[2]))
