"""The port's flash-decode (plain path on the CPU) against the JAX package's
decode_attention / decode_attention_chunk in interpret mode, and the port's
in-place KV cache against the JAX cache's functional updates.

Decode tolerance in float32: atol 2e-5, rtol 1e-5 (exp2 against exp and a
different summation order). Cache updates must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu_torch.ops import decode, kvcache
from flashattn_tpu_torch.utils.verify import verify_results

ATOL, RTOL = 2e-5, 1e-5


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


@pytest.mark.parametrize("option,item", [
    (dict(window=64), "A5"), (dict(sink=4), "A5"),
    (dict(logit_softcap=30.0), "A5"), (dict(alibi=True), "A5"),
])
def test_decode_unported_options_raise(option, item):
    rng = np.random.default_rng(2)
    _, cache = make_cache(1, 1, 64, 8, [10], rng)
    q = torch.zeros((1, 2, 8))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        decode.decode_attention(q, cache, **option)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
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


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_cache_raises(quant):
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        kvcache.init_cache(1, 1, 16, 8, quant=quant, device="cpu")


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
