"""K2 and the paged K2 at head dims 32, 80 and 96 (their plain versions on
the CPU; on the card the decode kernels compiled for the 64 and 128 tiles
take them at run time, csrc/common.cuh head_tile) against the JAX
package's flash-decode and paged kernels in interpret mode, on the same
numpy inputs: bf16, float32, int8 and fp8 caches (decode_attention_chunk at
T 4; decode_attention at T 1 on bf16), and a paged float32 and int8 pool
through a scrambled block table, bit for bit the dense plain version.

Tolerances: bf16 atol 2e-2 (ROADMAP's bf16 gate, verify_results); a
float32 cache atol 2e-5, rtol 1e-5 (exp2 against exp, another summation
order); int8 and fp8 caches atol 2e-3, rtol 1e-3 (one exp2 ulp can move
one requantized int8 P entry a step; the JAX kernel's fast fp8 converter
differs on subnormal codes), as tests/test_torch_decode.py states them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu_torch.ops import decode, kvcache, paged
from flashattn_tpu_torch.utils.verify import verify_results
from test_torch_head_dims import DIMS, HKV, HQ, O_TOL, bf16_pair

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

CACHE_TOL = {"bf16": O_TOL, "f32": dict(atol=2e-5, rtol=1e-5),
             "int8": dict(atol=2e-3, rtol=1e-3), "fp8": dict(atol=2e-3, rtol=1e-3)}


# The JAX package quantizes inside its jitted steps (XLA's product with the
# f32 reciprocal of qmax): tests/test_torch_decode.py.
jax_update_cache = jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",))

S_MAX = 256
LENGTHS = [5, 130, 256]
T = 4


def caches(mode: str, d: int, rng):
    """A JAX and a port cache of `mode` (bf16, f32, int8, fp8) holding the
    same tokens, LENGTHS long."""
    b, t = len(LENGTHS), max(LENGTHS)
    k = rng.standard_normal((b, HKV, t, d), dtype=np.float32)
    v = rng.standard_normal((b, HKV, t, d), dtype=np.float32)
    quant = mode if mode in ("int8", "fp8") else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32, torch.float32)
    ref = jax_kv.init_cache(b, HKV, S_MAX, d, dtype=jdt, quant=quant)
    port = kvcache.init_cache(b, HKV, S_MAX, d, dtype=tdt, quant=quant, device="cpu")
    ref = jax_update_cache(ref, jnp.asarray(k, dtype=jdt), jnp.asarray(v, dtype=jdt))
    kvcache.update_cache(port, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    lengths = np.asarray(LENGTHS, np.int32)
    ref = jax_kv.KVCache(k=ref.k, v=ref.v, k_scale=ref.k_scale, v_scale=ref.v_scale,
                         length=jnp.asarray(lengths))
    port.length.copy_(torch.from_numpy(lengths))
    return ref, port


def query(mode: str, d: int, t: int, rng) -> tuple[jnp.ndarray, torch.Tensor]:
    x = rng.standard_normal((len(LENGTHS), HQ, t, d), dtype=np.float32)
    if mode == "bf16":
        return bf16_pair(x)
    return jnp.asarray(x), torch.from_numpy(x)


def as_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8", "fp8"])
@pytest.mark.parametrize("d", DIMS)
def test_decode_matches_jax(d, mode):
    rng = np.random.default_rng(d + len(mode))
    ref_cache, port_cache = caches(mode, d, rng)
    jq, tq = query(mode, d, T, rng)
    ref = jax_decode.decode_attention_chunk(jq, ref_cache)
    out = decode.decode_attention_chunk(tq, port_cache)
    assert out.shape == tq.shape and bool(torch.isfinite(out).all())
    rep = verify_results(as_f32(ref), out.float(), **CACHE_TOL[mode])
    assert rep.passed, rep
    if mode == "bf16":  # one token a sequence, the decode step's call
        ref = jax_decode.decode_attention(jq[:, :, 0], ref_cache)
        out = decode.decode_attention(tq[:, :, 0].contiguous(), port_cache)
        rep = verify_results(as_f32(ref), out.float(), **CACHE_TOL[mode])
        assert rep.passed, rep


PAGE = 128  # the JAX pool takes multiples of 128
MAX_PAGES = S_MAX // PAGE


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_paged_decode_matches_jax(d, quant):
    """The paged K2's plain version through a scrambled block table against
    the JAX paged kernel, and bit for bit the dense plain version on the
    same tokens (P requantized per page in both, as the JAX paged kernel
    does)."""
    rng = np.random.default_rng(d)
    b = len(LENGTHS)
    num_pages = b * MAX_PAGES + 3
    jp = jax_paged.init_paged_cache(b, HKV, num_pages, PAGE, d, MAX_PAGES, dtype=jnp.float32,
                                    quant=quant)
    pp = paged.init_paged_cache(b, HKV, num_pages, PAGE, d, MAX_PAGES, dtype=torch.float32,
                                quant=quant, device="cpu")
    pd = kvcache.init_cache(b, HKV, S_MAX, d, dtype=torch.float32, quant=quant, device="cpu")
    perm = np.arange(3, 3 + b * MAX_PAGES, dtype=np.int32)[::-1].reshape(b, MAX_PAGES)
    for bi in range(b):
        jp = jax_paged.set_block_table(jp, bi, jnp.asarray(perm[bi]), 0)
        paged.set_block_table(pp, bi, perm[bi].tolist(), 0)
    t = max(LENGTHS)
    k = rng.standard_normal((b, HKV, t, d), dtype=np.float32)
    v = rng.standard_normal((b, HKV, t, d), dtype=np.float32)
    for bi, n in enumerate(LENGTHS):  # one sequence at a time, as tests/test_paged.py
        mask = np.arange(b) == bi
        kb = np.where(mask[:, None, None, None], k, 0)[:, :, :n].astype(np.float32)
        vb = np.where(mask[:, None, None, None], v, 0)[:, :, :n].astype(np.float32)
        jp = jax_paged.append_paged(jp, jnp.asarray(kb), jnp.asarray(vb),
                                    active=jnp.asarray(mask))
        paged.append_paged(pp, torch.from_numpy(kb), torch.from_numpy(vb),
                           active=torch.from_numpy(mask))
        kvcache.update_cache(pd, torch.from_numpy(kb), torch.from_numpy(vb),
                             active=torch.from_numpy(mask))
    q = rng.standard_normal((b, HQ, d), dtype=np.float32)
    ref = jax_paged.paged_decode_attention(jnp.asarray(q), jp)
    out = paged.paged_decode_attention(torch.from_numpy(q), pp)
    dense = decode.decode_attention_reference(torch.from_numpy(q)[:, :, None], pd,
                                              requant_block=PAGE)[:, :, 0]
    assert torch.equal(out, dense)
    rep = verify_results(np.asarray(ref), out, **CACHE_TOL[quant or "f32"])
    assert rep.passed, rep
