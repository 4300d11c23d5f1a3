"""ALiBi in the port's kernel glue (slope_h * (key position - query
position) on the scaled logits) on the CPU paths, the plain versions,
against the JAX package's kernels in interpret mode on the same numpy
inputs: flash_attention_forward and decode in every cache mode, and K2's
LSE output; mirrors tests/test_alibi.py. The paged decode, the model and
the server are in tests/test_torch_alibi_model.py (the head-sharded case
waits for the multi-card layer, ROADMAP A9).

Tolerances: float32 outputs and LSE atol 1e-5, rtol 1e-5 (tests/
test_alibi.py's); decode in float32 atol 2e-5, rtol 1e-5, with int8 and
fp8 caches atol 2e-3, rtol 1e-3, with a bf16 cache atol 2e-2, rtol 1e-2
(tests/test_torch_softcap_decode.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import default_alibi_slopes as jax_default_slopes
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import decode, flash_fwd, kvcache, paged
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
DEC_TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=1e-2),
           "int8": dict(atol=2e-3, rtol=1e-3), "fp8": dict(atol=2e-3, rtol=1e-3)}


def qkv(hq, hkv, s_q, s_k, seed, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, hq, s_q, d), dtype=np.float32),
            rng.standard_normal((1, hkv, s_k, d), dtype=np.float32),
            rng.standard_normal((1, hkv, s_k, d), dtype=np.float32))


def forward_pair(arrays, **kw):
    """(JAX O, LSE) in interpret mode and the port's (O, LSE) on the CPU."""
    jo, jl = jax_forward(*(jnp.asarray(a) for a in arrays), block_sizes=BS, **kw)
    kw = {k: torch.from_numpy(np.array(v)) if isinstance(v, jnp.ndarray) else v
          for k, v in kw.items()}
    o, lse = flash_fwd.flash_attention_forward(*(torch.from_numpy(a) for a in arrays), **kw)
    return (np.asarray(jo), np.asarray(jl)), (o, lse)


def assert_pair(ref, out, tol=F32_TOL):
    for name, r, o in zip(("O", "LSE"), ref, out):
        rep = verify_results(r, o, **tol)
        assert rep.passed, f"{name}: {rep}"


@pytest.mark.parametrize("is_causal,window,s_q", [
    (False, None, 256), (True, None, 256), (True, 96, 256), (True, None, 136),
])
def test_alibi_forward_matches_jax(is_causal, window, s_q):
    """Causal and not, with a window, and S_q < S_k (the bias's distance
    aligned bottom-right, as the causal mask)."""
    arrays = qkv(4, 4, s_q, 256, seed=0)
    ref, out = forward_pair(arrays, is_causal=is_causal, window=window, alibi=True)
    assert_pair(ref, out)
    plain = flash_fwd.flash_attention_forward(*(torch.from_numpy(a) for a in arrays),
                                              is_causal=is_causal, window=window)
    assert not torch.allclose(plain[0], out[0], atol=1e-3)  # the bias changes O


def test_alibi_gqa_slopes_follow_the_query_head():
    """Hq 4 over Hkv 2: each query head takes its own slope."""
    arrays = qkv(4, 2, 256, 256, seed=5)
    ref, out = forward_pair(arrays, is_causal=True, alibi=True)
    assert_pair(ref, out)
    # every query head of a group sharing one slope would be another result
    shared = torch.tensor([0.5, 0.5, 0.125, 0.125])
    other = flash_fwd.flash_attention_forward(*(torch.from_numpy(a) for a in arrays),
                                              is_causal=True, alibi=True, alibi_slopes=shared)
    assert not torch.allclose(other[0], out[0], atol=1e-3)


def test_custom_alibi_slopes():
    """The standard table passed explicitly is bit-equal to the default;
    other slopes match the JAX kernel given the same slopes. The tables
    themselves agree with the JAX package's: exactly where the exponents
    are whole (H 4, 8), within two float32 steps elsewhere (the two
    libraries' exp2)."""
    for h in (4, 8):
        assert torch.equal(flash_fwd.default_alibi_slopes(h),
                           torch.from_numpy(np.array(jax_default_slopes(h))))
    for h in (12, 32):
        np.testing.assert_allclose(flash_fwd.default_alibi_slopes(h).numpy(),
                                   np.asarray(jax_default_slopes(h)), rtol=2.0**-21, atol=0)
    q, k, v = (torch.from_numpy(a) for a in qkv(4, 4, 256, 256, seed=3))
    o_default, _ = flash_fwd.flash_attention_forward(q, k, v, True, alibi=True)
    o_explicit, _ = flash_fwd.flash_attention_forward(
        q, k, v, True, alibi=True, alibi_slopes=flash_fwd.default_alibi_slopes(4))
    assert torch.equal(o_default, o_explicit)
    slopes = np.full((4,), 0.25, np.float32)
    ref, out = forward_pair(qkv(4, 4, 256, 256, seed=3), is_causal=True, alibi=True,
                            alibi_slopes=jnp.asarray(slopes))
    assert_pair(ref, out)
    assert not torch.allclose(out[0], o_default, atol=1e-3)


def test_alibi_option_rules():
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 2, 8, 8, seed=1, d=8))
    with pytest.raises(ValueError, match="pick one"):
        flash_fwd.flash_attention_forward(q, k, v, True, alibi=True, logit_softcap=30.0)
    with pytest.raises(ValueError, match="needs alibi=True"):
        flash_fwd.flash_attention_forward(q, k, v, True, alibi_slopes=torch.ones(2))
    with pytest.raises(ValueError, match=r"\(2,\) tensor"):
        flash_fwd.flash_attention_forward(q, k, v, True, alibi=True, alibi_slopes=torch.ones(3))
    # The gradient through ALiBi runs (its backward is ported: tests/
    # test_torch_alibi_bwd.py); with the cap it still raises "pick one".
    o = flash_attention(q.requires_grad_(), k, v, True, alibi=True)
    (grad,) = torch.autograd.grad(o.sum(), q)
    assert bool(torch.isfinite(grad).all()) and bool(grad.any())
    with pytest.raises(ValueError, match="pick one"):
        flash_attention(q, k, v, True, alibi=True, logit_softcap=30.0)
    # Dropout beside ALiBi runs (ported: tests/test_torch_dropout.py), its
    # LSE that without dropout; dyn_pos_offset beside ALiBi runs too
    # (ported: tests/test_torch_dyn_offset.py), without the causal mask.
    o, lse = flash_fwd.flash_attention_forward(q, k, v, True, alibi=True, dropout_rate=0.1,
                                               dropout_seed=3)
    assert bool(torch.isfinite(o).all())
    assert torch.equal(lse, flash_fwd.flash_attention_forward(q, k, v, True, alibi=True)[1])
    o_d, lse_d = flash_fwd.flash_attention_forward(q, k, v, False, alibi=True, dyn_pos_offset=0)
    o_s, lse_s = flash_fwd.flash_attention_forward(q, k, v, False, alibi=True, pos_offset=0)
    assert torch.equal(o_d, o_s) and torch.equal(lse_d, lse_s)
    with pytest.raises(ValueError, match="is_causal=False"):
        flash_fwd.flash_attention_forward(q, k, v, True, alibi=True, dyn_pos_offset=0)
    with torch.no_grad():  # no gradient to take: the forward alone runs
        assert bool(torch.isfinite(flash_attention(q, k, v, True, alibi=True)).all())


# ---- K2: dense and paged decode ----

B, HQ, HKV, D, S_MAX = 2, 4, 2, 64, 256
LENGTHS = [40, 230]
PAGE, MAX_PAGES = 128, 2  # the JAX pool takes multiples of 128


def _update(quant):
    # JAX's quantizing update runs jitted, as in its generation steps
    # (tests/test_torch_decode.py).
    return jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",)) if quant else \
        jax_kv.update_cache


def filled(mode: str, seed: int, lengths=LENGTHS, pools: bool = False):
    """JAX and port dense caches, and with `pools` JAX and port paged pools
    in reversed pages (else None), holding the same tokens (appended a
    sequence at a time)."""
    quant = mode if mode in ("int8", "fp8") else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32,
                                                                      torch.float32)
    rng = np.random.default_rng(seed)
    jd = jax_kv.init_cache(B, HKV, S_MAX, D, dtype=jdt, quant=quant)
    pd = kvcache.init_cache(B, HKV, S_MAX, D, dtype=tdt, quant=quant, device="cpu")
    jp = pp = None
    if pools:
        num_pages = B * MAX_PAGES + 1
        jp = jax_paged.init_paged_cache(B, HKV, num_pages, PAGE, D, MAX_PAGES, dtype=jdt,
                                        quant=quant)
        pp = paged.init_paged_cache(B, HKV, num_pages, PAGE, D, MAX_PAGES, dtype=tdt,
                                    quant=quant, device="cpu")
        table = np.arange(1, num_pages, dtype=np.int32)[::-1].reshape(B, MAX_PAGES)
        for bi in range(B):
            jp = jax_paged.set_block_table(jp, bi, jnp.asarray(table[bi]), 0)
            paged.set_block_table(pp, bi, table[bi].tolist(), 0)
    update = _update(quant)
    for bi, n in enumerate(lengths):
        if n == 0:
            continue
        mask = np.arange(B) == bi
        kv = [np.where(mask[:, None, None, None],
                       rng.standard_normal((1, HKV, n, D), dtype=np.float32), 0
                       ).astype(np.float32) for _ in range(2)]
        jk, jv = (jnp.asarray(x, jdt) for x in kv)
        tk, tv = (torch.from_numpy(x).to(tdt) for x in kv)
        jd = update(jd, jk, jv, active=jnp.asarray(mask))
        kvcache.update_cache(pd, tk, tv, active=torch.from_numpy(mask))
        if pools:
            jp = jax_paged.append_paged(jp, jk, jv, active=jnp.asarray(mask))
            paged.append_paged(pp, tk, tv, active=torch.from_numpy(mask))
    return jd, jp, pd, pp


def query(mode, t, seed):
    q = np.random.default_rng(seed).standard_normal((B, HQ, t, D), dtype=np.float32)
    if mode == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def call(fns, q, cache, t, **kw):
    one, chunk = fns
    return one(q[:, :, 0], cache, **kw)[:, :, None] if t == 1 else chunk(q, cache, **kw)


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "fp8"])
def test_alibi_decode_matches_jax(mode, t):
    """Decode and the chunked mode (row t at position length - T + t) with
    ALiBi, every cache mode, against the JAX kernel in interpret mode."""
    jd, _, pd, _ = filled(mode, seed=10 + t)
    jq, tq = query(mode, t, seed=20 + t)
    ref = call((jax_decode.decode_attention, jax_decode.decode_attention_chunk), jq, jd, t,
               alibi=True)
    out = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t, alibi=True)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref.astype(jnp.float32)), out.float(), **DEC_TOL[mode])
    assert rep.passed, rep
    free = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t)
    assert not torch.allclose(free.float(), out.float(), atol=1e-3)


def test_alibi_decode_custom_slopes_match_jax():
    jd, _, pd, _ = filled("f32", seed=3)
    jq, tq = query("f32", 4, seed=4)
    slopes = np.array([0.5, 0.25, 0.75, 0.05], np.float32)
    ref = jax_decode.decode_attention_chunk(jq, jd, alibi=True, alibi_slopes=jnp.asarray(slopes))
    out = decode.decode_attention_chunk(tq, pd, alibi=True, alibi_slopes=torch.from_numpy(slopes))
    rep = verify_results(np.asarray(ref), out, **DEC_TOL["f32"])
    assert rep.passed, rep


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_decode_lse_matches_jax(mode, alibi):
    """K2's LSE output (with_lse): natural log, as the JAX launcher's
    _decode_attention(with_lse=True); a slot of length 0 sees no key: O 0
    and LSE -inf in both."""
    jd, _, pd, _ = filled(mode, seed=50, lengths=[0, 230])
    jq, tq = query(mode, 4, seed=51)
    jo, jl = jax_decode._decode_attention(jq, jd, None, None, None, False, None, with_lse=True,
                                          alibi=alibi)
    o, lse = decode._decode_attention(tq, pd, with_lse=True, alibi=alibi)
    assert lse.shape == (B, HQ, 4) and lse.dtype == torch.float32
    assert bool(torch.isneginf(lse[0]).all()) and bool(np.isneginf(np.asarray(jl)[0]).all())
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    tol = DEC_TOL[mode]
    for name, r, x in (("O", np.asarray(jo)[1], o[1]), ("LSE", np.asarray(jl)[1], lse[1])):
        rep = verify_results(r, x, **tol)
        assert rep.passed, f"{name}: {rep}"
    assert torch.equal(o, decode.decode_attention_chunk(tq, pd, alibi=alibi))
