"""The sliding window and attention sinks in the port's kernel glue (the
plain paths on the CPU) against the JAX package's kernels in interpret
mode, on the same numpy inputs: the flash forward (K1) with a window, its
gradients through flash_attention (the backward kernels' plain version)
against jax.grad of the JAX flash_attention, and the port's backward
against the JAX split and fused backward kernels; dense and paged
flash-decode (K2) with a window and sinks in every cache mode, at T 1 and
T 4. A window without is_causal raises, with or without a gradient.
Windowed gradients in float32: atol 1e-5, rtol 1e-5 (tests/test_window.py's
gate).

Tolerances: float32 atol 2e-5, rtol 1e-5 (exp2 against exp and another
summation order); int8 and fp8 caches atol 2e-3, rtol 1e-3 (one exp2 ulp
can move a requantized int8 P entry a step; the JAX kernel's fast fp8
converter differs on subnormal codes; tests/test_torch_decode.py); a bf16
cache atol 2e-2, rtol 1e-2, the repo's bf16 gate (the JAX kernel rounds P
to bf16 before P.V, the plain version keeps it in float32). The paged plain
version equals the dense one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import decode as jax_decode
from flashattn_tpu.ops import kvcache as jax_kv
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import decode, flash_bwd, flash_fwd, kvcache, launches, paged
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=1e-2),
       "int8": dict(atol=2e-3, rtol=1e-3), "fp8": dict(atol=2e-3, rtol=1e-3)}
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def make_qkv(hq, hkv, s_q, s_k, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, s, d), dtype=np.float32)
                 for h, s in ((hq, s_q), (hkv, s_k), (hkv, s_k)))


FWD_CASES = {
    # name: (Hq, Hkv, S_q, S_k, window, pos_offset)
    "w1": (4, 2, 160, 160, 1, None),
    "w7": (4, 2, 160, 160, 7, None),
    "w16_gqa4": (8, 2, 160, 160, 16, None),
    "w64": (4, 2, 256, 256, 64, None),
    "w_past_s": (4, 2, 160, 160, 1000, None),
    "w16_sq_below_sk": (4, 2, 96, 256, 16, None),
    "w64_pos_offset": (4, 1, 130, 256, 64, 60),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_windowed_forward_matches_jax(case):
    hq, hkv, s_q, s_k, w, off = FWD_CASES[case]
    q, k, v = make_qkv(hq, hkv, s_q, s_k, seed=s_q + w)
    o_j, lse_j = jax_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
                             window=w, block_sizes=BS, pos_offset=off)
    o, lse = flash_fwd.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True,
        pos_offset=off, window=w)
    for name, ref, out in (("O", o_j, o), ("LSE", lse_j, lse)):
        rep = verify_results(np.asarray(ref), out, **TOL["f32"])
        assert rep.passed, f"{name}: {rep}"
    # flash_attention without a gradient: K1's forward, no LSE
    o2 = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         is_causal=True, pos_offset=off, window=w)
    assert torch.equal(o2, o)


def test_window_needs_causal_and_a_positive_width():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(2, 1, 8, 8, d=8))
    with pytest.raises(ValueError, match="is_causal"):
        flash_fwd.flash_attention_forward(q, k, v, False, window=4)
    with pytest.raises(ValueError, match="positive"):
        flash_fwd.flash_attention_forward(q, k, v, True, window=0)
    with pytest.raises(ValueError, match="sinks need a window"):
        decode.check_window(None, 4)


def test_windowed_attention_with_a_gradient_raises():
    """A window without is_causal raises before any kernel runs, whether the
    call needs a gradient or not; with is_causal a windowed call that needs
    a gradient runs the forward and the backward (their plain versions on
    CPU tensors: no launch is counted)."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(4, 2, 32, 32, d=16))
    before = launches.read()
    with pytest.raises(ValueError, match="is_causal"):
        flash_attention(q.clone().requires_grad_(), k, v, is_causal=False, window=8)
    with torch.no_grad(), pytest.raises(ValueError, match="is_causal"):
        flash_attention(q, k, v, is_causal=False, window=8)
    leaf = q.clone().requires_grad_()
    flash_attention(leaf, k, v, is_causal=True, window=8).sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert launches.read() == before  # CPU tensors take the plain versions


def make_grad_inputs(hq, hkv, s, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, s, d), dtype=np.float32)
                 for h in (hq, hkv, hkv, hq))


GRAD_CASES = {
    # name: (Hq, Hkv, S, window): tests/test_window.py::test_window_grads'
    # windows at S 512, ::test_window_with_ragged_tail's S 500, and GQA.
    "w64": (2, 2, 512, 64),
    "w300": (2, 2, 512, 300),
    "ragged_tail_w200": (2, 2, 500, 200),
    "gqa4_2_w100": (4, 2, 300, 100),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_windowed_grads_match_jax(case):
    """O and dQ/dK/dV of a windowed flash_attention against jax.grad through
    the JAX package's flash_attention (its windowed kernels, interpret mode)."""
    hq, hkv, s, w = GRAD_CASES[case]
    q, k, v, do = make_grad_inputs(hq, hkv, s, seed=s + w)
    o_j, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
        q, k, v, is_causal=True, window=w, block_sizes=BS), *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*leaves, is_causal=True, window=w)
    o.backward(torch.from_numpy(do))
    rep = verify_results(np.asarray(o_j), o.detach(), **GRAD_TOL)
    assert rep.passed, f"O: {rep}"
    for name, ref, leaf in zip(("dQ", "dK", "dV"), grads_j, leaves):
        rep = verify_results(np.asarray(ref), leaf.grad, **GRAD_TOL)
        assert rep.passed, f"{name}: {rep}"


@pytest.mark.parametrize("impl", ["split", "fused"])
def test_windowed_backward_matches_jax_kernels(impl):
    """flash_attention_backward with a window and a pos_offset (S_q < S_k)
    against the JAX package's split (dQ, dK/dV) and fused kernels, on the
    same O and LSE."""
    hq, hkv, s_q, s_k, w, off = 4, 2, 130, 256, 64, 100
    q, k, v = make_qkv(hq, hkv, s_q, s_k, seed=7)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    o, lse = flash_fwd.flash_attention_forward(*map(torch.from_numpy, (q, k, v)), True,
                                               pos_offset=off, window=w)
    ref = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                       is_causal=True, block_sizes=BS, impl=impl, pos_offset=off, window=w)
    out = flash_bwd.flash_attention_backward(*map(torch.from_numpy, (q, k, v)), o,
                                             torch.from_numpy(do), lse, True, impl=impl,
                                             pos_offset=off, window=w)
    for name, r, g in zip(("dQ", "dK", "dV"), ref, out):
        rep = verify_results(np.asarray(r), g, **GRAD_TOL)
        assert rep.passed, f"{name}: {rep}"


# ---- flash-decode: dense and paged, every cache mode ----

B, HQ, HKV, D, S_MAX = 2, 4, 2, 64, 256
WINDOW, SINK = 48, 4
LENGTHS = [40, 230]  # one shorter than the window, one long past it
PAGE, MAX_PAGES = 128, 2  # the JAX pool takes multiples of 128


def _update(quant):
    # JAX's quantizing update runs jitted, as in its generation steps
    # (tests/test_torch_decode.py).
    return jax.jit(jax_kv.update_cache, static_argnames=("assume_fits",)) if quant else \
        jax_kv.update_cache


def filled(mode: str, seed: int):
    """JAX and port dense caches, and JAX and port paged pools in reversed
    pages, holding the same tokens (appended a sequence at a time)."""
    quant = mode if mode in ("int8", "fp8") else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32,
                                                                      torch.float32)
    rng = np.random.default_rng(seed)
    jd = jax_kv.init_cache(B, HKV, S_MAX, D, dtype=jdt, quant=quant)
    pd = kvcache.init_cache(B, HKV, S_MAX, D, dtype=tdt, quant=quant, device="cpu")
    num_pages = B * MAX_PAGES + 1
    jp = jax_paged.init_paged_cache(B, HKV, num_pages, PAGE, D, MAX_PAGES, dtype=jdt,
                                    quant=quant)
    pp = paged.init_paged_cache(B, HKV, num_pages, PAGE, D, MAX_PAGES, dtype=tdt, quant=quant,
                                device="cpu")
    table = np.arange(1, num_pages, dtype=np.int32)[::-1].reshape(B, MAX_PAGES)
    for bi in range(B):
        jp = jax_paged.set_block_table(jp, bi, jnp.asarray(table[bi]), 0)
        paged.set_block_table(pp, bi, table[bi].tolist(), 0)
    update = _update(quant)
    for bi, n in enumerate(LENGTHS):
        mask = np.arange(B) == bi
        kv = [np.where(mask[:, None, None, None],
                       rng.standard_normal((1, HKV, n, D), dtype=np.float32), 0
                       ).astype(np.float32) for _ in range(2)]
        jk, jv = (jnp.asarray(x, jdt) for x in kv)
        tk, tv = (torch.from_numpy(x).to(tdt) for x in kv)
        jd = update(jd, jk, jv, active=jnp.asarray(mask))
        jp = jax_paged.append_paged(jp, jk, jv, active=jnp.asarray(mask))
        kvcache.update_cache(pd, tk, tv, active=torch.from_numpy(mask))
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


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "fp8"])
def test_windowed_decode_matches_jax(mode, t):
    jd, _, pd, _ = filled(mode, seed=10 + t)
    jq, tq = query(mode, t, seed=20 + t)
    kw = dict(window=WINDOW, sink=SINK)
    ref = call((jax_decode.decode_attention, jax_decode.decode_attention_chunk), jq, jd, t, **kw)
    out = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t, **kw)
    assert bool(torch.isfinite(out).all())
    rep = verify_results(np.asarray(ref.astype(jnp.float32)), out.float(), **TOL[mode])
    assert rep.passed, rep
    # without sinks the result changes (the sink positions are seen)
    bare = call((decode.decode_attention, decode.decode_attention_chunk), tq, pd, t,
                window=WINDOW)
    assert not torch.equal(bare[1], out[1])


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["f32", "int8", "fp8"])
def test_windowed_paged_decode_matches_jax_and_dense(mode, t):
    """Through the table (pages in reversed order: the sink page is read
    through its own entry). An int8 pool requantizes P per page in both
    packages."""
    _, jp, pd, pp = filled(mode, seed=30 + t)
    jq, tq = query(mode, t, seed=40 + t)
    kw = dict(window=WINDOW, sink=SINK)
    ref = call((jax_paged.paged_decode_attention, jax_paged.paged_decode_attention_chunk),
               jq, jp, t, **kw)
    out = call((paged.paged_decode_attention, paged.paged_decode_attention_chunk), tq, pp, t,
               **kw)
    dense = decode.decode_attention_reference(tq, pd, requant_block=PAGE, **kw)
    assert torch.equal(out, dense)
    rep = verify_results(np.asarray(ref), out, **TOL[mode])
    assert rep.passed, rep


def test_visible_positions_rule():
    """Row r (position length - T + r % T) sees pos iff pos < length,
    pos <= its own and (pos > its own - window or pos < sink)."""
    seen = decode.visible_positions(torch.tensor([10]), 12, t=2, rows=2, window=3, sink=1)
    want = [[p < 10 and p <= own and (p > own - 3 or p < 1) for p in range(12)]
            for own in (8, 9)]
    assert seen[0].tolist() == want
