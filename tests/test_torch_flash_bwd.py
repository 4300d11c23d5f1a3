"""The port's flash backward (plain path on the CPU) against the JAX package's
flash_attention_backward, run in interpret mode through both of its
implementations ("split": the dQ and dK/dV kernels; "fused": the one-pass
kernel), on the same numpy inputs; and gradients through the port's
flash_attention against jax.grad through JAX's.

Tolerance in float32: atol 2e-5, rtol 1e-5 (the JAX kernels pre-scale q or
k by scale*log2(e), use exp2, and sum in another order; the gradients are
O(1))."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.attention import flash_attention as jax_flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.ops.attention import flash_attention, plain_flash_attention
from flashattn_tpu_torch.ops.reference import (
    reference_attention_backward,
    reference_attention_with_lse,
)
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128,
                block_kv_fused=128)

CASES = {
    # name: (Hq, Hkv, S_q, S_k, causal, pos_offset)
    "square": (2, 2, 128, 128, False, None),
    "square_causal": (2, 2, 128, 128, True, None),
    "gqa8_2_causal": (8, 2, 128, 128, True, None),
    "sq_below_sk": (2, 1, 128, 256, True, None),
    "sq_above_sk": (2, 1, 256, 128, True, None),
    "ragged": (4, 2, 200, 200, True, None),
    "no_key_rows": (2, 1, 128, 128, True, -64),
}


def make_inputs(hq, hkv, s_q, s_k, causal, pos_offset, d=64, seed=0):
    """q, k, v, dO from a seed, and O, LSE of the plain forward."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    k = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    v = rng.standard_normal((1, hkv, s_k, d), dtype=np.float32)
    do = rng.standard_normal((1, hq, s_q, d), dtype=np.float32)
    o, lse = reference_attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                          causal, None, pos_offset)
    return q, k, v, o.numpy(), do, lse.numpy()


def assert_close(jax_grads, port_grads):
    for name, ref, out in zip(("dQ", "dK", "dV"), jax_grads, port_grads):
        rep = verify_results(np.asarray(ref), out, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"{name}: {rep}"


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax(impl, case):
    hq, hkv, s_q, s_k, causal, off = CASES[case]
    arrays = make_inputs(hq, hkv, s_q, s_k, causal, off)
    ref = jax_backward(*map(jnp.asarray, arrays), is_causal=causal, block_sizes=BS,
                       impl=impl, pos_offset=off)
    out = flash_bwd.flash_attention_backward(*map(torch.from_numpy, arrays),
                                             is_causal=causal, impl=impl,
                                             pos_offset=off)
    assert_close(ref, out)
    if off is not None and off < 0:
        dq = out[0]
        assert torch.equal(dq[:, :, :-off], torch.zeros_like(dq[:, :, :-off]))
        assert bool(torch.isfinite(torch.cat([g.flatten() for g in out])).all())


@pytest.mark.parametrize("launcher", ["fused", "dq", "dkv"])
def test_kernel_launchers_refuse_cpu_tensors(launcher):
    """Only flash_attention_backward takes CPU tensors (to the plain
    version); each kernel's launcher raises on them and counts nothing."""
    q, k, v, o, do, lse = (torch.from_numpy(a) for a in make_inputs(4, 2, 64, 96, True, None))
    call = {
        "fused": lambda: flash_bwd_fused.flash_attention_backward_fused(q, k, v, o, do, lse),
        "dq": lambda: flash_bwd.flash_bwd_dq(q, k, v, o, do, lse),
        "dkv": lambda: flash_bwd.flash_bwd_dkv(q, k, v, do, lse, lse),
    }[launcher]
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert flash_bwd.DQ_LAUNCHES == flash_bwd.DKV_LAUNCHES == flash_bwd_fused.LAUNCHES == 0


def test_reference_rounds_p_and_ds_to_the_input_dtype():
    """bf16 inputs: the plain backward is within the repo's bf16-gradient
    gate (rtol 2e-2, atol 5e-2) of the float32 one, and differs from it."""
    arrays = [torch.from_numpy(a) for a in make_inputs(4, 2, 128, 128, True, None)]
    f32 = reference_attention_backward(*arrays, is_causal=True)
    low = [a.to(torch.bfloat16) if a.dim() == 4 else a for a in arrays]
    bf16 = reference_attention_backward(*low, is_causal=True)
    for ref, out in zip(f32, bf16):
        assert out.dtype == torch.bfloat16
        assert verify_results(ref, out, rtol=2e-2, atol=5e-2).passed
        assert not torch.equal(ref, out.float())


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal):
    """torch.autograd.grad through flash_attention (and through the plain
    route) against jax.grad through JAX's flash_attention, GQA 4/2."""
    q, k, v, _, do, _ = make_inputs(4, 2, 128, 128, causal, None, seed=3)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, is_causal=causal, block_sizes=BS)
        return jnp.sum(o * jnp.asarray(do))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (flash_attention, plain_flash_attention):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fn(qt, kt, vt, is_causal=causal)
        out = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
        assert_close(ref, out)


def test_impl_choice_and_env_override(monkeypatch):
    monkeypatch.delenv(flash_bwd.IMPL_ENV, raising=False)
    assert flash_bwd.resolve_impl("auto") == "fused"
    assert flash_bwd.resolve_impl("split") == "split"
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "split")
    assert flash_bwd.resolve_impl("auto") == "split"
    assert flash_bwd.resolve_impl("fused") == "fused"  # an explicit impl wins
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "fastest")
    with pytest.raises(ValueError, match=flash_bwd.IMPL_ENV):
        flash_bwd.resolve_impl("auto")
    with pytest.raises(ValueError, match="impl"):
        flash_bwd.resolve_impl("wavefront")
    assert os.environ[flash_bwd.IMPL_ENV] == "fastest"


@pytest.mark.parametrize("option", [dict(alibi=True, dyn_pos_offset=0), dict(dyn_pos_offset=0)])
def test_unported_options_raise(option):
    """dyn_pos_offset, which raised (ROADMAP A4), runs in the plain
    backward, also beside ALiBi (against JAX: tests/test_torch_dyn_offset.py):
    without a window it equals the static alignment pos_offset = offset; on
    the card its left-out combinations raise naming ROADMAP A9
    (test_torch_dyn_offset.py::test_card_combinations_left_out_raise_naming_a9).
    Dropout, which raised beside them before, runs
    (test_dropout_options_match_jax)."""
    arrays = [torch.from_numpy(a) for a in make_inputs(2, 1, 8, 8, False, None, d=8)]
    got = flash_bwd.flash_attention_backward(*arrays, **option)
    static = dict(option, pos_offset=option["dyn_pos_offset"])
    del static["dyn_pos_offset"]
    want = flash_bwd.flash_attention_backward(*arrays, **static)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("option", [
    dict(dropout_rate=0.1, segment_ids="ids"), dict(dropout_rate=0.1),
    dict(alibi=True, logit_softcap=30.0, dropout_rate=0.1),
], ids=["segments", "alone", "alibi_softcap"])
def test_dropout_options_match_jax(option):
    """The backward's option sets that raised before: with dropout alone
    and beside segment ids, the plain backward against the JAX kernels
    (split, on one O and LSE of the plain forward with the same rate and
    seed); with ALiBi and the soft-cap, which neither package takes
    together, both differentiable entry points refuse ("pick one")."""
    q, k, v, _, do, _ = make_inputs(2, 1, 128, 128, True, None, seed=5)
    opts = dict(option, dropout_seed=77)
    if "logit_softcap" in option:
        with pytest.raises(AssertionError, match="pick one"):
            jax.grad(lambda q: jnp.sum(jax_flash_attention(q, jnp.asarray(k), jnp.asarray(v),
                                                           is_causal=True, block_sizes=BS,
                                                           **opts)))(jnp.asarray(q))
        with pytest.raises(ValueError, match="pick one"):
            flash_attention(torch.from_numpy(q).requires_grad_(), torch.from_numpy(k),
                            torch.from_numpy(v), is_causal=True, **opts)
        return
    jopts, topts = dict(opts), dict(opts)
    if option.get("segment_ids") == "ids":
        ids = np.repeat(np.arange(2, dtype=np.int32), [70, 58])[None]
        jopts["segment_ids"] = (jnp.asarray(ids),) * 2
        topts["segment_ids"] = (torch.from_numpy(ids),) * 2
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_fwd.flash_attention_forward(tq, tk, tv, True, **topts)
    ref = jax_backward(*map(jnp.asarray, (q, k, v, o.numpy(), do, lse.numpy())),
                       is_causal=True, block_sizes=BS, impl="split", **jopts)
    assert_close(ref, flash_bwd.flash_attention_backward(tq, tk, tv, o, tdo, lse, True, **topts))


@pytest.mark.parametrize("bad", ["o_shape", "do_shape", "lse_shape"])
def test_bad_shapes_raise(bad):
    q, k, v, o, do, lse = (torch.from_numpy(a)
                           for a in make_inputs(4, 2, 16, 16, False, None, d=8))
    if bad == "o_shape":
        o = o[:, :, :8]
    elif bad == "do_shape":
        do = do[..., :4]
    else:
        lse = lse[..., None]
    with pytest.raises(ValueError):
        flash_bwd.flash_attention_backward(q, k, v, o, do, lse)


def test_verify_counts_equal_bf16_entries_in_the_cosine():
    """Two bf16 gradients equal bit for bit except one rounding difference
    pass the gate: equal entries of narrow types count toward the cosine
    (the JAX verify drops them and would see only the difference). Matching
    -inf still counts as zero error."""
    ref = torch.linspace(-1, 1, 4096).to(torch.bfloat16)
    out = ref.clone()
    out[7] = torch.nextafter(out[7], torch.tensor(2.0, dtype=torch.bfloat16))
    rep = verify_results(ref, out, rtol=2e-2, atol=5e-2)
    assert rep.passed and rep.cosine > 0.9999, rep
    lse = torch.tensor([float("-inf"), 1.0, 2.0])
    rep = verify_results(lse, lse + torch.tensor([0.0, 1e-6, 0.0]), atol=1e-3)
    assert rep.passed and rep.max_abs_err < 1e-5, rep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_matches_jax_verify_on_float32(dtype):
    """float32 operands get the JAX package's rule (equal entries drop out
    of the cosine), so the port-vs-JAX tests bind as tightly as its own;
    bf16 ones keep them. The case: equal but for the two entries nearest
    zero, whose signs flip (well inside atol; their own cosine is -1)."""
    from flashattn_tpu.utils.verify import verify_results as jax_verify

    ref = torch.linspace(-1, 1, 4096).to(dtype)
    out = ref.clone()
    out[2047:2049] = -ref[2047:2049]
    ours = verify_results(ref, out, atol=1e-2)
    theirs = jax_verify(ref.float().numpy(), out.float().numpy(), atol=1e-2)
    if dtype == torch.float32:
        assert (ours.passed, ours.cosine) == (theirs.passed, theirs.cosine), (ours, theirs)
        assert not ours.passed
    else:
        assert ours.passed and not theirs.passed, (ours, theirs)
