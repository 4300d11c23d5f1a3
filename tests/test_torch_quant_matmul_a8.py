"""The port's a8 mode of quant_matmul (W8A8, W4A8) against the JAX
package's: quantize_rows bit for bit against a jax.jit of the JAX
quantization (flashattn_tpu/ops/quant_matmul.py:226-229), and
quant_matmul(..., quantize_activations=True) against the JAX kernels in
interpret mode on the same inputs, for int8 and int4 weights.

quant_matmul tolerance: float32 out, atol 1e-6, rtol 1e-6 (both sum exact
integers: the port in int32, JAX per K block in int32 then in f32, exact
while the partial sums stay below 2^24, as they do here); bf16 out, atol
2e-2, rtol 1e-2 (one bf16 ulp). The accuracy budget against the
unquantized product is the JAX test's (tests/test_quant_matmul.py:88-99)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import quant_matmul as jax_qmm
from flashattn_tpu_torch.ops import quant_matmul as qmm
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


@jax.jit
def jax_quantize_rows(x):
    """flashattn_tpu/ops/quant_matmul.py:226-229, as quant_matmul's jit
    compiles them."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=1, keepdims=True)
    x_scale = jnp.maximum(amax / jax_qmm.INT8_MAX, 1e-10)
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / x_scale),
                   -jax_qmm.INT8_MAX, jax_qmm.INT8_MAX).astype(jnp.int8)
    return x_q, x_scale


def rows(m, k, seed):
    """Rows of random magnitude (2^-20 to 2^20, so the scale's last bit
    varies), an all-zero row, and rows whose amax is 127 * 2^e, giving the
    scale 2^e exactly, filled with (j + 0.5) * 2^e: every x / x_scale on a
    .5 boundary, where round half to even decides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= np.exp2(rng.uniform(-20, 20, (m, 1))).astype(np.float32)
    x[1] = 0.0
    for r, e in ((2, 0), (3, -3), (4, 5)):
        j = rng.integers(-127, 127, k).astype(np.float32)
        x[r] = (j + 0.5) * np.float32(2.0 ** e)
        x[r, 0] = 127.0 * 2.0 ** e
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_to_jitted_jax(dtype):
    x = rows(64, 256, 1)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref_q, ref_s = jax_quantize_rows(jx)
    x_q, x_scale = qmm.quantize_rows(tx)
    assert x_q.dtype == torch.int8 and x_scale.dtype == torch.float32
    assert x_q.shape == (64, 256) and x_scale.shape == (64, 1)
    np.testing.assert_array_equal(x_scale.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(ref_q))
    # The rows this test means to cover are there: the zero row takes the
    # scale floor; the .5 rows land on .5 before rounding and round half to
    # even, down from odd j + 0.5 and up from even j + 0.5.
    assert x_scale[1, 0] == np.float32(1e-10) and not x_q[1].any()
    for r, e in ((2, 0), (3, -3), (4, 5)):
        assert x_scale[r, 0] == np.float32(2.0 ** e)
        ratio = tx[r, 1:].float() / x_scale[r]
        assert bool((ratio - ratio.floor() == 0.5).all())
        q = x_q[r, 1:].float()
        assert bool((q % 2 == 0).all()) and (q < ratio).any() and (q > ratio).any()


def test_quantize_rows_scale_is_the_jitted_product():
    """The scale is amax * f32(1/127) (what XLA compiles the division into),
    which differs from the f32 division amax / 127 in a few per cent of
    rows: those rows must follow the product."""
    x = rows(512, 64, 2)
    _, x_scale = qmm.quantize_rows(torch.from_numpy(x))
    amax = np.abs(x).max(axis=1, keepdims=True)
    product = np.maximum(amax * np.float32(qmm.INV_INT8_MAX), np.float32(1e-10))
    division = np.maximum(amax / np.float32(127.0), np.float32(1e-10))
    assert qmm.INV_INT8_MAX == float(np.float32(1.0) / np.float32(127.0))
    np.testing.assert_array_equal(x_scale.numpy(), product)
    assert (product != division).any()


def weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n), dtype=np.float32) * 0.02
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-10 scale floor
    return w


CASES = [(bits, m) for bits in (8, 4) for m in (1, 6, 16, 17, 40)]


@pytest.mark.parametrize("bits,m", CASES)
def test_a8_matches_jax_interpret(bits, m):
    k, n = 256, 128
    rng = np.random.default_rng(10 * m + bits)
    x = rng.standard_normal((m, k), dtype=np.float32)
    x[0] = 0.0  # an all-zero row of x
    w = weights(k, n, m)
    jw = jax_qmm.quantize_weights(jnp.asarray(w), bits)
    tw = qmm.quantize_weights(torch.from_numpy(w), bits)
    for x_dtype in ("float32", "bfloat16"):
        jx = jnp.asarray(x, getattr(jnp, x_dtype))
        tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
        for out_dtype, tol in (("float32", dict(atol=1e-6, rtol=1e-6)),
                               ("bfloat16", dict(atol=2e-2, rtol=1e-2))):
            ref = jax_qmm.quant_matmul(jx, jw, out_dtype=getattr(jnp, out_dtype),
                                       quantize_activations=True)
            out = qmm.quant_matmul(tx, tw, out_dtype=getattr(torch, out_dtype),
                                   quantize_activations=True)
            assert out.shape == (m, n) and out.dtype == getattr(torch, out_dtype)
            rep = verify_results(np.asarray(ref.astype(jnp.float32)), out.float(), **tol)
            assert rep.passed, (x_dtype, out_dtype, rep)
            assert not out[0].any()


@pytest.mark.parametrize("bits", [8, 4])
def test_a8_matches_jax_over_several_k_blocks(bits):
    """JAX's block_k 128 at K 512: its f32 sum of four (int4: four pairs of)
    int32 block dots against the port's one int32 sum."""
    k, n, m = 512, 256, 24
    x = np.random.default_rng(bits).standard_normal((m, k), dtype=np.float32)
    w = weights(k, n, 7)
    ref = jax_qmm.quant_matmul(jnp.asarray(x), jax_qmm.quantize_weights(jnp.asarray(w), bits),
                               block_k=128, quantize_activations=True)
    out = qmm.quant_matmul(torch.from_numpy(x), qmm.quantize_weights(torch.from_numpy(w), bits),
                           quantize_activations=True)
    rep = verify_results(np.asarray(ref), out, atol=1e-6, rtol=1e-6)
    assert rep.passed, rep


@pytest.mark.parametrize("bits", [8, 4])
def test_a8_accuracy_budget(bits):
    """tests/test_quant_matmul.py::test_quant_matmul_a8's budget on the
    port: within atol 5e-2, rtol 5e-2 of x @ dequantize_weights (the
    activations' quantization noise, about 0.4 %)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 512), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((512, 256), dtype=np.float32) * 0.05)
    qw = qmm.quantize_weights(w, bits)
    y = qmm.quant_matmul(x, qw, quantize_activations=True)
    rep = verify_results(x @ qmm.dequantize_weights(qw), y, atol=5e-2, rtol=5e-2)
    assert rep.passed, rep


def test_a8_plain_version_is_the_exact_integer_product():
    """The plain version's sum is the integer product of x_q and the
    weights, exact in float64 and int32: equal to an int64 product."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 1024), dtype=np.float32))
    qw = qmm.quantize_weights(torch.from_numpy(weights(1024, 64, 5)), 8)
    x_q, x_scale = qmm.quantize_rows(x)
    exact = (x_q.long() @ qmm.integer_weights(qw).long()).float()
    want = exact * qw.scale * x_scale
    assert torch.equal(qmm.quant_matmul_reference(x, qw, quantize_activations=True), want)
    with pytest.raises(ValueError, match="a8 mode"):
        qmm.quant_matmul(torch.zeros(1, qmm.A8_K_MAX + 64), qmm.QuantizedLinear(
            torch.zeros(qmm.A8_K_MAX + 64, 16, dtype=torch.int8), torch.ones(1, 16), 8,
            qmm.A8_K_MAX + 64), quantize_activations=True)
