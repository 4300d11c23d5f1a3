"""The port's weight-only int8/int4 quantized matmul against the JAX
package's: quantize_weights and dequantize_weights bit for bit (the packed
int4 bytes included), and quant_matmul's plain version against the JAX
kernels in interpret mode on the same inputs; and the split-K plan that
quant_matmul gives qmm8's card kernel at M <= 16 (qmm8_split), a rule of
the shapes and the card's SM count.

quant_matmul tolerance: float32 x, atol 1e-5, rtol 1e-5 (fp32 sums over K in
another order); bf16 x with a bf16 result, atol 2e-2, rtol 1e-2 (the two
round the fp32 result to bf16 from sums in another order, one bf16 ulp)."""

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


def weights(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n), dtype=np.float32) * 0.02
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-10 scale floor
    return w


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_bit_equal_to_jax(bits):
    w = weights(256, 96, bits)
    ref = jax_qmm.quantize_weights(jnp.asarray(w), bits=bits)
    out = qmm.quantize_weights(torch.from_numpy(w), bits=bits)
    assert (out.bits, out.k) == (ref.bits, ref.k) and out.w.dtype == torch.int8
    np.testing.assert_array_equal(out.w.numpy(), np.asarray(ref.w))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(qmm.dequantize_weights(out).numpy(),
                                  np.asarray(jax_qmm.dequantize_weights(ref)))


def test_int4_half_split_packing():
    """Byte row r holds row r in its low nibble and row r + K/2 in its high
    one; every value in [-7, 7] round-trips."""
    k = 32
    r, c = np.meshgrid(np.arange(k), np.arange(16), indexing="ij")
    vals = ((r + c) % 15 - 7).astype(np.float32)  # each channel's amax is 7: scale 1
    qw = qmm.quantize_weights(torch.from_numpy(vals), bits=4)
    assert qw.w.shape == (k // 2, 16)
    raw = qw.w.view(torch.uint8).to(torch.int32)
    np.testing.assert_array_equal((raw & 0xF).numpy(), vals[: k // 2].astype(np.int32) & 0xF)
    np.testing.assert_array_equal((raw >> 4).numpy(), vals[k // 2:].astype(np.int32) & 0xF)
    np.testing.assert_array_equal(qmm.integer_weights(qw).numpy(), vals.astype(np.int32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(13, 512, 256), (4, 5632, 128), (1, 256, 32)])
def test_quant_matmul_matches_jax(bits, m, k, n):
    rng = np.random.default_rng(m * 7 + bits)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = weights(k, n, m + k)
    ref = jax_qmm.quant_matmul(jnp.asarray(x), jax_qmm.quantize_weights(jnp.asarray(w), bits))
    out = qmm.quant_matmul(torch.from_numpy(x), qmm.quantize_weights(torch.from_numpy(w), bits))
    assert out.shape == (m, n) and out.dtype == torch.float32
    rep = verify_results(np.asarray(ref), out, atol=1e-5, rtol=1e-5)
    assert rep.passed, rep


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_bf16_and_f32_output_match_jax(bits):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 256), dtype=np.float32)
    w = weights(256, 128, 6)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jw = jax_qmm.quantize_weights(jnp.asarray(w), bits)
    tw = qmm.quantize_weights(torch.from_numpy(w), bits)
    for out_dtype, jdt, tol in ((None, None, dict(atol=2e-2, rtol=1e-2)),
                                (torch.float32, jnp.float32, dict(atol=1e-5, rtol=1e-5))):
        ref = jax_qmm.quant_matmul(jx, jw, out_dtype=jdt)
        out = qmm.quant_matmul(tx, tw, out_dtype=out_dtype)
        assert out.dtype == (out_dtype or torch.bfloat16)
        rep = verify_results(np.asarray(ref).astype(np.float32), out.float(), **tol)
        assert rep.passed, (out_dtype, rep)


def test_a8_mode_raises_and_cpu_counts_no_launch():
    """The a8 mode runs on the CPU (its plain version; the JAX comparisons
    are in test_torch_quant_matmul_a8.py); a CPU call, a8 or not, counts
    no launch; a wrong K and unknown bits raise. The name is historical:
    the a8 mode raised before it had kernels, and no longer does."""
    qw = qmm.quantize_weights(torch.randn(64, 16), bits=8)
    counters = ("QMM8_LAUNCHES", "QMM4_LAUNCHES", "QMM8_A8_LAUNCHES", "QMM4_A8_LAUNCHES",
                "QUANTIZE_ROWS_LAUNCHES")
    before = [getattr(qmm, c) for c in counters]
    x = torch.randn(2, 64)
    y = qmm.quant_matmul(x, qw, quantize_activations=True)
    assert torch.equal(y, qmm.quant_matmul_reference(x, qw, quantize_activations=True))
    assert y.shape == (2, 16) and y.dtype == torch.float32
    with pytest.raises(ValueError, match="K="):
        qmm.quant_matmul(torch.randn(2, 32), qw)
    qmm.quant_matmul(torch.randn(2, 64), qw)
    qmm.quantize_rows(x)
    assert [getattr(qmm, c) for c in counters] == before
    with pytest.raises(ValueError, match="bits"):
        qmm.quantize_weights(torch.randn(64, 16), bits=3)


@pytest.mark.parametrize("m,k,n,want", [
    (4, 2048, 5632, (128, 16)),  # gate/up at the decode batch: 44 column tiles x 16 splits
    (1, 2048, 256, (64, 32)),  # wk/wv: one 64-row tile a split
    (16, 2048, 32000, (448, 5)),  # the head: few splits, many column tiles
    (4, 5632, 2048, (128, 44)),  # w_down
    (16, 2048, 2048, (64, 32)),
    (17, 2048, 5632, None),  # past the split-K kernel: one pass on the tensor cores
    (1024, 2048, 5632, None),
])
def test_qmm8_split_rule(m, k, n, want):
    """qmm8's split-K plan for the decode batch: rows per split a multiple of
    64 and at most 512, splits covering K exactly once, a grid of about 8
    CTAs an SM on an H100's 132 SMs; none above M 16."""
    got = qmm.qmm8_split(m, k, n)
    assert got == want
    if got is not None:
        rows, splits = got
        assert rows % qmm.K_MULTIPLE == 0 and rows <= qmm.SPLIT_ROWS_MAX
        assert (splits - 1) * rows < k <= splits * rows
        ctas = -(-n // qmm.SPLIT_COLS) * splits
        assert ctas >= min(k // qmm.K_MULTIPLE * -(-n // qmm.SPLIT_COLS),
                           qmm.SPLIT_CTAS_PER_SM * qmm.H100_SMS // 2)


@pytest.mark.parametrize("m,k,n,want", [
    (4, 2048, 5632, (64, 16)),  # gate/up at the decode batch: 1024 byte rows, 16 splits
    (1, 2048, 256, (64, 16)),  # wk/wv: one 64-byte-row tile a split
    (16, 2048, 32000, (256, 4)),  # the head: few splits, many column tiles
    (4, 5632, 2048, (64, 44)),  # w_down: 2816 byte rows
    (4, 64 * 3, 128, (64, 2)),  # K/2 = 96 byte rows: a last split of 32
    (17, 2048, 5632, None),  # past the split-K kernel: one pass on the tensor cores
    (1024, 2048, 5632, None),
])
def test_qmm4_split_rule(m, k, n, want):
    """qmm4's split-K plan over its K/2 packed byte rows: splits a multiple
    of 64 byte rows, covering them exactly once, the half-split x slice of a
    split (twice its byte rows) within the shared memory of SPLIT_ROWS_MAX
    columns, and about 8 CTAs an SM on an H100's 132 SMs; none above M 16."""
    got = qmm.qmm4_split(m, k, n)
    assert got == want
    if got is not None:
        rows, splits = got
        assert rows % qmm.K_MULTIPLE == 0 and 2 * rows <= qmm.SPLIT_ROWS_MAX
        assert (splits - 1) * rows < k // 2 <= splits * rows
        ctas = -(-n // qmm.SPLIT_COLS) * splits
        assert ctas >= min(-(-(k // 2) // qmm.K_MULTIPLE) * -(-n // qmm.SPLIT_COLS),
                           qmm.SPLIT_CTAS_PER_SM * qmm.H100_SMS // 2)
