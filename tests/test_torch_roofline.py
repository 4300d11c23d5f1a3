"""The port's roofline (utils/roofline.py) against the JAX package's FLOP
counts, and its H100 bounds at the shapes of PERF.md's kernel table, which
chip_smoke.py phase 2 prints from this module. FLOPs are compared exactly
(the same formula in float64); the bounds to the digits the table shows."""

import pytest
import torch

from flashattn_tpu.utils import roofline as jax_roofline
from flashattn_tpu_torch.utils import roofline

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

H100 = roofline.H100_SXM

ATTN_SHAPES = [  # (B, Hq, Hkv, S_q, S_k, D, causal)
    (1, 32, 4, 256, 256, 64, True),
    (4, 32, 4, 2048, 2048, 64, True),
    (4, 8, 8, 16384, 16384, 128, True),
    (2, 8, 2, 512, 1024, 128, False),
]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_flops_equal_jax(shape):
    # The JAX functions take the TPU's block sizes; the port's bytes do not
    # depend on blocks, so it takes none.
    fwd = roofline.attention_fwd_roofline(*shape, chip=H100)
    bwd = roofline.attention_bwd_roofline(*shape, chip=H100)
    assert fwd.flops == jax_roofline.attention_fwd_roofline(
        *shape, 128, 128, chip=jax_roofline.TPU_V5E).flops
    assert bwd.flops == jax_roofline.attention_bwd_roofline(
        *shape, 128, 128, chip=jax_roofline.TPU_V5E).flops
    # The split backward recomputes S: dQ 3 products, dK/dV 4, the fused 5.
    dq = roofline.attention_bwd_roofline(*shape, chip=H100, kernel="dq")
    dkv = roofline.attention_bwd_roofline(*shape, chip=H100, kernel="dkv")
    assert dq.flops + dkv.flops == pytest.approx(bwd.flops * 7 / 5)


# PERF.md's "Bound ms" column: (name, report, table value, decimals shown, by).
L = [1, 77, 1500, 2048]
TABLE = [
    ("B1 prefill", lambda: roofline.attention_fwd_roofline(
        1, 32, 4, 256, 256, 64, True, need_lse=False, chip=H100), 0.00070, 5, "bytes"),
    ("B1 training", lambda: roofline.attention_fwd_roofline(
        4, 32, 4, 2048, 2048, 64, True, chip=H100), 0.0695, 4, "operations"),
    ("B1 D 128", lambda: roofline.attention_fwd_roofline(
        4, 8, 8, 16384, 16384, 128, True, chip=H100), 2.223, 3, "operations"),
    ("B3", lambda: roofline.attention_bwd_roofline(
        4, 32, 4, 2048, 2048, 64, True, chip=H100), 0.1737, 4, "operations"),
    ("B4", lambda: roofline.attention_bwd_roofline(
        4, 32, 4, 2048, 2048, 64, True, chip=H100, kernel="dq"), 0.1042, 4, "operations"),
    ("B5", lambda: roofline.attention_bwd_roofline(
        4, 32, 4, 2048, 2048, 64, True, chip=H100, kernel="dkv"), 0.1390, 4, "operations"),
    ("B6 bf16", lambda: roofline.decode_roofline(4, 32, 4, 64, L, chip=H100),
     0.00112, 5, "bytes"),
    ("B6 int8", lambda: roofline.decode_roofline(
        4, 32, 4, 64, L, cache_dtype=torch.int8, chip=H100), 0.00060, 5, "bytes"),
    ("B6 int8 T 256", lambda: roofline.decode_roofline(
        4, 32, 4, 64, L, t=256, cache_dtype=torch.int8, chip=H100), 0.00350, 5,
     "operations"),
    ("B6 fp8", lambda: roofline.decode_roofline(
        4, 32, 4, 64, L, cache_dtype=torch.float8_e4m3fn, chip=H100), 0.00060, 5, "bytes"),
    ("B8a M 4", lambda: roofline.quant_matmul_roofline(4, 2048, 5632, 8, chip=H100),
     0.00347, 5, "bytes"),
    ("B8b M 4", lambda: roofline.quant_matmul_roofline(4, 2048, 5632, 4, chip=H100),
     0.00175, 5, "bytes"),
    ("B8b M 256", lambda: roofline.quant_matmul_roofline(256, 2048, 5632, 4, chip=H100),
     0.00597, 5, "operations"),
]


@pytest.mark.parametrize("row", TABLE, ids=[r[0] for r in TABLE])
def test_h100_bounds_equal_the_kernel_table(row):
    _, report, want, decimals, by = row
    r = report()
    assert round(r.bound_ms, decimals) == want and r.bound_by == by
    assert r.sol_seconds == max(r.compute_seconds, r.memory_seconds)


def test_peaks_by_type_and_detect_chip_without_a_card():
    assert H100.peak_ops(torch.bfloat16) == 989e12
    assert H100.peak_ops(torch.int8) == H100.peak_ops(torch.float8_e4m3fn) == 1979e12
    with pytest.raises(ValueError, match="no peak"):
        H100.peak_ops(torch.int32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: detect_chip is tested on the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.detect_chip()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.attention_fwd_roofline(1, 1, 1, 64, 64, 64, True)
