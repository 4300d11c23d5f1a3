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
    (1, 16, 8, 4608, 4608, 256, True),  # GEMMA2_9B's prefill, head dim 256
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
    ("B8a a8 M 4", lambda: roofline.quant_matmul_roofline(4, 2048, 5632, 8, a8=True,
                                                          chip=H100), 0.00347, 5, "bytes"),
    ("B8a a8 M 256", lambda: roofline.quant_matmul_roofline(256, 2048, 5632, 8, a8=True,
                                                            chip=H100), 0.00462, 5, "bytes"),
    ("B8b a8 M 256", lambda: roofline.quant_matmul_roofline(256, 2048, 5632, 4, a8=True,
                                                            chip=H100), 0.00298, 5, "operations"),
    ("B8a a8 LLAMA_8B M 256", lambda: roofline.quant_matmul_roofline(
        256, 4096, 14336, 8, a8=True, chip=H100), 0.02036, 5, "bytes"),
    ("B8b a8 LLAMA_8B M 256", lambda: roofline.quant_matmul_roofline(
        256, 4096, 14336, 4, a8=True, chip=H100), 0.01519, 5, "operations"),
]


@pytest.mark.parametrize("row", TABLE, ids=[r[0] for r in TABLE])
def test_h100_bounds_equal_the_kernel_table(row):
    _, report, want, decimals, by = row
    r = report()
    assert round(r.bound_ms, decimals) == want and r.bound_by == by
    assert r.sol_seconds == max(r.compute_seconds, r.memory_seconds)


@pytest.mark.parametrize("m,bits", [(4, 8), (256, 8), (256, 4), (1024, 4)])
def test_a8_bound_counts_the_function_bytes_and_the_int8_peak(m, bits):
    """The a8 mode's bound: the function's own bytes, the weight-only ones
    (x read once as bf16; x_q and x_scale are the kernels' intermediates,
    not counted); 2 M K N operations at the int8 peak, 1,979 TOP/s."""
    k, n = 4096, 14336
    a8 = roofline.quant_matmul_roofline(m, k, n, bits, a8=True, chip=H100)
    plain = roofline.quant_matmul_roofline(m, k, n, bits, chip=H100)
    assert a8.hbm_bytes == plain.hbm_bytes == 2 * m * k + k * n * bits // 8 + 4 * n + 2 * m * n
    assert a8.flops == plain.flops == 2.0 * m * k * n
    assert a8.compute_seconds == a8.flops / 1979e12
    assert a8.memory_seconds == a8.hbm_bytes / 3350e9


@pytest.mark.parametrize("m,x_bytes", [(4, 2), (256, 2), (256, 4)])
def test_quantize_rows_bound_counts_its_bytes(m, x_bytes):
    """quantize_rows' bound: x read once, x_q int8 and x_scale f32 written
    once, bound by the bytes at LLAMA_1B's K."""
    r = roofline.quantize_rows_roofline(m, 2048, x_bytes, chip=H100)
    assert r.hbm_bytes == m * 2048 * (x_bytes + 1) + 4 * m
    assert r.flops == 3.0 * m * 2048 and r.bound_by == "bytes"
    assert r.memory_seconds == r.hbm_bytes / 3350e9


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


@pytest.mark.parametrize("n,t,window,sink", [
    (1, 1, 4096, 4), (77, 1, 16, 0), (300, 4, 16, 4), (300, 64, 100, 70), (5, 8, 3, 1),
    (8192, 256, 4096, 4), (50, 3, None, 0),
])
def test_windowed_bounds_count_the_visible_pairs(n, t, window, sink):
    """The windowed bounds count the (row, position) pairs the rows see and
    the positions some row sees, exactly as the visibility rule of
    ops/decode.py gives them; the forward's pairs likewise."""
    from flashattn_tpu_torch.ops import decode

    seen = decode.visible_positions(torch.tensor([n]), n, t, t, window, sink)[0]
    assert roofline.decode_visible(n, t, window, sink) == (int(seen.sum()),
                                                           int(seen.any(0).sum()))
    rep = roofline.decode_roofline(1, 4, 2, 64, [n], t=t, window=window, sink=sink, chip=H100)
    assert rep.flops == 4.0 * 4 * 64 * int(seen.sum())
    if window is not None and t <= 64:
        s_q, s_k = t, n
        r = torch.arange(s_q)[:, None] + (s_k - s_q)
        c = torch.arange(s_k)[None, :]
        pairs = int(((c <= r) & (c > r - window)).sum())
        assert roofline.window_pairs(s_q, s_k, window) == pairs
        fwd = roofline.attention_fwd_roofline(1, 2, 1, s_q, s_k, 64, True, window=window,
                                              chip=H100)
        assert fwd.flops == 4.0 * 2 * 64 * pairs


@pytest.mark.parametrize("causal,window,pos_offset", [
    (False, None, None), (True, None, None), (True, 7, None), (True, 5, 3), (True, 1, None),
])
def test_segment_bounds_count_the_visible_pairs(causal, window, pos_offset):
    """Under segment ids the forward's and the three backward kernels'
    operations scale with the (batch row, row, column) pairs a head sees,
    counted here by brute force over ragged documents and padding (q -1,
    k -2), S_q 37 against S_k 45; the bytes add the ids once."""
    import numpy as np

    rng = np.random.default_rng(0)
    b, s_q, s_k = 2, 37, 45
    seg_q = np.sort(rng.integers(-1, 4, (b, s_q)), axis=1).astype(np.int32)
    seg_k = np.sort(rng.integers(0, 4, (b, s_k)), axis=1).astype(np.int32)
    seg_k[:, -3:] = -2
    off = s_k - s_q if pos_offset is None else pos_offset
    pairs = sum(int(seg_q[i, r] == seg_k[i, c]
                    and (not causal or c <= r + off)
                    and (window is None or c >= r + off - window + 1))
                for i in range(b) for r in range(s_q) for c in range(s_k))
    segs = (torch.from_numpy(seg_q), torch.from_numpy(seg_k))
    assert roofline.segment_pairs(*segs, causal, window, pos_offset) == pairs
    kw = dict(chip=H100, window=window, pos_offset=pos_offset, segment_ids=segs)
    fwd = roofline.attention_fwd_roofline(b, 4, 2, s_q, s_k, 64, causal, **kw)
    plain = roofline.attention_fwd_roofline(b, 4, 2, s_q, s_k, 64, causal, chip=H100)
    assert fwd.flops == 4.0 * 4 * 64 * pairs
    assert fwd.hbm_bytes == plain.hbm_bytes + 4 * b * (s_q + s_k)
    for kernel, products in (("fused", 5), ("dq", 3), ("dkv", 4)):
        bwd = roofline.attention_bwd_roofline(b, 4, 2, s_q, s_k, 64, causal, kernel=kernel, **kw)
        assert bwd.flops == products / 2 * fwd.flops
        assert bwd.hbm_bytes == roofline.attention_bwd_roofline(
            b, 4, 2, s_q, s_k, 64, causal, kernel=kernel, chip=H100).hbm_bytes + 4 * b * (s_q + s_k)


def test_head_dim_256_decode_bound_counts_its_bytes():
    """K2 at GEMMA2_9B's decode step (B 2, Hq 16, Hkv 8, D 256, full
    8192-token bf16 caches): the live K and V once, q and O, the lengths;
    4 D operations a q head and seen position. A soft-cap adds no
    operation to the count (utils/roofline.py)."""
    rep = roofline.decode_roofline(2, 16, 8, 256, [8192, 8192], chip=H100)
    assert rep.hbm_bytes == 2 * 8 * 16384 * 256 * 2 + 2 * 2 * 16 * 256 * 2 + 4 * 2
    assert rep.flops == 4.0 * 16 * 256 * 16384
    assert rep.bound_by == "bytes"
    half = roofline.decode_roofline(2, 16, 8, 128, [8192, 8192], chip=H100)
    assert rep.hbm_bytes == pytest.approx(2 * half.hbm_bytes, rel=1e-3)


@pytest.mark.parametrize("kernel,local,global_", [
    ("fused", 0.7290, 0.8122), ("dq", 0.4374, 0.4873), ("dkv", 0.5832, 0.6497),
])
def test_gemma_packed_backward_bounds(kernel, local, global_):
    """B3, B4 and B5 at GEMMA2_9B's packed training row (B 1, Hq 16, Hkv 8,
    D 256, S 8192, documents of 6100, 1300, 517 and 211 tokens then
    padding): the local layer's (window 4096) bounds equal the MISTRAL_7B
    packed row's (Hq D is 16 x 256 = 32 x 128; PERF.md's kernel table), the
    global layer's count every causal pair within a document; the soft-cap
    adds nothing."""
    ids = torch.full((1, 8192), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate((6100, 1300, 517, 211)):
        ids[0, off:off + n] = i
        off += n
    segs = (ids, torch.where(ids < 0, -2, ids).to(torch.int32))
    kw = dict(chip=H100, kernel=kernel, segment_ids=segs)
    mistral = roofline.attention_bwd_roofline(1, 32, 8, 8192, 8192, 128, True, window=4096, **kw)
    gemma = roofline.attention_bwd_roofline(1, 16, 8, 8192, 8192, 256, True, window=4096, **kw)
    assert gemma.flops == mistral.flops and gemma.bound_by == "operations"
    assert round(gemma.bound_ms, 4) == local
    wide = roofline.attention_bwd_roofline(1, 16, 8, 8192, 8192, 256, True, **kw)
    pairs = sum(n * (n + 1) // 2 for n in (6100, 1300, 517, 211))
    assert wide.flops == {"fused": 5, "dq": 3, "dkv": 4}[kernel] / 2 * 4.0 * 16 * 256 * pairs
    assert round(wide.bound_ms, 4) == global_


@pytest.mark.parametrize("t,touched,by", [(2, 16, "bytes"), (2000, 128, "bytes"),
                                          (16384, 128, "operations")])
def test_moe_bound_counts_the_touched_experts(t, touched, by):
    """The MoE FFN's bound at Qwen3-30B-A3B's widths (H 2048, F 768, 128
    experts, top 8): a decode step's two tokens touch at most 16 experts,
    and their 9.44 MB each bound it by bytes; a 2,000-token prefill reads
    every expert once, 1.21 GB, and its 6 T k H F operations (0.15 ms)
    still take less than the bytes (0.36 ms): 125 rows an expert; from
    about 7,000 tokens the operations bound it."""
    h, f, e, k = 2048, 768, 128, 8
    rep = roofline.moe_roofline(t, h, f, e, k, touched, chip=H100)
    assert rep.hbm_bytes == 2 * (2 * t * h + h * e + touched * 3 * h * f)
    assert rep.flops == 2.0 * t * h * e + 6.0 * t * k * h * f
    assert rep.bound_by == by
    if by == "bytes":
        assert rep.bound_ms == pytest.approx(rep.hbm_bytes / 3.35e12 * 1e3)
    else:
        assert rep.bound_ms == pytest.approx(rep.flops / 989e12 * 1e3)


def test_moe_backward_bound_counts():
    """The MoE FFN's backward (moe_bwd_roofline) on a small case, T 4, H 8,
    F 16, 4 experts, top 2, 3 touched, bf16: operations twice the
    forward's, 2 x (2 T H E + 6 T k H F) = 12,800; bytes 2 x (3 T H for x,
    dY and dX + 2 H E for the router and its gradient + 2 x 3 x 3 H F for
    the touched experts' weights and gradients) = 4,928. At Qwen3-30B-A3B's
    widths and T 4,096 over all 128 experts the bytes bound it: 2.47 GB,
    0.7365 ms, against 0.6297 ms of operations."""
    rep = roofline.moe_bwd_roofline(4, 8, 16, 4, 2, 3, chip=H100)
    assert rep.flops == 12800 == 2 * roofline.moe_roofline(4, 8, 16, 4, 2, 3, chip=H100).flops
    assert rep.hbm_bytes == 4928
    big = roofline.moe_bwd_roofline(4096, 2048, 768, 128, 8, 128, chip=H100)
    assert big.hbm_bytes == 2 * (3 * 4096 * 2048 + 2 * 2048 * 128 + 2 * 128 * 3 * 2048 * 768)
    assert big.bound_by == "bytes"
    assert round(big.bound_ms, 4) == 0.7365
    assert round(big.flops / 989e12 * 1e3, 4) == 0.6297
