"""Head dims 32, 80 and 96 through the port's kernel entry points (their
plain versions on the CPU; on the card the kernels compiled for the 64 and
128 tiles take them at run time, csrc/common.cuh head_tile) against the
JAX package's, run as its own tests run it on the CPU (Pallas kernels in
interpret mode), on the same numpy inputs:

- the forward, O and LSE (flash_attention_forward), causal and not;
- the backward, split (the dQ and dK/dV kernels) and fused.

K2 and the paged K2 at these dims: tests/test_torch_head_dims_decode.py.
Tolerances: bf16 O atol 2e-2 and bf16 gradients rtol 2e-2, atol 5e-2
(ROADMAP's bf16 gates, verify_results); the LSE atol 1e-2. The operand
check takes every dim of HEAD_DIMS and still refuses others."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward as jax_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward as jax_forward
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.reference import reference_attention_with_lse
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

DIMS = (32, 80, 96)
O_TOL = dict(atol=2e-2)
GRAD_TOL = dict(rtol=2e-2, atol=5e-2)
BS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128, block_kv_dq=128,
                block_q_dkv=128, block_kv_dkv=128, block_q_fused=128, block_kv_fused=128)
B, HQ, HKV = 1, 4, 2
S_Q, S_K = 130, 200  # ragged, S_q < S_k: the causal mask aligns bottom-right


def bf16_pair(x: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    """One bf16 array for each package, from the same float32 values."""
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def qkv(d: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, HQ, S_Q, d), (B, HKV, S_K, d), (B, HKV, S_K, d), (B, HQ, S_Q, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", DIMS)
def test_forward_matches_jax(d, causal):
    q, k, v, _ = qkv(d, d)
    (jq, tq), (jk, tk), (jv, tv) = map(bf16_pair, (q, k, v))
    o_j, lse_j = jax_forward(jq, jk, jv, is_causal=causal, block_sizes=BS)
    o_t, lse_t = flash_fwd.flash_attention_forward(tq, tk, tv, is_causal=causal)
    assert o_t.shape == (B, HQ, S_Q, d) and o_t.dtype == torch.bfloat16
    rep = verify_results(np.asarray(o_j.astype(jnp.float32)), o_t.float(), **O_TOL)
    assert rep.passed, f"O: {rep}"
    rep = verify_results(np.asarray(lse_j), lse_t, atol=1e-2)
    assert rep.passed, f"LSE: {rep}"


@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("d", DIMS)
def test_backward_matches_jax(d, impl):
    q, k, v, do = qkv(d, 100 + d)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = map(bf16_pair, (q, k, v, do))
    o, lse = reference_attention_with_lse(tq, tk, tv, True)
    ref = jax_backward(jq, jk, jv, jnp.asarray(o.float().numpy(), dtype=jnp.bfloat16), jdo,
                       jnp.asarray(lse.numpy()), is_causal=True, block_sizes=BS, impl=impl)
    out = flash_bwd.flash_attention_backward(tq, tk, tv, o, tdo, lse, True, impl=impl)
    for name, r, g in zip(("dQ", "dK", "dV"), ref, out):
        assert g.shape == (tq if name == "dQ" else tk).shape
        rep = verify_results(np.asarray(r.astype(jnp.float32)), g.float(), **GRAD_TOL)
        assert rep.passed, f"{name}: {rep}"


def test_operand_checks_take_the_new_head_dims():
    """Every dim of HEAD_DIMS passes the kernels' operand check (the
    forward's and the backward's set are one), in the tile that holds it;
    40 and 48, inside the 64 tile but not JAX-tested dims, still raise."""
    assert flash_fwd.HEAD_DIMS == flash_bwd.HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    assert [flash_fwd.head_tile(d) for d in flash_fwd.HEAD_DIMS] == [64, 64, 128, 128, 128,
                                                                       256]
    for d in flash_fwd.HEAD_DIMS:
        x = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
        flash_fwd.check_kernel_operands(flash_bwd.HEAD_DIMS, q=x, k=x, v=x, o=x, do=x)
    for d in (40, 48):
        x = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_fwd.check_kernel_operands(q=x, k=x, v=x)
