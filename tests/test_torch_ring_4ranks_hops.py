"""The rings' per-hop calls at 4 ranks (tests/test_torch_ring_4ranks.py):
the plain kernels that the JAX side of that test puts in place of
flash_attention_forward and flash_attention_backward, against the JAX
package's kernels in interpret mode (tests/_hop_checks.py; float32, atol
1e-5, rtol 1e-4). The contiguous ring's hop that its window prunes in
part, with ALiBi; a dropout hop whose folded seed wraps in int32; the
zigzag's (q_hi, k_lo) pair with dyn_pos_offset, a window and ALiBi."""

import jax.numpy as jnp
import pytest
import torch

from _hop_checks import check_hop, seed

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

# name: (Hq, Hkv, S_q, S_k, keywords of the kernel call, (seg_q, seg_k) or None)
HOPS = {
    # the ring (S/n 16): rank 3's hop from rank 1, window 20 reaching 13 of 16 keys
    "ring_window_alibi": (4, 2, 16, 16, dict(is_causal=True, pos_offset=32, window=20,
                                             alibi=True), None),
    "ring_dropout_wrapping_seed": (4, 2, 16, 16, dict(
        is_causal=True, pos_offset=16, dropout_rate=0.2, dropout_seed=seed(2**31 - 1, 3, 1)),
        None),
    # the zigzag ring (C 8): rank 2's (q_hi, k_lo) from rank 1, offset (7 - 2 - 1) * 8
    "zigzag_hi_lo_dyn_window_alibi": (4, 2, 8, 8, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(32), window=20, alibi=True), None),
}


@pytest.mark.parametrize("name", sorted(HOPS))
def test_plain_hop_matches_kernels(name):
    check_hop(HOPS[name], sorted(HOPS).index(name))
