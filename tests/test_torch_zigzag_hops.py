"""The zigzag ring's per-pair calls at 2 ranks (tests/test_torch_ring.py;
4 ranks: tests/test_torch_ring_4ranks_hops.py): the plain kernels that the
JAX side of that test puts in place of flash_attention_forward and
flash_attention_backward, against the JAX package's kernels in interpret
mode (tests/_hop_checks.py; float32, atol 1e-5, rtol 1e-4). The (q_hi, k_lo)
pair with dyn_pos_offset = ((2n - 1) - idx - src) * C (window, ALiBi with a
head slice, segment ids, dropout with the sub-call's seed, the soft-cap
with the window) and without it (soft-cap), and the causal (q_lo, k_lo) and (q_hi, k_hi) pairs at their
static offsets."""

import jax.numpy as jnp
import pytest
import torch

from _hop_checks import check_hop, ids, k_ids, seed, slopes

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

# name: (Hq, Hkv, S_q, S_k, keywords of the kernel call, (seg_q, seg_k) or None)
PAIRS = {
    # C 16; rank 0's first hop: offset (3 - 0 - 0) * 16 puts every key left
    # of the window (O 0, LSE -inf)
    "hi_lo_dyn_window_alibi": (4, 2, 16, 16, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(48), window=24, alibi=True), None),
    "hi_lo_dyn_alibi_slice": (4, 2, 16, 16, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(32), window=24, alibi=True,
        alibi_slopes=slopes(8, 4, 4)), None),
    "hi_lo_dyn_window_segments": (2, 1, 16, 16, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(32), window=24),
        (ids([(2, 10)], 16), k_ids([(0, 16)], 16))),
    # rank 1's first hop: offset (3 - 1 - 1) * 16
    "hi_lo_dyn_dropout_window": (2, 2, 16, 16, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(16), window=30, dropout_rate=0.3,
        dropout_seed=seed(-11, 1, 0, 0)), None),
    "lo_lo_dropout_window": (2, 2, 16, 16, dict(
        is_causal=True, pos_offset=16, window=30, dropout_rate=0.3,
        dropout_seed=seed(-11, 1, 1, 1)), None),
    "hi_hi_dropout_window": (2, 2, 16, 16, dict(
        is_causal=True, pos_offset=16, window=30, dropout_rate=0.3,
        dropout_seed=seed(-11, 0, 1, 2)), None),
    # rank 0's second hop: offset (3 - 0 - 1) * 16, the window's edge cuts the pair
    "hi_lo_dyn_window_softcap": (4, 2, 16, 16, dict(
        is_causal=False, dyn_pos_offset=jnp.int32(32), window=24, logit_softcap=5.0), None),
    "hi_lo_softcap": (4, 4, 16, 16, dict(is_causal=False, logit_softcap=5.0), None),
    "diagonal_softcap": (4, 4, 16, 16, dict(is_causal=True, logit_softcap=5.0), None),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plain_zigzag_pair_matches_kernels(name):
    check_hop(PAIRS[name], sorted(PAIRS).index(name))
