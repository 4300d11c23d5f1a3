"""The contiguous ring's per-hop calls at 2 ranks (tests/test_torch_ring.py;
4 ranks: tests/test_torch_ring_4ranks_hops.py): the plain kernels that the
JAX side of that test puts in place of flash_attention_forward and
flash_attention_backward, against the JAX package's kernels in interpret
mode (tests/_hop_checks.py; float32, atol 1e-5, rtol 1e-4). Causal with
pos_offset = step * S/n (the diagonal hop too), non-causal, a window with
ALiBi, the soft-cap, segment ids with canonical padding, dropout with a
seed folded per (rank, hop) by the JAX package's _fold_seed."""

import pytest
import torch

from _hop_checks import check_hop, ids, k_ids, seed, slopes

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

# name: (Hq, Hkv, S_q, S_k, keywords of the kernel call, (seg_q, seg_k) or None)
HOPS = {
    # rank 1's hops (S/n 32)
    "diagonal_gqa": (4, 2, 32, 32, dict(is_causal=True, pos_offset=0), None),
    "earlier_shard_gqa": (4, 2, 32, 32, dict(is_causal=True, pos_offset=32), None),
    "noncausal_gqa": (4, 1, 32, 32, dict(is_causal=False), None),
    "window_alibi": (4, 2, 32, 32, dict(is_causal=True, pos_offset=32, window=20, alibi=True,
                                        alibi_slopes=slopes(4, 0, 4)), None),
    "softcap_segments": (2, 2, 32, 32, dict(is_causal=True, pos_offset=32, logit_softcap=5.0),
                         (ids([(1, 21)], 32), k_ids([(0, 23), (1, 9)], 32))),
    "dropout": (4, 2, 32, 32, dict(is_causal=True, pos_offset=32, dropout_rate=0.2,
                                   dropout_seed=seed(7, 1, 1)), None),
}


@pytest.mark.parametrize("name", sorted(HOPS))
def test_plain_ring_hop_matches_kernels(name):
    check_hop(HOPS[name], sorted(HOPS).index(name))
