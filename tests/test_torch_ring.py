"""The port's context parallelism (parallel/ring.py, ulysses.py, mesh.py) on
2 gloo ranks on the CPU against the JAX package's, on the same numpy
inputs: sharded_ring_attention in the ring, zigzag and Ulysses modes, its
output and the gradients of sum(O * dO) in q, k and v, against the JAX
function under shard_map on the virtual CPU devices of tests/conftest.py; 4 ranks in
tests/test_torch_ring_4ranks.py.
Causal and not, GQA (Ulysses with fewer kv heads than ranks too), a window
(the ring's hop pruning at 4 ranks), ALiBi, both (the zigzag's
dyn_pos_offset path), the soft-cap (with the window too: the zigzag's
offset with Gemma-2's local-layer options), segment ids with padding, dropout (the
seeds folded per rank, hop and sub-call: the masks are the JAX package's
bit for bit).

The ranks are one spawn (tests/_torch_parallel_worker.py, gloo through a
file under tmp_path) running every case; the port's ranks run the kernels'
plain versions. The JAX side runs its rings with plain
jnp per-hop kernels (tests/_jax_plain_attention.py: the Pallas kernels in
interpret mode take 15-110 s a ring case there), which
tests/test_torch_*_hops.py hold against those kernels on these cases'
calls; every rank's result is the same global view.

Tolerance: float32, O atol 1e-5 and rtol 1e-4, gradients atol 5e-5 and
rtol 1e-3 (partials merged in another order; the JAX package's own ring
tests' gates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_harness import check_attention

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

# name: (mesh, mode, causal, Hq, Hkv, B, variant keywords, documents' lengths)
CASES = {
    "ring_causal": ({"sp": 2}, "ring", True, 4, 2, 1, {}, None),
    "ring_noncausal_gqa": ({"sp": 2}, "ring", False, 4, 1, 1, {}, None),
    "ring_window_alibi": ({"sp": 2}, "ring", True, 4, 2, 1, dict(window=20, alibi=True),
                          None),
    "ring_softcap_segments": ({"sp": 2}, "ring", True, 2, 2, 1,
                              dict(logit_softcap=5.0), (23, 30)),
    "ring_dropout": ({"sp": 2}, "ring", True, 4, 2, 1,
                     dict(dropout_rate=0.2, dropout_seed=7), None),
    "zigzag_causal": ({"sp": 2}, "zigzag", True, 4, 2, 1, {}, None),
    "zigzag_window_alibi": ({"sp": 2}, "zigzag", True, 4, 2, 1,
                            dict(window=24, alibi=True), None),
    "zigzag_window_segments": ({"sp": 2}, "zigzag", True, 2, 1, 1, dict(window=24),
                               (19, 27, 10)),
    "zigzag_dropout_window": ({"sp": 2}, "zigzag", True, 2, 2, 1,
                              dict(dropout_rate=0.3, dropout_seed=-11, window=30), None),
    "zigzag_softcap": ({"sp": 2}, "zigzag", True, 4, 4, 1, dict(logit_softcap=5.0), None),
    # Gemma-2's local layer: the window's left edge and the soft-cap on the
    # (hi, lo) pair's offset read on the card
    "zigzag_window_softcap": ({"sp": 2}, "zigzag", True, 4, 2, 1,
                              dict(window=24, logit_softcap=5.0), None),
    "ulysses_causal_gqa": ({"sp": 2}, "ulysses", True, 4, 2, 1, {}, None),
    "ulysses_window_alibi": ({"sp": 2}, "ulysses", True, 4, 2, 1,
                             dict(window=20, alibi=True), None),
    "ulysses_dropout": ({"sp": 2}, "ulysses", False, 4, 2, 1,
                        dict(dropout_rate=0.2, dropout_seed=2**31 - 1), None),
    "ulysses_segments": ({"sp": 2}, "ulysses", True, 2, 2, 1, {}, (40, 17)),
}


def test_sharded_attention_matches_jax(tmp_path):
    check_attention(2, CASES, tmp_path)


def test_fold_seed_wraps_as_jax_does():
    """The per-(rank, hop, sub-call) seed folds in int32 as the JAX
    function's arithmetic wraps, at the seeds' extremes."""
    from flashattn_tpu.parallel.ring import _fold_seed as jax_fold
    from flashattn_tpu_torch.parallel.ring import _fold_seed

    for seed in (0, 7, -11, 2**31 - 1, -2**31):
        for idx, step, subid in ((0, 0, 0), (3, 2, 1), (1, 3, 2)):
            want = np.asarray(jax_fold(jnp.int32(seed), jnp.int32(idx), step)
                              + jnp.int32(subid) * jnp.int32(424243))
            got = _fold_seed(torch.tensor(seed, dtype=torch.int32), idx, step, subid)
            assert got.dtype == torch.int32 and int(got) == int(want), (seed, idx, step, subid)


def test_zigzag_permutation_matches_jax():
    from flashattn_tpu.parallel.ring import zigzag_permutation as jax_perm
    from flashattn_tpu_torch.parallel.ring import zigzag_permutation, zigzag_shard, zigzag_unshard

    for s, n in ((16, 2), (64, 4), (48, 3)):
        assert np.array_equal(zigzag_permutation(s, n), jax_perm(s, n))
        assert np.array_equal(zigzag_permutation(s, n, True), jax_perm(s, n, inverse=True))
    x = torch.arange(2 * 64).reshape(1, 2, 64)
    assert torch.equal(zigzag_unshard(zigzag_shard(x, 4), 4), x)
    with pytest.raises(ValueError, match="multiple"):
        zigzag_permutation(30, 4)
