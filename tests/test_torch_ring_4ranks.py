"""The port's context parallelism on 4 gloo ranks on the CPU against the
JAX package's under shard_map (tests/test_torch_ring.py has 2 ranks and
what the harness does): the ring's hop pruning by a window, dropout with
GQA and ALiBi, the zigzag with a window, ALiBi and segment ids (the
dyn_pos_offset path) and with dropout, Ulysses with fewer kv heads than
ranks and without the causal mask, and data x sp meshes of the ring and
the zigzag ring.

Tolerance: float32, O atol 1e-5 and rtol 1e-4, gradients atol 5e-5 and
rtol 1e-3 (partials merged in another order)."""

import torch

from _parallel_harness import check_attention

torch.set_num_threads(1)

# name: (mesh, mode, causal, Hq, Hkv, B, variant keywords, documents' lengths)
CASES = {
    "ring_window_prunes_hops": ({"sp": 4}, "ring", True, 4, 2, 1, dict(window=20), None),
    "ring_dropout_gqa_alibi": ({"sp": 4}, "ring", True, 4, 1, 1,
                               dict(dropout_rate=0.1, dropout_seed=5, alibi=True), None),
    "zigzag_window_alibi_segments": ({"sp": 4}, "zigzag", True, 4, 2, 1,
                                     dict(window=20, alibi=True), (21, 30)),
    "zigzag_dropout": ({"sp": 4}, "zigzag", True, 2, 2, 1,
                       dict(dropout_rate=0.2, dropout_seed=3), None),
    "ulysses_gqa_kv_smaller_than_axis": ({"sp": 4}, "ulysses", True, 4, 2, 1, {}, None),
    "ulysses_noncausal_alibi": ({"sp": 4}, "ulysses", False, 8, 4, 1,
                                dict(alibi=True), None),
    "data_sp_ring_alibi": ({"data": 2, "sp": 2}, "ring", True, 4, 2, 2,
                           dict(alibi=True), None),
    "data_sp_zigzag_window": ({"data": 2, "sp": 2}, "zigzag", True, 2, 1, 2,
                              dict(window=20), (30, 20)),
}


def test_sharded_attention_matches_jax(tmp_path):
    check_attention(4, CASES, tmp_path)
