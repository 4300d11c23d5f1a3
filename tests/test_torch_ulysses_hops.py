"""Ulysses's attention call (tests/test_torch_ring.py,
tests/test_torch_ring_4ranks.py): a rank's head slice over the whole
sequence, the plain functions that the JAX side of those tests puts in
place of flash_attention and flash_attention_varlen against the JAX
package's kernels in interpret mode, O and the gradients of sum(O * dO)
(tests/_hop_checks.py; float32, atol 1e-5, rtol 1e-4). Causal with GQA, a
window with ALiBi on a slice of the slope table, dropout with the rank's
folded seed (int32 wrap included), segment ids with padding."""

import pytest
import torch

from _hop_checks import check_attention, seed, slopes

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

# name: (Hq, Hkv, keywords, documents' (id, length) spans or None)
CASES = {
    "causal_gqa": (2, 1, dict(is_causal=True), None),
    "window_alibi_head_slice": (2, 1, dict(is_causal=True, window=20, alibi=True,
                                           alibi_slopes=slopes(4, 2, 2)), None),
    "dropout_wrapping_seed": (2, 1, dict(is_causal=False, dropout_rate=0.2,
                                         dropout_seed=seed(2**31 - 1, 1, 0)), None),
    "segments": (2, 2, dict(is_causal=True), [(0, 40), (1, 17)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_ulysses_attention_matches_kernels(name):
    check_attention(CASES[name], sorted(CASES).index(name))
