"""The port's autotune cache and the backward's "auto" choice
(ops/autotune.py, ops/flash_bwd.py::resolve_impl), on the CPU: the cache
file's round trip, keys that keep shapes, causality and dtypes apart, the
order in which resolve_impl takes the explicit impl, FLASHATTN_BWD_IMPL and
the measured winner, and autotune's refusal of CPU tensors. The timing
itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py phase 13).
"""

import json

import pytest
import torch

from flashattn_tpu_torch.ops import autotune, flash_bwd
from flashattn_tpu_torch.ops.flash_fwd import flash_attention_forward

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

SHAPE = (4, 32, 4, 2048, 2048, 64, True, torch.bfloat16)  # LLAMA_1B's training shape


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A cache file of the test's own, on a card named TestCard."""
    path = tmp_path / "cache" / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setattr(autotune, "device_kind", lambda: "TestCard")
    monkeypatch.delenv(flash_bwd.IMPL_ENV, raising=False)
    return path


def test_cache_round_trip(cache):
    assert autotune.load_cache() == {} and autotune.cached_bwd_impl(*SHAPE) is None
    key = autotune._key(*SHAPE)
    assert key == "TestCard|b4h32/4|sq2048sk2048d64|c1|bfloat16"
    entry = {"bwd_impl": "split", "fused_ms": 2.5, "split_ms": 2.0}
    autotune.save_entry(key, entry)
    assert json.loads(cache.read_text()) == {key: entry}
    assert autotune.load_cache() == {key: entry}
    assert autotune.cached_bwd_impl(*SHAPE) == "split"
    autotune.save_entry(key, dict(entry, bwd_impl="fused"))  # a new measurement replaces it
    assert autotune.cached_bwd_impl(*SHAPE) == "fused"
    autotune.load_cache()[key]["bwd_impl"] = "split"  # a caller's copy changes nothing
    assert autotune.cached_bwd_impl(*SHAPE) == "fused"


def test_default_cache_path(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert autotune.cache_path() == autotune.DEFAULT_CACHE
    assert autotune.DEFAULT_CACHE.parts[-2:] == ("flashattn_tpu_torch", "autotune.json")


@pytest.mark.parametrize("index, value", [
    (0, 8), (1, 16), (2, 8), (3, 4096), (4, 1024), (5, 128), (6, False), (7, torch.float32)])
def test_keys_separate_shapes_causality_and_dtypes(cache, index, value):
    """An entry answers for its own shape, causality, dtype and card alone."""
    autotune.save_entry(autotune._key(*SHAPE), {"bwd_impl": "split"})
    other = list(SHAPE)
    other[index] = value
    assert autotune._key(*other) != autotune._key(*SHAPE)
    assert autotune.cached_bwd_impl(*other) is None
    assert autotune.cached_bwd_impl(*SHAPE) == "split"


def test_keys_separate_cards(cache, monkeypatch):
    autotune.save_entry(autotune._key(*SHAPE), {"bwd_impl": "split"})
    monkeypatch.setattr(autotune, "device_kind", lambda: "OtherCard")
    assert autotune.cached_bwd_impl(*SHAPE) is None


def test_resolve_impl_precedence(cache, monkeypatch):
    """explicit impl > FLASHATTN_BWD_IMPL > the measured winner > fused."""
    assert flash_bwd.resolve_impl("auto", SHAPE) == "fused"  # no entry
    autotune.save_entry(autotune._key(*SHAPE), {"bwd_impl": "split"})
    assert flash_bwd.resolve_impl("auto", SHAPE) == "split"
    assert flash_bwd.resolve_impl("auto") == "fused"  # no shape: no lookup
    assert flash_bwd.resolve_impl("fused", SHAPE) == "fused"
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "fused")
    assert flash_bwd.resolve_impl("auto", SHAPE) == "fused"
    assert flash_bwd.resolve_impl("split", SHAPE) == "split"
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "auto")
    assert flash_bwd.resolve_impl("auto", SHAPE) == "split"
    autotune.save_entry(autotune._key(*SHAPE), {"bwd_impl": "fused"})
    monkeypatch.setenv(flash_bwd.IMPL_ENV, "split")
    assert flash_bwd.resolve_impl("auto", SHAPE) == "split"
    monkeypatch.delenv(flash_bwd.IMPL_ENV)
    assert flash_bwd.resolve_impl("auto", SHAPE) == "fused"


def test_cpu_backward_reads_no_cache(cache, monkeypatch):
    """CPU tensors take the plain backward: no lookup, so no card name."""
    def no_card():
        raise AssertionError("the CPU backward looked the card up")

    monkeypatch.setattr(autotune, "device_kind", no_card)
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(1, 4, 16, 32, generator=g), torch.randn(1, 2, 16, 32, generator=g)
    o, lse = flash_attention_forward(q, k, k, True)
    dq, dk, dv = flash_bwd.flash_attention_backward(q, k, k, o, q, lse, True)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_autotune_refuses_cpu_tensors(cache):
    q = torch.zeros(1, 4, 16, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    for kw in ({}, {"force": True}, {"tune_backward": False}):
        with pytest.raises(ValueError, match="on the card"):
            autotune.autotune(q, k, k, is_causal=True, **kw)
    assert not cache.exists()
