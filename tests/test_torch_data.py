"""The port's packed-document pipeline (models/data.py) against the JAX
package's (flashattn_tpu/models/data.py): rows and batches equal bit for
bit on the same corpus and seed, the packing invariants, deterministic
resume, prefetch, and train.train consuming the packed batches (numpy, as
the pipeline yields them) with the boundary masking live in the loss.
tests/test_data.py's five tests, on the port."""

import dataclasses

import numpy as np
import pytest
import torch

from flashattn_tpu.models import data as jax_data
from flashattn_tpu_torch.models import data, llama, train
from flashattn_tpu_torch.models.config import TINY

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


def corpus(n=40, seed=0, vmax=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vmax, size=int(rng.integers(3, 60))).tolist() for _ in range(n)]


def test_pack_documents_invariants_and_jax_rows():
    docs = corpus()
    rows = list(data.pack_documents(docs, row_len=33, pad_id=0))
    jrows = list(jax_data.pack_documents(docs, row_len=33, pad_id=0))
    assert len(rows) == len(jrows)
    for (t, s), (jt, js) in zip(rows, jrows):
        assert t.dtype == s.dtype == np.int32
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(s, js)
    flat = []
    for t, s in rows:
        assert t.shape == (33,) and s.shape == (33,)
        live = s >= 0
        assert not np.any(np.diff(live.astype(int)) > 0)  # padding only at the end
        ids = s[live]
        assert np.sum(np.diff(ids) != 0) + 1 == len(np.unique(ids))  # one run an id
        flat.append(t[live])
    np.testing.assert_array_equal(np.concatenate(flat),
                                  np.concatenate([np.asarray(d) for d in docs]))


def test_long_document_splits():
    rows = list(data.pack_documents([list(range(100))], row_len=33))
    np.testing.assert_array_equal(np.concatenate([t[s >= 0] for t, s in rows]), np.arange(100))
    ids = np.concatenate([s[s >= 0] for _, s in rows])
    assert len(np.unique(ids)) >= 100 // 33  # chunks carry their own ids
    jrows = list(jax_data.pack_documents([list(range(100))], row_len=33))
    for (t, s), (jt, js) in zip(rows, jrows, strict=True):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(s, js)


def test_batches_deterministic_resume_and_equal_jax():
    ds = data.PackedDataset(corpus(), batch_size=2, seq_len=32, seed=7)
    jds = jax_data.PackedDataset(corpus(), batch_size=2, seq_len=32, seed=7)
    it, jit = ds.batches(), jds.batches()
    first = [next(it) for _ in range(8)]  # past an epoch's end
    for b in first:
        jb = next(jit)
        assert b["tokens"].shape == b["segment_ids"].shape == (2, 33)
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])
        np.testing.assert_array_equal(b["segment_ids"], jb["segment_ids"])
    resumed = next(ds.batches(start_step=3))
    np.testing.assert_array_equal(resumed["tokens"], first[3]["tokens"])
    np.testing.assert_array_equal(resumed["segment_ids"], first[3]["segment_ids"])
    other = next(data.PackedDataset(corpus(), 2, 32, seed=8).batches())
    assert not np.array_equal(other["tokens"], first[0]["tokens"])


def test_prefetch_transparent_and_reraises():
    ds = data.PackedDataset(corpus(), batch_size=2, seq_len=32, seed=7)
    plain = list(zip(range(3), ds.batches()))
    fetched = list(zip(range(3), data.prefetch(ds.batches(), size=2)))
    for (_, a), (_, b) in zip(plain, fetched):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["segment_ids"], b["segment_ids"])

    def broken():
        yield 1
        raise RuntimeError("producer failed")

    it = data.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_train_loop_consumes_packed_batches():
    cfg = dataclasses.replace(TINY, dtype=torch.float32)
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ds = data.PackedDataset(corpus(vmax=cfg.vocab_size - 1), batch_size=2, seq_len=64, seed=1)
    tc = train.TrainConfig(total_steps=4, warmup_steps=1)
    state, hist = train.train(model, data.prefetch(ds.batches()), tc, steps=2, log_every=1)
    assert state["step"] == 2 and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    # The packed loss differs from the same rows taken as one document: the
    # boundary masking is live.
    batch = next(ds.batches())
    with torch.no_grad():
        tokens = torch.from_numpy(batch["tokens"])
        l_seg = llama.loss_fn(model, tokens, segment_ids=batch["segment_ids"])
        l_dense = llama.loss_fn(model, tokens)
    assert not np.allclose(float(l_seg), float(l_dense))
