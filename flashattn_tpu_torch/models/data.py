"""Host-side packed-document data pipeline for training (counterpart of
flashattn_tpu/models/data.py, whose numpy code this module copies, so that
the port imports nothing of the JAX package; its rows equal that module's
bit for bit).

  - **Greedy sequence packing**: variable-length tokenized documents pack
    into fixed [B, S+1] rows with per-position segment ids, so the
    attention kernels mask across document boundaries (ops/varlen.py;
    llama.forward also restarts RoPE per document) and the loss ignores
    boundary and padding predictions (llama.loss_fn).
  - **Deterministic, resumable order**: epoch e is a seeded permutation of
    the corpus; the iterator's position is a single integer `step`, so
    checkpoint resume is `batches(start_step=state["step"])`: no iterator
    state to serialize.
  - **Host/device overlap**: `prefetch()` runs the packer in a background
    thread so batch assembly hides behind the device step.

Batches are numpy arrays; train.train moves them to the model's device.
Documents longer than the row are split into row-sized chunks (each chunk
gets its own segment id, the standard packing convention).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np

PAD_SEGMENT = -1  # loss masks ids < 0; attention never matches -1 vs -2 pads


def pack_documents(
    docs: Iterable[Sequence[int]],
    row_len: int,
    pad_id: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Greedily pack documents into (tokens [row_len], segment_ids [row_len])
    rows in arrival order. Long documents split into row-sized chunks; a doc
    (or chunk) that does not fit the current row starts the next one."""
    tokens = np.full((row_len,), pad_id, np.int32)
    segs = np.full((row_len,), PAD_SEGMENT, np.int32)
    fill = 0
    seg_id = 0
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        for start in range(0, len(doc), row_len):
            chunk = doc[start:start + row_len]
            if fill + len(chunk) > row_len:
                yield tokens, segs
                tokens = np.full((row_len,), pad_id, np.int32)
                segs = np.full((row_len,), PAD_SEGMENT, np.int32)
                fill = 0
            tokens[fill:fill + len(chunk)] = chunk
            segs[fill:fill + len(chunk)] = seg_id % (2**30)
            fill += len(chunk)
            seg_id += 1
    if fill:
        yield tokens, segs


class PackedDataset:
    """Deterministic, resumable packed-batch stream over a token corpus.

    Args:
      docs: list of tokenized documents (sequences of ints).
      batch_size / seq_len: batch shape; rows are seq_len + 1 tokens so the
        next-token loss sees seq_len predictions (llama.loss_fn convention).
      seed: epoch shuffling seed. The stream is an infinite, pure function
        of (docs, seed): batch `i` is always the same array, so resuming
        from a checkpoint is just `batches(start_step=restored_step)`.
    """

    def __init__(self, docs: Sequence[Sequence[int]], batch_size: int,
                 seq_len: int, seed: int = 0, pad_id: int = 0):
        assert len(docs) > 0, "empty corpus"
        self.docs = [np.asarray(d, np.int32) for d in docs]
        self.batch_size = batch_size
        self.row_len = seq_len + 1
        self.seed = seed
        self.pad_id = pad_id

    def _epoch_rows(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(
                len(self.docs))
        return pack_documents((self.docs[i] for i in order), self.row_len,
                              self.pad_id)

    def _rows_forever(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        epoch = 0
        while True:
            yield from self._epoch_rows(epoch)
            epoch += 1

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        """Infinite stream of {"tokens": [B, S+1], "segment_ids": [B, S+1]}
        int32 numpy batches, starting at batch index `start_step`."""
        rows = self._rows_forever()
        for _ in range(start_step * self.batch_size):
            next(rows)
        while True:
            got = [next(rows) for _ in range(self.batch_size)]
            yield {
                "tokens": np.stack([t for t, _ in got]),
                "segment_ids": np.stack([s for _, s in got]),
            }


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Run `it` in a daemon thread, keeping up to `size` items ready, so
    host-side batch assembly overlaps the device step.

    Producer exceptions re-raise in the consumer. When the consumer stops
    early (training streams are infinite), the worker notices via the stop
    event and exits instead of blocking on a full queue forever."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put((None, item), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put((None, _END))
        except BaseException as e:  # re-raised in the consumer, not lost
            q.put((e, None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            exc, item = q.get()
            if exc is not None:
                raise exc
            if item is _END:
                return
            yield item
    finally:
        stop.set()
