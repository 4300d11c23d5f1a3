"""Tracing helpers around torch.profiler (counterpart of
flashattn_tpu/utils/profiling.py, which wraps jax.profiler).

A trace is a Chrome trace (``*.pt.trace.json``), opened in Perfetto or
chrome://tracing. On the card it holds the kernels' device spans beside the
host's; a second profiler session in one process has been seen to record no
device event, so a check that needs them profiles in a process of its own.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from flashattn_tpu_torch.utils.timing import _sync


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block; its Chrome trace is written under `log_dir` when the
    block ends. CPU activity always, CUDA activity where there is a card.
    Yields the profiler (``key_averages()`` for sums by kernel).

    >>> with trace("traces/k1"):
    ...     flash_attention(q, k, v); torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def profile_fn(fn, *args, log_dir: str, iters: int = 3) -> str:
    """Call fn once to warm up, then `iters` times under the profiler;
    returns `log_dir`, which then holds the trace. There is no default
    directory (the JAX function's is under /tmp): the caller names it."""
    _sync(fn(*args))
    with trace(log_dir):
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
    produced = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if not produced:
        raise RuntimeError(f"no trace written under {log_dir}")
    return log_dir
