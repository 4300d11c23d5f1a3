"""Kernel timing on the card with CUDA events (counterpart of
flashattn_tpu/utils/timing.py).

A device time comes only from a run on the card: without one these
functions raise rather than time the CPU.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 20,
                 reps: int = 5) -> float:
    """Device milliseconds per call of `fn`, without its host launch cost.

    `fn` runs `warmup` times eagerly, then `iters` back-to-back calls are
    captured into one CUDA graph; the graph is replayed `reps` times between
    two CUDA events and the median replay time over `iters` is returned.
    Timing eager calls instead would read the Python wrappers' host cost
    whenever it exceeds the kernels' own time. `fn` must not synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # first replay uploads the graph
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attention_flops(b: int, h: int, s_q: int, s_k: int, d: int,
                    causal: bool, mode: str = "fwd") -> float:
    """FLOPs of attention by the JAX package's convention: 4*B*H*S_q*S_k*D
    for the forward, halved when causal, times 2.5 for the backward ("bwd")
    or 3.5 for both ("fwd_bwd")."""
    f = 4.0 * b * h * s_q * s_k * d
    if causal:
        f /= 2
    return f * {"fwd": 1.0, "bwd": 2.5, "fwd_bwd": 3.5}[mode]
