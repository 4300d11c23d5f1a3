"""Timing on the card with CUDA graphs and CUDA events, and the FLOP model
(counterpart of flashattn_tpu/utils/timing.py).

``cuda_time_ms`` times a kernel's calls on the card and raises without
one. ``measure``, ``measure_looped``, ``measure_looped_slope`` and
``measure_auto`` keep the JAX harness's signatures and return seconds per
call: the looped ones capture a chain of calls in one CUDA graph and time
its replay between CUDA events when the callable's output lies on the card
(the JAX harness chains the calls in an on-device scan), and read the host
clock for a callable on the CPU, as the JAX functions do there. ``measure``
reads the host clock around back-to-back calls and a synchronise. Every
capture here, and generate.DecodeGraph's, warms up with ``warm`` and
captures with ops/launches.py::capture, so the launch counters count each
replay's kernels.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from flashattn_tpu_torch.ops import launches


def cuda_time_ms(fn: Callable[[], object], warmup: int = 3, iters: int = 20,
                 reps: int = 5) -> float:
    """Device milliseconds per call of `fn`, without its host launch cost.

    `fn` runs `warmup` times eagerly, then `iters` back-to-back calls are
    captured into one CUDA graph; the graph is replayed `reps` times between
    two CUDA events and the median replay time over `iters` is returned.
    Timing eager calls instead would read the Python wrappers' host cost
    whenever it exceeds the kernels' own time. `fn` must not synchronise.
    The launch counters count each replay's calls (ops/launches.py)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    warm(fn, (), warmup)
    run = _chain(fn, (), iters, on_card=True)
    return statistics.median(run() for _ in range(reps)) * 1e3 / iters


def attention_flops(b: int, h: int, s_q: int, s_k: int, d: int,
                    causal: bool, mode: str = "fwd") -> float:
    """FLOPs of attention by the JAX package's convention: 4*B*H*S_q*S_k*D
    for the forward, halved when causal, times 2.5 for the backward ("bwd")
    or 3.5 for both ("fwd_bwd")."""
    f = 4.0 * b * h * s_q * s_k * d
    if causal:
        f /= 2
    return f * {"fwd": 1.0, "bwd": 2.5, "fwd_bwd": 3.5}[mode]


def _tensors(x):
    """The tensors in a (nested) output of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


def _sync(out) -> None:
    """Wait for the work that made `out` (a no-op for CPU outputs)."""
    if _on_card(out):
        torch.cuda.synchronize()


def warm(fn: Callable, args=(), n: int = 1):
    """`n` eager calls of fn(*args) (at least one), on a side stream where
    there is a card, as before a CUDA-graph capture: the kernels and the
    libraries' state load outside it. Returns the last output, finished."""
    if not torch.cuda.is_available():
        for _ in range(max(1, n)):
            out = fn(*args)
        return out
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(max(1, n)):
            out = fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return out


def _chain(fn: Callable, args, n: int, on_card: bool) -> Callable[[], float]:
    """A timer of `n` chained calls of fn: seconds for one run of the chain.
    On the card the n calls are captured once into a CUDA graph (the launch
    counters count each replay, ops/launches.py) and each run replays it
    between two CUDA events; on the CPU each run calls fn n times on the
    host clock."""
    if not on_card:
        def run_host() -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args)
            _sync(out)
            return time.perf_counter() - t0
        return run_host

    def calls():
        for _ in range(n):  # each output freed before the next call reuses its memory
            out = fn(*args)
        return out

    graph, _, counted = launches.capture(calls)
    graph.replay()  # the first replay uploads the graph
    launches.advance(counted)
    torch.cuda.synchronize()

    def run_card() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        launches.advance(counted)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return run_card


def measure(
    fn: Callable, *args, warmup: int = 3, n1: int = 5, n2: int = 20,
    repeat: int | None = None,
) -> float:
    """Steady-state seconds per call via two-point slope timing: n1 and n2
    back-to-back calls, each bracket ending in a synchronise, and
    (T2 - T1) / (n2 - n1), which cancels the bracket's fixed cost. The
    counts scale up until the long bracket holds about 0.5 s of calls; the
    median of three slopes is returned. On the card an eager call costs the
    larger of its host dispatch and its device time, so this reads the host
    cost of a host-bound callable (the looped functions read device time).
    `repeat` raises n2 when larger."""
    if repeat is not None:
        n2 = max(n2, repeat)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)

    def bracket(n: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        _sync(out)
        return time.perf_counter() - t0

    est = bracket(n1) / n1
    scale_n = max(1, int(0.5 / max(est * (n2 - n1), 1e-9)))
    n1, n2 = n1 * scale_n, n2 * scale_n
    for _ in range(2):
        slopes = sorted((bracket(n2) - bracket(n1)) / (n2 - n1) for _ in range(3))
        if slopes[1] > 0:
            return slopes[1]
    return max(slopes[1], 1e-9)


def measure_looped(
    fn: Callable, *args, iters: int = 200, warmup: int = 1, repeats: int = 1,
) -> float:
    """Seconds per call of `iters` chained calls, the best of `repeats`
    runs, after `warmup` eager calls. On the card the chain is one CUDA
    graph timed by events, so the reading is device time with one graph
    launch spread over the iterations; `fn` must then be capturable (no
    host read, no copy from pageable host memory)."""
    out = warm(fn, args, warmup)
    run = _chain(fn, args, iters, _on_card(out))
    return min(run() for _ in range(max(1, repeats))) / iters


def measure_looped_slope(
    fn: Callable, *args, est: float | None = None, repeats: int = 3,
) -> float:
    """Seconds per call from the slope between two chain lengths,
    (T2 - T1) / (n2 - n1), which cancels a chain's fixed cost (on the card
    its graph launch and events). Each length's best of `repeats` runs is
    taken (noise only adds time). (n1, n2) come from a crude estimate,
    `est` or measure()'s: (800, 2400) below 1 ms, (100, 300) below 8 ms,
    else (20, 60). A degenerate slope (T2 barely above T1) gets one more
    round of runs, then the long chain's own reading."""
    if est is None:
        est = measure(fn, *args, warmup=1, n1=2, n2=5)
    if est < 1e-3:
        n1, n2 = 800, 2400
    elif est < 8e-3:
        n1, n2 = 100, 300
    else:
        n1, n2 = 20, 60
    on_card = _on_card(warm(fn, args))
    run1, run2 = _chain(fn, args, n1, on_card), _chain(fn, args, n2, on_card)
    t1 = min(run1() for _ in range(repeats))
    t2 = min(run2() for _ in range(repeats))
    if t2 - t1 <= 0.05 * t1:
        t1 = min(t1, *(run1() for _ in range(repeats)))
        t2 = min(t2, *(run2() for _ in range(repeats)))
        if t2 - t1 <= 0.05 * t1:
            return t2 / n2
    return (t2 - t1) / (n2 - n1)


def measure_auto(
    fn: Callable, *args, warmup: int = 3, repeat: int | None = None,
    floor_s: float | None = None,
) -> float:
    """measure() for a crude estimate, then measure_looped_slope. floor_s
    is kept for the JAX signature and ignored, as there."""
    del floor_s
    est = measure(fn, *args, warmup=warmup, repeat=repeat)
    return measure_looped_slope(fn, *args, est=est)


def tflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e12
