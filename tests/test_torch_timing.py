"""The port's timing harness (utils/timing.py) on CPU callables, where it
reads the host clock as the JAX harness does on the CPU: every function
returns positive seconds per call, in the range of a call's own cost, and
tflops equals the JAX one."""

import time

import pytest
import torch

from flashattn_tpu.utils import timing as jax_timing
from flashattn_tpu_torch.ops import launches
from flashattn_tpu_torch.utils import timing

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

NAP = 2e-3  # seconds a call of `slow` sleeps


def slow(x):
    time.sleep(NAP)
    return x + 1


def cheap(x, w):
    return torch.matmul(x, w)


X = torch.ones((8, 8))
W = torch.ones((8, 8))


def test_measure_reads_a_calls_cost():
    t = timing.measure(slow, X, warmup=1, n1=2, n2=5)
    assert NAP * 0.9 < t < NAP * 5


def test_measure_looped_reads_a_calls_cost():
    t = timing.measure_looped(slow, X, iters=20, warmup=1, repeats=2)
    assert NAP * 0.9 < t < NAP * 5
    assert timing.measure_looped(cheap, X, W, iters=50) > 0


def test_measure_looped_slope_and_auto():
    t = timing.measure_looped_slope(slow, X, est=NAP * 10, repeats=1)  # chains of 20 and 60
    assert NAP * 0.5 < t < NAP * 5
    assert timing.measure_looped_slope(cheap, X, W, repeats=1) > 0  # chains of 800 and 2400
    assert timing.measure_auto(cheap, X, W, warmup=1) > 0


def test_cpu_timing_counts_no_launch():
    before = launches.read()
    timing.measure_looped(cheap, X, W, iters=10)
    assert launches.read() == before


@pytest.mark.parametrize("flops,seconds", [(1e12, 1.0), (3.5e9, 2.5e-4), (0.0, 1.0)])
def test_tflops_equals_jax(flops, seconds):
    assert timing.tflops(flops, seconds) == jax_timing.tflops(flops, seconds)


def test_attention_flops_equal_jax():
    for mode in ("fwd", "bwd", "fwd_bwd"):
        for causal in (True, False):
            assert timing.attention_flops(2, 8, 512, 1024, 64, causal, mode) == \
                jax_timing.attention_flops(2, 8, 512, 1024, 64, mode, causal)
