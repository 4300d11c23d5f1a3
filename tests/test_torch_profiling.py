"""The port's torch.profiler helper (utils/profiling.py), mirroring
tests/test_profiling.py::test_profile_fn_writes_trace on the CPU (the plain
flash forward)."""

import glob
import json
import os

import numpy as np
import torch

from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.utils.profiling import profile_fn, trace

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


def test_profile_fn_writes_trace(tmp_path):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 256, 64), dtype=np.float32))
               for _ in range(3))
    log_dir = profile_fn(lambda q, k, v: flash_attention(q, k, v, is_causal=True),
                         q, k, v, log_dir=str(tmp_path / "trace"))
    assert log_dir == str(tmp_path / "trace")
    traces = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_yields_the_profiler(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(4).sum()
    assert any(e.key == "aten::sum" for e in prof.key_averages())
    assert glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
