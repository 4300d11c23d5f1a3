"""The port imports no JAX: every module of flashattn_tpu_torch, and
chip_smoke.py, import and run on the CPU in a process where `import jax`
fails (generation, the server, two training steps, the quantized paged
server with a shared prefix and chunked admission, its calibrations, the
timing harness and the roofline). A CPU call takes the plain versions and
launches no kernel."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError

import flashattn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(flashattn_tpu_torch.__path__,
                                                "flashattn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the GPU smoke script imports no JAX either

import torch
from flashattn_tpu_torch.models import generate, llama, train
from flashattn_tpu_torch.models.config import TINY
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import (decode, flash_bwd, flash_bwd_fused, flash_fwd, paged,
                                     quant_matmul)

model = llama.init_params(TINY, torch.Generator().manual_seed(0), device="cpu")
generate.generate(model, torch.tensor([[1, 2, 3]]), max_new_tokens=3)
srv = InferenceServer(model, max_slots=2, max_len=128)
srv.submit(Request(uid=0, prompt=[4, 5], max_new_tokens=3))
assert len(srv.run()[0]) == 3
state, hist = train.train(model, iter([torch.randint(0, 512, (2, 17))] * 2),
                          train.TrainConfig(warmup_steps=1), steps=2, log_every=1)
assert state["step"] == 2 and len(hist) == 2
# The quantized, paged serving path: int8 weights, an int8 KV pool, a shared
# prefix and chunked admission.
llama.quantize_params(model, bits=8)
srv = InferenceServer(model, max_slots=2, max_len=256, quant="int8", paged=True,
                      page_size=64, admit_chunk=64, return_logprobs=True)
pid = srv.register_prefix(list(range(64)))
srv.submit(Request(uid=1, prompt=list(range(70)), max_new_tokens=3, prefix_id=pid))
srv.submit(Request(uid=2, prompt=[4, 5], max_new_tokens=3))
out = srv.run()
assert len(out[1]) == len(out[2]) == 3 and len(srv.finished_logprobs[1]) == 3
srv.unregister_prefix(pid)
assert srv.allocator.free_pages == srv.allocator.num_pages
# The server's calibrations, the timing harness and the roofline.
assert srv.calibrate_device_step(iters=2) > 0 and srv.stats()["device_step_ms"] > 0
assert srv.calibrate_admit(prompt_len=130, prefix_len=64, iters=1)["device_speedup"] > 0
from flashattn_tpu_torch.utils import roofline, timing
assert roofline.attention_fwd_roofline(1, 2, 2, 64, 64, 64, True,
                                       chip=roofline.H100_SXM).bound_ms > 0
assert timing.measure_looped(torch.matmul, torch.ones(4, 4), torch.ones(4, 4), iters=3) > 0
counts = (flash_fwd.LAUNCHES, decode.LAUNCHES, decode.INT8_LAUNCHES, decode.FP8_LAUNCHES,
          paged.LAUNCHES, quant_matmul.QMM8_LAUNCHES, quant_matmul.QMM4_LAUNCHES,
          flash_bwd.DQ_LAUNCHES, flash_bwd.DKV_LAUNCHES, flash_bwd_fused.LAUNCHES)
assert counts == (0,) * 10, f"CPU call counted a launch: {counts}"
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "flashattn_tpu" or m.startswith("flashattn_tpu.")]
assert loaded == ["jax"], loaded  # only the None placeholder
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
    assert int(proc.stdout.split()[1]) >= 20  # every module was imported
