"""Where a LLAMA_1B server's decode step spends its time on the card, eager
and captured in a CUDA graph, in one process.

    python -m flashattn_tpu_torch.utils.profile_serve

Builds LLAMA_1B at full width with random weights from a seed and runs two
servers with 4 slots and max_len 2048: bf16 weights and cache, and the
quantized configuration of chip_smoke.py phase 6 (a) (int8 weights through
qmm8, an int8 KV cache, dense caches). Each admits 4 requests of 100-token
prompts, then, once every slot decodes, runs STEPS steps of each of:

- ``eager``: generate.decode_step with every row inactive on the server's
  own model and caches, then the step's token read (argmax and .tolist());
- ``replay``: the server's captured step (generate.DecodeGraph) on the same
  inactive rows, then the same token read;
- ``server``: InferenceServer.step() with every slot decoding (the replay,
  the token read and the server's bookkeeping).

For each it prints the ms/step on the host clock (median of STEPS) and,
from one torch.profiler session a server (CPU and CUDA activity), the
device busy time per step (the kernels' self CUDA time, attributed to the
three runs by their profiler ranges) and the card's idle share; then
calibrate_device_step's reading on the same server and the kernels with
the most device time in the server's steps.

Then it times qmm8 alone at the decode batch (M 4, K 2048, N 5632): its
wrapper's host time per eager call (1,000 calls enqueued back to back, no
synchronise between them) against its device time (CUDA graph). Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import copy
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from flashattn_tpu_torch.models import generate
from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params, quantize_params
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import quant_matmul
from flashattn_tpu_torch.utils.timing import cuda_time_ms

SEED = 0
SLOTS, PROMPT = 4, 100
STEPS = 10  # a run's steps, timed on the host clock and profiled
TOP = 8
EAGER_CALLS = 1000


def profile_server(name: str, model, **options) -> None:
    srv = InferenceServer(model, max_slots=SLOTS, max_len=2048, **options)
    gen = torch.Generator().manual_seed(SEED)
    for uid in range(SLOTS):
        prompt = torch.randint(0, LLAMA_1B.vocab_size, (PROMPT,), generator=gen).tolist()
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8 * STEPS))
    while srv.queue or any(slot.free for slot in srv.slots):
        srv.step()  # admissions
    graph = srv.decode_graph()
    positions = torch.tensor([slot.position for slot in srv.slots],
                             dtype=torch.int32).pin_memory()
    idle = torch.zeros((SLOTS,), dtype=torch.bool).pin_memory()
    positions_dev, idle_dev = positions.cuda(), idle.cuda()
    steps = {
        "eager": lambda: generate.decode_step(model, srv.tokens, positions_dev, srv.caches,
                                              active=idle_dev)[0].argmax(-1).tolist(),
        "replay": lambda: graph(srv.tokens, positions, idle).argmax(-1).tolist(),
        "server": srv.step,
    }
    walls = {}
    for run, step in steps.items():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        walls[run] = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()
            walls[run].append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for run, step in steps.items():
            with record_function(f"profile_serve.{run}"):
                for _ in range(STEPS):
                    step()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name.split(".")[1]: e.time_range for e in events
              if e.name.startswith("profile_serve.")}
    busy = collections.defaultdict(float)
    by_kernel = collections.Counter()
    calls = collections.Counter()
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for run, r in ranges.items():
            if r.start <= e.time_range.start <= r.end:
                us = e.time_range.end - e.time_range.start
                busy[run] += us / 1e3 / STEPS
                if run == "server":
                    by_kernel[e.name] += us / 1e3 / STEPS
                    calls[e.name] += 1
    for run in steps:
        wall = statistics.median(walls[run])
        dev = (f"device busy {busy[run]:.3f} ms/step, idle share "
               f"{max(0.0, 1 - busy[run] / wall):.3f}" if busy[run] else
               "device busy not measured (the profiler recorded no device event)")
        print(f"[profile] LLAMA_1B {name}, {SLOTS} slots, {run}: {wall:.3f} ms/step median of "
              f"{[round(w, 3) for w in walls[run]]} (host clock), {dev}")
    calib = srv.calibrate_device_step(iters=STEPS) * 1e3
    print(f"[profile] LLAMA_1B {name}: calibrate_device_step({STEPS} steps in one CUDA graph, "
          f"every slot inactive): {calib:.3f} ms/step")
    for kernel, ms in by_kernel.most_common(TOP):
        print(f"[profile]   server step: {ms:8.3f} ms/step "
              f"{100 * ms / max(busy['server'], 1e-9):5.1f} %  "
              f"{calls[kernel] // STEPS:5d} calls/step  {kernel[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    model = init_params(LLAMA_1B, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    profile_server("bf16 weights, bf16 KV", model)
    w8 = quantize_params(copy.deepcopy(model), 8)
    del model
    profile_server("int8 weights, int8 KV", w8, quant="int8")

    k, n = 2048, 5632
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qw = quant_matmul.quantize_weights(
        torch.randn((k, n), generator=gen, device="cuda") * 0.02, 8)
    x = torch.randn((SLOTS, k), generator=gen, device="cuda", dtype=torch.bfloat16)
    for _ in range(10):
        quant_matmul.quant_matmul(x, qw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EAGER_CALLS):
        quant_matmul.quant_matmul(x, qw)
    host_us = (time.perf_counter() - t0) / EAGER_CALLS * 1e6
    torch.cuda.synchronize()
    device_us = cuda_time_ms(lambda: quant_matmul.quant_matmul(x, qw)) * 1e3
    print(f"[profile] qmm8 M={SLOTS} K={k} N={n}: {host_us:.1f} us a call on the host "
          f"({EAGER_CALLS} eager calls enqueued), {device_us:.1f} us on the device")


if __name__ == "__main__":
    main()
