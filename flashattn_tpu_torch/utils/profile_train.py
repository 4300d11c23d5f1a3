"""Where a LLAMA_1B training step's time goes on the card.

    python -m flashattn_tpu_torch.utils.profile_train

Builds LLAMA_1B at full width with random weights and tokens from a seed
and, for each backward path, the fused kernel and then the split pair
(selected through FLASHATTN_BWD_IMPL, as a user does), runs two warm-up
AdamW steps (train.train_step at B 4, S 2048, the shape of
benchmarks/train_bench.py, one repeated batch), then:

- times 3 steps on the host clock, each ended by a synchronise (ms/step,
  tokens/s), with the peak of torch.cuda.max_memory_allocated;
- profiles 3 more with torch.profiler (CPU and CUDA activity) and prints
  the device busy time per step (the kernels' self CUDA time), the card's
  idle share of the unprofiled step, the 15 kernels with the most
  device time and the port's attention kernels among the rest.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flashattn_tpu_torch.models import train
from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params
from flashattn_tpu_torch.ops import flash_bwd

SEED = 0
BATCH, SEQ = 4, 2048
STEPS = 3  # timed, then as many profiled
TOP = 15


def profile_step(model, tokens, impl: str) -> None:
    """Time and profile train steps with the backward path `impl`."""
    os.environ[flash_bwd.IMPL_ENV] = impl
    state = train.init_train_state(model, train.TrainConfig(warmup_steps=1))

    def step() -> None:
        nonlocal state
        state, metrics = train.train_step(state, tokens)
        float(metrics["loss"])  # the step's one host read, as train.train does

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = BATCH * SEQ
    print(f"[profile] LLAMA_1B B={BATCH} S={SEQ} AdamW step, {impl} backward: "
          f"{wall:.1f} ms/step median of {walls} (host clock, synchronised), "
          f"{n_tok / wall * 1e3:.0f} tokens/s, peak max_memory_allocated {peak:.2f} GiB")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them, and the device ranges of annotations such as
    # Optimizer.step, carry the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / STEPS
    print(f"[profile] {impl}: device busy {busy:.1f} ms/step (kernels' self CUDA time), "
          f"idle share {max(0.0, 1 - busy / wall):.3f} of the unprofiled step")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # The 15 largest rows, then the port's attention kernels below them.
    shown = events[:TOP] + [e for e in events[TOP:] if "flash_" in e.key]
    for e in shown:
        ms = e.self_device_time_total / 1e3 / STEPS
        print(f"[profile] {impl}: {ms:9.3f} ms/step {100 * ms / busy:5.1f} %  "
              f"{e.count // STEPS:5d} calls/step  {e.key[:110]}")
    del state


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(LLAMA_1B, gen, device="cuda")
    tokens = torch.randint(0, LLAMA_1B.vocab_size, (BATCH, SEQ + 1), generator=gen,
                           device="cuda")
    saved = os.environ.get(flash_bwd.IMPL_ENV)
    try:
        for impl in ("fused", "split"):
            profile_step(model, tokens, impl)
    finally:
        if saved is None:
            os.environ.pop(flash_bwd.IMPL_ENV, None)
        else:
            os.environ[flash_bwd.IMPL_ENV] = saved


if __name__ == "__main__":
    main()
