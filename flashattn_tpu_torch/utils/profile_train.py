"""Where a LLAMA_1B training step's time goes on the card.

    python -m flashattn_tpu_torch.utils.profile_train [--part adamw|remat|all]

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

Then (the remat part) one arm for each rematerialisation policy (remat
False, True, "dots", "attn") and each backward path (fused, split), each
through llama.sgd_train_step at the same shape (``remat_arm``): ms/step
(median of 3 after 2 warm-up steps), tokens/s, peak memory, the bytes the
layers' forward holds for the backward, per layer, and K1's launches a
step. This is the port's counterpart of benchmarks/train_bench.py's
--remat and --bwd-impl.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flashattn_tpu_torch.models import llama, train
from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params
from flashattn_tpu_torch.ops import flash_bwd, launches

SEED = 0
BATCH, SEQ = 4, 2048
STEPS = 3  # timed, then as many profiled
TOP = 15


def device_events(step, steps: int) -> list:
    """The device-side rows of torch.profiler's key_averages over `steps`
    calls of step(): kernels, copies and memsets. The CPU ops that launched
    them, and the device ranges of annotations such as Optimizer.step,
    carry the same time again and are left out."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]


def profile_step(model, tokens, impl: str) -> None:
    """Time and profile train steps with the backward path `impl` (the
    caller sets FLASHATTN_BWD_IMPL)."""
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

    events = device_events(step, STEPS)
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


@contextlib.contextmanager
def backward_impl(impl: str):
    """FLASHATTN_BWD_IMPL set to `impl` inside, as it was outside."""
    saved = os.environ.get(flash_bwd.IMPL_ENV)
    os.environ[flash_bwd.IMPL_ENV] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(flash_bwd.IMPL_ENV, None)
        else:
            os.environ[flash_bwd.IMPL_ENV] = saved


def layer_bytes(model, tokens, remat, segment_ids=None) -> float:
    """Bytes the layers' forward holds for the backward, per layer: device
    memory allocated after llama.layers_forward (its output, the embedded
    input and what each layer saved) less that before the embedding, over
    the layer count."""
    cfg = model.cfg
    inputs = tokens[:, :-1]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    x = llama.embed_tokens(model, inputs)
    seg = None if segment_ids is None else segment_ids[:, :-1]
    cos, sin = llama.input_tables(cfg, inputs, seg)
    x = llama.layers_forward(model, x, cos, sin, seg, remat)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before - cos.nbytes - sin.nbytes
    del x
    return held / cfg.num_layers


def remat_arm(model, tokens, remat, impl: str, lr: float = 1e-3, warmup: int = 2,
              steps: int = 3) -> dict:
    """`warmup` then `steps` llama.sgd_train_step calls with `remat` and the
    backward path `impl`: ms/step (median, host clock around each
    synchronised step), tokens/s, peak GiB over the timed steps, the bytes
    held after the layers' forward per layer (layer_bytes), the kernel
    launches of the last timed step (ops/launches.py's counters), then the
    device busy ms of one more step under torch.profiler (device_events)
    and the idle share it leaves of the median step."""
    with backward_impl(impl):
        for _ in range(warmup):
            llama.sgd_train_step(model, tokens, lr, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(steps):
            launches.reset()
            t0 = time.perf_counter()
            loss, _ = llama.sgd_train_step(model, tokens, lr, remat=remat)
            float(loss)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        step_launches = {k: n for k, n in launches.read().items() if n}
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_layer = layer_bytes(model, tokens, remat)
        events = device_events(lambda: llama.sgd_train_step(model, tokens, lr, remat=remat), 1)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    wall = statistics.median(walls)
    n_tok = tokens.shape[0] * (tokens.shape[1] - 1)
    return {"remat": remat, "impl": impl, "ms": wall, "walls": walls,
            "tokens_per_s": n_tok / wall * 1e3, "peak_gib": peak,
            "layer_mb": per_layer / 1e6, "launches": step_launches, "loss": float(loss),
            "busy_ms": busy, "idle": max(0.0, 1 - busy / wall)}


def remat_arms(model, tokens, log: str = "[remat]") -> list[dict]:
    """remat_arm for every policy and backward path, printed a line each."""
    arms = []
    for remat in (False, *llama.REMAT_POLICIES):
        for impl in ("fused", "split"):
            arm = remat_arm(model, tokens, remat, impl)
            arms.append(arm)
            print(f"{log} LLAMA_1B B={tokens.shape[0]} S={tokens.shape[1] - 1} "
                  f"sgd_train_step remat={remat!r} {impl}: {arm['ms']:.1f} ms/step (median "
                  f"of {[round(w, 1) for w in arm['walls']]}, host clock, synchronised), "
                  f"{arm['tokens_per_s']:.0f} tokens/s, peak {arm['peak_gib']:.2f} GiB, "
                  f"{arm['layer_mb']:.1f} MB a layer held after the forward, device busy "
                  f"{arm['busy_ms']:.1f} ms (profiled step; idle share {arm['idle']:.3f}), "
                  f"launches a step {arm['launches']}")
    return arms


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("adamw", "remat", "all"), default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(LLAMA_1B, gen, device="cuda")
    tokens = torch.randint(0, LLAMA_1B.vocab_size, (BATCH, SEQ + 1), generator=gen,
                           device="cuda")
    if args.part in ("adamw", "all"):
        for impl in ("fused", "split"):
            with backward_impl(impl):
                profile_step(model, tokens, impl)
    if args.part in ("remat", "all"):
        remat_arms(model, tokens)


if __name__ == "__main__":
    main()
