"""Where a LLAMA_1B server's decode step spends its time on the card.

    python -m flashattn_tpu_torch.utils.profile_serve

Builds LLAMA_1B at full width with random weights from a seed and runs two
servers with 4 slots and max_len 2048: bf16 weights and cache, and the
quantized configuration of chip_smoke.py phase 6 (a) (int8 weights through
qmm8, an int8 KV cache, dense caches). Each admits 4 requests of 100-token
prompts, then, once every slot decodes:

- times STEPS server steps on the host clock (each ends with the step's
  token read, as serving does): ms/step;
- profiles STEPS more with torch.profiler (CPU and CUDA activity) and
  prints the device busy time per step (the kernels' self CUDA time), the
  card's idle share of the unprofiled step, and the kernels with the most
  device time.

Then it times qmm8 alone at the decode batch (M 4, K 2048, N 5632): its
wrapper's host time per eager call (1,000 calls enqueued back to back, no
synchronise between them) against its device time (CUDA graph). Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import copy
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params, quantize_params
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import quant_matmul
from flashattn_tpu_torch.utils.timing import cuda_time_ms

SEED = 0
SLOTS, PROMPT = 4, 100
STEPS = 10  # timed, then as many profiled
TOP = 8
EAGER_CALLS = 1000


def profile_server(name: str, model, **options) -> None:
    srv = InferenceServer(model, max_slots=SLOTS, max_len=2048, **options)
    gen = torch.Generator().manual_seed(SEED)
    for uid in range(SLOTS):
        prompt = torch.randint(0, LLAMA_1B.vocab_size, (PROMPT,), generator=gen).tolist()
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=4 * STEPS))
    while srv.queue or any(slot.free for slot in srv.slots):
        srv.step()  # admissions
    for _ in range(2):
        srv.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        srv.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            srv.step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / STEPS
    print(f"[profile] LLAMA_1B {name}, {SLOTS} slots decoding: {wall:.2f} ms/step median "
          f"of {[round(w, 2) for w in walls]} (host clock), device busy {busy:.3f} ms/step, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:TOP]:
        ms = e.self_device_time_total / 1e3 / STEPS
        print(f"[profile]   {ms:8.3f} ms/step {100 * ms / busy:5.1f} %  "
              f"{e.count // STEPS:5d} calls/step  {e.key[:100]}")


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
