"""Where a LLAMA_1B server's admissions spend their time: on the host, on
the card, and in the CUDA caching allocator.

    python -m flashattn_tpu_torch.utils.profile_admit [--tag T]

Builds LLAMA_1B at full width with random weights from a seed and runs the
servers of chip_smoke.py phases 5 and 6 on their traffic (8 requests,
prompts of 16 + (37 i) % 160 tokens, 32 new tokens each; 4 slots, max_len
2048): bf16 weights and cache (phase 5), and int8 weights with an int8
cache (a) dense, (b) paged with a pool of 3 pages of 256, (c) paged with a
registered 512-token prefix before four of the prompts, admit_chunk 256
and logprobs. An admission is what the server's prefill_ms_avg times:
each call of InferenceServer._admit that admits a request and each
_prefill_chunk call. For each server it prints, a request:

- host ms: the host clock around the admissions (each ends in a
  synchronise; the card is idle when one starts);
- device ms: CUDA events around the same calls, the card's timeline from
  the admission's first enqueue to its last kernel's end, gaps included;
- busy ms: the kernels' device time in the admissions, from one
  torch.profiler session over a second run of fresh servers on the same
  prompts with PROFILED_NEW new tokens a request (an admission's work
  depends on its prompt alone, and short runs keep the session's events
  to the admissions' few thousand);
- the CUDA caching allocator's cudaMalloc and cudaFree calls in the
  admissions (memory_stats' segment counts) and the Python garbage
  collector's runs in them.

It calls only the server's options, submit, run, warmup and register_prefix
and the two admission methods, so it runs against an earlier checkout of
the port too: run it as a file with that checkout on PYTHONPATH,

    PYTHONPATH=<checkout> python flashattn_tpu_torch/utils/profile_admit.py --tag parent

The last line is one JSON object with every number, under the tag. Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import copy
import gc
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params, quantize_params
from flashattn_tpu_torch.models.serve import InferenceServer, Request

SEED = 0
N_REQ, N_NEW, PREFIX = 8, 32, 512
PROFILED_NEW = 2
SERVERS = {  # name: (weights, options), chip_smoke.py phases 5 and 6
    "5 bf16": ("bf16", dict()),
    "6a dense": ("int8", dict(quant="int8")),
    "6b paged": ("int8", dict(quant="int8", paged=True, page_size=256, num_pages=3)),
    "6c prefix+chunked": ("int8", dict(quant="int8", paged=True, page_size=256, num_pages=5,
                                       admit_chunk=256, return_logprobs=True)),
}


class AdmissionTimer:
    """Wraps a server's _admit and _prefill_chunk: host and event time,
    allocator and GC counts of every call that admits or streams."""

    def __init__(self, srv: InferenceServer, annotate: bool):
        self.srv, self.annotate = srv, annotate
        self.host_ms = self.device_ms = 0.0
        self.mallocs = self.frees = self.gcs = self.calls = 0
        for name in ("_admit", "_prefill_chunk"):
            setattr(srv, name, self._wrap(getattr(srv, name), name == "_admit"))

    def _wrap(self, fn, is_admit: bool):
        def timed(*args):
            torch.cuda.synchronize()
            queued = len(self.srv.queue)
            mem, gcs = torch.cuda.memory_stats(), sum(s["collections"] for s in gc.get_stats())
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with record_function("admission") if self.annotate else contextlib.nullcontext():
                fn(*args)
                end.record()
                torch.cuda.synchronize()
            host = time.perf_counter() - t0
            if is_admit and len(self.srv.queue) == queued:
                return  # nothing admitted: no free slot, or waiting for pages
            after = torch.cuda.memory_stats()
            self.calls += 1
            self.host_ms += host * 1e3
            self.device_ms += start.elapsed_time(end)
            self.mallocs += after["segment.all.allocated"] - mem["segment.all.allocated"]
            self.frees += after["segment.all.freed"] - mem["segment.all.freed"]
            self.gcs += sum(s["collections"] for s in gc.get_stats()) - gcs
        return timed


def traffic(cfg, gen: torch.Generator):
    prompts = [torch.randint(0, cfg.vocab_size, (16 + (37 * i) % 160,), generator=gen).tolist()
               for i in range(N_REQ)]
    prefix = torch.randint(0, cfg.vocab_size, (PREFIX,), generator=gen).tolist()
    return prompts, prefix


def serve(srv: InferenceServer, prompts, prefix, n_new: int = N_NEW) -> dict[int, list[int]]:
    pid = srv.register_prefix(prefix) if srv.admit_chunk else None
    for uid, p in enumerate(prompts):
        if pid is not None and uid % 2:
            srv.submit(Request(uid=uid, prompt=prefix + p, max_new_tokens=n_new, prefix_id=pid))
        else:
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new))
    got = srv.run()
    torch.cuda.synchronize()
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="change")
    tag = ap.parse_args().tag
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    bf16 = init_params(LLAMA_1B, torch.Generator(device="cuda").manual_seed(SEED),
                       device="cuda")
    models = {"bf16": bf16, "int8": quantize_params(copy.deepcopy(bf16), 8)}
    prompts, prefix = traffic(LLAMA_1B, torch.Generator().manual_seed(SEED))
    result, profiled = {}, {}
    for name, (weights, options) in SERVERS.items():
        srv = InferenceServer(models[weights], max_slots=4, max_len=2048, **options)
        srv.warmup()
        reserved = torch.cuda.memory_reserved() / 2**30
        timer = AdmissionTimer(srv, annotate=False)
        got = serve(srv, prompts, prefix)
        st = srv.stats()
        assert sorted(got) == list(range(N_REQ)), got
        result[name] = dict(
            admissions=timer.calls, host_ms=round(timer.host_ms / N_REQ, 3),
            device_ms=round(timer.device_ms / N_REQ, 3), cuda_mallocs=timer.mallocs,
            cuda_frees=timer.frees, gc_runs=timer.gcs,
            prefill_ms_avg=st["prefill_ms_avg"], decode_ms_avg=st["decode_ms_avg"],
            reserved_gib_before=round(reserved, 3))
        del srv, timer
        gc.collect()  # the timer and the server refer to each other
        srv = InferenceServer(models[weights], max_slots=4, max_len=2048, **options)
        srv.warmup()
        profiled[name] = srv
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for srv in profiled.values():
            AdmissionTimer(srv, annotate=True)
            with record_function("server"):
                serve(srv, prompts, prefix, PROFILED_NEW)
    events = prof.events()

    def ranges(name):  # the host's ranges (each also appears as a device annotation)
        return sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == name and e.device_type == DeviceType.CPU)

    def inside(spans, t):  # the index of the span holding time t, or None
        i = bisect.bisect_right([a for a, _ in spans], t) - 1
        return i if i >= 0 and t <= spans[i][1] else None

    servers, windows = ranges("server"), ranges("admission")
    assert len(servers) == len(SERVERS), servers
    busy = collections.defaultdict(float)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        t = e.time_range.start
        if inside(windows, t) is not None and (i := inside(servers, t)) is not None:
            busy[i] += (e.time_range.end - t) / 1e3
    for i, name in enumerate(SERVERS):
        r = result[name]
        r["busy_ms"] = round(busy[i] / N_REQ, 3) if busy else None
        print(f"[admit] {tag} {name}: {r['admissions']} admission calls; a request: host "
              f"{r['host_ms']} ms, device {r['device_ms']} ms (events), busy "
              f"{r['busy_ms']} ms (profiler); cudaMalloc {r['cuda_mallocs']}, cudaFree "
              f"{r['cuda_frees']}, GC runs {r['gc_runs']} in the admissions; stats "
              f"prefill {r['prefill_ms_avg']} ms/request, decode {r['decode_ms_avg']} ms/step; "
              f"reserved {r['reserved_gib_before']} GiB before the run")
    print(json.dumps({"tag": tag, "admission": result}))


if __name__ == "__main__":
    main()
