#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (into build/flashattn_tpu_torch/) and runs
four phases, printing one line per check:

1. environment: torch/CUDA versions, the card's name and power limit, the
   kernels' build time and their compiler report;
2. each kernel against its plain PyTorch version on the card, at the serving
   path's shapes, with the tolerance printed beside each result, and both
   timed with CUDA events;
3. LLAMA_1B at full width (random weights from a seed): prefill of a
   150-token prompt and 4 teacher-forced decode steps through the kernels,
   against the same run with every attention call on the plain version;
4. the InferenceServer at LLAMA_1B width with 4 slots and max_len 2048 on 8
   requests of 32 new tokens, counting the kernels' launches.

Any failed check raises: the script then exits nonzero and does not print
its last line. It needs a CUDA device and never falls back to the CPU. The
JAX package is not imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import torch

from flashattn_tpu_torch.models import generate
from flashattn_tpu_torch.models.config import LLAMA_1B
from flashattn_tpu_torch.models.llama import init_params
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.ops import _build, decode, flash_fwd
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.utils.timing import attention_flops, cuda_time_ms
from flashattn_tpu_torch.utils.verify import verify_results

SEED = 0
O_ATOL = 2e-2  # bf16 outputs against the fp32 plain version
LSE_ATOL = 1e-2
LOGIT_COS = 0.999
LOGIT_REL = 0.05  # max |logit delta| <= LOGIT_REL * max |reference logit|


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_environment() -> str:
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[env] device {name} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for lib in ("flash_fwd", "decode"):
        _build.load(lib)
    print(f"[env] kernels built/loaded in {time.perf_counter() - t0:.2f} s "
          f"(compile s: {_build.BUILD_SECONDS})")
    for lib in ("flash_fwd", "decode"):
        log = _build.library_path(lib).with_suffix(".log")
        if not log.exists():  # loaded from an earlier build of another run
            continue
        kernel = "?"
        for line in log.read_text().splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                kernel = kernel_label(entry.group(1))
            elif "registers" in line or "spill" in line:
                print(f"[env] ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    return name


def kernel_label(mangled: str) -> str:
    """'flash_fwd_mma_kernel<64>' from the mangled name of a kernel in csrc/."""
    m = re.search(r"\d+([a-z_]+_kernel)I(.*?)E+v", mangled)
    if m is None:
        return mangled
    types = {"13__nv_bfloat16": "bf16", "f": "float"}
    args = [t.group(1) or types[t.group(0)]
            for t in re.finditer(r"13__nv_bfloat16|f|Li(\d+)", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def _gate(name: str, ref, out, atol: float) -> float:
    rep = verify_results(ref, out, atol=atol)
    print(f"[kernels] {name}: {rep} (atol={atol}, rtol=1e-2, cos>0.999)")
    check(rep.passed, f"{name} disagrees with its plain version: {rep}")
    return rep.max_abs_err


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[kernels] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = "cuda"
    bf16 = dict(dtype=torch.bfloat16, device=dev)

    # K1 at the prefill shapes (B=1, Hq=32, Hkv=4, D=64, causal), plus D=128
    # non-causal and S_q < S_k (bottom-right alignment).
    k1_err = 0.0
    cases = [(1, 32, 4, s, s, 64, True) for s in (128, 256, 200)]
    cases += [(2, 8, 2, 256, 256, 128, False), (1, 32, 4, 64, 256, 64, True)]
    for b, hq, hkv, s_q, s_k, d, causal in cases:
        q = torch.randn((b, hq, s_q, d), generator=gen, **bf16)
        k = torch.randn((b, hkv, s_k, d), generator=gen, **bf16)
        v = torch.randn((b, hkv, s_k, d), generator=gen, **bf16)
        o_ref, lse_ref = flash_fwd.flash_attention_forward_reference(q, k, v, causal)
        o, lse = flash_fwd.flash_attention_forward(q, k, v, causal)
        o2, none = flash_fwd.flash_attention_forward(q, k, v, causal, need_lse=False)
        torch.cuda.synchronize()
        tag = f"K1 B={b} Hq={hq} Hkv={hkv} Sq={s_q} Sk={s_k} D={d} causal={causal}"
        k1_err = max(k1_err, _gate(tag + " O", o_ref, o, O_ATOL))
        _gate(tag + " LSE", lse_ref, lse, LSE_ATOL)
        check(none is None and torch.equal(o, o2), f"{tag}: need_lse=False changed O")
    try:
        flash_fwd.flash_attention_forward(
            *(torch.randn((1, 2, 64, 32), **bf16) for _ in range(3)))
    except ValueError as e:
        print(f"[kernels] K1 refuses D=32 on the card: {e}")
    else:
        raise AssertionError("K1 accepted D=32 on the card")

    # K2 on a bf16 cache with NaN past every length.
    b, hq, hkv, d, s_max = 4, 32, 4, 64, 2048
    lengths = [1, 77, 1500, 2048]
    cache = KVCache(
        k=torch.randn((b, hkv, s_max, d), generator=gen, **bf16),
        v=torch.randn((b, hkv, s_max, d), generator=gen, **bf16),
        length=torch.tensor(lengths, dtype=torch.int32, device=dev))
    for i, n in enumerate(lengths):
        cache.k[i, :, n:] = float("nan")
        cache.v[i, :, n:] = float("nan")
    k2_err = 0.0
    for t in (1, 4):
        q = torch.randn((b, hq, t, d), generator=gen, **bf16)
        o_ref = decode.decode_attention_reference(q, cache)
        o = (decode.decode_attention(q[:, :, 0].contiguous(), cache)[:, :, None]
             if t == 1 else decode.decode_attention_chunk(q, cache))
        torch.cuda.synchronize()
        tag = f"K2 B={b} Hq={hq} Hkv={hkv} D={d} Smax={s_max} T={t} lengths={lengths}"
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
        k2_err = max(k2_err, _gate(tag, o_ref, o, O_ATOL))

    # Times at the serving path's shapes: a 256-token prefill bucket, and
    # one decode step of the 4-slot batch.
    s = 256
    q = torch.randn((1, 32, s, 64), generator=gen, **bf16)
    k = torch.randn((1, 4, s, 64), generator=gen, **bf16)
    v = torch.randn((1, 4, s, 64), generator=gen, **bf16)
    k1_ms = cuda_time_ms(lambda: flash_fwd.flash_attention_forward(q, k, v, True, need_lse=False))
    k1_plain = cuda_time_ms(lambda: flash_fwd.flash_attention_forward_reference(
        q, k, v, True, need_lse=False))
    tf = attention_flops(1, 32, s, s, 64, True) / (k1_ms * 1e-3) / 1e12
    print(f"[kernels] K1 B=1 Hq=32 Hkv=4 S={s} D=64 causal: kernel {k1_ms:.4f} ms "
          f"({tf:.3f} TFLOP/s), plain {k1_plain:.4f} ms")
    qd = torch.randn((b, hq, d), generator=gen, **bf16)
    k2_ms = cuda_time_ms(lambda: decode.decode_attention(qd, cache))
    k2_plain = cuda_time_ms(lambda: decode.decode_attention_reference(qd[:, :, None], cache))
    live_bytes = 2 * hkv * d * 2 * sum(lengths)
    print(f"[kernels] K2 B={b} Hq={hq} Hkv={hkv} D={d} Smax={s_max} T=1 lengths={lengths}: "
          f"kernel {k2_ms:.4f} ms ({live_bytes / (k2_ms * 1e-3) / 1e9:.1f} GB/s of live "
          f"cache), plain {k2_plain:.4f} ms")
    return {
        "flash_fwd": dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain),
        "decode": dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain),
    }


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention calls to the plain versions."""
    saved = generate.flash_attention, generate.decode_attention
    generate.flash_attention = (
        lambda q, k, v, is_causal=False, scale=None:
        flash_fwd.flash_attention_forward_reference(q, k, v, is_causal, scale,
                                                    need_lse=False)[0])
    generate.decode_attention = (
        lambda q, cache, scale=None:
        decode.decode_attention_reference(q[:, :, None], cache, scale)[:, :, 0])
    try:
        yield
    finally:
        generate.flash_attention, generate.decode_attention = saved


def phase_model(model, gen: torch.Generator) -> None:
    cfg = model.cfg
    prompt = torch.randint(0, cfg.vocab_size, (1, 150), generator=gen, device="cuda")
    forced = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda")

    def run() -> list[torch.Tensor]:
        caches = generate.init_caches(model, 1, 2048)
        logits, caches = generate.prefill(model, prompt, caches)
        out = [logits]
        for i in range(4):
            pos = torch.tensor([150 + i], dtype=torch.int32, device="cuda")
            logits, caches = generate.decode_step(model, forced[i:i + 1], pos, caches)
            out.append(logits)
        torch.cuda.synchronize()
        return out

    counts = flash_fwd.LAUNCHES, decode.LAUNCHES
    kern = run()
    check((flash_fwd.LAUNCHES - counts[0], decode.LAUNCHES - counts[1])
          == (cfg.num_layers, 4 * cfg.num_layers), "kernel run missed a kernel")
    counts = flash_fwd.LAUNCHES, decode.LAUNCHES
    with plain_attention():
        plain = run()
    check((flash_fwd.LAUNCHES, decode.LAUNCHES) == counts,
          "plain run launched a kernel")
    for step, (a, r) in enumerate(zip(kern, plain)):
        a, r = a.float().flatten(), r.float().flatten()
        check(bool(torch.isfinite(a).all()), f"step {step}: non-finite logits")
        cos = float(torch.nn.functional.cosine_similarity(a, r, dim=0))
        delta = float((a - r).abs().max())
        bound = LOGIT_REL * float(r.abs().max())
        name = "prefill S=150" if step == 0 else f"decode {step}"
        print(f"[model] LLAMA_1B {name}: cos {cos:.6f} (> {LOGIT_COS}), "
              f"max|d| {delta:.4f} (<= {bound:.4f}), argmax kernel "
              f"{int(a.argmax())} plain {int(r.argmax())}")
        check(cos > LOGIT_COS and delta <= bound, f"LLAMA_1B {name} logits disagree")


def phase_server(model, gen: torch.Generator) -> dict[str, int]:
    cfg = model.cfg
    srv = InferenceServer(model, max_slots=4, max_len=2048)
    srv.warmup()
    n_new = 32
    lens = [16 + (37 * i) % 160 for i in range(8)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device="cuda").tolist() for n in lens]
    torch.cuda.synchronize()
    flash_fwd.LAUNCHES = 0
    decode.LAUNCHES = 0
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new))
    got = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES}
    st = srv.stats()
    check(sorted(got) == list(range(8)), f"finished {sorted(got)}")
    for uid, toks in got.items():
        check(len(toks) == n_new and all(0 <= x < cfg.vocab_size for x in toks),
              f"request {uid}: {len(toks)} tokens {toks[:4]}...")
    check(launches["flash_fwd"] >= 8 * cfg.num_layers, f"flash_fwd launches {launches}")
    check(launches["decode"] >= cfg.num_layers * st["decode_steps"],
          f"decode launches {launches} for {st['decode_steps']} steps")
    print(f"[server] LLAMA_1B 4 slots max_len 2048, 8 requests, prompts {lens}, "
          f"{n_new} new tokens each: all finished; launches {launches} over "
          f"{st['decode_steps']} decode steps")
    print(f"[server] prefill {st['prefill_ms_avg']} ms/request, decode "
          f"{st['decode_ms_avg']} ms/step, host {st['host_ms_avg']} ms/step, "
          f"wall {8 * n_new / wall:.1f} tokens/s ({8 * n_new} tokens in "
          f"{wall:.3f} s; stats() decode-phase rate {st['wall_tokens_per_s']} tokens/s)")
    return launches


def main() -> None:
    name = phase_environment()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timed = phase_kernels(gen)
    t0 = time.perf_counter()
    model = init_params(LLAMA_1B, gen, device="cuda")
    torch.cuda.synchronize()
    print(f"[model] LLAMA_1B random weights on the card in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters")
    phase_model(model, gen)
    launches = phase_server(model, gen)
    sources = {
        "flash_fwd": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                      "flashattn_tpu/ops/flash_fwd.py:469"),
        "decode": ("flashattn_tpu_torch/csrc/decode.cu",
                   "flashattn_tpu/ops/decode.py:351"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **timed[k]}
        for k, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
