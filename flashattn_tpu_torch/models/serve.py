"""Continuous-batching inference server (counterpart of
flashattn_tpu/models/serve.py), dense caches.

A fixed batch of `max_slots` cache rows; a request admits into a free slot
(prefill runs at B=1 on a bucket-padded prompt and the filled cache installs
with kvcache.write_slot), every step advances all active slots with one
decode step (inactive slots compute but do not advance), and a finished
slot frees at once for the next queued request. Each step reads the device
once: the batch's next tokens.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import torch

from flashattn_tpu_torch.models import generate
from flashattn_tpu_torch.models.llama import Llama
from flashattn_tpu_torch.models.sampling import SamplingParams, sample
from flashattn_tpu_torch.ops.common import round_up, unported
from flashattn_tpu_torch.ops.kvcache import init_cache, write_slot


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_token: int | None = None
    # Shared-prefix handle (paged backend, not ported); must stay None.
    prefix_id: int | None = None
    # None = greedy. A sampled draw uses a generator seeded from (server
    # seed, uid, position): reproducible whatever the batch composition.
    sampling: SamplingParams | None = None


@dataclasses.dataclass
class _Slot:
    uid: int = -1
    remaining: int = 0
    position: int = 0  # position index of the token in self.tokens
    eos: int | None = None
    sampling: SamplingParams | None = None
    out: list[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.uid < 0


class InferenceServer:
    """Greedy (or per-request sampled) continuous-batching engine.
    Synchronous API: submit() any time, step() advances one token for every
    active slot, run() drains. Runs under torch.inference_mode()."""

    def __init__(
        self,
        model: Llama,
        max_slots: int = 8,
        max_len: int = 2048,
        quant: str | None = None,
        prompt_bucket: int = 128,
        paged: bool = False,
        admit_chunk: int | None = None,
        seed: int = 0,
        return_logprobs: bool = False,
    ):
        if paged:
            raise unported("the paged KV backend", "A5")
        if quant is not None:
            raise unported(f"{quant} KV cache", "A5")
        if admit_chunk is not None:
            raise unported("chunked admission", "A5")
        if return_logprobs:
            raise unported("server logprobs", "A5")
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.device
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.seed = seed
        # Wall seconds per step phase (stats()): admission (prefill plus the
        # first token's read), the decode step up to its token read, and the
        # host bookkeeping after it.
        self._timing = {"steps": 0, "decode_steps": 0, "decode_s": 0.0,
                        "admit_s": 0.0, "host_s": 0.0, "decoded_tokens": 0,
                        "admitted": 0, "prefill_s": 0.0}
        self.caches = [
            init_cache(max_slots, cfg.num_kv_heads, max_len, cfg.head_dim,
                       dtype=cfg.dtype, device=self.device)
            for _ in range(cfg.num_layers)
        ]
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: deque[Request] = deque()
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.finished: dict[int, list[int]] = {}

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        if req.prefix_id is not None:
            raise unported("prefix sharing", "A5")
        self.queue.append(req)

    def register_prefix(self, tokens: list[int]) -> int:
        raise unported("prefix caching", "A5")

    def _generator(self, uid: int, position: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(hash((self.seed, uid, position)) & 0x7FFF_FFFF_FFFF_FFFF)
        return gen

    def _pick(self, logits_row: torch.Tensor, uid: int,
              sampling: SamplingParams | None, position: int) -> torch.Tensor:
        """Next token (a 0-d device tensor) from one slot's [V] logits."""
        if sampling is None or sampling.temperature == 0.0:
            return logits_row.argmax()
        return sample(logits_row[None], self._generator(uid, position), sampling)[0]

    def _admit(self) -> None:
        cfg = self.cfg
        for s, slot in enumerate(self.slots):
            if not self.queue or not slot.free:
                continue
            t0 = time.perf_counter()
            req = self.queue.popleft()
            plen = len(req.prompt)
            padded = min(round_up(max(plen, 1), self.prompt_bucket), self.max_len)
            prompt = torch.zeros((1, padded), dtype=torch.int32)
            prompt[0, :plen] = torch.tensor(req.prompt, dtype=torch.int32)
            single = [
                init_cache(1, cfg.num_kv_heads, self.max_len, cfg.head_dim,
                           dtype=cfg.dtype, device=self.device)
                for _ in range(cfg.num_layers)
            ]
            logits, single = generate.prefill(
                self.model, prompt.to(self.device), single, return_all=True)
            # Padding sits AFTER the prompt, so causal attention keeps the
            # real rows exact; length = plen makes the padded K/V dead (the
            # next appends land at plen and overwrite it).
            for li in range(cfg.num_layers):
                single[li].length.fill_(plen)
                write_slot(self.caches[li], single[li], s)
            first = int(self._pick(logits[0, plen - 1], req.uid, req.sampling,
                                   plen - 1))
            self._timing["prefill_s"] += time.perf_counter() - t0
            self._timing["admitted"] += 1
            self._start_slot(s, req, first)

    def _start_slot(self, s: int, req: Request, first: int) -> None:
        self.slots[s] = slot = _Slot(
            uid=req.uid, remaining=req.max_new_tokens - 1,
            position=len(req.prompt), eos=req.eos_token, sampling=req.sampling,
            out=[first])
        self.tokens[s] = first
        if slot.remaining <= 0 or (slot.eos is not None and first == slot.eos):
            self._finish(s)

    def _finish(self, s: int) -> None:
        slot = self.slots[s]
        self.finished[slot.uid] = slot.out
        self.slots[s] = _Slot()

    @torch.inference_mode()
    def step(self) -> None:
        """Admit queued requests, then advance every active slot one token."""
        t0 = time.perf_counter()
        self._admit()
        live = [s for s, slot in enumerate(self.slots) if not slot.free]
        t1 = time.perf_counter()
        self._timing["admit_s"] += t1 - t0
        self._timing["steps"] += 1
        if not live:
            return
        positions = torch.tensor([slot.position for slot in self.slots],
                                 dtype=torch.int32).to(self.device)
        active = torch.tensor([not slot.free for slot in self.slots]).to(self.device)
        logits, self.caches = generate.decode_step(
            self.model, self.tokens, positions, self.caches, active=active)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        for s in live:  # sampled slots draw on the device, before the read
            slot = self.slots[s]
            if slot.sampling is not None and slot.sampling.temperature != 0.0:
                nxt[s] = self._pick(logits[s], slot.uid, slot.sampling,
                                    slot.position)
        toks = nxt.tolist()  # the step's one device-to-host read
        t2 = time.perf_counter()
        self._timing["decode_s"] += t2 - t1
        for s in live:
            slot = self.slots[s]
            tok = toks[s]
            slot.position += 1
            slot.remaining -= 1
            slot.out.append(tok)
            if slot.remaining <= 0 or (slot.eos is not None and tok == slot.eos):
                self._finish(s)
        self.tokens = nxt
        self._timing["host_s"] += time.perf_counter() - t2
        self._timing["decode_steps"] += 1
        self._timing["decoded_tokens"] += len(live)

    def run(self) -> dict[int, list[int]]:
        """Drain queue and slots; returns {uid: generated tokens}."""
        while self.queue or any(not s.free for s in self.slots):
            self.step()
        out, self.finished = self.finished, {}
        return out

    @torch.inference_mode()
    def warmup(self) -> None:
        """Build the kernels and warm the libraries before traffic: one
        prefill at the first prompt bucket and one decode step with every
        slot inactive (which changes no cache)."""
        cfg = self.cfg
        b = len(self.slots)
        single = [
            init_cache(1, cfg.num_kv_heads, self.max_len, cfg.head_dim,
                       dtype=cfg.dtype, device=self.device)
            for _ in range(cfg.num_layers)
        ]
        generate.prefill(self.model,
                         torch.zeros((1, self.prompt_bucket), dtype=torch.int32,
                                     device=self.device),
                         single, return_all=True)
        generate.decode_step(
            self.model, self.tokens,
            torch.zeros((b,), dtype=torch.int32, device=self.device), self.caches,
            active=torch.zeros((b,), dtype=torch.bool, device=self.device))

    def stats(self) -> dict[str, Any]:
        """Occupancy, queue depth and the step-phase timings."""
        st = {
            "active_slots": sum(not s.free for s in self.slots),
            "max_slots": len(self.slots),
            "queued": len(self.queue),
            "live_tokens": sum(s.position for s in self.slots if not s.free),
        }
        t = self._timing
        if t["steps"]:
            wall = t["decode_s"] + t["admit_s"] + t["host_s"]
            dsteps = max(t["decode_steps"], 1)
            st.update(
                steps=t["steps"],
                decode_steps=t["decode_steps"],
                admitted=t["admitted"],
                prefill_ms_avg=round(1e3 * t["prefill_s"] / max(t["admitted"], 1), 3),
                decode_ms_avg=round(1e3 * t["decode_s"] / dsteps, 3),
                admit_ms_avg=round(1e3 * t["admit_s"] / t["steps"], 3),
                host_ms_avg=round(1e3 * t["host_s"] / dsteps, 3),
                sched_overhead_frac=round(
                    (t["admit_s"] + t["host_s"]) / max(wall, 1e-9), 3),
                wall_tokens_per_s=round(t["decoded_tokens"] / max(wall, 1e-9), 1),
            )
        return st
