"""Continuous-batching inference server (counterpart of
flashattn_tpu/models/serve.py).

A fixed batch of `max_slots` cache rows; a request admits into a free slot
(prefill runs at B=1 on a bucket-padded prompt and the filled cache installs
into the slot), every step advances all active slots with one decode step
(inactive slots compute but do not advance), and a finished slot frees at
once for the next queued request. Each step reads the device once for the
batch's next tokens (and once more for their log-probabilities when asked).

Options, as in the JAX server:
  - ``quant="int8"|"fp8"``: quantized KV caches;
  - ``paged=True``: one page pool per layer with block tables
    (ops/paged.py). A slot owns only ceil((prompt + max_new) / page_size)
    pages, so `num_pages` sizes memory to the live contexts; a request whose
    pages cannot be allocated stays queued (backpressure);
  - ``register_prefix``: a shared prompt prefix prefilled once into pages
    that every request naming it reads (reference-counted);
  - ``admit_chunk=N``: chunked admission: each step streams at most one
    N-token prompt chunk through the batch caches (the other slots held
    still) before the decode step, so a long prompt delays the decoding
    slots by one chunk at a time;
  - ``return_logprobs=True``: the log-probability of every emitted token, in
    ``finished_logprobs``.

On the card every decode step replays one CUDA graph of
``generate.decode_step`` (``generate.DecodeGraph``), captured by
``warmup()`` or by the first decode step; a server on the CPU runs
decode_step eagerly. Admission (prefill, chunked prompts) runs eagerly.
``calibrate_device_step`` and ``calibrate_admit`` time the decode step and
an admission on the device, without changing the server's state.
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
from flashattn_tpu_torch.ops.common import round_up
from flashattn_tpu_torch.ops.kvcache import init_cache, write_slot
from flashattn_tpu_torch.ops.paged import (PageAllocator, init_paged_cache,
                                           pages_needed, pages_to_dense,
                                           set_block_table, write_pages)
from flashattn_tpu_torch.utils.timing import measure_looped, measure_looped_slope


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_token: int | None = None
    # Shared-prefix handle from InferenceServer.register_prefix (paged
    # backend). The prompt must start with the registered tokens, whose
    # pages every request naming them reads.
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
    lps: list[float] = dataclasses.field(default_factory=list)

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
        page_size: int = 1024,
        num_pages: int | None = None,
        admit_chunk: int | None = None,
        seed: int = 0,
        return_logprobs: bool = False,
    ):
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.device
        self.max_len = max_len
        self.quant = quant
        self.prompt_bucket = prompt_bucket
        self.paged = paged
        self.page_size = page_size
        self.admit_chunk = admit_chunk
        self.seed = seed
        self.return_logprobs = return_logprobs
        self.finished_logprobs: dict[int, list[float]] = {}
        # slot -> [request, next prompt position] while its prompt streams in
        self._admitting: dict[int, list] = {}
        # Wall seconds per step phase (stats()): admission (prefill plus the
        # first token's read), the decode step up to its token read, and the
        # host bookkeeping after it.
        self._timing = {"steps": 0, "decode_steps": 0, "decode_s": 0.0,
                        "admit_s": 0.0, "host_s": 0.0, "decoded_tokens": 0,
                        "admitted": 0, "prefill_s": 0.0}
        if paged:
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"page_size {page_size}")
            self.max_pages_per_seq = max_len // page_size
            if num_pages is None:
                num_pages = max_slots * self.max_pages_per_seq
            self.allocator = PageAllocator(num_pages)
            self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
            self._slot_shared: list[list[int]] = [[] for _ in range(max_slots)]
            # prefix_id -> (tokens, pages); the pages hold one registry ref.
            self._prefixes: dict[int, tuple[list[int], list[int]]] = {}
            self._next_prefix_id = 0
            self.caches = [
                init_paged_cache(max_slots, cfg.num_kv_heads, num_pages, page_size,
                                 cfg.head_dim, self.max_pages_per_seq, dtype=cfg.dtype,
                                 quant=quant, device=self.device)
                for _ in range(cfg.num_layers)
            ]
        else:
            self.caches = [
                init_cache(max_slots, cfg.num_kv_heads, max_len, cfg.head_dim,
                           dtype=cfg.dtype, quant=quant, device=self.device)
                for _ in range(cfg.num_layers)
            ]
        self.slots = [_Slot() for _ in range(max_slots)]
        self.queue: deque[Request] = deque()
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.finished: dict[int, list[int]] = {}
        # A decode step's positions and active mask, written on the host and
        # copied to the card's buffers (pinned: the copy runs asynchronously;
        # the step's token read waits for it before the next step writes).
        pin = self.device.type == "cuda"
        self._positions = torch.zeros((max_slots,), dtype=torch.int32, pin_memory=pin)
        self._active = torch.zeros((max_slots,), dtype=torch.bool, pin_memory=pin)
        self._graph: generate.DecodeGraph | None = None  # captured on the card
        self._device_step_s: float | None = None  # calibrate_device_step

    def _single_caches(self) -> list:
        """Fresh B=1 dense caches of max_len (prefill staging)."""
        cfg = self.cfg
        return [init_cache(1, cfg.num_kv_heads, self.max_len, cfg.head_dim,
                           dtype=cfg.dtype, quant=self.quant, device=self.device)
                for _ in range(cfg.num_layers)]

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        if self.admit_chunk:
            # The last streamed chunk writes a whole admit_chunk at the last
            # chunk boundary; it must fit the cache row.
            c = self.admit_chunk
            if round_up(max(len(req.prompt), 1), c) > self.max_len:
                raise ValueError(f"prompt ({len(req.prompt)}) rounded to admit_chunk "
                                 f"({c}) exceeds max_len ({self.max_len})")
        if req.prefix_id is not None:
            if not self.paged:
                raise ValueError("prefix sharing needs the paged backend")
            if req.prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {req.prefix_id}")
            ptoks, _ = self._prefixes[req.prefix_id]
            if req.prompt[:len(ptoks)] != ptoks:
                raise ValueError("prompt does not start with the registered prefix")
        if self.paged:
            need = (pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size)
                    - len(self._shared_split(req)[1]))
            if need > self.allocator.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.allocator.num_pages}: it could never be admitted")
        self.queue.append(req)

    @torch.inference_mode()
    def register_prefix(self, tokens: list[int]) -> int:
        """Prefill a shared prompt prefix once into pool pages; requests
        submitted with the returned prefix_id read those pages (never write
        them: their appends land at positions past the prefix). Only whole
        pages are shared: a tail shorter than page_size is processed again
        per request as part of its suffix."""
        if not self.paged:
            raise ValueError("prefix caching needs the paged backend")
        shared = (len(tokens) // self.page_size) * self.page_size
        if shared <= 0:
            raise ValueError(f"prefix shorter than one page ({self.page_size}) "
                             "shares nothing")
        tokens = list(tokens[:shared])
        prompt = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        _, single = generate.prefill(self.model, prompt, self._single_caches())
        pages = self.allocator.alloc(shared // self.page_size)
        for cache, one in zip(self.caches, single):
            write_pages(cache, one, pages)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = (tokens, pages)
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop the registry's reference: the pages free once the last
        request reading them finishes."""
        _, pages = self._prefixes.pop(prefix_id)
        self.allocator.release(pages)

    def _make_table(self, pages: list[int]) -> torch.Tensor:
        """A slot's block-table row: its pages, then the out-of-range
        sentinel num_pages, which installs drop and decode never reads."""
        sentinel = self.allocator.num_pages
        return torch.tensor(pages + [sentinel] * (self.max_pages_per_seq - len(pages)),
                            dtype=torch.int32, device=self.device)

    def _shared_split(self, req: Request) -> tuple[int, list[int]]:
        """(shared_len, shared_pages) of a request: whole prefix pages only,
        always leaving a non-empty suffix (admission needs the last prompt
        token's logits, which shared pages do not carry)."""
        if req.prefix_id is None:
            return 0, []
        ptoks, ppages = self._prefixes[req.prefix_id]
        shared = min(len(ptoks),
                     ((len(req.prompt) - 1) // self.page_size) * self.page_size)
        return shared, ppages[:shared // self.page_size]

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
        for s, slot in enumerate(self.slots):
            if not self.queue or not slot.free:
                continue
            shared, spages = 0, []
            if self.paged:
                nxt = self.queue[0]
                shared, spages = self._shared_split(nxt)
                need = pages_needed(len(nxt.prompt) + nxt.max_new_tokens,
                                    self.page_size) - len(spages)
                if need > self.allocator.free_pages:
                    # Backpressure: stay queued until pages free up. With
                    # nothing in flight the free pool is already as large as
                    # it can get (only registered prefixes hold pages), so
                    # waiting cannot help.
                    if all(sl.free for sl in self.slots) and not self._admitting:
                        raise RuntimeError(
                            f"request {nxt.uid} needs {need} pages but only "
                            f"{self.allocator.free_pages} can ever be free "
                            "(registered prefixes hold the rest): unregister a "
                            "prefix or grow num_pages")
                    return
            req = self.queue.popleft()
            t0 = time.perf_counter()
            if self.admit_chunk:
                self._begin_chunked_admission(s, req, shared, spages)
            elif spages:
                self._admit_with_prefix(s, req, shared, spages)
            else:
                self._admit_prefill(s, req)
            self._timing["prefill_s"] += time.perf_counter() - t0

    def _admit_prefill(self, s: int, req: Request) -> None:
        plen = len(req.prompt)
        padded = min(round_up(max(plen, 1), self.prompt_bucket), self.max_len)
        prompt = torch.zeros((1, padded), dtype=torch.int32)
        prompt[0, :plen] = torch.tensor(req.prompt, dtype=torch.int32)
        logits, single = generate.prefill(
            self.model, prompt.to(self.device), self._single_caches(), return_all=True)
        # Padding sits AFTER the prompt, so causal attention keeps the real
        # rows exact; length = plen makes the padded K/V dead (the next
        # appends land at plen and overwrite it).
        if self.paged:
            owned = self.allocator.alloc(
                pages_needed(plen + req.max_new_tokens, self.page_size))
            self._slot_pages[s] = owned
            table = self._make_table(owned)
        for cache, one in zip(self.caches, single):
            one.length.fill_(plen)
            if self.paged:  # the owned pages alone: the table's sentinels write nothing
                write_pages(cache, one, owned)
                set_block_table(cache, s, table, plen)
            else:
                write_slot(cache, one, s)
        self._start_slot(s, req, logits[0, plen - 1])

    def _admit_with_prefix(self, s: int, req: Request, shared: int,
                           spages: list[int]) -> None:
        """Admission reusing a registered prefix's pages: only the suffix is
        prefilled (chunk_step against the prefix's K/V gathered back into a
        dense B=1 cache, its quantized bytes verbatim), then installed into
        freshly owned pages from the suffix's first block on."""
        plen = len(req.prompt)
        suffix = req.prompt[shared:]
        own = self.allocator.alloc(
            pages_needed(plen + req.max_new_tokens, self.page_size) - len(spages))
        self.allocator.retain(spages)
        self._slot_pages[s] = own
        self._slot_shared[s] = spages
        table = self._make_table(spages + own)
        padded = min(round_up(len(suffix), self.prompt_bucket), self.max_len - shared)
        piece = torch.zeros((1, padded), dtype=torch.int32)
        piece[0, :len(suffix)] = torch.tensor(suffix, dtype=torch.int32)
        positions = torch.arange(shared, shared + padded, device=self.device)
        single = [pages_to_dense(cache, spages, self.max_len, length=shared)
                  for cache in self.caches]
        # chunk_step attends the prefix and the chunk causally; the padding
        # appends dead K/V (the length is set to plen below).
        logits, single = generate.chunk_step(self.model, piece.to(self.device),
                                             positions, single)
        for cache, one in zip(self.caches, single):
            write_pages(cache, one, own, first_block=len(spages))
            set_block_table(cache, s, table, plen)
        self._start_slot(s, req, logits[0, len(suffix) - 1])

    def _begin_chunked_admission(self, s: int, req: Request, shared: int,
                                 spages: list[int]) -> None:
        """Claim the slot (and its pages); the prompt itself streams in
        through _prefill_chunk, one admit_chunk a step."""
        if self.paged:
            own = self.allocator.alloc(
                pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size)
                - len(spages))
            if spages:
                self.allocator.retain(spages)
            self._slot_pages[s] = own
            self._slot_shared[s] = spages
            table = self._make_table(spages + own)
            for cache in self.caches:
                set_block_table(cache, s, table, shared)
        else:
            self._set_slot_length(s, 0)
        # Placeholder: occupied (uid set) but not decodable until the whole
        # prompt has streamed in.
        self.slots[s] = _Slot(uid=req.uid, remaining=req.max_new_tokens,
                              eos=req.eos_token, sampling=req.sampling)
        self._admitting[s] = [req, shared]

    def _set_slot_length(self, s: int, n: int) -> None:
        for cache in self.caches:
            cache.length[s] = n

    def _prefill_chunk(self, s: int) -> None:
        """Stream one admit_chunk of slot s's prompt through the batch caches
        (the other slots inactive); after the last chunk the slot becomes
        decodable with the prompt's first token."""
        t0 = time.perf_counter()
        req, pos = self._admitting[s]
        plen = len(req.prompt)
        c = self.admit_chunk
        take = min(c, plen - pos)
        b = len(self.slots)
        piece = torch.zeros((b, c), dtype=torch.int32)
        piece[s, :take] = torch.tensor(req.prompt[pos:pos + take], dtype=torch.int32)
        positions = torch.zeros((b, c), dtype=torch.int32)
        positions[s] = torch.arange(pos, pos + c, dtype=torch.int32)
        active = torch.zeros((b,), dtype=torch.bool)
        active[s] = True
        logits, _ = generate.chunk_step(
            self.model, piece.to(self.device), positions.to(self.device), self.caches,
            active=active.to(self.device))
        pos += take
        if pos < plen:
            self._admitting[s][1] = pos
        else:
            if take < c:  # the padded tail appended dead K/V: pin the length
                self._set_slot_length(s, plen)
            del self._admitting[s]
            self._start_slot(s, req, logits[s, take - 1])
        self._timing["prefill_s"] += time.perf_counter() - t0

    def _start_slot(self, s: int, req: Request, logits_row: torch.Tensor) -> None:
        """Make slot s decodable with the first token picked from the
        prompt's last logits row."""
        plen = len(req.prompt)
        first = int(self._pick(logits_row, req.uid, req.sampling, plen - 1))
        lps = [self._logprob(logits_row, first)] if self.return_logprobs else []
        self._timing["admitted"] += 1
        self.slots[s] = slot = _Slot(
            uid=req.uid, remaining=req.max_new_tokens - 1, position=plen,
            eos=req.eos_token, sampling=req.sampling, out=[first], lps=lps)
        self.tokens[s] = first
        if slot.remaining <= 0 or (slot.eos is not None and first == slot.eos):
            self._finish(s)

    @staticmethod
    def _logprob(logits_row: torch.Tensor, tok: int) -> float:
        return float(logits_row[tok] - torch.logsumexp(logits_row, dim=-1))

    def _finish(self, s: int) -> None:
        slot = self.slots[s]
        self.finished[slot.uid] = slot.out
        if self.return_logprobs:
            self.finished_logprobs[slot.uid] = slot.lps
        self.slots[s] = _Slot()
        if self.paged:
            for owned in (self._slot_pages, self._slot_shared):
                if owned[s]:
                    self.allocator.release(owned[s])  # a prefix: drops one ref
                    owned[s] = []

    @torch.inference_mode()
    def step(self) -> None:
        """Admit queued requests, stream at most one prompt chunk, then
        advance every decodable slot one token."""
        t0 = time.perf_counter()
        self._admit()
        if self._admitting:
            # Round robin over the streaming slots: the front one streams,
            # then goes to the back, so a short prompt admitted second is
            # not starved behind a long one's chunks.
            s = next(iter(self._admitting))
            self._prefill_chunk(s)
            if s in self._admitting:
                self._admitting[s] = self._admitting.pop(s)
        live = [s for s, slot in enumerate(self.slots)
                if not slot.free and s not in self._admitting]
        t1 = time.perf_counter()
        self._timing["admit_s"] += t1 - t0
        self._timing["steps"] += 1
        if not live:
            return  # an admission-only step: no decode phase
        self._positions.numpy()[:] = [slot.position for slot in self.slots]
        self._active.numpy()[:] = [s in live for s in range(len(self.slots))]
        if self.device.type == "cuda":
            logits = self.decode_graph()(self.tokens, self._positions, self._active)
        else:
            logits, _ = generate.decode_step(self.model, self.tokens, self._positions,
                                             self.caches, active=self._active)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        for s in live:  # sampled slots draw on the device, before the read
            slot = self.slots[s]
            if slot.sampling is not None and slot.sampling.temperature != 0.0:
                nxt[s] = self._pick(logits[s], slot.uid, slot.sampling, slot.position)
        toks = nxt.tolist()  # the step's one device-to-host read of tokens
        lps = None
        if self.return_logprobs:  # one batched gather + logsumexp + read
            lps = (logits.gather(1, nxt[:, None].long())[:, 0]
                   - torch.logsumexp(logits, dim=-1)).tolist()
        t2 = time.perf_counter()
        self._timing["decode_s"] += t2 - t1
        # Slots still streaming their prompt hold no decodable state: their
        # logits rows are garbage and must not advance or finish them.
        for s in live:
            slot = self.slots[s]
            tok = toks[s]
            slot.position += 1
            slot.remaining -= 1
            slot.out.append(tok)
            if lps is not None:
                slot.lps.append(lps[s])
            if slot.remaining <= 0 or (slot.eos is not None and tok == slot.eos):
                self._finish(s)
        self.tokens.copy_(nxt)
        self._timing["host_s"] += time.perf_counter() - t2
        self._timing["decode_steps"] += 1
        self._timing["decoded_tokens"] += len(live)

    def run(self) -> dict[int, list[int]]:
        """Drain queue and slots; returns {uid: generated tokens}."""
        while self.queue or any(not s.free for s in self.slots):
            self.step()
        out, self.finished = self.finished, {}
        return out

    def decode_graph(self) -> generate.DecodeGraph:
        """The captured decode step of this server's caches (card only),
        captured at the first call; a capture that fails raises."""
        if self._graph is None:
            self._graph = generate.DecodeGraph(self.model, self.caches)
        return self._graph

    def device_step_fn(self):
        """The decode step that calibrate_device_step times, and its
        arguments: the server's own token buffer, model and caches, not
        copies. Every slot is inactive, so a call changes no cache (the JAX
        server's step is functional and runs with every slot active); it
        runs the live step's kernels on the same shapes, K2 over each slot's
        current length."""
        b = len(self.slots)
        positions = torch.tensor([max(s.position, 1) if not s.free else 1
                                  for s in self.slots], dtype=torch.int32).to(self.device)
        idle = torch.zeros((b,), dtype=torch.bool, device=self.device)

        def fn(tokens, model, caches):
            return generate.decode_step(model, tokens, positions, caches, active=idle)[0]

        return fn, (self.tokens, self.model, self.caches)

    @torch.inference_mode()
    def calibrate_device_step(self, iters: int = 100) -> float:
        """Seconds of device time per decode step, stored for stats()
        (device_step_ms and the tokens/s bound it gives). On the card
        utils/timing.py captures a chain of steps in one CUDA graph and
        times its replay with CUDA events (the slope between two chain
        lengths from 50 iterations up; below, one chain, the best of three
        replays); on the CPU it reads the host clock. Leaves every cache bit
        for bit as it was."""
        fn, args = self.device_step_fn()
        if iters < 50:
            self._device_step_s = measure_looped(fn, *args, iters=iters, repeats=3)
        else:
            self._device_step_s = measure_looped_slope(fn, *args)
        return self._device_step_s

    @torch.inference_mode()
    def calibrate_admit(self, prompt_len: int, prefix_len: int,
                        iters: int = 50) -> dict[str, float]:
        """Device milliseconds of one admission with and without a shared
        prefix, timed as calibrate_device_step times a step:

          replicated: the whole prompt through chunk_step in pieces of at
                      most 512, then its pages installed;
          shared:     the prefix's pages gathered to a dense cache, the
                      suffix through chunk_step, the suffix's pages
                      installed (the compute of a prefix admission).

        Both run on dense caches and a page pool of their own, so the live
        pool, tables and lengths are never touched. Returns both times and
        the device speedup of sharing."""
        if not self.paged:
            raise ValueError("prefix calibration needs the paged backend")
        if not 0 < prefix_len < prompt_len <= self.max_len:
            raise ValueError(f"need 0 < prefix_len ({prefix_len}) < prompt_len "
                             f"({prompt_len}) <= max_len ({self.max_len})")
        if prefix_len % self.page_size:
            raise ValueError(f"prefix_len {prefix_len} is not a multiple of page_size "
                             f"{self.page_size}: register_prefix shares whole pages")
        cfg, dev = self.cfg, self.device
        nshared = prefix_len // self.page_size
        n_all = pages_needed(prompt_len, self.page_size)
        pool = [init_paged_cache(1, cfg.num_kv_heads, n_all, self.page_size, cfg.head_dim,
                                 self.max_pages_per_seq, dtype=cfg.dtype, quant=self.quant,
                                 device=dev)
                for _ in range(cfg.num_layers)]
        pages_all = torch.arange(n_all, dtype=torch.int32, device=dev)
        padded_full = min(round_up(prompt_len, self.prompt_bucket), self.max_len)
        pos_full = torch.arange(padded_full, device=dev)
        cal_chunk = min(512, padded_full)

        def replicated(piece, model, pool, empty):
            for cache in empty:
                cache.length.zero_()
            logits = None
            for c0 in range(0, padded_full, cal_chunk):
                logits, _ = generate.chunk_step(model, piece[:, c0:c0 + cal_chunk],
                                                pos_full[c0:c0 + cal_chunk], empty)
            for dst, one in zip(pool, empty):
                write_pages(dst, one, pages_all)
            return logits

        suffix_len = prompt_len - prefix_len
        padded_suf = min(round_up(suffix_len, self.prompt_bucket), self.max_len - prefix_len)
        pos_suf = torch.arange(prefix_len, prefix_len + padded_suf, device=dev)
        spages, opages = pages_all[:nshared], pages_all[nshared:]

        def shared(piece, model, pool):
            single = [pages_to_dense(cache, spages, self.max_len, length=prefix_len)
                      for cache in pool]
            logits, single = generate.chunk_step(model, piece, pos_suf, single)
            for dst, one in zip(pool, single):
                write_pages(dst, one, opages, first_block=nshared)
            return logits

        rep_args = (torch.zeros((1, padded_full), dtype=torch.int32, device=dev), self.model,
                    pool, self._single_caches())
        sh_args = (torch.zeros((1, padded_suf), dtype=torch.int32, device=dev), self.model,
                   pool)
        if iters < 50:
            t_rep = measure_looped(replicated, *rep_args, iters=iters, repeats=3)
            t_sh = measure_looped(shared, *sh_args, iters=iters, repeats=3)
        else:
            t_rep = measure_looped_slope(replicated, *rep_args)
            t_sh = measure_looped_slope(shared, *sh_args)
        return {
            "prefill_ms_replicated": round(t_rep * 1e3, 3),
            "prefill_ms_shared": round(t_sh * 1e3, 3),
            "device_speedup": round(t_rep / t_sh, 2),
        }

    @torch.inference_mode()
    def warmup(self) -> None:
        """Build the kernels and warm the libraries before traffic: one
        prefill at the first prompt bucket (or one chunk step with every slot
        inactive, under admit_chunk), then on the card the decode step's
        capture (decode_graph), on the CPU one decode step with every slot
        inactive; none of them changes a cache."""
        b = len(self.slots)
        idle = torch.zeros((b,), dtype=torch.bool, device=self.device)
        if self.admit_chunk:
            zeros = torch.zeros((b, self.admit_chunk), dtype=torch.int32, device=self.device)
            generate.chunk_step(self.model, zeros, zeros, self.caches, active=idle)
        else:
            generate.prefill(self.model,
                             torch.zeros((1, self.prompt_bucket), dtype=torch.int32,
                                         device=self.device),
                             self._single_caches(), return_all=True)
        if self.device.type == "cuda":
            self.decode_graph()
        else:
            generate.decode_step(
                self.model, self.tokens,
                torch.zeros((b,), dtype=torch.int32, device=self.device), self.caches,
                active=idle)

    def stats(self) -> dict[str, Any]:
        """Occupancy, queue depth, the page pool (paged), the step-phase
        timings and, once calibrate_device_step has run, the device time of a
        step and the tokens/s bound it sets (every slot decoding)."""
        st = {
            "active_slots": sum(not s.free for s in self.slots),
            "max_slots": len(self.slots),
            "queued": len(self.queue),
            "live_tokens": sum(s.position for s in self.slots if not s.free),
        }
        if self.paged:
            total = self.allocator.num_pages
            st.update(
                pages_total=total,
                pages_free=self.allocator.free_pages,
                pages_used=total - self.allocator.free_pages,
                prefix_pages=sum(len(p) for _, p in self._prefixes.values()),
                page_utilization=round(1 - self.allocator.free_pages / total, 3),
            )
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
        if self._device_step_s:
            st["device_step_ms"] = round(1e3 * self._device_step_s, 4)
            st["device_tokens_per_s_bound"] = round(len(self.slots) / self._device_step_s, 1)
        return st
