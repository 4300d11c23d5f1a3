"""Prefill + decode generation (counterpart of flashattn_tpu/models/generate.py).

Prefill runs the prompt through the flash forward (K1) and fills the
caches; each decode step appends one token per sequence and attends the
cache through flash-decode (K2); ``chunk_step`` appends and attends C tokens
per sequence the same way (chunked prefill, prefix-seeded admission). The
caches may be dense (KVCache) or paged (PagedKVCache), bf16/f32 or
quantized (int8/fp8); the dispatch is on the cache's type. The caches are
updated in place (ops/kvcache.py, ops/paged.py); the functions return them
as the JAX ones do. ``DecodeGraph`` replays decode_step from one CUDA
graph, where the JAX package jits it.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.llama import Llama
from flashattn_tpu_torch.models.sampling import SamplingParams, sample
from flashattn_tpu_torch.ops import launches
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.common import round_up
from flashattn_tpu_torch.ops.decode import decode_attention, decode_attention_chunk
from flashattn_tpu_torch.ops.kvcache import KVCache, init_cache, update_cache
from flashattn_tpu_torch.ops.paged import (PagedKVCache, append_paged,
                                           paged_decode_attention,
                                           paged_decode_attention_chunk)
from flashattn_tpu_torch.utils.timing import warm


def init_caches(model: Llama, batch: int, max_len: int,
                quant: str | None = None) -> list[KVCache]:
    cfg = model.cfg
    return [
        init_cache(batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                   dtype=cfg.dtype, quant=quant, device=model.device)
        for _ in range(cfg.num_layers)
    ]


def _append(cache, k, v, active=None, assume_fits=False):
    if isinstance(cache, PagedKVCache):
        return append_paged(cache, k, v, active=active)
    return update_cache(cache, k, v, active=active, assume_fits=assume_fits)


@torch.inference_mode()
def prefill(
    model: Llama,
    tokens: torch.Tensor,  # [B, S] int
    caches: list,
    return_all: bool = False,
) -> tuple[torch.Tensor, list]:
    """Run the prompt through the flash forward, filling the caches.

    Returns (float32 logits [B, vocab] for the last position, or
    [B, S, vocab] for every position when return_all, and the caches)."""
    cfg = model.cfg
    b, s = tokens.shape
    x = llama.embed_tokens(model, tokens)
    cos, sin = llama.rope_tables(cfg, torch.arange(s, device=tokens.device))
    for layer, cache in zip(model.layers, caches):
        xn = llama.rms_norm(x, layer.attn_norm, cfg.norm_eps, cfg.norm_offset)
        q, k, v = llama.qkv(layer, xn, cfg)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)
        # A fresh cache and an admission-bounded prompt: no drop guard.
        _append(cache, k, v, assume_fits=True)
        o = flash_attention(q, k, v, is_causal=True, scale=cfg.attn_scale)
        o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
        x = x + llama.proj(o, layer.wo)
        x = x + llama._mlp_block(layer, x, cfg)
    return llama.lm_logits(x if return_all else x[:, -1], model), caches


@torch.inference_mode()
def decode_step(
    model: Llama,
    token: torch.Tensor,  # [B] int — the token just sampled
    positions: torch.Tensor,  # [B] int — its position index
    caches: list,
    active: torch.Tensor | None = None,  # [B] bool — continuous batching
) -> tuple[torch.Tensor, list]:
    """One decode step -> (float32 logits [B, vocab], caches).

    Inactive slots compute but do not advance their cache; their logits
    are garbage and must be ignored by the caller."""
    cfg = model.cfg
    b = token.shape[0]
    x = llama.embed_tokens(model, token)  # [B, H]
    cos, sin = llama.rope_tables(cfg, positions)  # [B, D/2]
    for layer, cache in zip(model.layers, caches):
        xn = llama.rms_norm(x, layer.attn_norm, cfg.norm_eps, cfg.norm_offset)
        q, k, v = llama.qkv(layer, xn[:, None], cfg)
        q = llama.apply_rope(q, cos[:, None], sin[:, None])
        k = llama.apply_rope(k, cos[:, None], sin[:, None])
        _append(cache, k, v, active=active)
        attn = (paged_decode_attention if isinstance(cache, PagedKVCache)
                else decode_attention)
        o = attn(q[:, :, 0], cache, scale=cfg.attn_scale)  # [B, Hq, D]
        x = x + llama.proj(o.reshape(b, cfg.num_heads * cfg.head_dim), layer.wo)
        x = x + llama._mlp_block(layer, x, cfg)
    return llama.lm_logits(x, model), caches


class DecodeGraph:
    """decode_step captured in one CUDA graph, for one model and one list of
    caches (so one graph per slot count and cache kind).

    It holds static ``token`` [B] int32, ``positions`` [B] int32 and
    ``active`` [B] bool buffers and the graph's logits [B, vocab]. A call
    copies its arguments into the buffers, replays the graph and returns
    the logits (the same tensor at every call, overwritten by the next).
    The graph reads and writes the caches' own tensors: a caller must write
    into them in place (admission does) and never replace one.

    Capture runs decode_step once eagerly with every row inactive (which
    changes no cache; it loads the kernels and the libraries' state before
    the capture), captures it, and replays it once. A wrapper called during
    the capture launches nothing, so the capture's launch counts are taken
    back and added again at every replay (ops/launches.py). CUDA caches
    only; a CPU caller runs decode_step."""

    def __init__(self, model: Llama, caches: list):
        device = caches[0].length.device
        if device.type != "cuda" or model.device != device:
            raise ValueError(f"a captured decode step needs the model and the caches on "
                             f"one CUDA device, got {model.device} and {device}")
        b = caches[0].length.shape[0]
        self.model, self.caches = model, caches
        self.token = torch.zeros((b,), dtype=torch.int32, device=device)
        self.positions = torch.zeros((b,), dtype=torch.int32, device=device)
        self.active = torch.zeros((b,), dtype=torch.bool, device=device)
        self.replays = 0

        def step():
            return decode_step(model, self.token, self.positions, caches, active=self.active)

        warm(step)
        self.graph, (self.logits, _), self.launches = launches.capture(step)
        self.replay()

    def replay(self) -> torch.Tensor:
        """Replay the graph on what the buffers hold; returns the logits."""
        self.graph.replay()
        launches.advance(self.launches)
        self.replays += 1
        return self.logits

    def __call__(self, token: torch.Tensor, positions: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
        """decode_step(model, token, positions, caches, active)'s logits:
        the arguments are copied into the buffers (host tensors should be
        pinned), then the graph replays."""
        # The buffers are inference tensors when the graph was made under
        # inference mode (a server's step), writable only inside it.
        with torch.inference_mode():
            self.token.copy_(token, non_blocking=True)
            self.positions.copy_(positions, non_blocking=True)
            self.active.copy_(active, non_blocking=True)
        return self.replay()


@torch.inference_mode()
def chunk_step(
    model: Llama,
    piece: torch.Tensor,  # [B, C] int — C new tokens per sequence
    positions: torch.Tensor,  # [C] or [B, C] int — their position indices
    caches: list,
    active: torch.Tensor | None = None,  # [B] bool — continuous batching
) -> tuple[torch.Tensor, list]:
    """Process C new tokens against the caches, appending them: the
    multi-token analogue of decode_step, through K2's chunked mode. Dense or
    paged caches (chunked prefill straight into pages). Inactive rows
    compute but do not advance; their logits are garbage (a row whose cache
    holds fewer than C tokens sees no key at its first positions, and gets
    O = 0 there where the JAX kernel sums its block's V rows).
    Returns (float32 logits [B, C, vocab] for every chunk position, caches)."""
    cfg = model.cfg
    b, c = piece.shape
    x = llama.embed_tokens(model, piece)  # [B, C, H]
    cos, sin = llama.rope_tables(cfg, positions)
    for layer, cache in zip(model.layers, caches):
        xn = llama.rms_norm(x, layer.attn_norm, cfg.norm_eps, cfg.norm_offset)
        q, k, v = llama.qkv(layer, xn, cfg)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)
        _append(cache, k, v, active=active)
        attn = (paged_decode_attention_chunk if isinstance(cache, PagedKVCache)
                else decode_attention_chunk)
        o = attn(q.contiguous(), cache, scale=cfg.attn_scale)  # [B, Hq, C, D]
        o = o.transpose(1, 2).reshape(b, c, cfg.num_heads * cfg.head_dim)
        x = x + llama.proj(o, layer.wo)
        x = x + llama._mlp_block(layer, x, cfg)
    return llama.lm_logits(x, model), caches


def chunked_prefill(
    model: Llama,
    tokens: torch.Tensor,  # [B, S] int
    caches: list,
    chunk: int = 256,
) -> tuple[torch.Tensor, list]:
    """Prefill in fixed chunks through chunk_step: each chunk attends the
    cache so far and itself causally. S must be a multiple of `chunk` (pad
    prompts to the chunk grid). Returns (last-position logits [B, vocab],
    caches)."""
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"prompt length {s} is not a multiple of chunk {chunk}")
    logits = None
    for c0 in range(0, s, chunk):
        positions = torch.arange(c0, c0 + chunk, device=tokens.device)
        logits, caches = chunk_step(model, tokens[:, c0:c0 + chunk], positions, caches)
    return logits[:, -1], caches


@torch.inference_mode()
def generate(
    model: Llama,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int = 32,
    max_len: int | None = None,
    quant: str | None = None,
    sampling: SamplingParams | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Greedy (default) or sampled generation -> [B, max_new_tokens] int32,
    on dense caches (quantized when `quant` is "int8" or "fp8")."""
    b, s = prompt.shape
    if max_len is None:
        max_len = round_up(s + max_new_tokens, 128)
    if sampling is None:
        sampling = SamplingParams(temperature=0.0)
    caches = init_caches(model, b, max_len, quant=quant)
    logits, caches = prefill(model, prompt, caches)
    token = sample(logits, generator, sampling)
    out = [token]
    for i in range(max_new_tokens - 1):
        positions = torch.full((b,), s + i, dtype=torch.int32, device=prompt.device)
        logits, caches = decode_step(model, token, positions, caches)
        token = sample(logits, generator, sampling)
        out.append(token)
    return torch.stack(out, dim=1)
