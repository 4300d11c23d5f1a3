"""Prefill + decode generation (counterpart of flashattn_tpu/models/generate.py).

Prefill runs the prompt through the flash forward (K1) and fills the
caches; each decode step appends one token per sequence and attends the
cache through flash-decode (K2). Dense caches only. The caches are updated
in place (ops/kvcache.py); the functions return them as the JAX ones do.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.llama import Llama
from flashattn_tpu_torch.models.sampling import SamplingParams, sample
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.common import round_up
from flashattn_tpu_torch.ops.decode import decode_attention
from flashattn_tpu_torch.ops.kvcache import KVCache, init_cache, update_cache


def init_caches(model: Llama, batch: int, max_len: int,
                quant: str | None = None) -> list[KVCache]:
    cfg = model.cfg
    return [
        init_cache(batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                   dtype=cfg.dtype, quant=quant, device=model.device)
        for _ in range(cfg.num_layers)
    ]


@torch.inference_mode()
def prefill(
    model: Llama,
    tokens: torch.Tensor,  # [B, S] int
    caches: list[KVCache],
    return_all: bool = False,
) -> tuple[torch.Tensor, list[KVCache]]:
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
        update_cache(cache, k, v, assume_fits=True)
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
    caches: list[KVCache],
    active: torch.Tensor | None = None,  # [B] bool — continuous batching
) -> tuple[torch.Tensor, list[KVCache]]:
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
        update_cache(cache, k, v, active=active)
        o = decode_attention(q[:, :, 0], cache, scale=cfg.attn_scale)  # [B, Hq, D]
        x = x + llama.proj(o.reshape(b, cfg.num_heads * cfg.head_dim), layer.wo)
        x = x + llama._mlp_block(layer, x, cfg)
    return llama.lm_logits(x, model), caches


@torch.inference_mode()
def generate(
    model: Llama,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int = 32,
    max_len: int | None = None,
    sampling: SamplingParams | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Greedy (default) or sampled generation -> [B, max_new_tokens] int32."""
    b, s = prompt.shape
    if max_len is None:
        max_len = round_up(s + max_new_tokens, 128)
    if sampling is None:
        sampling = SamplingParams(temperature=0.0)
    caches = init_caches(model, b, max_len)
    logits, caches = prefill(model, prompt, caches)
    token = sample(logits, generator, sampling)
    out = [token]
    for i in range(max_new_tokens - 1):
        positions = torch.full((b,), s + i, dtype=torch.int32, device=prompt.device)
        logits, caches = decode_step(model, token, positions, caches)
        token = sample(logits, generator, sampling)
        out.append(token)
    return torch.stack(out, dim=1)
