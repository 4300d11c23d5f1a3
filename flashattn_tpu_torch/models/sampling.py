"""Token sampling: temperature / top-k / top-p (counterpart of
flashattn_tpu/models/sampling.py). Randomness comes from an explicit
torch.Generator, so a draw is reproducible from its generator's seed."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0  # 0 = greedy
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1 = off


def sample(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None,
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """Sample token ids [B] (int32) from logits under the given params.

    Greedy (temperature 0) needs no generator; otherwise the generator must
    live on the logits' device."""
    if params.temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = transformed_probs(logits, params)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def transformed_probs(
    logits: torch.Tensor,  # [..., V] float32
    params: SamplingParams = SamplingParams(),
) -> torch.Tensor:
    """The distribution `sample` draws from: the softmax after the
    temperature, top-k and top-p transforms (masked entries are 0).
    Speculative sampling needs these probabilities for both models."""
    if params.temperature <= 0.0:
        raise ValueError("greedy sampling (temperature 0) has no distribution")
    logits = logits / params.temperature
    if params.top_k:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with mass >= top_p (the first token is
        # always kept); cutoff = logit of the last kept sorted position.
        keep = cum - probs < params.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return torch.softmax(logits, dim=-1)
