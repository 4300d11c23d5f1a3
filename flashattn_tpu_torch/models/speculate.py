"""Speculative decoding (counterpart of flashattn_tpu/models/speculate.py).

A draft model proposes k tokens; the target verifies the anchor token and
the k drafts in ONE chunk_step, the chunked mode of the decode kernel (K2 at
T = k + 1), instead of k + 1 decode steps. A rejected suffix rolls back by
resetting the caches' per-sequence ``length`` in place: what lies past a
length is dead by construction, so a rollback writes one int a layer and,
on paged caches, releases no page. Greedy acceptance reproduces the
target's greedy generation token for token; with ``sampling`` the
Leviathan accept/reject scheme (``spec_accept``) emits tokens distributed
exactly as sampling from the target.

One sequence a call (B = 1), as in the JAX package: acceptance lengths
depend on the data, so batching speculation is a scheduler's concern.
Randomness comes from an explicit torch.Generator (the JAX package's
``jax.random`` stream cannot be reproduced, so a sampled run matches the
JAX one in distribution, not token for token).
"""

from __future__ import annotations

import numpy as np
import torch

from flashattn_tpu_torch.models import generate
from flashattn_tpu_torch.models.llama import Llama
from flashattn_tpu_torch.models.sampling import SamplingParams, sample, transformed_probs
from flashattn_tpu_torch.ops.common import round_up
from flashattn_tpu_torch.ops.paged import init_paged_cache, set_block_table


def _rollback(caches: list, length: int) -> list:
    """Every cache's length set to `length`, in place (dense or paged; a
    paged cache keeps its pages)."""
    for cache in caches:
        cache.length.fill_(length)
    return caches


def _float64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _uniform(generator: torch.Generator) -> float:
    """One draw from U[0, 1) on the generator's device."""
    return float(torch.rand((), generator=generator, dtype=torch.float64,
                            device=generator.device))


def _choice(dist: np.ndarray, generator: torch.Generator) -> int:
    """An index drawn from the distribution `dist` (inverse CDF of one
    uniform draw); an entry of probability 0 is never drawn."""
    cum = np.cumsum(dist)
    idx = int(np.searchsorted(cum, _uniform(generator) * cum[-1], side="right"))
    return min(idx, int(np.flatnonzero(dist)[-1]))


def spec_accept(p_probs, q_probs, drafts, generator: torch.Generator) -> tuple[int, int]:
    """Leviathan et al.'s speculative-sampling accept/reject, host math in
    float64.

    p_probs [k+1, V]: the target's distribution at each verified position;
    q_probs [k, V]: the draft distribution each proposal was drawn from;
    drafts [k]: the proposed tokens. Returns (n_accepted, next_token):
    draft i is accepted with probability min(1, p_i(x_i) / q_i(x_i)); at the
    first rejection the replacement is drawn from the residual
    norm(max(0, p_i - q_i)); on full acceptance the bonus token comes from
    p_k. The emitted sequence is distributed exactly as sampling from the
    target. The draws come from `generator`, in order: one uniform a
    draft examined, then one for the token drawn."""
    p, q = _float64(p_probs), _float64(q_probs)
    k = len(drafts)
    for i in range(k):
        x = int(drafts[i])
        if q[i, x] > 0 and _uniform(generator) < min(1.0, p[i, x] / q[i, x]):
            continue
        resid = np.clip(p[i] - q[i], 0.0, None)
        z = resid.sum()
        dist = resid / z if z > 0 else p[i] / p[i].sum()
        return i, _choice(dist, generator)
    return k, _choice(p[k] / p[k].sum(), generator)


def _paged_caches(model: Llama, max_len: int, page_size: int) -> list:
    """One sequence's paged caches, its table the pool's pages in order."""
    cfg = model.cfg
    pages = max_len // page_size
    table = torch.arange(pages, dtype=torch.int32)
    return [set_block_table(init_paged_cache(1, cfg.num_kv_heads, pages, page_size,
                                             cfg.head_dim, pages, dtype=cfg.dtype,
                                             device=model.device), 0, table, 0)
            for _ in range(cfg.num_layers)]


@torch.inference_mode()
def speculative_generate(
    target: Llama,
    draft: Llama,
    prompt: torch.Tensor,  # [1, S] int
    max_new_tokens: int = 32,
    k: int = 4,
    max_len: int | None = None,
    paged: bool = False,
    page_size: int = 128,
    sampling: SamplingParams | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, float]:
    """Speculative decoding of one sequence -> ([1, max_new_tokens] int32
    tokens, the draft's acceptance rate).

    Greedy (sampling None or temperature 0): the tokens equal the target's
    greedy generation. Sampled: the drafts are drawn from the draft's
    distribution and accepted with probability min(1, p / q) (spec_accept),
    every draw from `generator` (on the models' device; seeded 0 when
    None), so one seed gives one output. Each round: the draft proposes
    k tokens by decode_step, the target scores the anchor and the drafts
    in one chunk_step (T = k + 1), both caches roll back to the accepted
    frontier, and the accepted piece is re-ingested into the draft by one
    chunk_step (on full acceptance the last draft's K/V was never
    appended). paged=True runs both models on paged caches of `page_size`
    pages."""
    b, s = prompt.shape
    if b != 1:
        raise ValueError(f"speculation runs one sequence a call, got a batch of {b}")
    if target.device != draft.device:
        raise ValueError(f"target on {target.device}, draft on {draft.device}")
    device = target.device
    sampled = sampling is not None and sampling.temperature > 0.0
    if sampled and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if max_len is None:
        max_len = round_up(s + max_new_tokens + k + 1, 128)
    if paged:
        max_len = round_up(max_len, page_size)
        t_caches = _paged_caches(target, max_len, page_size)
        d_caches = _paged_caches(draft, max_len, page_size)
    else:
        t_caches = generate.init_caches(target, 1, max_len)
        d_caches = generate.init_caches(draft, 1, max_len)
    prompt = prompt.to(device)
    t_logits, t_caches = generate.prefill(target, prompt, t_caches)
    _, d_caches = generate.prefill(draft, prompt, d_caches)

    def pick(logits: torch.Tensor) -> int:  # one [V] row
        if sampled:
            return int(sample(logits[None], generator, sampling)[0])
        return int(logits.argmax())

    token = pick(t_logits[0])  # the anchor: the target's next token
    out = [token]
    pos = s  # the anchor's position
    proposed = accepted = 0
    while len(out) < max_new_tokens:
        k_now = min(k, max_new_tokens - len(out))
        drafts, q_rows = [], []
        d_tok = token
        for i in range(k_now):
            d_logits, d_caches = generate.decode_step(
                draft, torch.tensor([d_tok], dtype=torch.int32, device=device),
                torch.tensor([pos + i], dtype=torch.int32, device=device), d_caches)
            d_tok = pick(d_logits[0])
            if sampled:
                q_rows.append(transformed_probs(d_logits[0], sampling))
            drafts.append(d_tok)
        piece = torch.tensor([[token] + drafts], dtype=torch.int32, device=device)
        positions = torch.arange(pos, pos + k_now + 1, dtype=torch.int32, device=device)
        v_logits, t_caches = generate.chunk_step(target, piece, positions, t_caches)
        if sampled:
            n_acc, nxt = spec_accept(transformed_probs(v_logits[0], sampling),
                                     torch.stack(q_rows), drafts, generator)
        else:
            # greedy[i]: the target's next token after piece[:, :i + 1].
            greedy = v_logits[0].argmax(dim=-1).tolist()
            n_acc = 0
            while n_acc < k_now and drafts[n_acc] == greedy[n_acc]:
                n_acc += 1
            nxt = greedy[n_acc]
        proposed += k_now
        accepted += n_acc
        out.extend(drafts[:n_acc] + [nxt])
        # The target appended positions pos..pos + k_now: keep the anchor and
        # the accepted drafts. The draft appended the anchor and
        # drafts[:k_now - 1]: roll it back to pos and append the accepted piece.
        _rollback(t_caches, pos + n_acc + 1)
        _rollback(d_caches, pos)
        generate.chunk_step(draft, piece[:, :n_acc + 1], positions[:n_acc + 1], d_caches)
        token = out[-1]
        pos += n_acc + 1
    rate = accepted / proposed if proposed else 0.0
    return torch.tensor([out[:max_new_tokens]], dtype=torch.int32, device=device), rate
