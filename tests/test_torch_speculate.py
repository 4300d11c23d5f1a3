"""Speculative decoding and sampling in the port (models/speculate.py,
models/sampling.py) on the CPU, mirroring tests/test_speculate.py and
tests/test_sampling.py.

Greedy speculation must reproduce the target's greedy generation token for
token, with a perfect draft (the target itself: acceptance 1.0), with a
disagreeing one and on paged caches, and must equal the JAX package's
speculative_generate on the same weights (params_from_jax). spec_accept
must emit tokens distributed as the target's distribution whatever the
draft's: a Monte-Carlo total-variation distance under 0.02 over 20,000
draws from a fixed torch.Generator (the JAX test's bound; the JAX random
stream is not reproduced, so sampling is held in distribution).
transformed_probs matches the JAX function within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import sampling as jax_sampling
from flashattn_tpu.models import speculate as jax_speculate
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.models.sampling import SamplingParams, sample, transformed_probs
from flashattn_tpu_torch.models.speculate import spec_accept, speculative_generate

torch.set_num_threads(1)

KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
          num_kv_heads=2, head_dim=32, max_seq_len=256)
CFG = ModelConfig(dtype=torch.float32, **KW)
DRAFT_CFG = dataclasses.replace(CFG, num_layers=1)


def model(cfg=CFG, seed=0):
    return llama.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def greedy_oracle(target, prompt, n):
    return generate.generate(target, prompt, max_new_tokens=n, max_len=256)[0].tolist()


def test_speculate_with_perfect_draft():
    target = model()
    prompt = torch.tensor([[5, 9, 42, 7]])
    got, rate = speculative_generate(target, target, prompt, max_new_tokens=12, k=4)
    assert got[0].tolist() == greedy_oracle(target, prompt, 12)
    assert rate == 1.0  # the draft IS the target


def test_speculate_with_disagreeing_draft():
    target, draft = model(), model(DRAFT_CFG, seed=99)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    got, rate = speculative_generate(target, draft, prompt, max_new_tokens=16, k=4)
    assert got[0].tolist() == greedy_oracle(target, prompt, 16), (rate, got)
    assert 0.0 <= rate < 1.0


@pytest.mark.parametrize("draft_seed", [0, 99])
def test_speculate_paged_backend(draft_seed):
    """Paged caches for target and draft (the rollback resets lengths and
    keeps the pages), the perfect and the disagreeing draft."""
    target = model()
    draft = target if draft_seed == 0 else model(DRAFT_CFG, seed=draft_seed)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    got, rate = speculative_generate(target, draft, prompt, max_new_tokens=16, k=4,
                                     paged=True, page_size=128)
    assert got[0].tolist() == greedy_oracle(target, prompt, 16), (rate, got)
    assert (rate == 1.0) == (draft is target)


def test_spec_accept_preserves_target_distribution():
    """Tokens emitted by the accept/reject core are distributed as the
    target p whatever the draft q (k = 1, Monte Carlo)."""
    v = 6
    p = np.asarray([0.30, 0.25, 0.20, 0.15, 0.07, 0.03])
    q = np.asarray([0.05, 0.10, 0.40, 0.05, 0.25, 0.15])  # a very wrong draft
    p_probs, q_probs = np.stack([p, p]), q[None]
    n = 20000
    gen = torch.Generator().manual_seed(123)
    drafts = torch.multinomial(torch.from_numpy(q).expand(n, v), 1,
                               generator=torch.Generator().manual_seed(7))[:, 0].tolist()
    counts = np.zeros(v)
    for x in drafts:
        n_acc, nxt = spec_accept(p_probs, q_probs, [x], gen)
        counts[x if n_acc == 1 else nxt] += 1
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert tv < 0.02, (tv, counts / n, p)


def test_spec_accept_residual_and_bonus():
    """A draft of probability 0 under q is rejected and never re-drawn
    where the residual has no mass; full acceptance draws the bonus from
    p_k."""
    gen = torch.Generator().manual_seed(0)
    p = np.asarray([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert spec_accept(p, np.asarray([[1.0, 0.0, 0.0]]), [1], gen) == (0, 1)
    assert spec_accept(p, np.asarray([[0.0, 1.0, 0.0]]), [1], gen) == (1, 2)


def test_speculate_sampled_runs_and_is_deterministic():
    """Sampled speculation: valid tokens, the same for the same generator
    seed, and not the greedy tokens at a high temperature."""
    target, draft = model(), model(DRAFT_CFG, seed=99)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    sp = SamplingParams(temperature=1.2, top_k=24)
    a, _ = speculative_generate(target, draft, prompt, max_new_tokens=10, k=3, sampling=sp,
                                generator=torch.Generator().manual_seed(5))
    b, _ = speculative_generate(target, draft, prompt, max_new_tokens=10, k=3, sampling=sp,
                                generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert all(0 <= t < CFG.vocab_size for t in a[0].tolist())
    assert a[0].tolist() != greedy_oracle(target, prompt, 10)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_speculation_matches_jax(paged):
    """The port's greedy speculative_generate and the JAX package's on the
    same target and draft weights: the same tokens and acceptance rate."""
    jcfg = JaxConfig(dtype=jnp.float32, **KW)
    jdraft_cfg = dataclasses.replace(jcfg, num_layers=1)
    jt = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    jd = jax_llama.init_params(jdraft_cfg, jax.random.PRNGKey(99))
    target, draft = llama.Llama(CFG, device="cpu"), llama.Llama(DRAFT_CFG, device="cpu")
    target.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt)))
    draft.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jd)))
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    want, want_rate = jax_speculate.speculative_generate(
        jt, jcfg, jd, jdraft_cfg, jnp.asarray(prompt), max_new_tokens=16, k=4, paged=paged)
    got, rate = speculative_generate(target, draft, torch.from_numpy(prompt),
                                     max_new_tokens=16, k=4, paged=paged)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    assert rate == pytest.approx(want_rate)


@pytest.mark.parametrize("params", [SamplingParams(temperature=0.7),
                                    SamplingParams(temperature=1.2, top_k=5),
                                    SamplingParams(temperature=1.0, top_p=0.8),
                                    SamplingParams(temperature=0.9, top_k=20, top_p=0.9)])
def test_transformed_probs_matches_jax(params):
    logits = np.random.default_rng(0).standard_normal((3, 4, 50), dtype=np.float32) * 3
    want = jax_sampling.transformed_probs(jnp.asarray(logits), jax_sampling.SamplingParams(
        params.temperature, params.top_k, params.top_p))
    got = transformed_probs(torch.from_numpy(logits), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="greedy"):
        transformed_probs(torch.from_numpy(logits), SamplingParams(temperature=0.0))


# ---- tests/test_sampling.py ----


def logits_fixture():
    return torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.04, 0.01]]))


def test_temperature_zero_is_greedy():
    assert int(sample(logits_fixture(), None, SamplingParams(temperature=0.0))[0]) == 0


def test_top_k_masks_support():
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(5)
    for _ in range(200):
        counts[int(sample(logits_fixture(), gen, SamplingParams(top_k=2))[0])] += 1
    assert counts[2:].sum() == 0 and counts[:2].all()


def test_top_p_masks_tail():
    """Keep the smallest prefix whose mass reaches top_p (the crossing token
    included): p = 0.6 keeps {0.5, 0.3}, renormalised about 5:3."""
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(5)
    for _ in range(300):
        counts[int(sample(logits_fixture(), gen, SamplingParams(top_p=0.6))[0])] += 1
    assert counts[2:].sum() == 0 and counts[0] > 0 and counts[1] > 0
    assert 0.4 < counts[0] / max(counts[1], 1) / (0.5 / 0.3) < 2.5


def test_sampled_generation_deterministic_and_diverse():
    cfg = dataclasses.replace(CFG, num_layers=1, max_seq_len=128)
    m = model(cfg)
    prompt = torch.tensor([[1, 2, 3]])
    sp = SamplingParams(temperature=1.0, top_p=0.95)

    def run(seed):
        return generate.generate(m, prompt, max_new_tokens=8, sampling=sp,
                                 generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))  # another seed, other draws (w.h.p.)
