"""Hugging Face checkpoints into the port (models/convert.py), against
transformers and against the JAX package, in float32 on the CPU.

The families of tests/test_hf_parity.py (ten, and its three
mixture-of-experts cases: Mixtral, Qwen3-MoE with both routing conventions
and Qwen2-MoE with its shared expert), each a tiny random transformers
model: its weights through config_from_hf and params_from_hf into the
port (experts stacked; the Qwen MoE families' expert width from
moe_intermediate_size), whose logits must match transformers' at rtol/atol 2e-3
(the JAX test's tolerance) and the JAX llama.forward's on the JAX
package's conversion of the same weights at 1e-4 (tests/test_torch_model.py's
tolerance; the two conversions are equal bit for bit); where the JAX test
generates, the port's greedy tokens must equal transformers'. The loader
and the command line: tests/test_torch_hf_loader.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import convert as jax_convert
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu_torch.models import convert, generate, llama

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

HF_TOL = dict(rtol=2e-3, atol=2e-3)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
HALF = 16  # longrope factors: head_dim 32
# One compile a family (the config is static) instead of one a primitive.
JAX_FORWARD = jax.jit(jax_llama.forward, static_argnums=2)


def _base(**kw):
    cfg = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
               rms_norm_eps=1e-5, attn_implementation="eager")
    cfg.update(kw)
    return cfg


# family -> (config class, model class, config fields, seed, [token shapes],
# greedy-generation prompt and count, or None): the settings of
# tests/test_hf_parity.py's tests, every input [2, 48] (past Mistral's
# 24-token window and llama3's 32-token original context) so the JAX side
# compiles few shapes; longrope also at [2, 96], past its 64.
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              _base(rope_theta=10000.0, tie_word_embeddings=False), 42, [(2, 48)],
              ([[7, 3, 99, 21, 5]], 8)),
    "mistral_window": ("MistralConfig", "MistralForCausalLM",
                       _base(rope_theta=10000.0, sliding_window=24, tie_word_embeddings=False),
                       7, [(2, 48)], None),
    "qwen2_bias": ("Qwen2Config", "Qwen2ForCausalLM",
                   _base(rope_theta=10000.0, tie_word_embeddings=False,
                         use_sliding_window=False), 11, [(2, 48)], ("first8", 8)),
    "phi3_fused": ("Phi3Config", "Phi3ForCausalLM",
                   _base(rope_theta=10000.0, tie_word_embeddings=False, sliding_window=None,
                         pad_token_id=0), 13, [(2, 48)], None),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               _base(num_hidden_layers=4, head_dim=48, query_pre_attn_scalar=48,
                     rms_norm_eps=1e-6, sliding_window=16, attn_logit_softcapping=50.0,
                     final_logit_softcapping=30.0), 7, [(2, 48)],
               ([[7, 3, 99, 21, 5]], 24)),
    "gemma1": ("GemmaConfig", "GemmaForCausalLM", _base(head_dim=48, rms_norm_eps=1e-6),
               29, [(2, 48)], ([[7, 3, 99, 21, 5]], 8)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              _base(head_dim=48, rms_norm_eps=1e-6, tie_word_embeddings=False), 11, [(2, 48)],
              ([[7, 3, 99, 21, 5]], 8)),
    "llama3_rope": ("LlamaConfig", "LlamaForCausalLM",
                    _base(rope_theta=10000.0, tie_word_embeddings=False, rope_scaling={
                        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                        "high_freq_factor": 4.0, "original_max_position_embeddings": 32}),
                    17, [(2, 48)], ("first40", 8)),
    "phi3_longrope": ("Phi3Config", "Phi3ForCausalLM",
                      _base(original_max_position_embeddings=64, rope_theta=10000.0,
                            rope_scaling={"type": "longrope",
                                          "short_factor": [1.0 + 0.02 * i for i in range(HALF)],
                                          "long_factor": [2.0 + 0.25 * i for i in range(HALF)]},
                            tie_word_embeddings=False, sliding_window=None, pad_token_id=0),
                      23, [(2, 48), (2, 96)], None),  # both sides of the 64 boundary
    # tests/test_hf_parity.py's mixture-of-experts cases: Mixtral's
    # block_sparse_moe experts, Qwen3-MoE's mlp.experts under both routing
    # conventions, Qwen2-MoE's shared expert and biases.
    "mixtral_moe": ("MixtralConfig", "MixtralForCausalLM",
                    _base(num_local_experts=4, num_experts_per_tok=2, rope_theta=10000.0,
                          sliding_window=None, tie_word_embeddings=False), 31, [(2, 48)],
                    ([[7, 3, 99, 21, 5]], 8)),
    "qwen3_moe_norm_topk": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                            _base(moe_intermediate_size=192, head_dim=48, num_experts=4,
                                  num_experts_per_tok=2, norm_topk_prob=True,
                                  rms_norm_eps=1e-6, tie_word_embeddings=False),
                            37, [(2, 48)], None),
    "qwen3_moe_full_softmax": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                               _base(moe_intermediate_size=192, head_dim=48, num_experts=4,
                                     num_experts_per_tok=2, norm_topk_prob=False,
                                     rms_norm_eps=1e-6, tie_word_embeddings=False),
                               37, [(2, 48)], None),
    "qwen2_moe_shared": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM",
                         _base(moe_intermediate_size=192, shared_expert_intermediate_size=224,
                               num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
                               decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
                               tie_word_embeddings=False, use_sliding_window=False),
                         41, [(2, 48)], None),
}
# The tenth case of tests/test_hf_parity.py, the Llama model's greedy
# generation, is "llama"'s case of the generation test.


def hf_model(family):
    cfg_cls, model_cls, fields, seed, _, _ = FAMILIES[family]
    hf_cfg = getattr(transformers, cfg_cls)(**fields)
    torch.manual_seed(seed)
    return getattr(transformers, model_cls)(hf_cfg).eval(), hf_cfg


def port_model(model, hf_cfg):
    cfg = convert.config_from_hf(hf_cfg, dtype=torch.float32)
    if hf_cfg.model_type == "mistral":  # set on the converted config, as the JAX test does
        cfg = dataclasses.replace(cfg, attn_window=24)
    return convert.llama_from_state_dict(cfg, convert.params_from_hf(model.state_dict(), cfg)), cfg


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_family_logits_match_transformers_and_jax(family):
    model, hf_cfg = hf_model(family)
    port, cfg = port_model(model, hf_cfg)
    jcfg = jax_convert.config_from_hf(hf_cfg, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, attn_window=cfg.attn_window)
    jparams = jax_convert.params_from_hf(model.state_dict(), jcfg)
    # The same converted weights on both sides, bit for bit (a MoE layer's
    # experts stacked alike).
    ours = port.state_dict()
    leaves = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(leaves) == set(ours)
    for name, value in leaves.items():
        np.testing.assert_array_equal(ours[name].numpy(), value.numpy(), err_msg=name)

    rng = np.random.default_rng(FAMILIES[family][3])
    for shape in FAMILIES[family][4]:
        tokens = rng.integers(0, hf_cfg.vocab_size, size=shape)
        with torch.no_grad():
            want = model(torch.from_numpy(tokens)).logits.numpy()
            got = llama.forward(port, torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(got, want, **HF_TOL)
        ref = np.asarray(JAX_FORWARD(jparams, jnp.asarray(tokens, jnp.int32), jcfg))
        np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("family", sorted(f for f, v in FAMILIES.items() if v[5]))
def test_hf_family_greedy_generation_matches_transformers(family):
    model, hf_cfg = hf_model(family)
    port, _ = port_model(model, hf_cfg)
    prompt, n = FAMILIES[family][5]
    if isinstance(prompt, str):  # the first tokens of the family's logits input
        tokens = np.random.default_rng(FAMILIES[family][3]).integers(
            0, hf_cfg.vocab_size, size=FAMILIES[family][4][0])
        prompt = tokens[:, :int(prompt[5:])]
    prompt = torch.as_tensor(np.asarray(prompt))
    with torch.no_grad():
        hf_out = model.generate(prompt, max_new_tokens=n, do_sample=False, pad_token_id=0,
                                eos_token_id=-1)
    ours = generate.generate(port, prompt, max_new_tokens=n, max_len=256)
    assert ours[0].tolist() == hf_out[0, prompt.shape[1]:].tolist()
