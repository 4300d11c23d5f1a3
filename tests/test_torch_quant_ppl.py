"""The quantized-KV and quantized-weight quality gate of the JAX package
(tests/test_quant_ppl.py; BASELINE.json's north star: FP8-KV decode within
0.1 ppl of bf16) on the port, with that test's config (vocab 128, hidden
128, 2 layers, 4 heads over 2 KV heads, head dim 32, float32), steps,
learning rate and gates.

The model starts from the JAX package's initial parameters (carried across
by params_from_jax) and trains 60 AdamW steps with the port's
train.train_step on the JAX test's tokens, to the sharp next-token
distributions of memorisation, where quantization error in the KV cache or
the weights moves the loss. Perplexity then runs through the port's decode
path (utils/perplexity.decode_ppl: prefill on the first token, one
decode_step a token) on the plain route here, as the card runs it through
K1, K2 and qmm8/qmm4 (chip_smoke.py phase 23). The gates are the JAX
test's: decode within 5 % + 0.05 of the training forward's perplexity, fp8
and int8 caches within 0.1, int8 weights within 0.1, int4 weights within
1.0; the fp8 and int8 caches also within 0.1 of a bf16 cache under the
trained weights cast to bf16 (the north star's wording).

The port's decode_ppl against the JAX package's on the same parameters:
tests/test_torch_quant_ppl_parity.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import generate, llama, train
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.perplexity import decode_ppl, train_ppl

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128)
JCFG = JaxConfig(dtype=jnp.float32, **CFG_KW)
CFG = ModelConfig(dtype=torch.float32, **CFG_KW)
TC = train.TrainConfig(learning_rate=2e-3, warmup_steps=2, total_steps=80)
STEPS = 60


def jax_init():
    return jax_llama.init_params(JCFG, jax.random.PRNGKey(0))


def jax_tokens(s: int = 65) -> np.ndarray:
    """The JAX test's tokens: [2, 65] int32 from PRNGKey(1)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, s), 0, CFG.vocab_size,
                                         jnp.int32))


def port_model(params, cfg: ModelConfig = CFG) -> llama.Llama:
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def quantized(model: llama.Llama, bits: int) -> llama.Llama:
    """A weight-only quantized copy (quantize_params works in place)."""
    copy = llama.Llama(model.cfg, device="cpu")
    copy.load_state_dict(model.state_dict())
    return llama.quantize_params(copy, bits=bits)


@pytest.fixture(scope="module")
def trained():
    model = port_model(jax_init())
    tokens = torch.from_numpy(jax_tokens().copy())
    state = train.init_train_state(model, TC)
    for _ in range(STEPS):
        state, m = train.train_step(state, tokens)
    assert float(m["loss"]) < 1.0, float(m["loss"])
    return model, tokens


@pytest.fixture(scope="module")
def ppl_full(trained):
    model, tokens = trained
    return decode_ppl(model, tokens)


def test_decode_path_matches_training_forward(trained, ppl_full):
    """The float32-cache decode perplexity agrees with the training
    forward's."""
    model, tokens = trained
    ppl_train = train_ppl(model, tokens)
    assert abs(ppl_full - ppl_train) < 0.05 * ppl_train + 0.05, (ppl_train, ppl_full)


@pytest.mark.parametrize("quant,budget", [("fp8", 0.1), ("int8", 0.1)])
def test_quantized_kv_ppl_gate(trained, ppl_full, quant, budget):
    model, tokens = trained
    ppl_q = decode_ppl(model, tokens, quant=quant)
    assert abs(ppl_q - ppl_full) < budget, (quant, ppl_full, ppl_q)


@pytest.mark.parametrize("quant,budget", [("fp8", 0.1), ("int8", 0.1)])
def test_quantized_kv_ppl_gate_against_bf16(trained, quant, budget):
    """The north star's wording: the trained weights cast to bf16, the fp8
    and int8 caches against a bf16 cache."""
    model, tokens = trained
    bf16 = llama.Llama(dataclasses.replace(CFG, dtype=torch.bfloat16), device="cpu")
    bf16.load_state_dict(model.state_dict())
    ppl_bf16 = decode_ppl(bf16, tokens)
    ppl_q = decode_ppl(bf16, tokens, quant=quant)
    assert abs(ppl_q - ppl_bf16) < budget, (quant, ppl_bf16, ppl_q)


@pytest.mark.parametrize("bits,budget", [(8, 0.1), (4, 1.0)])
def test_weight_only_quant_ppl(trained, ppl_full, bits, budget):
    """Weight-only int8/int4 projections through the decode path: int8
    within the KV gates' 0.1, int4 within the JAX test's looser 1.0."""
    model, tokens = trained
    ppl_q = decode_ppl(quantized(model, bits), tokens)
    assert abs(ppl_q - ppl_full) < budget, (bits, ppl_full, ppl_q)


def test_weight_quant_plus_kv_quant_generation(trained):
    """int8 weights and an int8 KV cache together through generate."""
    model, tokens = trained
    out = generate.generate(quantized(model, 8), tokens[:1, :8], max_new_tokens=8, max_len=128,
                            quant="int8")
    assert out.shape == (1, 8)
    assert bool(((out >= 0) & (out < CFG.vocab_size)).all())
