"""Mixture-of-experts models through the port (the grouped dispatch of
parallel/moe.py in every layer, the other kernels on their plain paths on
the CPU) against the JAX package's (moe_ffn_dense_reference in every
layer, interpret-mode kernels), on the same weights (params_from_jax
carries the nested ``moe`` tree) and tokens: TINY_MOE (Mixtral-style, 4
experts, top 2, D 32) and a Qwen2-MoE-shaped variant (6 experts, top 4,
the full-softmax gates, a sigmoid-gated shared expert, q/k/v biases). The
forward; prefill and 4 teacher-forced decode steps; generate's tokens;
quantize_params, which quantizes the attention projections and the head
and leaves the router and the experts as they were, as the JAX function
does. The servers: tests/test_torch_moe_serve.py; loss_fn's gradients:
tests/test_torch_moe_train.py.

float32 models. Logits within atol/rtol 1e-4 (tests/test_torch_model.py's
gate); greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import config as jax_config
from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu_torch.models import config, generate, llama
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.ops.quant_matmul import QuantizedLinear
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
TINY_MOE_KW = {f.name: getattr(jax_config.TINY_MOE, f.name)
               for f in dataclasses.fields(jax_config.TINY_MOE) if f.name != "dtype"}
CONFIGS = {
    "tiny_moe": TINY_MOE_KW,
    "qwen2_moe_shaped": dict(TINY_MOE_KW, num_experts=6, top_k_experts=4,
                             moe_norm_topk=False, moe_shared_intermediate=192,
                             attn_bias=True),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def moe_models(request):
    """(name, JAX config, JAX params, port model): the JAX init's weights,
    the norms perturbed (and the biases drawn) so that they matter."""
    kw = CONFIGS[request.param]
    jcfg = jax_config.ModelConfig(dtype=jnp.float32, **kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jcfg,
                                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tree["final_norm"] = tree["final_norm"] + rng.standard_normal(
        tree["final_norm"].shape, dtype=np.float32) * 0.1
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
            if key in layer:
                layer[key] = layer[key] + rng.standard_normal(layer[key].shape,
                                                               dtype=np.float32) * 0.1
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return request.param, jcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def test_tiny_moe_config_matches_jax():
    port = {f.name: getattr(config.TINY_MOE, f.name)
            for f in dataclasses.fields(config.TINY_MOE) if f.name != "dtype"}
    assert port == TINY_MOE_KW
    config.check_supported(config.TINY_MOE)


def test_moe_forward_matches_jax(moe_models):
    _, jcfg, params, model = moe_models
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    ref = jax_llama.forward(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        out = llama.forward(model, torch.from_numpy(tokens))
    rep = verify_results(np.asarray(ref), out, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep


def run_both(jcfg, params, model, prompt, forced):
    """Prefill (all positions) then teacher-forced decode steps in both
    packages; the (JAX, port) logits of every call."""
    b, s = prompt.shape
    jcaches = jax_generate.init_caches(jcfg, b, 128)
    caches = generate.init_caches(model, b, 128)
    jl, jcaches = jax_generate.prefill(params, jnp.asarray(prompt), jcaches, jcfg,
                                       return_all=True)
    pl, caches = generate.prefill(model, torch.from_numpy(prompt), caches, return_all=True)
    out = [(jl, pl)]
    for i, tok in enumerate(forced):
        pos = np.full((b,), s + i, np.int32)
        jl, jcaches = jax_generate.decode_step(params, jnp.asarray(tok), jnp.asarray(pos),
                                               jcaches, jcfg)
        pl, caches = generate.decode_step(model, torch.from_numpy(tok),
                                          torch.from_numpy(pos), caches)
        out.append((jl, pl))
    return out


def test_moe_prefill_and_decode_match_jax(moe_models):
    _, jcfg, params, model = moe_models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (4, 2), dtype=np.int32)
    for i, (ref, got) in enumerate(run_both(jcfg, params, model, prompt, forced)):
        rep = verify_results(np.asarray(ref), got, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"call {i}: {rep}"


def test_moe_generate_matches_jax(moe_models):
    _, jcfg, params, model = moe_models
    prompt = np.asarray([[1, 2, 3], [7, 11, 13]], np.int32)
    want = jax_generate.generate(params, jnp.asarray(prompt), jcfg, max_new_tokens=8,
                                 max_len=128)
    got = generate.generate(model, torch.from_numpy(prompt), max_new_tokens=8, max_len=128)
    assert got.tolist() == np.asarray(want).tolist()


def test_moe_quantize_params_leaves_experts(moe_models):
    """int8 weights: the state dict equals the JAX quantize_params' tree
    byte for byte; the attention projections and the head are quantized,
    the router and the experts (the shared one too) keep their values;
    prefill and decode against the JAX quantized model."""
    _, jcfg, params, model = moe_models
    model = llama.Llama(model.cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    before = {k: v.clone() for k, v in model.state_dict().items() if ".moe." in k}
    qparams = jax_llama.quantize_params(params, 8)
    llama.quantize_params(model, 8)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    ours = model.state_dict()
    assert set(sd) == set(ours)
    for name, value in sd.items():
        assert torch.equal(ours[name], value), name
    assert all(torch.equal(ours[k], v) for k, v in before.items()) and before
    layer = model.layers[0]
    assert isinstance(layer.wq, QuantizedLinear) and isinstance(model.lm_head, QuantizedLinear)
    assert not any(isinstance(m, QuantizedLinear) for m in layer.moe.modules())
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (2, 2), dtype=np.int32)
    for i, (ref, got) in enumerate(run_both(jcfg, qparams, model, prompt, forced)):
        rep = verify_results(np.asarray(ref), got, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"call {i}: {rep}"
