"""The port's Llama prefill and decode steps against the JAX package's, on the
same weights (the JAX tree converted with params_from_jax) and the same
tokens, in float32 with the flash kernels on their plain/interpret paths.

Tolerance: logits within atol 1e-4, rtol 1e-4 (float32 through two
layers; the packages sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig, check_supported
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

ATOL = RTOL = 1e-4

# The config of tests/test_serve.py, and one that also exercises the plain
# tensor options the port carries (tied head, final soft-cap, norm offset,
# scaled embeddings, GeGLU, a softmax-scale override).
CONFIGS = {
    "llama": dict(vocab_size=128, hidden_size=128, intermediate_size=256,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                  max_seq_len=512),
    "gemma_like": dict(vocab_size=128, hidden_size=128, intermediate_size=256,
                       num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                       max_seq_len=512, tie_embeddings=True,
                       final_logit_softcap=30.0, norm_offset=1.0,
                       scale_embeddings=True, mlp_activation="gelu_tanh",
                       attn_scale=0.2),
}


def make_models(name):
    kw = CONFIGS[name]
    jcfg = JaxConfig(dtype=jnp.float32, **kw)
    tcfg = ModelConfig(dtype=torch.float32, **kw)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    # Perturb the norms so their weights matter to the comparison.
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["final_norm"] = tree["final_norm"] + rng.standard_normal(
        tree["final_norm"].shape, dtype=np.float32) * 0.1
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm"):
            layer[key] = layer[key] + rng.standard_normal(
                layer[key].shape, dtype=np.float32) * 0.1
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = llama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, params, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    jcfg, params, model = make_models(name)
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 20, 128
    prompt = rng.integers(0, jcfg.vocab_size, (b, s), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (3, b), dtype=np.int32)

    jcaches = jax_generate.init_caches(jcfg, b, max_len)
    jlogits, jcaches = jax_generate.prefill(params, jnp.asarray(prompt), jcaches,
                                            jcfg, return_all=True)
    caches = generate.init_caches(model, b, max_len)
    logits, caches = generate.prefill(model, torch.from_numpy(prompt), caches,
                                      return_all=True)
    rep = verify_results(np.asarray(jlogits), logits, atol=ATOL, rtol=RTOL)
    assert rep.passed, f"prefill: {rep}"

    for i in range(3):
        pos = np.full((b,), s + i, np.int32)
        jlogits, jcaches = jax_generate.decode_step(
            params, jnp.asarray(forced[i]), jnp.asarray(pos), jcaches, jcfg)
        logits, caches = generate.decode_step(
            model, torch.from_numpy(forced[i]), torch.from_numpy(pos), caches)
        rep = verify_results(np.asarray(jlogits), logits, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"decode step {i}: {rep}"
    np.testing.assert_array_equal(caches[0].length.numpy(),
                                  np.asarray(jcaches[0].length))


def test_state_dict_names_and_layout_match_jax_tree():
    jcfg, params, model = make_models("llama")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    assert sd["layers.1.wq"].shape == (jcfg.hidden_size,
                                       jcfg.num_heads * jcfg.head_dim)
    assert model.layers[1].w_down.shape == np.asarray(
        params["layers"][1]["w_down"]).shape


def test_params_from_jax_keeps_bf16_values():
    """A bf16 JAX tree (ml_dtypes arrays) converts to bf16 tensors, value
    for value, and loads into a bf16 model."""
    kw = dict(CONFIGS["llama"], num_layers=1)
    params = jax_llama.init_params(JaxConfig(dtype=jnp.bfloat16, **kw),
                                   jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = params_from_jax(tree)
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["layers.0.wq"].float().numpy(),
                                  tree["layers"][0]["wq"].astype(np.float32))
    model = llama.Llama(ModelConfig(dtype=torch.bfloat16, **kw), device="cpu")
    model.load_state_dict(sd)


def test_building_blocks_match_jax():
    cfg_kw = CONFIGS["llama"]
    jcfg = JaxConfig(dtype=jnp.float32, **cfg_kw)
    tcfg = ModelConfig(dtype=torch.float32, **cfg_kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    pos = np.arange(5, dtype=np.int32)
    jcos, jsin = jax_llama.rope_tables(jcfg, jnp.asarray(pos))
    cos, sin = llama.rope_tables(tcfg, torch.from_numpy(pos))
    for ref, out in ((jcos, cos), (jsin, sin)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        llama.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jax_llama.apply_rope(jnp.asarray(x), jcos, jsin)),
        atol=1e-6, rtol=1e-6)
    for offset in (0.0, 1.0):
        np.testing.assert_allclose(
            llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset).numpy(),
            np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)),
            atol=1e-6, rtol=1e-6)


def test_init_params_is_seeded():
    cfg = ModelConfig(dtype=torch.float32, **CONFIGS["llama"])
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = llama.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert torch.equal(a.layers[0].attn_norm, torch.ones(cfg.hidden_size))
    assert abs(float(a.layers[0].wq.detach().std()) - cfg.hidden_size**-0.5) < 0.01


@pytest.mark.parametrize("field,value,item", [
    ("attn_window", 64, "A4 and A5"), ("attn_sink", 4, "A5"),
    ("logit_softcap", 50.0, "A4 and A5"), ("use_alibi", True, "A4 and A5"),
    ("qk_norm", True, "A8"), ("attn_bias", True, "A8"),
    ("use_post_norms", True, "A8"), ("num_experts", 4, "A9"),
    ("rope_scaling", (8.0, 1.0, 4.0, 8192), "A8"),
    ("rope_longrope", ((1.0,), (1.0,), 4096, 1.0), "A8"),
])
def test_unported_config_fields_raise(field, value, item):
    cfg = dataclasses.replace(ModelConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        check_supported(cfg)
