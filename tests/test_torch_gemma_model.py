"""Gemma-2 through the port's model, generation and server (the plain paths
on the CPU) against the JAX package's, on the same weights (carried across
by models/convert.py::params_from_jax, the post-norms included) and tokens:
a tiny config with every Gemma-2 field set (3 layers, D 256, GQA 2/1, an
alternate window of 16, attention soft-cap 50 and final soft-cap 30,
post-norms, GeGLU, norm_offset 1, scaled tied embeddings, attn_scale
256**-0.5), its q projection scaled up so that the logits reach the cap.
The forward's logits against JAX llama.forward; prefill, teacher-forced
decode steps and a chunk step against JAX generate's; the forward against
the port's own teacher-forced decode
(tests/test_softcap.py::test_softcapped_model_train_decode_agree); the
InferenceServer, dense and int8-KV paged with chunked admission, against
the JAX server's greedy tokens; GEMMA2_9B equal to the JAX preset field by
field. Training such a model: tests/test_torch_gemma_train.py.

float32 models. Logits within atol 1e-4, rtol 1e-4 of JAX's
(tests/test_torch_model.py's gate); the forward against the teacher-forced
decode within rtol 2e-4, atol 2e-4 (the JAX test's); greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import config as jax_config
from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import serve as jax_serve
from flashattn_tpu_torch.models import config, generate, llama
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.models.serve import InferenceServer, Request
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
CFG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=3,
              num_heads=2, num_kv_heads=1, head_dim=256, max_seq_len=256, norm_eps=1e-6,
              tie_embeddings=True, attn_window=16, window_pattern="alternate",
              logit_softcap=50.0, final_logit_softcap=30.0, mlp_activation="gelu_tanh",
              use_post_norms=True, scale_embeddings=True, attn_scale=256**-0.5,
              norm_offset=1.0)
Q_GAIN = 12.0  # wq's factor: attention logits to about +-50, where the cap bends


@pytest.fixture(scope="module")
def gemma():
    """The JAX params and config, and the port's model with the same
    weights: norms perturbed so that their weights (the post-norms'
    included) matter, wq scaled by Q_GAIN."""
    jcfg = jax_config.ModelConfig(dtype=jnp.float32, **CFG_KW)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tree["final_norm"] = tree["final_norm"] + rng.standard_normal(
        tree["final_norm"].shape, dtype=np.float32) * 0.1
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
            layer[key] = layer[key] + rng.standard_normal(layer[key].shape,
                                                           dtype=np.float32) * 0.1
        layer["wq"] = layer["wq"] * Q_GAIN
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **CFG_KW), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def test_gemma2_9b_config_matches_jax():
    port = {f.name: getattr(config.GEMMA2_9B, f.name)
            for f in dataclasses.fields(config.GEMMA2_9B) if f.name != "dtype"}
    ref = {f.name: getattr(jax_config.GEMMA2_9B, f.name)
           for f in dataclasses.fields(jax_config.GEMMA2_9B) if f.name != "dtype"}
    assert port == ref
    assert config.GEMMA2_9B.dtype == torch.bfloat16
    config.check_supported(config.GEMMA2_9B)
    assert [llama.layer_window(config.GEMMA2_9B, i) for i in range(4)] == [4096, None] * 2
    # 9.24 B parameters: the tied 256,128 x 3,584 embedding and 42 layers
    model = llama.Llama(config.GEMMA2_9B, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert model.embed.numel() == 256128 * 3584 and round(n / 1e9, 2) == 9.24


def test_post_norms_load_from_the_jax_tree(gemma):
    jcfg, params, model = gemma
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    assert {"layers.2.post_attn_norm", "layers.2.post_mlp_norm"} <= set(sd)
    assert "lm_head" not in sd  # tied
    np.testing.assert_array_equal(model.layers[1].post_mlp_norm.detach().numpy(),
                                  np.asarray(params["layers"][1]["post_mlp_norm"]))
    fresh = llama.init_params(model.cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(fresh.layers[0].post_attn_norm, torch.zeros(128))  # 1 - norm_offset


def test_gemma_forward_matches_jax(gemma):
    """A 40-token prompt, past the local layers' 16-token window."""
    jcfg, params, model = gemma
    tokens = np.random.default_rng(1).integers(0, 128, (2, 40)).astype(np.int32)
    ref = jax_llama.forward(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        out = llama.forward(model, torch.from_numpy(tokens))
    rep = verify_results(np.asarray(ref), out, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep
    # the attention cap bends these logits: without it they move
    free = dataclasses.replace(model.cfg, logit_softcap=None)
    model.cfg, cfg = free, model.cfg
    try:
        with torch.no_grad():
            uncapped = llama.forward(model, torch.from_numpy(tokens))
    finally:
        model.cfg = cfg
    assert not torch.allclose(uncapped, out, atol=1e-3)


def test_gemma_prefill_decode_and_chunk_match_jax(gemma):
    jcfg, params, model = gemma
    rng = np.random.default_rng(2)
    b, s, max_len = 2, 24, 128
    prompt = rng.integers(0, 128, (b, s), dtype=np.int32)
    forced = rng.integers(0, 128, (3, b), dtype=np.int32)
    jcaches = jax_generate.init_caches(jcfg, b, max_len)
    jlogits, jcaches = jax_generate.prefill(params, jnp.asarray(prompt), jcaches, jcfg,
                                            return_all=True)
    caches = generate.init_caches(model, b, max_len)
    logits, caches = generate.prefill(model, torch.from_numpy(prompt), caches, return_all=True)
    rep = verify_results(np.asarray(jlogits), logits, atol=ATOL, rtol=RTOL)
    assert rep.passed, f"prefill: {rep}"
    for i in range(3):
        pos = np.full((b,), s + i, np.int32)
        jlogits, jcaches = jax_generate.decode_step(params, jnp.asarray(forced[i]),
                                                    jnp.asarray(pos), jcaches, jcfg)
        logits, caches = generate.decode_step(model, torch.from_numpy(forced[i]),
                                              torch.from_numpy(pos), caches)
        rep = verify_results(np.asarray(jlogits), logits, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"decode step {i}: {rep}"
    piece = rng.integers(0, 128, (b, 8), dtype=np.int32)
    positions = np.arange(s + 3, s + 11, dtype=np.int32)
    jlogits, _ = jax_generate.chunk_step(params, jnp.asarray(piece), jnp.asarray(positions),
                                         jcaches, jcfg)
    logits, _ = generate.chunk_step(model, torch.from_numpy(piece),
                                    torch.from_numpy(positions), caches)
    rep = verify_results(np.asarray(jlogits), logits, atol=ATOL, rtol=RTOL)
    assert rep.passed, f"chunk step: {rep}"


def test_gemma_forward_matches_decode_steps(gemma):
    """tests/test_softcap.py::test_softcapped_model_train_decode_agree on the
    port: the soft-cap threads through the forward and the decode path
    (a one-token prefill, then teacher-forced steps past the window)."""
    _, _, model = gemma
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (1, 32)).astype(np.int32))
    with torch.no_grad():
        train_logits = llama.forward(model, tokens)
    caches = generate.init_caches(model, 1, 128)
    logits, caches = generate.prefill(model, tokens[:, :1], caches)
    np.testing.assert_allclose(logits.numpy(), train_logits[:, 0].numpy(), rtol=2e-4, atol=2e-4)
    for t in range(1, 32):
        logits, caches = generate.decode_step(model, tokens[:, t],
                                              torch.full((1,), t, dtype=torch.int32), caches)
        np.testing.assert_allclose(logits.numpy(), train_logits[:, t].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"position {t}")


REQS = [  # (uid, prompt, new tokens): prompts past the window, slots recycling
    (1, [(3 + 5 * i) % 128 for i in range(41)], 5),
    (2, [2, 7, 1], 6),
    (3, [(7 * i) % 128 for i in range(70)], 4),
]
OPTIONS = {
    "dense": dict(),
    "int8_kv_paged_admit_chunk": dict(quant="int8", paged=True, page_size=128, num_pages=4,
                                      admit_chunk=32),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_gemma_server_matches_jax(gemma, name):
    jcfg, params, model = gemma
    option = OPTIONS[name]
    jsrv = jax_serve.InferenceServer(params, jcfg, max_slots=2, max_len=256, **option)
    srv = InferenceServer(model, max_slots=2, max_len=256, **option)
    for uid, prompt, n in REQS:
        jsrv.submit(jax_serve.Request(uid=uid, prompt=prompt, max_new_tokens=n))
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    want, got = jsrv.run(), srv.run()
    assert got == want and sorted(got) == [1, 2, 3]
    if srv.paged:
        assert srv.allocator.free_pages == srv.allocator.num_pages
