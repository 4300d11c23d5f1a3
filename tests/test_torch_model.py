"""The port's Llama prefill and decode steps against the JAX package's, on the
same weights (the JAX tree converted with params_from_jax) and the same
tokens, in float32 with the flash kernels on their plain/interpret paths.

Tolerance: logits within atol 1e-4, rtol 1e-4 (float32 through two
layers; the packages sum in different orders), also with int8/int4 weights
(the same quantized values on both sides); atol 2e-3, rtol 2e-3 with an
int8/fp8 KV cache (K2's quantized-mode parity, tests/test_torch_decode.py,
carried through two layers). Quantized weights convert bit for bit."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu.ops import paged as jax_paged
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig, check_supported
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.ops import attention, paged
from flashattn_tpu_torch.parallel import moe
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

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


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_alibi_under_grad_raises_naming_a4(route):
    """An ALiBi model serves and trains (check_supported passes it; its
    backward is ported): a loss through ALiBi takes a gradient on both
    attention routes, every parameter's finite (against JAX:
    tests/test_torch_alibi_train.py); the backward's dyn_pos_offset beside
    ALiBi, which raised naming ROADMAP A4, runs too (tests/
    test_torch_dyn_offset.py), and a causal call with it raises
    ValueError."""
    cfg = ModelConfig(dtype=torch.float32, use_alibi=True, **CONFIGS["llama"])
    check_supported(cfg)
    model = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(1))
    with contextlib.ExitStack() as stack:
        if route == "plain":  # the model's attention on its plain Function
            stack.enter_context(mock.patch.object(llama, "flash_attention",
                                                  attention.plain_flash_attention))
        llama.loss_fn(model, tokens).backward()
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
        with torch.no_grad():  # no gradient to take: the forward runs
            assert bool(torch.isfinite(llama.forward(model, tokens[:, :-1])).all())
    from flashattn_tpu_torch.ops import flash_bwd
    x = torch.zeros((1, 2, 8, 16))
    grads = flash_bwd.flash_attention_backward(x, x, x, x, x, x[..., 0], alibi=True,
                                               dyn_pos_offset=0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(ValueError, match="is_causal=False"):
        flash_bwd.flash_attention_backward(x, x, x, x, x, x[..., 0], True, alibi=True,
                                           dyn_pos_offset=0)


@pytest.mark.parametrize("dispatcher", ["moe_ffn", "moe_ffn_a2a"])
def test_ep_dispatchers_raise_naming_a9(dispatcher):
    """The expert-parallel MoE dispatchers are ported (they raised naming
    ROADMAP A9 before): on a group of one process, with no process group,
    each is the single-device function, its output within 1e-6 of
    moe_ffn_dense_reference's (float32 sums in another order). Over ranks
    they are held against the JAX functions in tests/test_torch_moe_ep.py."""
    params = moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4)
    x = torch.randn((12, 16), generator=torch.Generator().manual_seed(1))
    out = getattr(moe, dispatcher)(x, params, 2)
    torch.testing.assert_close(out, moe.moe_ffn_dense_reference(x, params, 2), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("field,value", [
    ("qk_norm", True), ("attn_bias", True),
    ("rope_scaling", (8.0, 1.0, 4.0, 8192)),
    ("rope_longrope", ((1.0,), (1.0,), 4096, 1.0)),
    ("num_experts", 4),
])
def test_model_family_fields_are_supported(field, value):
    """Qwen3's q/k norm, Qwen2's biases, the llama3 and longrope RoPE
    variants and the mixture-of-experts FFN are ported (their parity with
    the JAX model: tests/test_torch_model_families.py,
    tests/test_torch_moe_model.py)."""
    check_supported(dataclasses.replace(ModelConfig(), **{field: value}))


@pytest.mark.parametrize("field,value", [("logit_softcap", 50.0), ("use_post_norms", True)])
def test_gemma2_config_fields_are_supported(field, value):
    """The attention soft-cap and the post-norms are ported (the Gemma-2
    model's parity: tests/test_torch_gemma_model.py)."""
    check_supported(dataclasses.replace(ModelConfig(), **{field: value}))


# ---- quantized weights, quantized KV caches, chunked steps, paged caches ----

QUANT_ATOL = QUANT_RTOL = 2e-3  # int8/fp8 KV: K2's quantized-mode parity (test_torch_decode.py)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_params_from_jax_bit_identical(bits):
    """A JAX tree quantized by the JAX package converts to the state dict of
    a model quantized by the port from the same weights, byte for byte, and
    loads into it."""
    jcfg, params, model = make_models("llama")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_llama.quantize_params(params, bits)))
    llama.quantize_params(model, bits)
    ours = model.state_dict()
    assert set(sd) == set(ours)
    assert sd["layers.0.wq.w"].dtype == torch.int8 and "lm_head.scale" in sd
    for name, value in sd.items():
        assert torch.equal(ours[name], value), name
    fresh = llama.quantize_params(llama.Llama(model.cfg, device="cpu"), bits)
    fresh.load_state_dict(sd)
    assert isinstance(fresh.layers[1].w_down, llama.QuantizedLinear)
    assert fresh.layers[1].w_down.bits == bits


def run_both(jcfg, params, model, prompt, forced, quant=None):
    """Prefill (all positions) then decode steps in both packages; returns
    the (JAX, port) logits of every call and the final caches."""
    b, s = prompt.shape
    jcaches = jax_generate.init_caches(jcfg, b, 128, quant=quant)
    caches = generate.init_caches(model, b, 128, quant=quant)
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
    return out, jcaches, caches


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_match_jax(bits):
    """The w8/w4 model: every projection and the head through quant_matmul
    (the plain version here, the JAX kernels in interpret mode)."""
    jcfg, params, model = make_models("llama")
    params = jax_llama.quantize_params(params, bits)
    llama.quantize_params(model, bits)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (2, 2), dtype=np.int32)
    out, _, _ = run_both(jcfg, params, model, prompt, forced)
    for i, (ref, got) in enumerate(out):
        rep = verify_results(np.asarray(ref), got, atol=ATOL, rtol=RTOL)
        assert rep.passed, f"call {i}: {rep}"


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_kv_generation_matches_jax(quant):
    jcfg, params, model = make_models("llama")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20), dtype=np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (3, 2), dtype=np.int32)
    out, jcaches, caches = run_both(jcfg, params, model, prompt, forced, quant=quant)
    for i, (ref, got) in enumerate(out):
        rep = verify_results(np.asarray(ref), got, atol=QUANT_ATOL, rtol=QUANT_RTOL)
        assert rep.passed, f"call {i}: {rep}"
    assert caches[1].k.dtype == (torch.int8 if quant == "int8" else torch.float8_e4m3fn)
    np.testing.assert_array_equal(caches[1].length.numpy(), np.asarray(jcaches[1].length))


def paged_caches(jcfg, model, table, quant=None):
    """One-sequence paged caches of both packages with the same table."""
    jc, pc = [], []
    for _ in range(jcfg.num_layers):
        j = jax_paged.init_paged_cache(1, jcfg.num_kv_heads, 4, 128, jcfg.head_dim, 4,
                                       dtype=jnp.float32, quant=quant)
        jc.append(jax_paged.set_block_table(j, 0, jnp.asarray(table, jnp.int32), 0))
        p = paged.init_paged_cache(1, jcfg.num_kv_heads, 4, 128, jcfg.head_dim, 4,
                                   dtype=torch.float32, quant=quant, device="cpu")
        pc.append(paged.set_block_table(p, 0, table, 0))
    return jc, pc


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_chunked_prefill_matches_jax(backend):
    """chunked_prefill of a 256-token prompt in two 128-token chunks, into
    dense caches or scrambled pages, then a decode step: JAX's logits, and
    on the port the paged run equals the dense one bit for bit."""
    jcfg, params, model = make_models("llama")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 256), dtype=np.int32)
    if backend == "dense":
        jc, pc = jax_generate.init_caches(jcfg, 1, 512), generate.init_caches(model, 1, 512)
    else:
        jc, pc = paged_caches(jcfg, model, [2, 0, 3, 1])
    jl, jc = jax_generate.chunked_prefill(params, jnp.asarray(tokens), jc, jcfg, chunk=128)
    pl, pc = generate.chunked_prefill(model, torch.from_numpy(tokens), pc, chunk=128)
    rep = verify_results(np.asarray(jl), pl, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.full((1,), 256, np.int32)
    jl2, _ = jax_generate.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), jc, jcfg)
    pl2, _ = generate.decode_step(model, torch.from_numpy(tok), torch.from_numpy(pos), pc)
    rep = verify_results(np.asarray(jl2), pl2, atol=ATOL, rtol=RTOL)
    assert rep.passed, rep
    if backend == "paged":
        dense = generate.init_caches(model, 1, 512)
        dl, dense = generate.chunked_prefill(model, torch.from_numpy(tokens), dense, chunk=128)
        assert torch.equal(dl, pl)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_chunk_step_with_active_rows_matches_jax(quant):
    """A chunk appended to one row of a batch while the other holds still
    (chunked admission): the active row's logits, and both rows' lengths."""
    jcfg, params, model = make_models("llama")
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20), dtype=np.int32)
    _, jc, pc = run_both(jcfg, params, model, prompt, [], quant=quant)
    piece = rng.integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    positions = np.stack([np.arange(20, 36), np.zeros(16, int)]).astype(np.int32)
    active = np.asarray([True, False])
    jl, jc = jax_generate.chunk_step(params, jnp.asarray(piece), jnp.asarray(positions), jc,
                                     jcfg, active=jnp.asarray(active))
    pl, pc = generate.chunk_step(model, torch.from_numpy(piece), torch.from_numpy(positions),
                                 pc, active=torch.from_numpy(active))
    tol = dict(atol=ATOL, rtol=RTOL) if quant is None else dict(atol=QUANT_ATOL, rtol=QUANT_RTOL)
    rep = verify_results(np.asarray(jl)[0], pl[0], **tol)
    assert rep.passed, rep
    np.testing.assert_array_equal(pc[0].length.numpy(), [36, 20])
    np.testing.assert_array_equal(pc[1].length.numpy(), np.asarray(jc[1].length))
