"""The model-family fields in the port against the JAX package: Qwen3's q/k
RMSNorm (qk_norm), Qwen2's q/k/v biases (attn_bias), Llama-3.1's llama3
RoPE remap (rope_scaling) and Phi-3's longrope (rope_longrope), each on a
tiny config whose biases and norm weights are perturbed so they matter.

forward, prefill, decode_step and chunk_step against the JAX functions on
the same weights (params_from_jax), logits within atol/rtol 1e-4
(tests/test_torch_model.py's); attention_operands with biases and norms
through torch.library.opcheck and against autograd through the same
arithmetic; a longrope step whose positions cross the original context,
eagerly and with the factor set chosen without a host read (what a
captured decode step needs). loss_fn's gradients with these fields:
tests/test_torch_model_families_grad.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
          num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128)
HALF = KW["head_dim"] // 2
LONG_ORIG = 32  # longrope's original context: prompts of 20 stay short, chunks cross it
FAMILIES = {
    "qk_norm": dict(qk_norm=True),
    "attn_bias": dict(attn_bias=True),
    "rope_scaling": dict(rope_scaling=(8.0, 1.0, 4.0, 16)),
    "rope_longrope": dict(rope_longrope=(tuple(1.0 + 0.05 * i for i in range(HALF)),
                                         tuple(2.0 + 0.3 * i for i in range(HALF)),
                                         LONG_ORIG, 1.19)),
}
OPS = torch.ops.flashattn_tpu_torch


def make_models(family, seed=0):
    """(JAX config, JAX params, port model) with the family's field set and
    its biases, q/k norm weights and layer norms perturbed."""
    jcfg = JaxConfig(dtype=jnp.float32, **KW, **FAMILIES[family])
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 7)
    tree = jax.tree_util.tree_map(np.asarray, params)
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm", "bq", "bk", "bv", "q_norm", "k_norm"):
            if key in layer:
                layer[key] = layer[key] + 0.1 * rng.standard_normal(layer[key].shape,
                                                                    dtype=np.float32)
    model = llama.Llama(ModelConfig(dtype=torch.float32, **KW, **FAMILIES[family]),
                        device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def check(ref, got, what):
    rep = verify_results(np.asarray(ref), got, atol=ATOL, rtol=RTOL)
    assert rep.passed, f"{what}: {rep}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_and_generation_steps_match_jax(family):
    """forward on 40 tokens; prefill of 20, 3 decode steps, then a chunk of
    16 (positions 23-38: past llama3's original 16 and, for longrope, past
    its original 32, so the chunk's K rotate with the long set)."""
    jcfg, params, model = make_models(family)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, KW["vocab_size"], (2, 40), dtype=np.int32)
    ref = jax.jit(jax_llama.forward, static_argnums=2)(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        check(ref, llama.forward(model, torch.from_numpy(tokens)), "forward")

    b, s = 2, 20
    prompt = tokens[:, :s]
    jc = jax_generate.init_caches(jcfg, b, 128)
    pc = generate.init_caches(model, b, 128)
    jl, jc = jax_generate.prefill(params, jnp.asarray(prompt), jc, jcfg, return_all=True)
    pl, pc = generate.prefill(model, torch.from_numpy(prompt), pc, return_all=True)
    check(jl, pl, "prefill")
    for i in range(3):
        tok, pos = tokens[:, s + i], np.full((b,), s + i, np.int32)
        jl, jc = jax_generate.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), jc, jcfg)
        pl, pc = generate.decode_step(model, torch.from_numpy(tok), torch.from_numpy(pos), pc)
        check(jl, pl, f"decode step {i}")
    piece = rng.integers(0, KW["vocab_size"], (b, 16), dtype=np.int32)
    positions = np.arange(s + 3, s + 19, dtype=np.int32)
    jl, jc = jax_generate.chunk_step(params, jnp.asarray(piece), jnp.asarray(positions), jc, jcfg)
    pl, pc = generate.chunk_step(model, torch.from_numpy(piece), torch.from_numpy(positions), pc)
    check(jl, pl, "chunk step")
    np.testing.assert_array_equal(pc[1].length.numpy(), np.asarray(jc[1].length))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_building_blocks_match_jax(family):
    """attention_inputs (the projections with the biases, the q/k norm and
    RoPE: what every site feeds the kernels) against the JAX qkv_proj,
    apply_qk_norm and apply_rope on one layer's weights at positions past
    the original contexts, and rope_tables against the JAX tables at
    positions on both sides of them."""
    jcfg, params, model = make_models(family, seed=5)
    cfg, layer, jlayer = model.cfg, model.layers[0], params["layers"][0]
    s = 7
    xn = np.random.default_rng(6).standard_normal((2, s, KW["hidden_size"]), dtype=np.float32)
    pos = np.arange(34, 34 + s, dtype=np.int32)
    with torch.no_grad():
        got = llama.attention_inputs(layer, torch.from_numpy(xn),
                                     *llama.rope_tables(cfg, torch.from_numpy(pos)), cfg)
    shapes = {"q": KW["num_heads"], "k": KW["num_kv_heads"], "v": KW["num_kv_heads"]}
    ref = {w: jax_llama.qkv_proj(jnp.asarray(xn), jlayer, jcfg, w).reshape(2, s, n, -1)
           for w, n in shapes.items()}
    ref["q"], ref["k"] = jax_llama.apply_qk_norm(ref["q"], ref["k"], jlayer, jcfg)
    cos, sin = jax_llama.rope_tables(jcfg, jnp.asarray(pos))
    ref = {w: x.transpose(0, 2, 1, 3) for w, x in ref.items()}  # [B, H, S, D]
    ref["q"], ref["k"] = (jax_llama.apply_rope(ref[w], cos, sin) for w in "qk")
    for name, x in zip("qkv", got):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref[name]), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # Angles up to 79 rad: one float32 ulp of the angle (7.6e-6) bounds the
    # tables' difference when the two packages round the remap differently.
    pos = np.arange(0, 80, 3, dtype=np.int32)
    for got, want in zip(llama.rope_tables(cfg, torch.from_numpy(pos)),
                         jax_llama.rope_tables(jcfg, jnp.asarray(pos))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def operand_inputs(dtype=torch.float32, s=12, seed=0):
    """xn, weights, RoPE tables, biases and q/k norm weights of a 4/2-head,
    D 16 layer."""
    g = torch.Generator().manual_seed(seed)
    b, h, nq, nkv, d = 2, 64, 4, 2, 16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    xn = rand(b, s, h)
    ws = [rand(h, n * d, scale=h**-0.5) for n in (nq, nkv, nkv)]
    cfg = ModelConfig(dtype=dtype, vocab_size=8, hidden_size=h, intermediate_size=8,
                      num_layers=1, num_heads=nq, num_kv_heads=nkv, head_dim=d)
    cos, sin = llama.rope_tables(cfg, torch.arange(s))
    biases = [rand(n * d, scale=0.1) for n in (nq, nkv, nkv)]
    norms = [1.0 + rand(d, scale=0.1) for _ in range(2)]
    return xn, ws, cos, sin, biases, norms


def test_attention_operands_opcheck_with_biases_and_norms():
    xn, ws, cos, sin, biases, norms = operand_inputs()
    leaves = [t.requires_grad_() for t in (xn, *ws)]
    extras = [t.requires_grad_() for t in (*biases, *norms)]
    torch.library.opcheck(OPS.attention_operands.default,
                          (*leaves, cos, sin, 4, 2, *extras, 1e-6, 0.0),
                          test_utils=("test_schema", "test_autograd_registration",
                                      "test_faketensor"))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_attention_operands_backward_against_autograd(offset):
    """The registered backward (RoPE backward, then the RMSNorm backward
    over D, then the projections; a bias's gradient summed over B and S)
    against autograd through the same arithmetic (llama._operands)."""
    xn, ws, cos, sin, biases, norms = operand_inputs(seed=3)
    leaves = [t.clone().requires_grad_() for t in (xn, *ws, *biases, *norms)]
    out = OPS.attention_operands(*leaves[:4], cos, sin, 4, 2, *leaves[4:], 1e-6, offset)
    ref_leaves = [t.clone().requires_grad_() for t in (xn, *ws, *biases, *norms)]
    ref = llama._operands(*ref_leaves[:4], cos, sin, 4, 2, *ref_leaves[4:], 1e-6, offset)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(t.shape, generator=g) for t in ref]
    got = torch.autograd.grad(out, leaves, cots)
    want = torch.autograd.grad(ref, ref_leaves, cots)
    names = ["xn", "wq", "wk", "wv", "bq", "bk", "bv", "q_norm", "k_norm"]
    for name, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


class NoHostRead(TorchDispatchMode):
    """Fails on any read of a tensor's value by the host (.item(), bool(),
    int()): a captured CUDA graph bakes such a read's answer in."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default,
                    torch.ops.aten.is_nonzero.default):
            raise AssertionError(f"host read of a tensor's value: {func}")
        return func(*args, **(kwargs or {}))


def test_longrope_crossing_the_original_context():
    """The long factor set once the call's largest position + 1 passes the
    original context (the JAX rule, a maximum over the whole call), chosen
    on the device: rope_tables runs with no host read of the positions, and
    decode_step, fed its positions through fixed buffers as a captured
    step is, switches sets between two calls as JAX does."""
    jcfg, params, model = make_models("rope_longrope", seed=4)
    cfg = model.cfg
    for pos in ([LONG_ORIG - 2, LONG_ORIG - 1], [LONG_ORIG - 1, LONG_ORIG], [3, LONG_ORIG + 5]):
        p = np.asarray(pos, np.int32)
        with NoHostRead():
            cos, sin = llama.rope_tables(cfg, torch.from_numpy(p))
        jcos, jsin = jax_llama.rope_tables(jcfg, jnp.asarray(p))
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=1e-6)
    short, _ = llama.rope_tables(cfg, torch.tensor([LONG_ORIG - 1]))
    crossed, _ = llama.rope_tables(cfg, torch.tensor([LONG_ORIG - 1, LONG_ORIG]))
    assert not torch.equal(short[0], crossed[0])  # one position, two factor sets

    b, s = 2, LONG_ORIG - 2
    prompt = np.random.default_rng(5).integers(0, KW["vocab_size"], (b, s), dtype=np.int32)
    jc = jax_generate.init_caches(jcfg, b, 128)
    pc = generate.init_caches(model, b, 128)
    _, jc = jax_generate.prefill(params, jnp.asarray(prompt), jc, jcfg)
    _, pc = generate.prefill(model, torch.from_numpy(prompt), pc)
    token = torch.zeros((b,), dtype=torch.int32)  # the step's fixed buffers
    positions = torch.zeros((b,), dtype=torch.int32)
    for i, tok in enumerate(([5, 6], [7, 8], [9, 10])):  # positions 30, 31, 32: crosses at 32
        token.copy_(torch.tensor(tok, dtype=torch.int32))
        positions.fill_(s + i)
        pl, pc = generate.decode_step(model, token, positions, pc)
        jl, jc = jax_generate.decode_step(params, jnp.asarray(tok, jnp.int32),
                                          jnp.full((b,), s + i, jnp.int32), jc, jcfg)
        check(jl, pl, f"decode step at position {s + i}")
