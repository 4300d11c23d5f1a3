"""The port's single-device mixture-of-experts FFN (parallel/moe.py) against
the JAX package's (flashattn_tpu/parallel/moe.py), on the same numpy
inputs from a seed: router_gates for both routing conventions (ids equal,
gates within 1e-6), the grouped dispatch (moe_ffn_grouped, the card route,
whose products run on the CPU through the same torch._grouped_mm) and the
port's masked-dense plain version against JAX's moe_ffn_dense_reference
at top_k 1, 2 and 8 over 4 to 16 experts, SiLU and tanh-GELU; the MoE
layer's FFN with Qwen2-MoE's sigmoid-gated shared expert against the JAX
layer's (llama._mlp_block); router_aux_loss; init_moe_params' layout and
scales.

Tolerances: float32 within rtol/atol 1e-5 (the packages' matrix products
sum in other orders); bf16 under the repo's gate (verify_results, atol
2e-2), the two packages rounding the products' bf16 outputs at the same
points. On one device the grouped dispatch and the plain version run the
same products in the same order: float32 outputs bit for bit equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu.parallel import moe as jax_moe
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.parallel import moe
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
H, F, T = 64, 96, 40

# (top_k, num_experts, activation): top 1 (Switch), 2 (Mixtral), 8 of 16
# (Qwen3-30B-A3B's k, every token on half the experts).
CASES = [(1, 4, "silu"), (2, 8, "gelu_tanh"), (2, 4, "silu"), (8, 16, "silu"),
         (4, 12, "gelu_tanh")]


def inputs(num_experts: int, seed: int = 0):
    """x [T, H] and the MoE parameters as float32 numpy arrays, the JAX
    init's scales; x at unit scale so the routes' logits spread."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H), dtype=np.float32)
    params = {"router": rng.standard_normal((H, num_experts), dtype=np.float32) * H**-0.5,
              "w_gate": rng.standard_normal((num_experts, H, F), dtype=np.float32) * H**-0.5,
              "w_up": rng.standard_normal((num_experts, H, F), dtype=np.float32) * H**-0.5,
              "w_down": rng.standard_normal((num_experts, F, H), dtype=np.float32) * F**-0.5}
    return x, params


def to_jax(a, dtype):
    return jnp.asarray(a, dtype)


def to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_router_gates_match_jax(norm_topk, top_k):
    x, p = inputs(16, seed=top_k)
    ids, gates = moe.router_gates(to_torch(x, torch.float32), to_torch(p["router"],
                                  torch.float32), top_k, norm_topk)
    jids, jgates = jax_moe.router_gates(to_jax(x, jnp.float32), to_jax(p["router"],
                                        jnp.float32), top_k, norm_topk)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6, atol=1e-6)
    if norm_topk:
        np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    else:
        assert bool((gates.sum(-1) < 1.0).all())


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k,num_experts,act", CASES)
def test_grouped_and_plain_match_jax_float32(top_k, num_experts, act, norm_topk):
    x, p = inputs(num_experts, seed=num_experts)
    want = np.asarray(jax_moe.moe_ffn_dense_reference(
        to_jax(x, jnp.float32), {k: to_jax(v, jnp.float32) for k, v in p.items()}, top_k,
        act, norm_topk))
    tp = {k: to_torch(v, torch.float32) for k, v in p.items()}
    xt = to_torch(x, torch.float32)
    grouped = moe.moe_ffn_grouped(xt, tp, top_k, act, norm_topk)
    plain = moe.moe_ffn_dense_reference(xt, tp, top_k, act, norm_topk)
    np.testing.assert_allclose(grouped.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    assert torch.equal(grouped, plain)


@pytest.mark.parametrize("top_k,num_experts,act", CASES[:4])
def test_grouped_and_plain_match_jax_bf16(top_k, num_experts, act):
    x, p = inputs(num_experts, seed=100 + num_experts)
    want = jax_moe.moe_ffn_dense_reference(
        to_jax(x, jnp.bfloat16), {k: to_jax(v, jnp.bfloat16) for k, v in p.items()}, top_k,
        act)
    want = np.asarray(want.astype(jnp.float32))
    tp = {k: to_torch(v, torch.bfloat16) for k, v in p.items()}
    xt = to_torch(x, torch.bfloat16)
    for name, fn in (("grouped", moe.moe_ffn_grouped), ("plain", moe.moe_ffn_dense_reference)):
        out = fn(xt, tp, top_k, act)
        assert out.dtype == torch.bfloat16
        report = verify_results(want, out, atol=2e-2)
        assert report.passed, f"{name}: {report}"


def test_grouped_reads_only_the_picked_experts():
    """Experts that no token picks read nothing: a router that sends every
    token to experts 0 and 1 gives the same output whatever the other
    experts hold (here NaN)."""
    x, p = inputs(8, seed=5)
    tp = {k: to_torch(v, torch.float32) for k, v in p.items()}
    tp["router"][:, 2:] = -1e3
    tp["router"][:, :2] = torch.abs(tp["router"][:, :2])
    xt = torch.abs(to_torch(x, torch.float32))
    want = moe.moe_ffn_grouped(xt, tp, 2)
    for key in ("w_gate", "w_up", "w_down"):
        tp[key][2:] = float("nan")
    got = moe.moe_ffn_grouped(xt, tp, 2)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


MOE_LAYER = dict(vocab_size=64, hidden_size=H, intermediate_size=F, num_layers=1,
                 num_heads=2, num_kv_heads=1, head_dim=32, max_seq_len=64, num_experts=6,
                 top_k_experts=2)


@pytest.mark.parametrize("shared,norm_topk,act", [(0, True, "silu"), (80, False, "silu"),
                                                  (80, True, "gelu_tanh")])
def test_moe_layer_ffn_matches_jax(shared, norm_topk, act):
    """The layer's MLP block, router and experts, and the shared expert
    times sigmoid(x shared_gate) added in float32, against the JAX layer's
    on a [2, 20, H] input."""
    kw = dict(MOE_LAYER, moe_shared_intermediate=shared, moe_norm_topk=norm_topk,
              mlp_activation=act)
    jcfg = JaxConfig(dtype=jnp.float32, **kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jcfg,
                                                                   jax.random.PRNGKey(3)))
    layer = tree["layers"][0]
    layer["mlp_norm"] = layer["mlp_norm"] + np.random.default_rng(1).standard_normal(
        H, dtype=np.float32) * 0.1
    x = np.random.default_rng(2).standard_normal((2, 20, H), dtype=np.float32)
    want = np.asarray(jax_llama._mlp_block(jax.tree_util.tree_map(jnp.asarray, layer),
                                           jnp.asarray(x), jcfg))
    model = llama.Llama(ModelConfig(dtype=torch.float32, **kw), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    got = llama._mlp_block(model.layers[0], torch.from_numpy(x), model.cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert ("shared_gate" in dict(model.layers[0].moe.named_parameters())) == bool(shared)


def test_router_aux_loss_matches_jax():
    x, p = inputs(8, seed=9)
    got = moe.router_aux_loss(to_torch(x, torch.float32), to_torch(p["router"], torch.float32))
    want = jax_moe.router_aux_loss(to_jax(x, jnp.float32), to_jax(p["router"], jnp.float32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) >= 1.0 - 1e-6  # E · Σ f p is 1 at uniform dispatch, more otherwise


def test_init_moe_params_layout_and_scales():
    """The JAX init's layout ([H, E], [E, H, F], [E, F, H]) and scales,
    seeded, in the requested dtype."""
    e, h, f = 8, 256, 512
    p = moe.init_moe_params(torch.Generator().manual_seed(0), h, f, e, torch.bfloat16)
    j = jax_moe.init_moe_params(jax.random.PRNGKey(0), h, f, e, jnp.bfloat16)
    for name in moe.ROUTED:
        assert tuple(p[name].shape) == tuple(j[name].shape), name
        assert p[name].dtype == torch.bfloat16
        scale = f**-0.5 if name == "w_down" else h**-0.5
        assert abs(float(p[name].float().std()) - scale) < 0.05 * scale, name
    again = moe.init_moe_params(torch.Generator().manual_seed(0), h, f, e, torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_moe_model_state_dict_matches_jax_tree():
    """A MoE layer's parameters carry the JAX tree's nested names and shapes,
    the shared expert's too; no dense w_gate/w_up/w_down at the top."""
    kw = dict(MOE_LAYER, moe_shared_intermediate=80)
    tree = jax_llama.init_params(JaxConfig(dtype=jnp.float32, **kw), jax.random.PRNGKey(0))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    model = llama.Llama(dataclasses.replace(ModelConfig(**kw), dtype=torch.float32),
                        device="meta")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in sd.items()}
    assert "layers.0.moe.shared.w_down" in ours and "layers.0.w_gate" not in ours
