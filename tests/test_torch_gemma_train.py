"""Training a soft-capped model (Gemma-2) through the port (the kernels'
plain versions on the CPU) against the JAX package, on the same weights
(models/convert.py::params_from_jax, the post-norms included) and tokens: a
tiny Gemma-2 (tests/test_torch_gemma_model.py's config cut to 2 layers,
one local and one global) whose logits reach the cap; loss_fn and every
parameter's gradient, unpacked and on a packed row, against
jax.value_and_grad(llama.loss_fn); AdamW train_steps on the packed row
against the optax train_step.

Float32. The loss within 2e-4 and the gradients atol 1e-4, rtol 1e-4
(tests/test_torch_gemma_model.py's and tests/test_torch_packed_model.py's
gates); after two AdamW steps (warmup 1: lr 0, then 1e-3) the loss rel
1e-5, grad_norm rel 1e-4, and the parameters up to 1 in 10^3 entries beyond
1e-6, each within a fifth of the learning rate. Adam's first steps move a
weight by lr g / (|g| + 1e-8) whatever the gradient's size, so where |g| is
near 1e-8 a rounding difference of 1e-7 in g moves the weight by up to
1e-4; this model's soft-capped, post-normed layers hold more such entries
than tests/test_torch_packed_model.py's (whose rule is 1 in 10^4 beyond
1e-6, all within 1e-4): 2 in 10^4 here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import config as jax_config
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import train as jax_train
from flashattn_tpu_torch.models import config, llama, train
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.ops import launches
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


def ids_of(lens, total):
    """[1, total] int32 ids of documents of `lens`, then padding (-1)."""
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[0, off:off + n] = i
        off += n
    return ids


# The tiny Gemma-2 of tests/test_torch_gemma_model.py cut to 2 layers (one
# local, one global): D 256, GQA 2/1, window 16, caps 50 and 30, post-norms;
# wq scaled so that the attention logits reach the cap.
GEMMA_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=2, num_kv_heads=1, head_dim=256, max_seq_len=256, norm_eps=1e-6,
                tie_embeddings=True, attn_window=16, window_pattern="alternate",
                logit_softcap=50.0, final_logit_softcap=30.0, mlp_activation="gelu_tanh",
                use_post_norms=True, scale_embeddings=True, attn_scale=256**-0.5,
                norm_offset=1.0)
Q_GAIN = 12.0
S = 40  # past the local layer's window
DOCS = [19, 14]  # then 8 positions of padding in a row of S + 1


@pytest.fixture(scope="module")
def gemma():
    """The JAX params and config and the port's model on the same weights:
    the norms perturbed so that their weights matter, wq times Q_GAIN."""
    jcfg = jax_config.ModelConfig(dtype=jnp.float32, **GEMMA_KW)
    tree = jax.tree_util.tree_map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(11)
    tree["final_norm"] = tree["final_norm"] + rng.standard_normal(
        tree["final_norm"].shape, dtype=np.float32) * 0.1
    for layer in tree["layers"]:
        for key in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
            layer[key] = layer[key] + rng.standard_normal(layer[key].shape,
                                                           dtype=np.float32) * 0.1
        layer["wq"] = layer["wq"] * Q_GAIN
    model = llama.Llama(config.ModelConfig(dtype=torch.float32, **GEMMA_KW), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def gemma_batch(packed: bool, seed=4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, GEMMA_KW["vocab_size"], size=(1, S + 1)).astype(np.int32)
    return tokens, (ids_of(DOCS, S + 1) if packed else None)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_gemma_loss_and_grads_match_jax(gemma, packed):
    """loss_fn and every parameter's gradient of the soft-capped model
    against jax.value_and_grad(llama.loss_fn), unpacked and on a packed
    row; on the CPU no kernel launches."""
    jcfg, params, model = gemma
    tokens, ids = gemma_batch(packed)
    value_and_grad = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=2)
    jloss, jgrads = value_and_grad(params, jnp.asarray(tokens), jcfg,
                                   segment_ids=None if ids is None else jnp.asarray(ids))
    before = launches.read()
    model.zero_grad(set_to_none=True)
    loss = llama.loss_fn(model, torch.from_numpy(tokens),
                         segment_ids=None if ids is None else torch.from_numpy(ids))
    loss.backward()
    assert launches.read() == before
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-4
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        rep = verify_results(ref[name], p.grad, atol=1e-4, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"
    model.zero_grad(set_to_none=True)


def test_gemma_train_steps_match_jax(gemma):
    """Two AdamW train_steps of the soft-capped model on a packed row
    (warmup 1: lr 0, then 1e-3) against the optax train_step: loss,
    grad_norm and every parameter, which the second step moves."""
    jcfg, params, model = gemma
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)
    tokens, ids = gemma_batch(True, seed=6)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    fresh = llama.Llama(model.cfg, device="cpu")
    fresh.load_state_dict(start)
    jstate = jax_train.init_train_state(params, jax_train.TrainConfig(**tc_kw))
    state = train.init_train_state(fresh, train.TrainConfig(**tc_kw))
    for step in range(2):
        jstate, jm = jax_train.train_step(jstate, jnp.asarray(tokens), jcfg,
                                          jax_train.TrainConfig(**tc_kw),
                                          segment_ids=jnp.asarray(ids))
        state, m = train.train_step(state, torch.from_numpy(tokens),
                                    segment_ids=torch.from_numpy(ids))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), step
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4), step
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    beyond = total = moved = 0
    for name, p in state["model"].named_parameters():
        err = (p.detach() - ref[name]).abs()
        assert float(err.max()) <= 0.2 * tc_kw["learning_rate"], f"{name}: max {float(err.max())}"
        beyond += int((err > 1e-6).sum())
        total += err.numel()
        moved += int((p.detach() != start[name]).sum())
    assert beyond <= 1e-3 * total, f"{beyond} of {total} entries beyond 1e-6"
    assert moved > total // 2, f"{moved} of {total} entries moved"
