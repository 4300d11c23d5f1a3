"""Training an ALiBi model (cfg.use_alibi: RoPE off, the standard slopes'
bias) through the port (the kernels' plain versions on the CPU) against the
JAX package, on the same weights (models/convert.py::params_from_jax) and
tokens: loss_fn and every parameter's gradient against
jax.value_and_grad(llama.loss_fn), with remat False and "attn", unpacked
and on a packed row (attention through flash_attention_varlen with the
ids: the bias on the global packed positions); sgd_train_step with
remat="attn" against JAX's; AdamW train_steps on the packed row against
the optax train_step. Mirrors tests/test_torch_model_families_grad.py,
tests/test_torch_packed_model.py and
tests/test_packed_training.py::test_packed_alibi_model_forward.

Float32. The loss within rel 1e-5 and the gradients atol 1e-5, rtol 1e-4
(tests/test_torch_train.py's gates); after two AdamW steps (warmup 1:
lr 0, then 1e-3) the loss rel 1e-5, grad_norm rel 1e-4, and the
parameters up to 1 in 10^4 entries beyond 1e-6, each within a fifth of the
learning rate (tests/test_torch_packed_model.py's rule: Adam's first steps
move a weight by lr g / (|g| + 1e-8) whatever the gradient's size)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import train as jax_train
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import llama, train
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.ops import launches
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128, use_alibi=True)
S = 48
DOCS = [13, 17, 14]  # off the tile multiples, then 5 positions of padding in a row of S + 1
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def alibi_model():
    """The JAX params and config and the port's model on the same weights."""
    jcfg = JaxConfig(dtype=jnp.float32, **CFG_KW)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(3))
    model = llama.Llama(ModelConfig(dtype=torch.float32, **CFG_KW), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def batch(packed: bool, b: int = 2, seed: int = 4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG_KW["vocab_size"], size=(b, S + 1)).astype(np.int32)
    if not packed:
        return tokens, None
    ids = np.full((b, S + 1), -1, np.int32)
    off = 0
    for i, n in enumerate(DOCS):
        ids[:, off:off + n] = i
        off += n
    return tokens, ids


def test_alibi_weights_carry_over(alibi_model):
    """An ALiBi model has no parameter of its own: params_from_jax fills
    every tensor of the port's model, and the model holds exactly the JAX
    tree's weights (no RoPE table, no slope table)."""
    _, params, model = alibi_model
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    assert llama.rope_tables(model.cfg, torch.arange(4)) == (None, None)


@pytest.mark.parametrize("remat", [False, "attn"], ids=["no_remat", "remat_attn"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_alibi_loss_and_grads_match_jax(alibi_model, packed, remat):
    """loss_fn and every parameter's gradient of the ALiBi model against
    jax.value_and_grad(llama.loss_fn) with the same remat policy, unpacked
    and on a packed row; on the CPU no kernel launches."""
    jcfg, params, model = alibi_model
    tokens, ids = batch(packed)
    value_and_grad = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(2, 6))
    jloss, jgrads = value_and_grad(params, jnp.asarray(tokens), jcfg, None, None,
                                   None if ids is None else jnp.asarray(ids), remat)
    before = launches.read()
    model.zero_grad(set_to_none=True)
    loss = llama.loss_fn(model, torch.from_numpy(tokens),
                         segment_ids=None if ids is None else torch.from_numpy(ids), remat=remat)
    loss.backward()
    assert launches.read() == before
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        rep = verify_results(ref[name], p.grad, **GRAD_TOL)
        assert rep.passed, f"grad {name}: {rep}"
    model.zero_grad(set_to_none=True)


def test_alibi_sgd_train_step_matches_jax(alibi_model):
    """sgd_train_step with remat="attn" (the full-depth path of the card's
    ALiBi training phase) against JAX's: the loss and every updated
    parameter."""
    jcfg, params, model = alibi_model
    tokens, _ = batch(False, b=1, seed=8)
    lr = 1e-2
    step = jax.jit(lambda p, t: jax_llama.sgd_train_step(p, t, jcfg, lr, remat="attn"))
    jloss, jnew = step(params, jnp.asarray(tokens))
    fresh = llama.Llama(model.cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    loss, fresh = llama.sgd_train_step(fresh, torch.from_numpy(tokens), lr, remat="attn")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew))
    for name, p in fresh.named_parameters():
        rep = verify_results(ref[name], p.detach(), atol=lr * 1e-5, rtol=1e-5)
        assert rep.passed, f"{name}: {rep}"


def test_alibi_train_steps_match_jax(alibi_model):
    """Two AdamW train_steps of the ALiBi model on a packed row (warmup 1:
    lr 0, then 1e-3) against the optax train_step: loss, grad_norm and
    every parameter, which the second step moves."""
    jcfg, params, model = alibi_model
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)
    tokens, ids = batch(True, b=1, seed=6)
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
    assert beyond <= 1e-4 * total, f"{beyond} of {total} entries beyond 1e-6"
    assert moved > total // 2, f"{moved} of {total} entries moved"
