"""Packed-document training through the port's model (the kernels' plain
versions on the CPU) against itself unpacked and against the JAX package,
on weights carried from the JAX tree (models/convert.py::params_from_jax):
tests/test_packed_training.py's first three tests (the packed forward
equals each document's own forward, the packed loss is the token-weighted
mean of the documents' losses, AdamW steps lower the packed loss), then
loss_fn and its gradients against jax.value_and_grad(llama.loss_fn) with
segment ids (without and with a 16-token window), and AdamW train_steps
with segment ids against the JAX train_step.

Float32. Tolerances: forward and loss rtol/atol 2e-4 (as
tests/test_packed_training.py); against JAX the loss within 2e-4 and the
gradients atol 1e-4, rtol 1e-4 (two layers of float32, sums in another
order); after two AdamW steps the parameters within 1e-6, up to 1 in 10^4
entries within 1e-4 (tests/test_torch_train.py's rule: Adam divides by
sqrt(v))."""

import dataclasses

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
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
          num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256)
LENS = [40, 17, 60]
TC_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)


def configs(window=None):
    return (JaxConfig(dtype=jnp.float32, attn_window=window, **KW),
            ModelConfig(dtype=torch.float32, attn_window=window, **KW))


def models(window=None, seed=0):
    jcfg, cfg = configs(window)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def packed_inputs(seed=0, pad=11):
    total = sum(LENS) + pad
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, KW["vocab_size"], size=(1, total)).astype(np.int32)
    ids = np.full((1, total), -1, np.int32)
    off = 0
    for i, n in enumerate(LENS):
        ids[0, off:off + n] = i
        off += n
    return tokens, ids


def test_packed_forward_matches_unpacked():
    params, model = models()
    tokens, ids = packed_inputs()
    with torch.no_grad():
        packed = llama.forward(model, torch.from_numpy(tokens), segment_ids=torch.from_numpy(ids))
        off = 0
        for n in LENS:
            solo = llama.forward(model, torch.from_numpy(tokens[:, off:off + n]))
            np.testing.assert_allclose(packed[:, off:off + n].numpy(), solo.numpy(),
                                       rtol=2e-4, atol=2e-4)
            off += n
    jpacked = jax_llama.forward(params, jnp.asarray(tokens), configs()[0],
                                segment_ids=jnp.asarray(ids))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked), rtol=2e-4, atol=2e-4)


def test_packed_loss_masks_boundaries():
    _, model = models()
    tokens, ids = packed_inputs(seed=2)
    with torch.no_grad():
        loss = float(llama.loss_fn(model, torch.from_numpy(tokens),
                                   segment_ids=torch.from_numpy(ids)))
        assert np.isfinite(loss)
        tot, cnt, off = 0.0, 0, 0
        for n in LENS:
            doc = torch.from_numpy(tokens[:, off:off + n])
            tot += float(llama.loss_fn(model, doc)) * (n - 1)
            cnt += n - 1
            off += n
    assert abs(loss - tot / cnt) < 2e-4, (loss, tot / cnt)


def test_packed_training_step():
    _, model = models()
    tokens, ids = packed_inputs(seed=3)
    state = train.init_train_state(model, train.TrainConfig(**TC_KW))
    losses = []
    for _ in range(10):
        state, metrics = train.train_step(state, tokens, segment_ids=ids)  # numpy batches
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("window", [None, 16])
def test_packed_loss_and_grads_match_jax(window):
    params, model = models(window, seed=1)
    tokens, ids = packed_inputs(seed=4)
    jloss, jgrads = jax.value_and_grad(jax_llama.loss_fn)(
        params, jnp.asarray(tokens), configs(window)[0], segment_ids=jnp.asarray(ids))
    loss = llama.loss_fn(model, torch.from_numpy(tokens), segment_ids=torch.from_numpy(ids))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-4
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        rep = verify_results(ref[name], p.grad, atol=1e-4, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"


def test_packed_train_steps_match_jax():
    """Two AdamW steps on a packed batch (warmup 1: lr 0, then 1e-3): loss,
    grad_norm and the parameters against the optax train_step."""
    params, model = models(seed=2)
    tokens, ids = packed_inputs(seed=5)
    jcfg = configs()[0]
    jstate = jax_train.init_train_state(params, jax_train.TrainConfig(**TC_KW))
    state = train.init_train_state(model, train.TrainConfig(**TC_KW))
    for step in range(2):
        jstate, jm = jax_train.train_step(jstate, jnp.asarray(tokens), jcfg,
                                          jax_train.TrainConfig(**TC_KW),
                                          segment_ids=jnp.asarray(ids))
        state, m = train.train_step(state, torch.from_numpy(tokens),
                                    segment_ids=torch.from_numpy(ids))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), step
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4), step
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    beyond = total = 0
    for name, p in state["model"].named_parameters():
        err = (p.detach() - ref[name]).abs()
        assert float(err.max()) <= 1e-4, f"{name}: max {float(err.max())}"
        beyond += int((err > 1e-6).sum())
        total += err.numel()
    assert beyond <= 1e-4 * total, f"{beyond} of {total} entries beyond 1e-6"


def test_document_positions_restart():
    ids = torch.tensor([[0, 0, 0, 1, 1, 2, -1, -1], [5, 5, 5, 5, 5, 5, 5, 5]])
    assert llama.document_positions(ids).tolist() == [[0, 1, 2, 0, 1, 0, 0, 1],
                                                      list(range(8))]
    _, model = models()
    with pytest.raises(ValueError, match="shaped like the tokens"):
        llama.forward(model, torch.zeros((1, 8), dtype=torch.long),
                      segment_ids=torch.zeros((1, 7), dtype=torch.int32))
