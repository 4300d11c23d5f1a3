"""The port's training path against the JAX package's, on the same weights
(the JAX tree converted with params_from_jax) and tokens: loss_fn and its
gradients against jax.value_and_grad(llama.loss_fn), sgd_train_step, and
three AdamW train_steps against the optax train_step. Then the trainer's own
behaviour (memorisation, checkpoints, resume), mirroring tests/test_train.py
on the port alone.

Float32 throughout, the flash kernels on their plain (port) and interpret
(JAX) paths. Tolerances: loss rtol 1e-5 and gradients atol 1e-5, rtol 1e-4
(float32 through two layers, sums in another order). After three AdamW
steps at most 1 in 10^4 parameter entries differ by more than 1e-6, none by
more than 1e-4 (a tenth of one update at lr 1e-3), and the mean absolute
difference stays below 1e-7: Adam divides by sqrt(v), so an entry whose
gradient is near zero turns a float32 difference far below 1e-6 into an
update difference of up to about 1e-4 (20 of 328,320 entries beyond 1e-6,
the largest 6.6e-5, mean 4e-9 on this seed). The
learning-rate schedule within rel 1e-5 of optax's, which evaluates it in
float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
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

TINY2_KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128)
JCFG = JaxConfig(dtype=jnp.float32, **TINY2_KW)
CFG = ModelConfig(dtype=torch.float32, **TINY2_KW)
TC_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
JTC = jax_train.TrainConfig(**TC_KW)
TC = train.TrainConfig(**TC_KW)


def jax_params(seed=0):
    return jax_llama.init_params(JCFG, jax.random.PRNGKey(seed))


def port_model(params) -> llama.Llama:
    model = llama.Llama(CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def tokens(b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (b, s + 1), dtype=np.int32)


def batches(n, **kw):
    t = tokens(**kw)
    for _ in range(n):
        yield t  # the same batch every step: memorisation


def assert_tree_close(jax_tree, model, atol, max_err=None, max_share=0.0):
    """Every entry within atol, or, with max_err, at most max_share of all
    entries beyond atol and none beyond max_err; mean error below 1e-7."""
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))
    got = dict(model.named_parameters())
    assert set(sd) == set(got)
    beyond = total = 0
    for name, ref in sd.items():
        err = (got[name].detach() - ref).abs()
        assert float(err.max()) <= (max_err or atol), f"{name}: max {float(err.max())}"
        assert float(err.mean()) < 1e-7, f"{name}: mean {float(err.mean())}"
        beyond += int((err > atol).sum())
        total += err.numel()
    assert beyond <= max_share * total, f"{beyond} of {total} entries beyond {atol}"


def test_loss_and_grads_match_jax():
    params = jax_params()
    toks = tokens()
    jloss, jgrads = jax.value_and_grad(jax_llama.loss_fn)(params, jnp.asarray(toks), JCFG)
    model = port_model(params)
    loss = llama.loss_fn(model, torch.from_numpy(toks))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        rep = verify_results(sd[name], p.grad, atol=1e-5, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"


def test_sgd_train_step_matches_jax():
    params = jax_params()
    toks = tokens(seed=2)
    jloss, jparams = jax_llama.sgd_train_step(params, jnp.asarray(toks), JCFG, lr=1e-2)
    loss, model = llama.sgd_train_step(port_model(params), torch.from_numpy(toks), lr=1e-2)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_tree_close(jparams, model, atol=1e-6)
    assert all(p.grad is None for p in model.parameters())


def test_train_steps_match_optax():
    """Three steps with warmup 2: lr 0, 5e-4, then 1e-3; loss, the raw
    grad_norm and the parameters against the optax train_step."""
    params = jax_params()
    jstate = jax_train.init_train_state(params, JTC)
    state = train.init_train_state(port_model(params), TC)
    toks = tokens()
    for step in range(3):
        jstate, jm = jax_train.train_step(jstate, jnp.asarray(toks), JCFG, JTC)
        state, m = train.train_step(state, torch.from_numpy(toks))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), step
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4), step
    assert state["step"] == int(jstate["step"]) == 3
    assert float(jm["grad_norm"]) > TC.grad_clip  # the clip was active
    assert_tree_close(jstate["params"], state["model"], atol=1e-6, max_err=1e-4,
                      max_share=1e-4)


def test_learning_rate_schedule_matches_optax():
    for tc in (TC, train.TrainConfig(), train.TrainConfig(warmup_steps=1, total_steps=6)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, tc.learning_rate, tc.warmup_steps, tc.total_steps, tc.learning_rate * 0.1)
        for step in (0, 1, 2, tc.warmup_steps, tc.warmup_steps + 3, tc.total_steps // 2,
                     tc.total_steps, tc.total_steps + 5):
            assert train.learning_rate(tc, step) == pytest.approx(float(sched(step)),
                                                                 rel=1e-5, abs=1e-12)
    state = train.init_train_state(port_model(jax_params()), TC)
    assert state["optimizer"].param_groups[0]["lr"] == 0.0  # the first step's lr


def test_loss_decreases():
    state = train.init_train_state(port_model(jax_params()), TC)
    first = None
    for batch in batches(30):
        state, metrics = train.train_step(state, batch)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first * 0.7, (first, last)
    assert np.isfinite(last)
    assert state["step"] == 30


def test_checkpoint_roundtrip(tmp_path):
    params = jax_params()
    state = train.init_train_state(port_model(params), TC)
    for batch in batches(3):
        state, _ = train.train_step(state, batch)
    assert train.save_checkpoint(tmp_path / "ckpt", state) == 3
    restored = train.restore_checkpoint(tmp_path / "ckpt",
                                        train.init_train_state(port_model(params), TC))
    assert restored["step"] == 3
    for a, b in zip(state["model"].parameters(), restored["model"].parameters()):
        assert torch.equal(a, b)
    assert restored["optimizer"].param_groups[0]["lr"] == state["optimizer"].param_groups[0]["lr"]


def test_checkpoints_keep_the_newest(tmp_path):
    state = train.init_train_state(port_model(jax_params()), TC)
    for batch in batches(4):
        state, _ = train.train_step(state, batch)
        train.save_checkpoint(tmp_path, state, max_to_keep=2)
    assert train.checkpoint_steps(tmp_path) == [3, 4]
    with pytest.raises(FileNotFoundError):
        train.restore_checkpoint(tmp_path / "empty", state)


def test_resume_is_deterministic(tmp_path):
    params = jax_params()
    s_full = train.init_train_state(port_model(params), TC)
    for batch in batches(6):
        s_full, m_full = train.train_step(s_full, batch)

    s_a = train.init_train_state(port_model(params), TC)
    for batch in batches(3):
        s_a, _ = train.train_step(s_a, batch)
    train.save_checkpoint(tmp_path / "ckpt", s_a)
    s_b = train.restore_checkpoint(tmp_path / "ckpt",
                                   train.init_train_state(port_model(params), TC))
    for batch in batches(3):
        s_b, m_b = train.train_step(s_b, batch)

    assert s_b["step"] == 6
    assert float(m_b["loss"]) == pytest.approx(float(m_full["loss"]), rel=1e-6)
    for a, b in zip(s_full["model"].parameters(), s_b["model"].parameters()):
        assert torch.allclose(a, b, atol=1e-7), "resume diverged"


def test_train_driver_with_resume(tmp_path):
    params = jax_params()
    state, hist = train.train(port_model(params), batches(5), TC, steps=5,
                              ckpt_dir=tmp_path / "ckpt", ckpt_every=100, log_every=1)
    assert state["step"] == 5 and len(hist) == 5
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5]
    state2, _ = train.train(port_model(params), batches(2), TC, steps=2,
                            ckpt_dir=tmp_path / "ckpt", ckpt_every=100, log_every=1)
    assert state2["step"] == 7  # resumed from step 5


def test_segment_ids_shape_and_dict_batches():
    """Segment ids of another shape than the tokens raise, and a dict batch
    trains with or without them (one id for every token: the same loss as
    no ids)."""
    model = port_model(jax_params())
    toks = torch.from_numpy(tokens(s=16))
    segs = torch.zeros_like(toks)
    with pytest.raises(ValueError, match="shaped like the tokens"):
        llama.loss_fn(model, toks, segment_ids=segs[:, 1:])
    with pytest.raises(ValueError, match="shaped like the tokens"):
        llama.forward(model, toks, segment_ids=segs[:, :-1])
    with torch.no_grad():
        assert float(llama.loss_fn(model, toks, segment_ids=segs)) == pytest.approx(
            float(llama.loss_fn(model, toks)), rel=1e-6)
    state = train.init_train_state(model, TC)
    state, _ = train.train_step(state, toks)  # a dict batch without segment ids trains
    _, hist = train.train(model, iter([{"tokens": toks, "segment_ids": segs}]), TC, steps=1,
                          log_every=1)
    _, hist2 = train.train(model, iter([{"tokens": toks}]), TC, steps=1, log_every=1)
    assert len(hist) == len(hist2) == 1


def test_constructors_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(CFG, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.Llama(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg, torch.Generator())
    from flashattn_tpu_torch.ops.kvcache import init_cache
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(1, 2, 16, 8)
    assert llama.Llama(cfg, device="cpu").device.type == "cpu"
