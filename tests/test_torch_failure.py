"""Failure detection and recovery (utils/failure.py), mirroring the six
tests of tests/test_failure.py on the port: check_finite, the step timer's
persistent-slowdown rule, probe_collectives over two gloo ranks on the
CPU, resilient_train recovering from an injected non-finite loss (the
restored state and the skipped batch held against the JAX package's
train_step on the same numpy batches and parameters, the failing batch
left out), giving up on a fault that stays, and resuming across a
process's death.

Float32. The recovered run's parameters against JAX's after six AdamW
steps: every entry within 1e-4, at most 1 in 10^4 beyond 1e-6, the mean
difference below 1e-7 (tests/test_torch_train.py's rule: Adam divides by
sqrt(v))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_harness import run_ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import train as jax_train
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import llama, train
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.failure import (StepTimer, TrainingFailure, check_finite,
                                               resilient_train)

torch.set_num_threads(1)

KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=1, num_heads=2,
          num_kv_heads=2, head_dim=32, max_seq_len=64)
JCFG = JaxConfig(dtype=jnp.float32, **KW)
CFG = ModelConfig(dtype=torch.float32, **KW)
TC_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
TC = train.TrainConfig(**TC_KW)


def data_stream(seed=0, b=2, s=33):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, KW["vocab_size"], size=(b, s)).astype(np.int32)


def jax_params(seed=0):
    return jax.jit(jax_llama.init_params, static_argnums=0)(JCFG, jax.random.PRNGKey(seed))


def model_from(params) -> llama.Llama:
    model = llama.Llama(CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def test_check_finite():
    check_finite({"loss": 1.0, "grad_norm": 2.0}, step=1)
    check_finite({"loss": torch.tensor(0.5)}, step=2)
    with pytest.raises(TrainingFailure) as e:
        check_finite({"loss": float("nan")}, step=3)
    assert e.value.kind == "nonfinite"
    with pytest.raises(TrainingFailure):
        check_finite({"grad_norm": torch.tensor(float("inf"))}, step=4)


def test_step_timer_flags_persistent_slowdown_only():
    t = StepTimer(factor=3.0, calibrate=2, patience=2)
    for step, dt in enumerate((0.01, 0.01, 0.012, 0.2)):  # one straggler is fine
        t.start()
        t._t0 -= dt  # the elapsed time, simulated
        t.stop(step, torch.tensor(1.0))  # a step's result is read back before the clock
    t.start()
    t._t0 -= 0.2  # a second slow step in a row
    with pytest.raises(TrainingFailure) as e:
        t.stop(99)
    assert e.value.kind == "timeout"


def test_probe_collectives_healthy_mesh(tmp_path):
    """Two gloo ranks on the CPU: the probe's all-reduce returns in time and
    sums to 0 + 1 on both."""
    ranks = run_ranks("probe", 2, {"healthy": dict(mesh={"data": 2})}, tmp_path)
    assert [r["healthy"] for r in ranks] == [True, True]


def poisoned_step(step_fn, at, left):
    """step_fn, with the loss replaced by NaN once the step count reaches
    `at` (as long as left[0] > 0)."""
    def step(state, batch):
        state, metrics = step_fn(state, batch)
        if int(state["step"]) == at and left[0]:
            left[0] -= 1
            metrics = dict(metrics, loss=float("nan"))
        return state, metrics
    return step


def test_resilient_train_recovers_from_injected_nan(tmp_path):
    """A NaN loss at step 3 (once): one recovery event, the state restored
    to step 2's checkpoint and the batch skipped, 6 steps reached; the
    final parameters those of the JAX package's train_step on the same
    batches but the failing one."""
    params = jax_params()
    state = train.init_train_state(model_from(params), TC)
    final, events = resilient_train(
        state, data_stream(), poisoned_step(train.train_step, 3, [1]), steps=6,
        ckpt_dir=tmp_path / "port", ckpt_every=2, max_recoveries=2)
    assert final["step"] == 6 and len(events) == 1
    ev = events[0]
    assert ev.kind == "nonfinite" and ev.restored_step == 2 and ev.step == 2
    assert all(bool(torch.isfinite(p).all()) for p in final["model"].parameters())

    # JAX's train_step on the batches the recovery keeps: the third is skipped
    jtc = jax_train.TrainConfig(**TC_KW)
    jstate = jax_train.init_train_state(params, jtc)
    for i, batch in zip(range(7), data_stream()):
        if i != 2:
            jstate, _ = jax_train.train_step(jstate, jnp.asarray(batch), JCFG, jtc)
    assert int(jstate["step"]) == 6
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    beyond = total = 0
    for n, p in final["model"].named_parameters():
        err = (p.detach() - ref[n]).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) < 1e-7, n
        beyond += int((err > 1e-6).sum())
        total += err.numel()
    assert beyond <= 1e-4 * total


def test_resilient_train_gives_up_on_persistent_fault(tmp_path):
    state = train.init_train_state(model_from(jax_params()), TC)

    def step_fn(state, batch):
        state, metrics = train.train_step(state, batch)
        if state["step"] >= 2:  # every batch after step 1 fails
            metrics = dict(metrics, loss=torch.tensor(float("inf")))
        return state, metrics

    with pytest.raises(TrainingFailure):
        resilient_train(state, data_stream(), step_fn, steps=6, ckpt_dir=tmp_path,
                        ckpt_every=2, max_recoveries=2)


def test_resilient_train_resumes_across_process_death(tmp_path):
    """A first run checkpoints and stops after 4 steps (a process that
    died); a fresh state restored from the directory goes on to 7."""
    state = train.init_train_state(model_from(jax_params()), TC)
    resilient_train(state, data_stream(), train.train_step, steps=4, ckpt_dir=tmp_path,
                    ckpt_every=2)
    fresh = train.init_train_state(model_from(jax_params(1)), TC)
    restored = train.restore_checkpoint(tmp_path, fresh)
    assert restored["step"] == 4
    final, events = resilient_train(restored, data_stream(seed=7), train.train_step, steps=3,
                                    ckpt_dir=tmp_path, ckpt_every=2)
    assert final["step"] == 7 and not events
