"""Tensor parallelism (the model's "model" axis) on 4 gloo ranks on the CPU,
mirroring tests/test_model.py::test_sharded_forward_matches_unsharded on a
data 2 x model 2 mesh: each rank takes its shard of one parameter set
(llama.shard_params; the JAX side places the same arrays by
param_shardings), then the forward's logits, loss_fn and every gradient,
one sgd_train_step and two clipped AdamW train_steps against the JAX
functions under the same mesh (its attention on plain per-head kernels,
tests/_jax_plain_attention.py), and a checkpoint written by train.train
under the mesh, restored into one process. The config has q/k/v biases
(split with the heads) and ALiBi (each rank cuts its heads' slopes out of
the whole table); RoPE's path is the unsplit one (the tables are the
same on every rank), run under "model" by
tests/test_torch_parallel_model.py.

Float32. Tolerances: the logits atol 1e-5, rtol 1e-4; the loss within 2e-5
(relative); gradients and the parameters after the SGD step atol 1e-5,
rtol 1e-4 (the harness's GRAD_TOL order: sums over ranks in another
order), bk's by atol alone: under ALiBi q.bk is the same for every key of
a row, so its gradient is 0 in exact arithmetic and float32 noise of
1e-9 has no direction; after the AdamW steps every entry within 1e-4 and
at most 1 in 10^4 beyond 1e-6 (tests/test_torch_train.py's rule: Adam
divides by sqrt(v)), bk's within two learning rates (Adam turns its noise
into an lr-sized step of any sign); the restored checkpoint bit for
bit."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _jax_plain_attention import plain_attention, plain_kernels
from _parallel_harness import Ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import train as jax_train
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu_torch.models import llama, train
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

MESH = {"data": 2, "model": 2}
KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, max_seq_len=64)
VARIANTS = {"bias_alibi": dict(attn_bias=True, use_alibi=True)}
TC_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20, grad_clip=0.5)
LR = 0.05
TOL = dict(atol=1e-5, rtol=1e-4)


def as_state(tree) -> dict:
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def close(name: str, want, got) -> tuple[bool, object]:
    """(passed, report) under TOL; bk by atol alone (module docstring)."""
    rep = verify_results(want, got, **TOL)
    return rep.passed or (name.endswith(".bk") and np.allclose(got, want, **TOL)), rep


def jax_runs(jcfg, params, tokens):
    """The JAX functions under MESH on placed parameters: the forward's
    logits, loss and gradients, the parameters after sgd_train_step, and
    two AdamW train_steps' metrics and parameters."""
    mesh = jax_make_mesh(MESH)
    shard = jax.tree_util.tree_map(lambda spec: NamedSharding(mesh, spec),
                                   jax_llama.param_shardings(jcfg),
                                   is_leaf=lambda x: isinstance(x, P))
    placed = jax.device_put(params, shard)
    toks = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
    tc = jax_train.TrainConfig(**TC_KW)
    with plain_kernels(), mock.patch.object(jax_llama, "flash_attention", plain_attention):
        logits = jax.jit(jax_llama.forward, static_argnums=(2, 3))(placed, toks[:, :-1], jcfg,
                                                                   mesh)
        loss, grads = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(2, 3))(
            placed, toks, jcfg, mesh)
        _, sgd = jax.jit(jax_llama.sgd_train_step, static_argnums=(2, 3, 4))(
            placed, toks, jcfg, LR, mesh)
        state = jax_train.init_train_state(placed, tc)
        metrics = []
        for _ in range(2):
            state, m = jax_train.train_step(state, toks, jcfg, tc, mesh)
            metrics.append({k: float(v) for k, v in m.items()})
    return dict(logits=np.asarray(logits), loss=float(loss), grads=as_state(grads),
                sgd=as_state(sgd), adamw=metrics, adamw_params=as_state(state["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (the port's ranks' results, JAX's, the unsharded port's
    logits, the case)}; the ranks run while JAX computes."""
    cases, inputs = {}, {}
    ckpt = tmp_path_factory.mktemp("ckpt")
    for i, name in enumerate(VARIANTS):
        jcfg = JaxConfig(dtype=jnp.float32, **KW, **VARIANTS[name])
        cfg = ModelConfig(dtype=torch.float32, **KW, **VARIANTS[name])
        params = jax_llama.init_params(jcfg, jax.random.PRNGKey(i))
        tokens = np.random.default_rng(i).integers(0, KW["vocab_size"], (4, 33)).astype(np.int32)
        cases[name] = dict(cfg=cfg, params=as_state(params), tokens=tokens, lr=LR, mesh=MESH,
                           tc=train.TrainConfig(**TC_KW), ckpt=str(ckpt / name))
        inputs[name] = (jcfg, params, tokens)
    ranks = Ranks("tensor_parallel", 4, cases, tmp_path_factory.mktemp("ranks"))
    refs = {}
    for name, (jcfg, params, tokens) in inputs.items():
        whole = llama.Llama(cases[name]["cfg"], device="cpu")
        whole.load_state_dict(cases[name]["params"])
        with torch.no_grad():
            unsharded = llama.forward(whole, torch.from_numpy(tokens[:, :-1]))
        refs[name] = (jax_runs(jcfg, params, tokens), unsharded, cases[name])
    got = ranks.results()
    return {name: (got, *refs[name]) for name in VARIANTS}


def rows(rank: int) -> slice:
    """The batch rows of a rank of MESH (data outermost)."""
    d = rank // MESH["model"]
    return slice(2 * d, 2 * d + 2)


@pytest.mark.parametrize("name", VARIANTS)
def test_sharded_forward_matches_unsharded(runs, name):
    ranks, ref, unsharded, _ = runs[name]
    for r, got in enumerate(ranks):
        logits = got[name]["logits"]
        assert logits.shape == (2, 32, KW["vocab_size"])  # the whole vocabulary
        for what, want in (("JAX", ref["logits"][rows(r)]), ("unsharded", unsharded[rows(r)])):
            rep = verify_results(np.asarray(want), logits, **TOL)
            assert rep.passed, f"rank {r} logits vs {what}: {rep}"


@pytest.mark.parametrize("name", VARIANTS)
def test_loss_and_grads_match_jax(runs, name):
    ranks, ref, _, _ = runs[name]
    failures = []
    for r, got in enumerate(ranks):
        res = got[name]
        if abs(res["loss"] - ref["loss"]) > 2e-5 * abs(ref["loss"]):
            failures.append(f"rank {r} loss {res['loss']} vs {ref['loss']}")
        assert set(res["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            ok, rep = close(n, g, res["grads"][n])
            if not ok:
                failures.append(f"rank {r} grad {n}: {rep}")
    assert not failures, "\n".join(failures[:20])


@pytest.mark.parametrize("name", VARIANTS)
def test_sgd_train_step_matches_jax(runs, name):
    ranks, ref, _, _ = runs[name]
    for r, got in enumerate(ranks):
        res = got[name]
        assert abs(res["step_loss"] - ref["loss"]) <= 2e-5 * abs(ref["loss"])
        for n, p in ref["sgd"].items():
            ok, rep = close(n, p, res["sgd"][n])
            assert ok, f"rank {r} {n} after the step: {rep}"


@pytest.mark.parametrize("name", VARIANTS)
def test_clipped_train_steps_match_optax(runs, name):
    """Two AdamW steps (lr 0, then 1e-3) with the clip active: the loss,
    the raw grad norm (the whole gradient's: the split parameters' squares
    summed over "model") and the parameters."""
    ranks, ref, _, _ = runs[name]
    assert ref["adamw"][0]["grad_norm"] > TC_KW["grad_clip"]  # the clip bites
    for r, got in enumerate(ranks):
        res = got[name]
        for step, (m, jm) in enumerate(zip(res["adamw"], ref["adamw"])):
            assert m["loss"] == pytest.approx(jm["loss"], rel=2e-5), (r, step)
            assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4), (r, step)
        beyond = total = 0
        for n, p in ref["adamw_params"].items():
            err = (res["adamw_params"][n] - p).abs()
            if n.endswith(".bk"):  # Adam's step on a zero gradient's noise: lr-sized, any sign
                assert float(err.max()) <= 2 * TC_KW["learning_rate"], f"rank {r} {n}"
                continue
            assert float(err.max()) <= 1e-4, f"rank {r} {n}: {float(err.max())}"
            beyond += int((err > 1e-6).sum())
            total += err.numel()
        assert beyond <= 1e-4 * total, f"rank {r}: {beyond} of {total} entries beyond 1e-6"


def test_checkpoint_under_tp_restores_into_one_process(runs):
    """train.train under the mesh wrote the whole model and its AdamW
    state; one process restores it into a whole model, bit for bit the
    ranks' gathered parameters, and trains on from it."""
    ranks, _, _, case = runs["bias_alibi"]
    want = ranks[0]["bias_alibi"]["ckpt_params"]
    assert all(torch.equal(got["bias_alibi"]["ckpt_params"][n], p)
               for got in ranks for n, p in want.items())
    model = llama.Llama(case["cfg"], device="cpu")
    state = train.restore_checkpoint(case["ckpt"], train.init_train_state(model, case["tc"]))
    assert state["step"] == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    moments = state["optimizer"].state_dict()["state"]
    assert all(m["exp_avg"].shape == p.shape
               for m, p in zip(moments.values(), model.parameters()))
    state, metrics = train.train_step(state, torch.from_numpy(case["tokens"]))
    assert state["step"] == 3 and bool(torch.isfinite(metrics["loss"]))
