"""The model under a data x sp mesh (context parallelism) on 4 gloo ranks on
the CPU: llama.loss_fn and its gradients, then sgd_train_step, on TINY in
float32 from the JAX package's parameters (models/convert.py::
params_from_jax), against the JAX functions under the same mesh (their
rings with plain per-hop kernels: tests/_jax_plain_attention.py) and
against the port's own unsharded loss and gradients; with and without a
window and ALiBi (the ring's positions are global). Every rank returns the
global loss and ends the step with the same parameters. A "model", "pp"
or "ep" axis beside "data" runs, its loss the unsharded one's.

Tolerance: the loss within 2e-5 (relative), gradients and the parameters
after the step atol 1e-5 and rtol 1e-4 (float32 sums over ranks and hops in
another order)."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_plain_attention import plain_attention, plain_kernels
from _parallel_harness import Ranks, run_ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import TINY as JAX_TINY
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.config import TINY, TINY_MOE
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.parallel.mesh import Mesh
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
LR = 0.05
MESH = {"data": 2, "sp": 2}
# name: ModelConfig fields beside TINY's
VARIANTS = {"plain": {}, "window_alibi": dict(attn_window=24, use_alibi=True)}


def case(name, seed):
    jcfg = dataclasses.replace(JAX_TINY, dtype=jnp.float32, **VARIANTS[name])
    cfg = dataclasses.replace(TINY, dtype=torch.float32, **VARIANTS[name])
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(0, TINY.vocab_size, (2, 65)).astype(np.int32)
    return jcfg, cfg, params, tokens


def jax_step(jcfg, params, tokens):
    """JAX's loss, gradients and parameters after sgd_train_step under MESH."""
    mesh = jax_make_mesh(MESH)
    toks = jnp.asarray(tokens)
    with plain_kernels(), mock.patch.object(jax_llama, "flash_attention", plain_attention):
        loss, grads = jax.jit(jax.value_and_grad(jax_llama.loss_fn),
                              static_argnums=(2, 3))(params, toks, jcfg, mesh)
        _, new = jax.jit(jax_llama.sgd_train_step, static_argnums=(2, 3, 4))(
            params, toks, jcfg, LR, mesh)
    as_torch = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    return float(loss), as_torch(grads), as_torch(new)


def test_data_sp_step_matches_jax_and_unsharded(tmp_path, axis_runs):
    cases, refs = {}, {}
    for i, name in enumerate(VARIANTS):
        jcfg, cfg, params, tokens = case(name, i)
        state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        cases[name] = dict(cfg=cfg, params=state, tokens=tokens, lr=LR, mesh=MESH)
        refs[name] = jax_step(jcfg, params, tokens)
        # the port unsharded, in this process
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(state)
        loss = llama.loss_fn(model, torch.from_numpy(tokens))
        loss.backward()
        refs[name] += (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    ranks = run_ranks("model", 4, cases, tmp_path)
    failures = []
    for name in VARIANTS:
        j_loss, j_grads, j_params, u_loss, u_grads = refs[name]
        for r, got in enumerate(ranks):
            res = got[name]
            for what, want in (("JAX", j_loss), ("unsharded", u_loss)):
                for key in ("loss", "step_loss"):
                    if abs(res[key] - want) > 2e-5 * abs(want):
                        failures.append(f"{name} rank {r} {key} {res[key]} vs {what} {want}")
            for what, grads in (("JAX", j_grads), ("unsharded", u_grads)):
                for n, g in grads.items():
                    rep = verify_results(np.asarray(g), res["grads"][n], **TOL)
                    if not rep.passed:
                        failures.append(f"{name} rank {r} grad {n} vs {what}: {rep}")
            for n, p in j_params.items():
                rep = verify_results(np.asarray(p), res["params"][n], **TOL)
                if not rep.passed:
                    failures.append(f"{name} rank {r} param {n} after the step: {rep}")
    assert not failures, "\n".join(failures[:20])


AXIS_CFGS = {"model": TINY, "pp": TINY, "ep": TINY_MOE}


@pytest.fixture(scope="module")
def axis_runs(tmp_path_factory):
    """The "axes" job's losses, started at the module's first test so that
    it runs beside the data x sp one: {axis: (every rank's loss, the
    unsharded port's)}."""
    cases, want = {}, {}
    for i, (axis, base) in enumerate(AXIS_CFGS.items()):
        cfg = dataclasses.replace(base, dtype=torch.float32)
        model = llama.init_params(cfg, torch.Generator().manual_seed(i), device="cpu")
        tokens = np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        cases[axis] = dict(cfg=cfg, params=model.state_dict(), tokens=tokens,
                           mesh={"data": 2, axis: 2})
        with torch.no_grad():
            want[axis] = float(llama.loss_fn(model, torch.from_numpy(tokens)))
    started = Ranks("axes", 4, cases, tmp_path_factory.mktemp("axes"))
    return functools.cache(lambda: ({a: [r[a] for r in started.results()] for a in AXIS_CFGS},
                                    want))


@pytest.mark.parametrize("axis", ["model", "pp", "ep"])
def test_unported_axes_raise_naming_a9(axis_runs, axis):
    """Tensor, pipeline and expert parallelism are ported (a "model", "pp" or
    "ep" axis raised naming ROADMAP A9 before) and run: under data 2 x {axis} 2
    on 4 gloo ranks (the rank's shard_params shard, or its
    stack_pipeline_params stage through pipeline_loss_fn) every rank's loss
    is the unsharded port's, within 2e-5; check_mesh takes the axis at any
    size and raises ValueError for an axis the model does not know. The
    parity of each against JAX: tests/test_torch_tensor_parallel.py,
    test_torch_pipeline.py, test_torch_moe_ep.py."""
    llama.check_mesh(Mesh({"sp": 1, axis: 2}, {"sp": 0, axis: 0}, {}))
    with pytest.raises(ValueError, match="axes"):
        llama.check_mesh(Mesh({"tensor": 2}, {"tensor": 0}, {}))
    got, want = axis_runs()
    for r, loss in enumerate(got[axis]):
        assert abs(loss - want[axis]) <= 2e-5 * abs(want[axis]), (r, loss, want[axis])
