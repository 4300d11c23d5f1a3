"""Expert parallelism (parallel/moe.py's moe_ffn and moe_ffn_a2a, the
model's "ep" axis) on 4 gloo ranks on the CPU, mirroring the ep tests of
tests/test_moe.py: the masked-dense and the all_to_all dispatch at top_k 1
and 2 over ep 2 and 4, their gradients, the activation threading; plus a
capacity that drops, where the kept (token, pick) set is bit for bit the
JAX function's, and a MoE model's loss and gradients under data 2 x ep 2
against jax.value_and_grad, with each dispatch. The JAX side runs the same
parameters under shard_map (ep 2 cases beside a data axis: each data row's
ep group computes the same).

Float32. Tolerances: outputs the JAX test's 1e-5 (atol and rtol: the
experts' float32 sums in another order), gradients the harness's GRAD_TOL
(its a2a gradient test's atol 5e-4 would pass too), the model's loss
within 2e-5 (relative) and its gradients atol 1e-5, rtol 1e-4; the kept
set exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _parallel_harness import GRAD_TOL, Ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import TINY_MOE as JAX_TINY_MOE
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu.parallel.moe import (moe_ffn, moe_ffn_a2a, moe_ffn_dense_reference,
                                        router_gates)
from flashattn_tpu_torch.models.config import TINY_MOE
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)
SPECS = {"router": P(), "w_gate": P("ep"), "w_up": P("ep"), "w_down": P("ep")}
DISPATCHES = ("a2a", "dense")  # the model's cfg.moe_dispatch ("dense": masked-dense)


def ep_mesh(n: int) -> dict:
    """The port's mesh for ep n on 4 ranks."""
    return {"ep": 4} if n == 4 else {"data": 2, "ep": 2}


def jax_moe(x, params, n, top_k, a2a, capacity=None, activation="silu"):
    """The JAX dispatcher under shard_map over ep n."""
    mesh = jax_make_mesh({"ep": n})
    if a2a:
        fn = functools.partial(moe_ffn_a2a, axis_name="ep", top_k=top_k, capacity_factor=8.0,
                               capacity=capacity, activation=activation)
        specs = (P("ep"), SPECS), P("ep")
    else:
        fn = functools.partial(moe_ffn, axis_name="ep", top_k=top_k, activation=activation)
        specs = (P(), SPECS), P()
    return jax.shard_map(fn, mesh=mesh, in_specs=specs[0], out_specs=specs[1],
                         check_vma=False)(x, params)


def standalone(name, n, top_k, a2a, hidden, inter, e, tokens, key, capacity=None,
               act="silu"):
    rng = np.random.default_rng(key)
    scale = {"router": hidden, "w_gate": hidden, "w_up": hidden, "w_down": inter}
    shapes = {"router": (hidden, e), "w_gate": (e, hidden, inter), "w_up": (e, hidden, inter),
              "w_down": (e, inter, hidden)}  # init_moe_params' shapes and scales
    arrays = {k: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale[k] ** -0.5)
              for k, shape in shapes.items()}
    x = rng.standard_normal((tokens, hidden), dtype=np.float32)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    case = dict(mesh=ep_mesh(n), top_k=top_k, a2a=a2a, act=act, capacity=capacity, x=x,
                params={k: torch.from_numpy(v) for k, v in arrays.items()})

    def ref():
        """(y, the gradients of sum(y^2) for a "_grads" case)."""
        fn = lambda p: jax_moe(x, p, n, top_k, a2a, capacity, act)  # noqa: E731
        if not name.endswith("_grads"):
            return np.asarray(jax.jit(fn)(params)), None
        (_, y), grads = jax.jit(jax.value_and_grad(lambda p: (jnp.sum(fn(p) ** 2), fn(p)),
                                                   has_aux=True))(params)
        return np.asarray(y), {k: np.asarray(v) for k, v in grads.items()}
    return name, case, ref


def model_case(dispatch):
    import dataclasses

    jcfg = dataclasses.replace(JAX_TINY_MOE, dtype=jnp.float32, moe_dispatch=dispatch)
    cfg = dataclasses.replace(TINY_MOE, dtype=torch.float32, moe_dispatch=dispatch)
    params = jax.jit(jax_llama.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    case = dict(mesh={"data": 2, "ep": 2}, model=True, cfg=cfg, tokens=tokens,
                params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    def ref():
        mesh = jax_make_mesh({"data": 2, "model": 1, "ep": 2})  # param_shardings names model
        shard = jax.tree_util.tree_map(lambda spec: NamedSharding(mesh, spec),
                                       jax_llama.param_shardings(jcfg),
                                       is_leaf=lambda x: isinstance(x, P))
        placed = jax.device_put(params, shard)
        loss, grads = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(2, 3))(
            placed, jnp.asarray(tokens), jcfg, mesh)
        return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return f"model_{dispatch}", case, ref


def all_cases():
    made = [standalone(f"{'a2a' if a2a else 'dense'}_k{k}_ep{n}", n, k, a2a, 64, 128, 8, 96, 1)
            for a2a in (False, True) for k in (1, 2) for n in (2, 4)]
    made += [standalone("dense_grads", 4, 2, False, 64, 128, 8, 64, 2),
             standalone("a2a_grads", 4, 2, True, 64, 128, 8, 64, 2),
             standalone("a2a_gelu", 2, 2, True, 64, 128, 4, 32, 1, act="gelu_tanh"),
             standalone("a2a_drops", 2, 2, True, 32, 64, 4, 48, 3, capacity=8)]
    made += [model_case(d) for d in DISPATCHES]
    return made


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (case, JAX's result, every rank's result)}."""
    made = all_cases()
    started = Ranks("moe", 4, {name: case for name, case, _ in made},
                    tmp_path_factory.mktemp("ranks"))
    refs = {name: ref() for name, _, ref in made}
    ranks = started.results()
    return {name: (case, refs[name], [r[name] for r in ranks]) for name, case, _ in made}


def check_output(runs, name, grads=False):
    _, (y_ref, g_ref), outs = runs[name]
    for r, res in enumerate(outs):
        rep = verify_results(y_ref, res["y"], **OUT_TOL)
        assert rep.passed, f"rank {r} output: {rep}"
        if grads:
            for k, g in g_ref.items():
                rep = verify_results(g, res["grads"][k], **GRAD_TOL)
                assert rep.passed, f"rank {r} grad {k}: {rep}"
                assert float(res["grads"][k].abs().max()) > 0, k  # every expert gets tokens


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_ep", [2, 4])
def test_moe_matches_dense(runs, top_k, n_ep):
    check_output(runs, f"dense_k{top_k}_ep{n_ep}")


def test_moe_grads_match_dense(runs):
    check_output(runs, "dense_grads", grads=True)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_ep", [2, 4])
def test_moe_a2a_matches_dense(runs, top_k, n_ep):
    check_output(runs, f"a2a_k{top_k}_ep{n_ep}")


def test_moe_activation_threading(runs):
    """gelu_tanh reaches the a2a dispatch: the JAX function's output under
    the same activation, not SiLU's."""
    check_output(runs, "a2a_gelu")
    case, (y_ref, _), _ = runs["a2a_gelu"]
    silu = jax.jit(moe_ffn_dense_reference, static_argnums=2)(
        jnp.asarray(case["x"]), {k: jnp.asarray(v.numpy()) for k, v in case["params"].items()},
        2)
    assert not np.allclose(np.asarray(silu), y_ref)


def test_moe_a2a_grads_match_dense(runs):
    check_output(runs, "a2a_grads", grads=True)


def test_moe_a2a_capacity_drops_match_jax(runs):
    """Capacity 8 for 24 local tokens x 2 picks over 4 experts: pairs are
    dropped, the kept set (capacity_slots) equals the JAX function's slot
    rule on its own router picks, bit for bit, and the output with the
    drops equals JAX's."""
    case, _, outs = runs["a2a_drops"]
    check_output(runs, "a2a_drops")
    x = jnp.asarray(case["x"])
    router = jnp.asarray(case["params"]["router"].numpy())
    for r, res in enumerate(outs):
        part = r % 2  # the ep index of rank r in data 2 x ep 2
        ids, _ = router_gates(x[24 * part:24 * part + 24], router, 2)
        ids_cm = ids.T.reshape(-1)  # flashattn_tpu/parallel/moe.py:148-153
        m = jax.nn.one_hot(ids_cm, 4, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(m, axis=0) - m, ids_cm[:, None], axis=1)[:, 0]
        keep = np.asarray(pos < 8)
        assert not keep.all()  # the capacity drops
        np.testing.assert_array_equal(res["keep"].numpy(), keep, err_msg=f"rank {r}")


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_model_ep_axis_matches_jax(runs, dispatch):
    """TINY_MOE under data 2 x ep 2 (each rank its block of every layer's
    experts, llama.shard_params): the loss and every gradient, gathered,
    against jax.value_and_grad(loss_fn) under the same mesh."""
    _, (loss, grads), outs = runs[f"model_{dispatch}"]
    failures = []
    for r, res in enumerate(outs):
        if abs(res["loss"] - loss) > 2e-5 * abs(loss):
            failures.append(f"rank {r} loss {res['loss']} vs {loss}")
        assert set(res["grads"]) == set(grads)
        for n, g in grads.items():
            rep = verify_results(g, res["grads"][n], **MODEL_TOL)
            if not rep.passed:
                failures.append(f"rank {r} grad {n}: {rep}")
    assert not failures, "\n".join(failures[:20])
