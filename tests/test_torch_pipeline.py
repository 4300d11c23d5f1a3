"""Pipeline parallelism (parallel/pipeline.py, llama.pipeline_forward and
pipeline_loss_fn) on gloo ranks on the CPU, mirroring
tests/test_pipeline.py: the schedule's identity math on pp 4, the forward
at (pp, microbatches) (2, 4) and (4, 4), the gradients on pp 2, data 2 x
pp 2, and remat's gradients bit for bit equal to no remat's. Each rank
holds its own stage (stack_pipeline_params under the mesh); the JAX side
runs its pipeline under shard_map on the same parameters, its attention on
plain per-head kernels (tests/_jax_plain_attention.py).

Float32. Tolerances: the harness's O_TOL for the logits and GRAD_TOL for
the gradients (the stages' sums in another order), the loss within 2e-5
(relative); the identity math to 1e-6; remat bit for bit."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_plain_attention import plain_attention, plain_kernels
from _parallel_harness import GRAD_TOL, O_TOL, Ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

torch.set_num_threads(1)

KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=2,
          num_kv_heads=2, head_dim=32, max_seq_len=64)
JCFG = JaxConfig(dtype=jnp.float32, **KW)
CFG = ModelConfig(dtype=torch.float32, **KW)
X = np.random.default_rng(0).standard_normal((8, 4, 16), dtype=np.float32)  # [M, mb, F]


def tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (b, s)).astype(np.int32)


# name: (mesh, microbatches, tokens, what), the JAX test's shapes and seeds
CASES = {
    "forward_2_4": ({"pp": 2}, 4, tokens(8, 32, 1), "forward"),
    "forward_4_4": ({"pp": 4}, 4, tokens(8, 32, 1), "forward"),
    "data_pp_forward": ({"data": 2, "pp": 2}, 4, tokens(8, 32, 3), "forward"),
    "data_pp_grads": ({"data": 2, "pp": 2}, 2, tokens(8, 17, 4), "grads"),
    "grads": ({"pp": 2}, 2, tokens(4, 17, 2), "grads"),
    "remat_off": ({"pp": 2}, 2, tokens(4, 17, 5), "grads"),
    "remat_on": ({"pp": 2}, 2, tokens(4, 17, 5), "remat"),
}


def as_state(tree) -> dict:
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def jax_case(params, mesh_axes, mb, toks, what):
    """JAX's pipeline_forward logits, or pipeline_loss_fn's loss and
    gradients in the plain parameters."""
    mesh = jax_make_mesh(mesh_axes)
    n_pp = mesh_axes["pp"]
    t = jnp.asarray(toks)
    with plain_kernels(), mock.patch.object(jax_llama, "flash_attention", plain_attention):
        if what == "forward":
            fwd = jax.jit(lambda p: jax_llama.pipeline_forward(
                jax_llama.stack_pipeline_params(p, n_pp), t, JCFG, mesh, mb))
            return np.asarray(fwd(params))
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_llama.pipeline_loss_fn(
            jax_llama.stack_pipeline_params(p, n_pp), t, JCFG, mesh, mb)))(params)
    return float(loss), as_state(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results {case: [rank results]}, JAX's {case: result})."""
    params = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    state = as_state(params)
    jobs = {2: {}, 4: {"identity": dict(mesh={"pp": 4}, toy=True, x=X)}}
    for name, (mesh, mb, toks, what) in CASES.items():
        world = int(np.prod(list(mesh.values())))
        jobs[world][name] = dict(mesh=mesh, mb=mb, tokens=toks, cfg=CFG, params=state,
                                 forward=what == "forward", remat=what == "remat")
    started = {w: Ranks("pipeline", w, c, tmp_path_factory.mktemp(f"w{w}"))
               for w, c in jobs.items()}
    ref = {name: jax_case(params, mesh, mb, toks, "forward" if what == "forward" else "grads")
           for name, (mesh, mb, toks, what) in CASES.items() if not name.startswith("remat")}
    got = {}
    for ranks in (r.results() for r in started.values()):
        for res in ranks:
            for name, value in res.items():
                got.setdefault(name, []).append(value)
    return got, ref


def whole_grads(res: dict, k: int) -> dict:
    """A rank's gradients under the whole model's names: its stage's
    stacked [1, k, ...] rows as layers stage * k + i."""
    out = {}
    for n, g in res["grads"].items():
        if n.startswith("stages."):
            for i in range(k):
                out[f"layers.{res['stage'] * k + i}.{n[len('stages.'):]}"] = g[0, i]
        else:
            out[n] = g
    return out


def test_pipeline_apply_identity_math(runs):
    """A toy stage adds its rank's index: 4 stages add 0 + 1 + 2 + 3."""
    got, _ = runs
    for r, y in enumerate(got["identity"]):
        np.testing.assert_allclose(y, X + 6.0, rtol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ["forward_2_4", "forward_4_4"])
def test_pipeline_forward_matches_jax(runs, name):
    got, ref = runs
    for r, res in enumerate(got[name]):
        rep = verify_results(ref[name], res["logits"], **O_TOL)
        assert rep.passed, f"rank {r}: {rep}"


def test_pipeline_grads_match_jax(runs):
    """Every gradient (each stage's layers from their rank, the embedding
    and head after reduce_gradients on every rank), the loss and the
    clipping norm (global_grad_norm: the stages' squares summed over pp)."""
    check_grads(runs, "grads", 2)


def test_pipeline_with_data_axis(runs):
    """data 2 x pp 2: each data rank's rows through the pipeline (logits
    against JAX's rows), and the loss and gradients summed over data."""
    got, ref = runs
    for r, res in enumerate(got["data_pp_forward"]):
        d = r // 2
        rep = verify_results(ref["data_pp_forward"][4 * d:4 * d + 4], res["logits"], **O_TOL)
        assert rep.passed, f"rank {r}: {rep}"
    check_grads(runs, "data_pp_grads", 2)


def check_grads(runs, name, k):
    got, ref = runs
    loss, grads = ref[name]
    norm = float(np.sqrt(sum(float(np.sum(np.square(g.numpy()))) for g in grads.values())))
    failures = []
    for r, res in enumerate(got[name]):
        if abs(res["loss"] - loss) > 2e-5 * abs(loss):
            failures.append(f"rank {r} loss {res['loss']} vs {loss}")
        if abs(res["norm"] - norm) > 1e-4 * norm:
            failures.append(f"rank {r} grad norm {res['norm']} vs {norm}")
        mine = whole_grads(res, k)
        for n, g in mine.items():
            rep = verify_results(grads[n], g, **GRAD_TOL)
            if not rep.passed:
                failures.append(f"rank {r} grad {n}: {rep}")
    assert not failures, "\n".join(failures[:20])


def test_pipeline_remat_grads_identical(runs):
    """remat=True changes what is kept, not what is computed: the same
    gradients bit for bit."""
    got, _ = runs
    for off, on in zip(got["remat_off"], got["remat_on"]):
        assert off["loss"] == on["loss"]
        for n, g in off["grads"].items():
            assert torch.equal(g, on["grads"][n]), n
