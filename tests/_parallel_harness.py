"""The harness of the parallel layer's CPU tests (tests/test_torch_ring.py,
tests/test_torch_ring_4ranks.py, tests/test_torch_parallel_model.py and the
tensor-parallel, pipeline, sharded-decode, expert-parallel and failure
tests): the
port's ranks run in a subprocess (tests/_torch_parallel_worker.py), the JAX
package's functions under shard_map with plain per-hop kernels
(tests/_jax_plain_attention.py), each side from the same numpy inputs."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _jax_plain_attention import plain_kernels
from flashattn_tpu.parallel import make_mesh as jax_make_mesh
from flashattn_tpu.parallel import sharded_ring_attention as jax_sharded
from flashattn_tpu_torch.utils.verify import verify_results

WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
# float32: partials merged in another order (the JAX package's ring tests' gates)
O_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
S, D = 64, 16


def ids_of(lens, total, b=1):
    """[b, total] int32 ids of documents of `lens`, then padding (-1)."""
    ids = np.full((b, total), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        ids[:, off:off + n] = i
        off += n
    return ids


def case_inputs(cases: dict, name: str, seed: int) -> dict:
    """A case of (mesh, mode, causal, Hq, Hkv, B, variant keywords,
    documents) with q, k, v, dO and segment ids from a numpy seed."""
    mesh, mode, causal, hq, hkv, b, kw, docs = cases[name]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, S, D), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, S, D), dtype=np.float32) for _ in range(2))
    seg = None if docs is None else ids_of(docs, S, b)
    return dict(mesh=mesh, q=q, k=k, v=v, do=do, seg=seg,
                kw=dict(mode=mode, is_causal=causal, **kw))


def jax_case(c: dict) -> list:
    """The JAX package's O and gradients of sum(O * dO) on the case."""
    mesh = jax_make_mesh(c["mesh"])
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])
    q, k, v, do = (jnp.asarray(c[x]) for x in ("q", "k", "v", "do"))

    def loss(q, k, v):
        o = jax_sharded(q, k, v, mesh, segment_ids=seg, **c["kw"])
        return jnp.sum(o * do), o

    with plain_kernels():  # traced here: one compiled program for O and the gradients
        (_, o), grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


class Ranks:
    """`job` on `cases` in `world` ranks (tests/_torch_parallel_worker.py),
    started at construction, so that the test computes its JAX side
    meanwhile; results() waits for every rank's."""

    def __init__(self, job: str, world: int, cases: dict, tmp_path: Path):
        case_file = tmp_path / "cases.pt"
        torch.save(cases, case_file)
        self.world, self.tmp_path = world, tmp_path
        self.proc = subprocess.Popen([sys.executable, str(WORKER), job, str(world),
                                      str(case_file), str(tmp_path)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def results(self) -> list[dict]:
        _, err = self.proc.communicate(timeout=240)
        assert self.proc.returncode == 0, err[-4000:]
        return [torch.load(self.tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def run_ranks(job: str, world: int, cases: dict, tmp_path: Path) -> list[dict]:
    """Every rank's results of `job` on `cases` (tests/_torch_parallel_worker.py)."""
    return Ranks(job, world, cases, tmp_path).results()


def check_attention(world: int, cases: dict, tmp_path: Path) -> None:
    """Every case on `world` gloo ranks against JAX, every rank's global O
    and gradients."""
    inputs = {name: case_inputs(cases, name, i + 10 * world)
              for i, name in enumerate(sorted(cases))}
    ranks = run_ranks("attention", world, inputs, tmp_path)
    failures = []
    for name, c in inputs.items():
        ref = jax_case(c)
        for r, got in enumerate(ranks):
            for what, a, b in zip(("O", "dQ", "dK", "dV"), ref, got[name]):
                rep = verify_results(a, b, **(O_TOL if what == "O" else GRAD_TOL))
                if not rep.passed:
                    failures.append(f"{name} rank {r} {what}: {rep}")
    assert not failures, "\n".join(failures)
