"""Ranks of the parallel layer's CPU tests (tests/test_torch_ring.py,
tests/test_torch_parallel_model.py). Imports no JAX.

    python tests/_torch_parallel_worker.py JOB WORLD CASES OUT_DIR

spawns WORLD processes that join one gloo process group through a file in
OUT_DIR, run the job ("attention" or "model") on every case of CASES (a
torch.save file the test wrote) and save what each rank computed as
OUT_DIR/rank<r>.pt. Every process runs torch on one thread.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def _meshes():
    from flashattn_tpu_torch.parallel import make_mesh

    made = {}

    def mesh(axes):  # one set of process groups a mesh shape, made in case order
        key = tuple(axes.items())
        if key not in made:
            made[key] = make_mesh(axes)
        return made[key]
    return mesh


def attention(cases: dict) -> dict:
    """sharded_ring_attention on the global inputs: O and the gradients of
    sum(O * dO) in q, k and v."""
    from flashattn_tpu_torch.parallel import sharded_ring_attention

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in ("q", "k", "v"))
        seg = torch.from_numpy(c["seg"]) if c.get("seg") is not None else None
        o = sharded_ring_attention(q, k, v, mesh(c["mesh"]), segment_ids=seg, **c["kw"])
        grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(c["do"]))
        out[name] = [o.detach().numpy()] + [g.numpy() for g in grads]
    return out


def model(cases: dict) -> dict:
    """llama.loss_fn's value and gradients (summed over the ranks), then the
    parameters after sgd_train_step, under each case's mesh, from the
    case's parameters."""
    from flashattn_tpu_torch.models import llama

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        m = llama.Llama(c["cfg"], device="cpu")
        m.load_state_dict(c["params"])
        tokens = torch.from_numpy(c["tokens"])
        loss = llama.loss_fn(m, tokens, mesh=mesh(c["mesh"]))
        loss.backward()
        llama.reduce_gradients(m)  # this rank's share -> the sum over the ranks
        grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        step_loss, m = llama.sgd_train_step(m, tokens, lr=c["lr"], mesh=mesh(c["mesh"]))
        out[name] = dict(loss=float(loss), grads=grads, step_loss=float(step_loss),
                         params={n: p.detach().clone() for n, p in m.named_parameters()})
    return out


JOBS = {"attention": attention, "model": model}


def rank_main(rank: int, world: int, job: str, case_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from flashattn_tpu_torch.parallel import initialize_distributed

    initialize_distributed("gloo", f"file://{os.path.join(out_dir, 'rendezvous')}", world, rank,
                           timeout=120)
    cases = torch.load(case_file, weights_only=False)
    torch.save(JOBS[job](cases), os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    job, world, case_file, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mp.spawn(rank_main, args=(world, job, case_file, out_dir), nprocs=world)
