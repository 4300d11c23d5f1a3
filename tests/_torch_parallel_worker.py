"""Ranks of the parallel layer's CPU tests (tests/test_torch_ring.py,
tests/test_torch_parallel_model.py, tests/test_torch_tensor_parallel.py,
tests/test_torch_pipeline.py, tests/test_torch_decode_sharded.py,
tests/test_torch_moe_ep.py, tests/test_torch_moe_train.py,
tests/test_torch_failure.py). Imports no JAX.

    python tests/_torch_parallel_worker.py JOB WORLD CASES OUT_DIR

spawns WORLD processes that join one gloo process group through a file in
OUT_DIR, run the job (a name of JOBS) on every case of CASES (a
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


def _whole(model, mesh, grads: bool = False) -> dict:
    """Every parameter of a rank's shard (or its gradient), gathered whole."""
    from flashattn_tpu_torch.parallel.mesh import full_tensor

    specs = model.shardings()
    return {n: full_tensor(p.grad if grads else p.detach(), specs[n], mesh)
            for n, p in model.named_parameters()}


def tensor_parallel(cases: dict) -> dict:
    """Under each case's mesh ("model" among its axes), from the case's
    whole parameters: the forward's logits (this rank's rows), loss_fn's
    loss and gradients (gathered whole), the parameters after
    sgd_train_step, two clipped AdamW train_steps' metrics and parameters,
    and train.train's checkpoint written to the case's directory."""
    from flashattn_tpu_torch.models import llama, train

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        whole = llama.Llama(c["cfg"], device="cpu")
        whole.load_state_dict(c["params"])
        tokens = torch.from_numpy(c["tokens"])
        res = {}
        m = llama.shard_params(whole, mm)
        with torch.no_grad():
            res["logits"] = llama.forward(m, tokens[:, :-1], mesh=mm)
        loss = llama.loss_fn(m, tokens, mesh=mm)
        loss.backward()
        llama.reduce_gradients(m, mm)
        res.update(loss=float(loss), grads=_whole(m, mm, grads=True))
        m = llama.shard_params(whole, mm)
        step_loss, m = llama.sgd_train_step(m, tokens, lr=c["lr"], mesh=mm)
        res.update(step_loss=float(step_loss), sgd=_whole(m, mm))
        state = train.init_train_state(llama.shard_params(whole, mm), c["tc"])
        metrics = []
        for _ in range(2):
            state, mt = train.train_step(state, tokens, mesh=mm)
            metrics.append({k: float(v) for k, v in mt.items()})
        res.update(adamw=metrics, adamw_params=_whole(state["model"], mm))
        if c.get("ckpt"):
            state, _ = train.train(llama.shard_params(whole, mm), iter([tokens] * 2), c["tc"],
                                   steps=2, ckpt_dir=c["ckpt"], mesh=mm)
            res["ckpt_params"] = _whole(state["model"], mm)
        out[name] = res
    return out


def pipeline(cases: dict) -> dict:
    """pipeline_apply on a toy stage, or the model's pipeline_forward
    logits and pipeline_loss_fn's loss and gradients (each rank's stage
    parameters, its own block) under the case's mesh."""
    from flashattn_tpu_torch.models import llama
    from flashattn_tpu_torch.parallel import pipeline_apply

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        if c.get("toy"):
            bias = torch.tensor([float(mm.index("pp"))])
            out[name] = pipeline_apply(lambda b, t: t + b[0], bias, torch.from_numpy(c["x"]),
                                       mm.group("pp")).numpy()
            continue
        whole = llama.Llama(c["cfg"], device="cpu")
        whole.load_state_dict(c["params"])
        pm = llama.stack_pipeline_params(whole, mm.size("pp"), mm)
        tokens = torch.from_numpy(c["tokens"])
        res = {}
        if c.get("forward"):
            with torch.no_grad():
                res["logits"] = llama.pipeline_forward(pm, tokens, mm, c["mb"])
        else:
            loss = llama.pipeline_loss_fn(pm, tokens, mm, c["mb"], remat=c.get("remat", False))
            loss.backward()
            llama.reduce_gradients(pm, mm)
            res.update(loss=float(loss), stage=mm.index("pp"),
                       grads={n: p.grad.clone() for n, p in pm.named_parameters()},
                       norm=float(llama.global_grad_norm(pm, mm)))
        out[name] = res
    return out


def decode(cases: dict) -> dict:
    """Each case's split decode: "sequence" through
    sharded_decode_attention, "heads" (dense or paged) through the rank's
    block of the heads of q and the cache, gathered over the axis."""
    from flashattn_tpu_torch.ops import decode as dec
    from flashattn_tpu_torch.ops import paged
    from flashattn_tpu_torch.parallel import serving
    from flashattn_tpu_torch.parallel.mesh import full_tensor, local_block

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        q = c["q"]
        if c["mode"] == "sequence":
            out[name] = serving.sharded_decode_attention(q, c["cache"], mm)
            continue
        cache = serving.local_cache(c["cache"], serving.head_specs("model", c["paged"]), mm)
        q_l = local_block(q, (None, "model"), mm).contiguous()
        kw = {}
        if c.get("alibi"):
            kw = dict(alibi=True, alibi_slopes=local_block(c["slopes"], ("model",), mm))
        call = paged.paged_decode_attention if c["paged"] else dec.decode_attention
        out[name] = full_tensor(call(q_l, cache, **kw), (None, "model"), mm)
    return out


def moe(cases: dict) -> dict:
    """moe_ffn or moe_ffn_a2a over the case's "ep" axis (the rank's block
    of the experts; for a2a of the tokens too): the output gathered whole
    and the gradients of sum(y^2) (the experts' gathered, the router's
    whole); or a MoE model's loss_fn and gradients under the mesh."""
    from flashattn_tpu_torch.models import llama
    from flashattn_tpu_torch.parallel import moe as pmoe
    from flashattn_tpu_torch.parallel.collectives import gather_from_group
    from flashattn_tpu_torch.parallel.mesh import full_tensor, local_block

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        group = mm.group("ep")
        if c.get("model"):
            whole = llama.Llama(c["cfg"], device="cpu")
            whole.load_state_dict(c["params"])
            m = llama.shard_params(whole, mm)
            loss = llama.loss_fn(m, torch.from_numpy(c["tokens"]), mesh=mm)
            loss.backward()
            llama.reduce_gradients(m, mm)
            out[name] = dict(loss=float(loss), grads=_whole(m, mm, grads=True))
            continue
        spec = ("ep", None, None)
        params = {k: (v if k == "router" else local_block(v, spec, mm).contiguous())
                  .clone().requires_grad_() for k, v in c["params"].items()}
        x = torch.from_numpy(c["x"])
        if c["a2a"]:
            y_l = pmoe.moe_ffn_a2a(local_block(x, ("ep",), mm).contiguous(), params, c["top_k"],
                                   group, capacity=c.get("capacity"),
                                   capacity_factor=c.get("cf", 8.0), activation=c["act"])
            y = gather_from_group(y_l, group, 0)
            loss = (y_l.float() ** 2).sum()  # this rank's tokens' share of sum(y^2)
        else:
            y = pmoe.moe_ffn(x, params, c["top_k"], group, activation=c["act"])
            loss = (y.float() ** 2).sum()
        loss.backward()
        grads = {k: (p.grad if k == "router" else full_tensor(p.grad, spec, mm))
                 for k, p in params.items()}
        res = dict(y=y.detach(), grads=grads)
        if c["a2a"]:
            x_l = local_block(x, ("ep",), mm)
            ids, _ = pmoe.router_gates(x_l, c["params"]["router"], c["top_k"])
            e = c["params"]["router"].shape[1]
            cap = c.get("capacity") or pmoe.default_capacity(c.get("cf", 8.0), c["top_k"],
                                                             x_l.shape[0], e)
            res["keep"] = pmoe.capacity_slots(ids, e, cap)[1]
        out[name] = res
    return out


def moe_train(cases: dict) -> dict:
    """One AdamW train_step of each case's MoE model under its mesh (the
    rank's shard_params shard): the loss, the grad norm, and the clipped
    gradients and updated parameters gathered whole."""
    from flashattn_tpu_torch.models import llama, train

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        whole = llama.Llama(c["cfg"], device="cpu")
        whole.load_state_dict(c["params"])
        state = train.init_train_state(llama.shard_params(whole, mm), c["tc"])
        state, metrics = train.train_step(state, torch.from_numpy(c["tokens"]), mesh=mm)
        out[name] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                         grads=_whole(state["model"], mm, grads=True),
                         params=_whole(state["model"], mm))
    return out


def probe(cases: dict) -> dict:
    """probe_collectives over every rank (the CPU)."""
    from flashattn_tpu_torch.utils.failure import probe_collectives

    mesh = _meshes()
    return {name: probe_collectives(mesh(c["mesh"]), timeout_s=60.0, device="cpu")
            for name, c in cases.items()}


def axes(cases: dict) -> dict:
    """The loss under each case's "model", "pp" or "ep" axis."""
    from flashattn_tpu_torch.models import llama

    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        mm = mesh(c["mesh"])
        whole = llama.Llama(c["cfg"], device="cpu")
        whole.load_state_dict(c["params"])
        tokens = torch.from_numpy(c["tokens"])
        if "pp" in c["mesh"]:
            loss = llama.pipeline_loss_fn(llama.stack_pipeline_params(whole, 2, mm), tokens, mm, 2)
        else:
            loss = llama.loss_fn(llama.shard_params(whole, mm), tokens, mesh=mm)
        out[name] = float(loss)
    return out


JOBS = {"attention": attention, "model": model, "tensor_parallel": tensor_parallel,
        "pipeline": pipeline, "decode": decode, "moe": moe, "moe_train": moe_train,
        "probe": probe, "axes": axes}


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
