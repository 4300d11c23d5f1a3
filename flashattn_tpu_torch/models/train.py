"""Training loop + checkpoint/resume (counterpart of flashattn_tpu/models/train.py).

AdamW as the JAX package builds it with optax, step for step:

- the learning rate follows optax.warmup_cosine_decay_schedule(0, lr,
  warmup, total, 0.1 * lr) evaluated at the step count before the update,
  so the first step runs at lr 0 (a LambdaLR stepped after each
  optimizer.step());
- the gradients are clipped as optax.clip_by_global_norm does it: scaled by
  max_norm / |g| only when |g| >= max_norm;
- the logged grad_norm is the norm of the raw gradients;
- torch.optim.AdamW with b1, b2, eps 1e-8 and decoupled weight decay on
  every parameter.

Checkpoints are torch.save files in step-numbered directories (Orbax's
layout, without Orbax), the newest ``max_to_keep`` kept.

The train state owns the model: ``train_step`` updates its parameters in
place, where the JAX step returns new ones. The trainer runs wherever the
model lives: the card, unless the model was built with device="cpu".

Under a mesh (``mesh=``, parallel/mesh.py, the JAX train_step's: "data",
"sp", "model" and "ep" axes over the ranks of a process group) every rank
runs the trainer on the same global batches with its shard of the model
(llama.shard_params under "model" or "ep"): the loss is llama.loss_fn's
global mean; each gradient is summed over the ranks that hold a share of
it (llama.reduce_gradients) before the norm, the clip and the update; the
norm is the whole gradient's (llama.global_grad_norm). A checkpoint holds
the whole model, as the JAX package's Orbax checkpoint does: every rank
takes part in gathering the split parameters and their optimizer state,
rank 0 writes it, and restore_checkpoint cuts a rank's blocks out of it
again under a mesh, so a checkpoint written under one mesh restores under
another, or into one process.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from pathlib import Path
from typing import Iterator

import torch
import torch.distributed as dist

from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.llama import Llama
from flashattn_tpu_torch.parallel.mesh import full_tensor, local_block

STATE_FILE = "state.pt"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0


def learning_rate(tc: TrainConfig, step: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, 0.1 lr) at
    `step` (the count of updates already made)."""
    lr = tc.learning_rate
    if step < tc.warmup_steps:
        return lr * step / tc.warmup_steps
    decay_steps = tc.total_steps - tc.warmup_steps
    t = min(step - tc.warmup_steps, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    return lr * (0.9 * cosine + 0.1)


def make_optimizer(model: Llama, tc: TrainConfig):
    """(AdamW, its LambdaLR schedule) over every parameter of `model`."""
    opt = torch.optim.AdamW(model.parameters(), lr=tc.learning_rate,
                            betas=(tc.b1, tc.b2), eps=1e-8,
                            weight_decay=tc.weight_decay)
    base = tc.learning_rate
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: learning_rate(tc, step) / base if base else 0.0)
    return opt, sched


def init_train_state(model: Llama, tc: TrainConfig) -> dict:
    """The train state: the model, its optimizer and schedule, the step."""
    opt, sched = make_optimizer(model, tc)
    return {"model": model, "optimizer": opt, "scheduler": sched, "step": 0,
            "tc": tc}


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient entry (optax.global_norm),
    a float32 scalar on the gradients' device."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / |g| * max_norm when
    |g| >= max_norm, g unchanged otherwise. Decided on the device: no host
    read."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def train_step(state: dict, tokens: torch.Tensor,
               segment_ids=None, mesh=None) -> tuple[dict, dict]:
    """One optimizer step on tokens [B, S+1] (tensor or numpy, moved to
    the model's device), with packed-document segment_ids [B, S+1] when
    given (llama.loss_fn) -> (state, {"loss", "grad_norm"}), both float32
    scalar tensors on the model's device. Under a mesh the tokens are the
    global batch on every rank (module docstring)."""
    model, opt = state["model"], state["optimizer"]
    tokens = torch.as_tensor(tokens, device=model.device)
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=model.device)
    opt.zero_grad(set_to_none=True)
    loss = llama.loss_fn(model, tokens, segment_ids=segment_ids, mesh=mesh)
    loss.backward()
    if mesh is not None:
        llama.reduce_gradients(model, mesh)
    grads = [p.grad for p in model.parameters()]
    gnorm = global_norm(grads) if mesh is None else llama.global_grad_norm(model, mesh)
    clip_by_global_norm_(grads, gnorm, state["tc"].grad_clip)
    opt.step()
    state["scheduler"].step()
    state["step"] += 1
    return state, {"loss": loss.detach(), "grad_norm": gnorm}


# ---------------- checkpoint / resume ----------------


def checkpoint_steps(ckpt_dir: str | Path) -> list[int]:
    """Steps saved in ckpt_dir, oldest first."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def _payload(state: dict, mesh=None) -> dict:
    """The train state as a checkpoint holds it: under a mesh the whole
    model's parameters and optimizer state, gathered (every rank of the
    split axes calls it)."""
    model, opt = state["model"], state["optimizer"]
    weights, moments = model.state_dict(), opt.state_dict()
    if mesh is not None:
        specs = model.shardings()
        weights = {n: full_tensor(t, specs[n], mesh) for n, t in weights.items()}
        moments = _map_moments(model, moments, lambda t, spec: full_tensor(t, spec, mesh))
    return {"step": int(state["step"]), "model": weights, "optimizer": moments,
            "scheduler": state["scheduler"].state_dict()}


def _map_moments(model, opt_state: dict, fn) -> dict:
    """The optimizer's state dict with fn(tensor, spec) applied to each
    per-parameter tensor shaped like its parameter (AdamW's moments; the
    step count is kept)."""
    specs = model.shardings()
    params = list(model.named_parameters())
    state = {}
    for i, entry in opt_state["state"].items():
        name, p = params[i]
        state[i] = {k: (fn(v, specs[name]) if torch.is_tensor(v) and v.dim() == p.dim()
                        and v.dim() > 0 else v) for k, v in entry.items()}
    return {**opt_state, "state": state}


def save_checkpoint(ckpt_dir: str | Path, state: dict, max_to_keep: int = 3,
                    mesh=None) -> int:
    """Save the full train state under ckpt_dir/<step>/; returns the step.

    Written to a temporary directory and renamed, so a crash leaves either
    the old or the new checkpoint. Only the newest max_to_keep stay. Under
    a mesh every rank calls it: each takes part in gathering the whole
    state, rank 0 alone writes it and the others wait for it."""
    payload = _payload(state, mesh)
    step = payload["step"]
    if mesh is not None and dist.get_rank() != 0:
        dist.barrier()
        return step
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(payload, tmp / STATE_FILE)
    final = root / str(step)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in checkpoint_steps(root)[:-max_to_keep]:
        shutil.rmtree(root / str(old))
    if mesh is not None:
        dist.barrier()
    return step


def restore_checkpoint(ckpt_dir: str | Path, state_like: dict,
                       step: int | None = None, mesh=None) -> dict:
    """Load a checkpoint (the newest by default) into `state_like`, a state
    built with init_train_state, on its model's device; returns it. Under a
    mesh the state's model is a rank's shard: it takes its blocks of the
    checkpoint's whole tensors."""
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        step = steps[-1]
    payload = torch.load(Path(ckpt_dir) / str(step) / STATE_FILE,
                         map_location=state_like["model"].device, weights_only=True)
    model = state_like["model"]
    if mesh is not None:
        specs = model.shardings()
        payload["model"] = {n: local_block(t, specs[n], mesh).contiguous()
                            for n, t in payload["model"].items()}
        payload["optimizer"] = _map_moments(
            model, payload["optimizer"], lambda t, spec: local_block(t, spec, mesh).contiguous())
    model.load_state_dict(payload["model"])
    state_like["optimizer"].load_state_dict(payload["optimizer"])
    state_like["scheduler"].load_state_dict(payload["scheduler"])
    state_like["step"] = payload["step"]
    return state_like


# ---------------- driver loop ----------------


def train(
    model: Llama,
    data: Iterator,
    tc: TrainConfig,
    steps: int,
    ckpt_dir: str | Path | None = None,
    ckpt_every: int = 1000,
    log_every: int = 50,
    mesh=None,
) -> tuple[dict, list[dict]]:
    """Minimal synchronous training driver: `steps` steps on batches from
    `data` (a [B, S+1] token array or tensor, or a dict with "tokens" and
    optionally "segment_ids", as models/data.py::PackedDataset yields them;
    numpy batches move to the model's device), resuming from ckpt_dir if it
    holds a checkpoint. Under a mesh every rank runs it on the same
    batches (module docstring). Returns (final_state, metric history)."""
    state = init_train_state(model, tc)
    if ckpt_dir is not None and checkpoint_steps(ckpt_dir):
        state = restore_checkpoint(ckpt_dir, state, mesh=mesh)
    history = []
    for _ in range(steps):
        batch = next(data)
        if isinstance(batch, dict):
            tokens, segs = batch["tokens"], batch.get("segment_ids")
        else:
            tokens, segs = batch, None
        state, metrics = train_step(state, tokens, segment_ids=segs, mesh=mesh)
        step = state["step"]
        if step % log_every == 0 or step == 1:
            history.append({"step": step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"])})
        if ckpt_dir is not None and step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, mesh=mesh)
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, state, mesh=mesh)
    return state, history
