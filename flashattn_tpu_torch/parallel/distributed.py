"""Process-group start-up and the transports of the parallel layer
(counterpart of flashattn_tpu/parallel/distributed.py).

The JAX package wires its hosts with ``jax.distributed.initialize`` and lets
XLA emit the collectives; the port's ranks are processes joined by
``torch.distributed``, and this module is where they meet:

- ``initialize_distributed`` starts the default process group. The caller
  names the backend: ``"nccl"`` when each rank owns a card, ``"gloo"`` on the
  CPU and for ranks that share one card. Nothing changes backend quietly:
  where the JAX function logs its fallback to one process, this one raises.
- ``pod_mesh`` builds the (data, model, sp) mesh the JAX function builds
  (parallel/mesh.py::make_mesh).
- The exchanges the rings, Ulysses and the model run (``Hop``,
  ``all_to_all``, ``all_gather``, ``all_reduce``) go over a group's backend as
  it is, except gloo with tensors on the card: gloo reads host memory, so
  each exchange is staged through it in the open (a copy into page-locked
  host memory before it, a copy back after it). ``transport`` names the
  route, and the first exchange of each kind on a route prints it (to
  standard error).
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_ANNOUNCED: set[tuple[str, str]] = set()


def initialize_distributed(backend: str, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           timeout: float | None = None) -> None:
    """Start the default process group (idempotent for the same backend).

    Args:
      backend: "nccl" (each rank owns a card: rank r takes card LOCAL_RANK,
        else r) or "gloo" (the CPU, or ranks that share one card: their
        exchanges are staged through host memory). Required: the port does
        not pick one.
      init_method: "tcp://host:port", "file:///path", or None for "env://"
        (MASTER_ADDR and MASTER_PORT).
      world_size, rank: this run's; None reads WORLD_SIZE and RANK.
      timeout: seconds a collective may wait before it fails.

    Raises ValueError for an unknown backend or a missing world size or
    rank, and RuntimeError when the group is up with another backend or
    NCCL finds no card of its own for this rank.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group is up with {have!r}, not {backend!r}")
        return
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if backend == "nccl":
        card = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or card >= torch.cuda.device_count():
            raise RuntimeError(
                f"nccl needs a card for each rank, and rank {rank} finds none of its own "
                f"({torch.cuda.device_count()} visible): ranks that share a card use gloo")
        torch.cuda.set_device(card)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"pass {name.lower()} or set {name}: a run of several processes "
                         "names its size and each process its rank")
    return int(os.environ[name])


def pod_mesh(data: int | None = None, model: int = 1, sp: int = 1):
    """The (data, model, sp) mesh over every rank, `data` outermost (the JAX
    function's axis order: the axes with an exchange every layer innermost);
    data defaults to what model * sp leaves. See parallel/mesh.py::make_mesh."""
    from flashattn_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    inner = model * sp
    if data is None:
        if n % inner:
            raise ValueError(f"{n} ranks do not split into model {model} x sp {sp}")
        data = n // inner
    if data * inner != n:
        raise ValueError(f"data {data} x model {model} x sp {sp} != {n} ranks")
    return make_mesh({"data": data, "model": model, "sp": sp})


def transport(group, device: torch.device) -> str:
    """The route of a group's exchanges of tensors on `device`: "nccl",
    "gloo", or "gloo-host" (gloo with tensors on the card, staged through
    host memory)."""
    backend = dist.get_backend(group)
    return "gloo-host" if backend == "gloo" and device.type == "cuda" else backend


def _announce(route: str, what: str) -> None:
    if (route, what) not in _ANNOUNCED:
        _ANNOUNCED.add((route, what))
        print(f"[parallel] rank {dist.get_rank()}: {what} over {route}", file=sys.stderr,
              flush=True)


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """An empty host tensor of t's shape and type in page-locked memory:
    PyTorch's caching host allocator hands the same buffers back exchange
    after exchange, and a copy between one and the card runs at the link's
    rate, where .cpu() takes fresh pageable memory every time."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _host(t: torch.Tensor, staged: bool) -> torch.Tensor:
    return _pinned_like(t).copy_(t) if staged else t.contiguous()


def _receiver(src: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty tensor like the sent `src` for an exchange to write into."""
    return _pinned_like(src) if staged else torch.empty_like(src)


class Hop:
    """One posted exchange of tensors with the group's next and previous
    ranks (a ring hop, or any shift): each tensor goes to the rank `shift`
    places on and the same-shaped tensor comes from the rank `shift` places
    back, by one ``dist.batch_isend_irecv``, posted at construction. The
    caller runs its compute, then ``wait()`` returns the received tensors
    on the senders' device. Over gloo-host the sends are copied to the host
    before the post and the receipts back to the card after the wait."""

    def __init__(self, tensors: list[torch.Tensor], group=None, shift: int = 1):
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.device = tensors[0].device
        route = transport(group, self.device)
        _announce(route, "ring hops")
        self.staged = route == "gloo-host"
        sends = [_host(t, self.staged) for t in tensors]
        self.recvs = [_receiver(t, self.staged) for t in sends]
        g = group or dist.group.WORLD
        to = dist.get_global_rank(g, (me + shift) % n)
        frm = dist.get_global_rank(g, (me - shift) % n)
        ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, frm, group) for t in self.recvs]
        self.sends = sends  # held until the wait
        self.reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> list[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        self.sends = None
        if self.staged:
            return [t.to(self.device) for t in self.recvs]
        return self.recvs


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_to_all_single of x's leading dimension (split in equal parts,
    part i to the group's rank i), staged over gloo-host."""
    route = transport(group, x.device)
    _announce(route, "all-to-all")
    staged = route == "gloo-host"
    src = _host(x, staged)
    out = _receiver(src, staged)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *x.shape]: every rank's x in the group's rank order, staged over
    gloo-host."""
    route = transport(group, x.device)
    _announce(route, "all-gather")
    staged = route == "gloo-host"
    src = _host(x, staged)
    parts = [_receiver(src, staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The SUM (or another `op`, such as MAX) of x over the group, in place
    (x returned), staged over gloo-host."""
    route = transport(group, x.device)
    _announce(route, "all-reduce")
    if route != "gloo-host":
        dist.all_reduce(x, op=op, group=group)
        return x
    host = _host(x, True)
    dist.all_reduce(host, op=op, group=group)
    return x.copy_(host)
