"""A named mesh of ranks and the global-view sharded attention (counterpart
of flashattn_tpu/parallel/mesh.py).

``make_mesh({"data": 2, "sp": 2})`` lays the default group's ranks out
row-major over named axes and makes, for each axis, the process group of
the ranks that differ along it alone (every rank creates every group, in
one order, as torch.distributed requires). ``sharded_ring_attention`` is the
JAX function's global view: every rank passes the whole [B, H, S, D]
arrays and gets the whole output back, as a program over jax.shard_map
does; inside, batch over `data` and heads over `model` are local slices and
only the sequence axis `sp` communicates (ring, zigzag ring or Ulysses).
Under that contract every rank computes the same function of the output,
so the gradient of the output is the same on every rank: the backward of
the gather keeps this rank's block of it, and the backward of the slicing
gathers every rank's block into the whole gradient.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from flashattn_tpu_torch.ops.flash_fwd import default_alibi_slopes
from flashattn_tpu_torch.parallel.distributed import all_gather, all_reduce
from flashattn_tpu_torch.parallel.ring import (
    ring_flash_attention,
    zigzag_ring_flash_attention,
    zigzag_shard,
    zigzag_unshard,
)
from flashattn_tpu_torch.parallel.ulysses import ulysses_flash_attention

MODES = ("ring", "zigzag", "ulysses")


class Mesh:
    """Ranks over named axes: ``shape`` {axis: size} (in axis order),
    ``coords`` {axis: this rank's index along it}, ``group(axis)`` the
    process group of the ranks along the axis through this rank."""

    def __init__(self, shape: dict[str, int], coords: dict[str, int], groups: dict):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self._groups = groups

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def group(self, axis: str):
        return self._groups[axis]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def active(self) -> tuple[str, ...]:
        """The axes above size 1."""
        return tuple(a for a, n in self.shape.items() if n > 1)

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The SUM of x over the ranks that differ along `axes` (those of them
        above size 1), in place: one all-reduce over the default group when
        they are every axis above size 1, else one an axis."""
        axes = [a for a in axes if self.size(a) > 1]
        if axes and set(axes) == set(self.active()):
            return all_reduce(x)
        for axis in axes:
            all_reduce(x, self.group(axis))
        return x

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(axes: Mapping[str, int]) -> Mesh:
    """A Mesh of {axis: size} over every rank of the default process group
    (sizes multiply to its size; axis order = the mapping's, the first
    outermost). Without a process group the sizes must all be 1."""
    shape = {name: int(size) for name, size in axes.items()}
    n = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(tuple(shape.values()))
    coords = dict(zip(shape, (int(i) for i in np.unravel_index(rank, grid.shape))))
    groups = {}
    for ax, name in enumerate(shape):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[name]):
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if dist.is_initialized() else None
            if rank in ranks:
                groups[name] = group
    return Mesh(shape, coords, groups)


def local_block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global tensor whose dimension d splits over
    the axis spec[d] (None: whole), as jax.sharding's PartitionSpec reads;
    axes of size 1 or absent from the mesh split nothing."""
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not split over "
                                 f"{axis} ({n} ranks)")
            part = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axis) * part, part)
    return x


def full_tensor(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The global tensor of local_block's blocks: an all-gather over each
    axis of `spec` above size 1. Every rank of those axes calls it."""
    for dim, axis in enumerate(spec):
        if axis and mesh.size(axis) > 1:
            x = torch.cat(list(all_gather(x.contiguous(), mesh.group(axis)).unbind(0)), dim=dim)
    return x


class _Scatter(torch.autograd.Function):
    """This rank's block of a global-view tensor; the backward gathers every
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return local_block(x, spec, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return full_tensor(g, ctx.spec, ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    """The global-view tensor of every rank's block; the backward keeps this
    rank's block of the gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return full_tensor(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return local_block(g, ctx.spec, ctx.mesh).contiguous(), None, None


def sharded_ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    is_causal: bool = False,
    scale: float | None = None,
    *,
    seq_axis: str = "sp",
    batch_axis: str | None = "data",
    head_axis: str | None = "model",
    mode: str = "ring",
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Global-view [B, H, S, D] attention sharded over `mesh`; every rank
    calls it with the same global q, k, v and gets the global O.

    Batch over `batch_axis`, heads over `head_axis` (local slices), the
    sequence over `seq_axis` with the ring ("ring"), the zigzag ring
    ("zigzag", causal only: the layout permutation, of the tokens and the
    segment ids, happens here) or Ulysses ("ulysses"). Axes absent from the
    mesh are ignored. The variants ride every mode; the ALiBi slope table
    is built globally and sliced with the heads. segment_ids: [B, S]
    packed-document ids. The backward kernels are flash_attention_backward's
    impl="auto" choice (FLASHATTN_BWD_IMPL selects it)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if seq_axis not in mesh.axis_names:
        raise ValueError(f"{seq_axis!r} is not an axis of {mesh}")
    n_sp = mesh.size(seq_axis)
    spec = tuple(a if a in mesh.axis_names else None for a in (batch_axis, head_axis)) + (
        seq_axis, None)
    slopes = None
    if alibi:
        slopes = local_block(default_alibi_slopes(q.shape[1]).to(q.device), spec[1:2], mesh)
    if mode == "zigzag":
        if not is_causal:
            raise ValueError("the zigzag layout is for causal attention: use mode='ring'")
        q, k, v = (zigzag_shard(x, n_sp) for x in (q, k, v))
        if segment_ids is not None:
            segment_ids = zigzag_shard(segment_ids, n_sp, axis=1)
    q_l, k_l, v_l = (_Scatter.apply(x, mesh, spec) for x in (q, k, v))
    segs = None
    if segment_ids is not None:
        seg_l = local_block(segment_ids.to(torch.int32), spec[::2], mesh).contiguous()
        segs = (seg_l, seg_l)
    group = mesh.group(seq_axis)
    variants = dict(window=window, logit_softcap=logit_softcap, alibi=alibi,
                    dropout_rate=dropout_rate, dropout_seed=dropout_seed, segment_ids=segs)
    if mode == "zigzag":
        o = zigzag_ring_flash_attention(q_l, k_l, v_l, group, scale, alibi_slopes=slopes,
                                        **variants)
    elif mode == "ulysses":
        o = ulysses_flash_attention(q_l, k_l, v_l, group, is_causal, scale, alibi_slopes=slopes,
                                    **variants)
    else:
        o = ring_flash_attention(q_l, k_l, v_l, group, is_causal, scale, alibi_slopes=slopes,
                                 **variants)
    o = _Gather.apply(o, mesh, spec)
    return zigzag_unshard(o, n_sp) if mode == "zigzag" else o
