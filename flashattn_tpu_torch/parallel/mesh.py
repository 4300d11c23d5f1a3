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
from flashattn_tpu_torch.parallel.distributed import all_gather
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

    def rank_coords(self, rank: int) -> dict[str, int]:
        """The coordinates of a rank of the default group."""
        return dict(zip(self.shape, np.unravel_index(rank, tuple(self.shape.values()))))

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


def _blocks(mesh: Mesh, dims: dict[str, int], coords: dict[str, int], shape) -> tuple:
    """The index of the block of a global tensor of `shape` that the rank at
    `coords` holds when axis a of dims splits tensor dimension dims[a]."""
    index = [slice(None)] * len(shape)
    for axis, dim in dims.items():
        n = mesh.size(axis)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} ({shape[dim]}) does not split over {axis} "
                             f"({n} ranks)")
        part = shape[dim] // n
        index[dim] = slice(coords.get(axis, 0) * part, (coords.get(axis, 0) + 1) * part)
    return tuple(index)


def _assemble(mesh: Mesh, dims: dict[str, int], local: torch.Tensor, shape) -> torch.Tensor:
    """The global tensor from every rank's block (an all-gather over the
    default group)."""
    parts = all_gather(local.contiguous())
    out = local.new_empty(shape)
    for rank, part in enumerate(parts):
        out[_blocks(mesh, dims, mesh.rank_coords(rank), shape)] = part
    return out


class _Scatter(torch.autograd.Function):
    """This rank's block of a global-view tensor; the backward gathers every
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims, ctx.shape = mesh, dims, x.shape
        return x[_blocks(mesh, dims, mesh.coords, x.shape)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _assemble(ctx.mesh, ctx.dims, g, ctx.shape), None, None


class _Gather(torch.autograd.Function):
    """The global-view tensor of every rank's block; the backward keeps this
    rank's block of the gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, shape):
        ctx.mesh, ctx.dims = mesh, dims
        return _assemble(mesh, dims, x, shape)

    @staticmethod
    def backward(ctx, g):
        return g[_blocks(ctx.mesh, ctx.dims, ctx.mesh.coords, g.shape)].contiguous(), None, None, None


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
    dims = {seq_axis: 2}
    if batch_axis in mesh.axis_names:
        dims[batch_axis] = 0
    if head_axis in mesh.axis_names:
        dims[head_axis] = 1
    slopes = None
    if alibi:
        table = default_alibi_slopes(q.shape[1]).to(q.device)
        n_h = mesh.size(head_axis) if head_axis in dims else 1
        part = q.shape[1] // n_h
        slopes = table[mesh.index(head_axis) * part:(mesh.index(head_axis) + 1) * part]
    if mode == "zigzag":
        if not is_causal:
            raise ValueError("the zigzag layout is for causal attention: use mode='ring'")
        q, k, v = (zigzag_shard(x, n_sp) for x in (q, k, v))
        if segment_ids is not None:
            segment_ids = zigzag_shard(segment_ids, n_sp, axis=1)
    out_shape = q.shape
    q_l, k_l, v_l = (_Scatter.apply(x, mesh, dims) for x in (q, k, v))
    segs = None
    if segment_ids is not None:
        seg_dims = {a: (0 if d == 0 else 1) for a, d in dims.items() if d != 1}
        seg = segment_ids.to(torch.int32)
        seg_l = seg[_blocks(mesh, seg_dims, mesh.coords, seg.shape)].contiguous()
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
    o = _Gather.apply(o, mesh, dims, out_shape)
    return zigzag_unshard(o, n_sp) if mode == "zigzag" else o
