"""The exchanges of the tensor-, pipeline- and expert-parallel layers as
autograd Functions over one process group (the collectives that GSPMD and
shard_map's transposes insert in the JAX package).

- ``copy_to_group`` (Megatron's f): identity forward, the SUM of the
  gradient over the group backward. It stands before a product whose weight
  is split over the group (column-parallel), so that the input's gradient,
  partial on each rank, comes out whole.
- ``reduce_from_group`` (Megatron's g): the SUM over the group forward,
  identity backward. It closes a row-parallel product; every rank then
  computes the same function of the sum, so each passes its own gradient
  on unchanged.
- ``gather_from_group``: every rank's block concatenated along a dimension;
  the backward keeps this rank's block (every rank holds the same gradient
  of the whole).
- ``split_to_group``: this rank's block; the backward gathers every rank's
  block of the gradient.
- ``all_to_all_group``: parallel/distributed.py's all_to_all (the leading
  dimension split in equal parts); with equal parts it is its own inverse,
  so its backward is the same exchange.
- ``keep_gradient``: identity forward; the backward passes the gradient on
  this rank only where `keep` holds, zeros elsewhere (a replicated value's
  gradient counted on one rank of a group).

Over gloo with tensors on the card each exchange is staged through host
memory (parallel/distributed.py). A group of one process (or no process
group at all) exchanges nothing: each function is then the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flashattn_tpu_torch.parallel.distributed import all_gather, all_reduce, all_to_all


def _rank(group) -> int:
    return dist.get_rank(group)


def _alone(group) -> bool:
    return not dist.is_initialized() or dist.get_world_size(group) == 1


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return torch.cat(list(all_gather(x.contiguous(), group).unbind(0)), dim=dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not split over {n} ranks")
    part = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * part, part).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x; its gradient summed over `group` (Megatron's f)."""
    return x if _alone(group) else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; the gradient passes unchanged (Megatron's g)."""
    return x if _alone(group) else _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in the group's rank order."""
    return x if _alone(group) else _Gather.apply(x, group, dim)


def split_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of x along `dim` (equal blocks in rank order)."""
    return x if _alone(group) else _Split.apply(x, group, dim)


def all_to_all_group(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all of x's leading dimension over `group`, differentiable."""
    return x if _alone(group) else _AllToAll.apply(x, group)


def keep_gradient(x: torch.Tensor, keep: bool) -> torch.Tensor:
    """x; its gradient on this rank only if `keep`."""
    return _Keep.apply(x, keep)
