"""Pipeline parallelism, GPipe's schedule over a process group (counterpart
of flashattn_tpu/parallel/pipeline.py).

The JAX function is one SPMD program: each device holds one stage of
layers, and M microbatches go through n stages in M + n - 1 ticks of a
``lax.scan``, the activations rotating to the next stage by ``ppermute``
after each tick; ``jax.grad`` runs the reverse schedule through the
ppermute's transpose. The port keeps that shape with one process a stage:

- every rank of the group runs the stage function at each of the M + n - 1
  ticks (stage 0 on microbatch t, the others on what the previous stage
  sent; a stage outside its window computes on zeros or garbage that no
  output keeps, the cost of an SPMD pipeline);
- the rotation to rank + 1 is an autograd Function (``_Rotate``), one
  ``batch_isend_irecv`` a tick (parallel/distributed.py's ``Hop``) whose
  backward sends the gradient to rank - 1. Every rank takes part in every
  rotation and its backward, in tick order: the selection of stage 0's
  input is a ``torch.where`` over both, as the JAX function's ``jnp.where``,
  so that its received tensor stays in the graph too;
- the last stage's outputs, zero elsewhere, are summed over the ranks at
  the end (all-reduce forward, identity backward: every rank computes the
  same function of the sum, so the last stage gets the gradient once).

With ``remat=True`` each tick's stage runs under
``torch.utils.checkpoint`` (non-reentrant): only its input is kept and the
backward recomputes the rest, as ``jax.checkpoint`` of the tick does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from flashattn_tpu_torch.parallel.collectives import reduce_from_group
from flashattn_tpu_torch.parallel.distributed import Hop
from flashattn_tpu_torch.parallel.ring import group_size_rank


class _Rotate(torch.autograd.Function):
    """x to the group's next rank, the previous rank's x back; the backward
    sends the gradient to the previous rank and takes the next one's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return Hop([x.contiguous()], group, shift=1).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return Hop([g.contiguous()], ctx.group, shift=-1).wait()[0], None


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, group=None,
                   remat: bool = False) -> torch.Tensor:
    """Run x through the group's n stages; every rank of `group` calls it.

    Args:
      stage_fn: (stage_params, activation) -> activation of the same shape,
        applied by every stage to its own parameters.
      stage_params: this rank's stage parameters (any object stage_fn takes).
      x: [M, microbatch, ...], M microbatches; every rank passes the same
        (only stage 0 reads it).
      group: the process group of the pipeline axis (None: the default).
      remat: checkpoint each tick's stage.

    Returns [M, microbatch, ...], the last stage's outputs, on every rank.
    """
    n, idx = group_size_rank(group)
    m = x.shape[0]
    fn = stage_fn
    if remat and torch.is_grad_enabled():
        fn = lambda p, t: checkpoint(stage_fn, p, t, use_reentrant=False)  # noqa: E731
    first = torch.tensor(idx == 0, device=x.device)
    carry = torch.zeros_like(x[0])
    outs = []
    ticks = m + n - 1
    for t in range(ticks):
        out = fn(stage_params, torch.where(first, x[min(t, m - 1)], carry))
        if t >= n - 1:  # the last stage's output for microbatch t - n + 1
            outs.append(out)
        if n > 1 and t < ticks - 1:  # the last tick's rotation would feed nothing
            carry = _Rotate.apply(out, group)
    y = torch.stack(outs)
    if n == 1:
        return y
    last = torch.tensor(idx == n - 1, device=x.device)
    return reduce_from_group(torch.where(last, y, torch.zeros_like(y)), group)


def stack_stage_params(per_stage_params: list[dict[str, torch.Tensor]]
                       ) -> dict[str, torch.Tensor]:
    """[stage 0's {name: tensor}, stage 1's, ...] -> {name: [n_stages, ...]}:
    a leading stage axis (a rank keeps its block of it: [1, ...])."""
    return {name: torch.stack([p[name] for p in per_stage_params])
            for name in per_stage_params[0]}


def unstack_stage_params(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A rank's block of stacked parameters, [1, ...] -> [...]: drop the
    (local, length-1) stage axis."""
    return {name: t[0] for name, t in stacked.items()}
