"""Mixture-of-experts FFN on one device (counterpart of flashattn_tpu/parallel/moe.py).

Top-k routing with no capacity and no dropped token: each token's FFN
output is the sum over its k picked experts of gate x SwiGLU expert(x).

- ``moe_ffn_dense_reference`` is the JAX module's single-device function
  and the plain version here: masked-dense, every expert over every token,
  a float32 accumulator in ascending expert id. On the card it would read
  every expert at every decode step (Qwen3-30B-A3B: 58 GB a step).
- ``moe_ffn_grouped`` is the card route, the same function by a grouped
  dispatch: the T·k (token, pick) pairs sorted by expert (a stable sort),
  each expert's rows through its three products in one grouped product
  each (``torch._grouped_mm``, the expert offsets on the device), the
  outputs gathered back through the inverse permutation and summed in
  float32 in each token's ascending expert order, the dense loop's order.
  The gather of each token's k rows (``gather_pairs``) takes its gradient
  the same way back: the k pair gradients of a token summed in float32 in
  ascending expert id and rounded once, with no atomics, so the backward
  gives the same bits at every run. It rounds where the JAX function
  does: g and u in the compute dtype, act(g) in float32 rounded to it,
  times u, then y in it. It reads nothing
  back to the host and makes no shape that depends on the data (the
  counts by a fixed-size scatter_add_ into E counters; no bincount,
  nonzero, unique or boolean indexing), so a CUDA graph captures it with
  the decode step (models/generate.py::DecodeGraph). The CPU runs the
  same code.

Expert parallelism, the experts split over the ranks of a process group
(the JAX functions' ``ep`` axis; each rank passes its block of the stacked
experts, the router whole):

- ``moe_ffn``, masked-dense: every rank runs its E/n experts over every
  token (passed whole on every rank), each weighted by the router's gate
  (0 where unpicked), and the float32 sums are summed over the group.
  Exact: no capacity, no dropped token.
- ``moe_ffn_a2a``, GShard's capacity dispatch: tokens split over the
  group; each rank packs its (token, pick) pairs into per-expert queues
  of `capacity` slots (choice-major priority: every first pick claims its
  slot before any second pick; past the capacity a pair is dropped), one
  all_to_all ships every expert its queues from every rank, the experts
  run as batched products, a second all_to_all brings the outputs back,
  and each token sums its kept picks times their gates in pick order. Each
  kept pair owns one slot, so the dispatch is an index copy and the
  combine a gather, both ways free of float atomics (``_SlotCopy``,
  ``_SlotGather``).

Both apply copy_to_group to the router's weight (and moe_ffn to the
tokens): a rank's gradient of each is a share (its experts' gates, or its
tokens), and the backward sums the shares over the group, so every rank
holds the whole gradient of what it holds whole. On a group of one process
(or without a process group) each is the single-device function.

The expert products are plain matrix products, which the JAX package
leaves to XLA outside any Pallas kernel; PyTorch computes them here
(``torch._grouped_mm``, ``torch.matmul`` and ``torch.bmm``), as
torch.matmul computes the dense projections.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from flashattn_tpu_torch.parallel.collectives import (all_to_all_group, copy_to_group,
                                                      reduce_from_group)
from flashattn_tpu_torch.parallel.ring import group_size_rank

ROUTED = ("router", "w_gate", "w_up", "w_down")  # the routed experts' parameters


class Experts(nn.Module):
    """A MoE layer's parameters, the JAX tree's ``layers[i]["moe"]``: router
    [H, E], w_gate and w_up [E, H, F], w_down [E, F, H] (experts stacked on
    axis 0, each in [in, out] layout); with a shared expert of width
    `shared` (Qwen2-MoE), ``shared.{w_gate, w_up, w_down}`` and
    ``shared_gate`` [H, 1]."""

    def __init__(self, hidden: int, intermediate: int, num_experts: int, shared: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cuda"):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        self.router = param(hidden, num_experts)
        self.w_gate = param(num_experts, hidden, intermediate)
        self.w_up = param(num_experts, hidden, intermediate)
        self.w_down = param(num_experts, intermediate, hidden)
        if shared:
            self.shared = nn.Module()
            self.shared.w_gate = param(hidden, shared)
            self.shared.w_up = param(hidden, shared)
            self.shared.w_down = param(shared, hidden)
            self.shared_gate = param(hidden, 1)

    def routed(self) -> dict[str, torch.Tensor]:
        """The routed experts' parameters as the FFN functions take them."""
        return {name: getattr(self, name) for name in ROUTED}


@torch.no_grad()
def init_moe_params(generator: torch.Generator, hidden: int, intermediate: int,
                    num_experts: int, dtype: torch.dtype = torch.float32
                    ) -> dict[str, torch.Tensor]:
    """Router and SwiGLU experts at the JAX package's scales (normal draws
    in float32 times h**-0.5, w_down's times f**-0.5, cast to `dtype`),
    experts stacked on axis 0, on the generator's device."""
    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * scale).to(dtype)

    e, h, f = num_experts, hidden, intermediate
    return {"router": dense((h, e), h**-0.5), "w_gate": dense((e, h, f), h**-0.5),
            "w_up": dense((e, h, f), h**-0.5), "w_down": dense((e, f, h), f**-0.5)}


def router_gates(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 norm_topk: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, H] -> (expert ids [T, k] int64, gates [T, k] float32), the
    picks in descending logit order.

    The logits are float32 (x and the router cast up; a float32 product on
    the card runs in full float32 unless a caller turns TF32 on, and it
    must not: near-ties between the k-th and (k+1)-th logit decide a pick).
    norm_topk (Mixtral, Qwen3-MoE): a softmax over the picked logits;
    without it (Qwen2-MoE) the picks keep their probabilities of the full
    softmax, exp(top - logsumexp(all))."""
    logits = torch.matmul(x.float(), router_w.float())
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    if norm_topk:
        gates = torch.softmax(top_vals, dim=-1)
    else:
        gates = torch.exp(top_vals - torch.logsumexp(logits, dim=-1, keepdim=True))
    return top_idx, gates


def _act(g: torch.Tensor, name: str) -> torch.Tensor:
    """The MLP's activation of a float32 tensor: tanh-approximate GELU
    ("gelu_tanh") or SiLU."""
    return F.gelu(g, approximate="tanh") if name == "gelu_tanh" else F.silu(g)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
           act: str = "silu") -> torch.Tensor:
    """One gated expert: (act(x wg) * (x wu)) wd, each product in x's dtype,
    the activation in float32."""
    g = torch.matmul(x, wg)
    u = torch.matmul(x, wu)
    return torch.matmul(_act(g.float(), act).to(x.dtype) * u, wd)


def moe_ffn_dense_reference(x: torch.Tensor, params: Mapping[str, torch.Tensor],
                            top_k: int = 2, activation: str = "silu",
                            norm_topk: bool = True) -> torch.Tensor:
    """The plain version: every expert over every token, each token's output
    the sum of y x its gate (0 where unpicked) in a float32 accumulator, in
    ascending expert id; x [T, H] -> [T, H] in x's dtype."""
    ids, gates = router_gates(x, params["router"], top_k, norm_topk)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(params["w_gate"].shape[0]):
        weight = torch.where(ids == j, gates, 0.0).sum(dim=-1)
        y = swiglu(x, params["w_gate"][j], params["w_up"][j], params["w_down"][j], activation)
        acc = acc + y.float() * weight[:, None]
    return acc.to(x.dtype)


class _PairGather(torch.autograd.Function):
    """x [T, H] -> xs [T k, H], row i token src[i]'s (the pairs in expert
    order); the backward brings each pair's gradient back to its token
    through the inverse permutation `inv` (pair p = t k + j, token t's
    j-th pick in ascending expert id, sits at row inv[p]) and sums a
    token's k rows in float32 in pick order, rounded once to x's dtype.
    index_select's own backward (index_add_) would add the k rows by
    float atomics in x's dtype, in the order they land on the card."""

    @staticmethod
    def forward(ctx, x, src, inv, top_k):
        ctx.save_for_backward(inv)
        ctx.top_k = top_k
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        pairs = g.index_select(0, inv).view(-1, ctx.top_k, g.shape[1])
        acc = pairs[:, 0].float()
        for j in range(1, ctx.top_k):  # a fixed order: the same sum at every run
            acc = acc + pairs[:, j].float()
        return acc.to(g.dtype), None, None, None


def gather_pairs(x: torch.Tensor, src: torch.Tensor, inv: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """x.index_select(0, src), its backward a fixed-order float32 sum of
    each token's k pair gradients (_PairGather)."""
    return _PairGather.apply(x, src, inv, top_k)


def moe_ffn_grouped(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int = 2,
                    activation: str = "silu", norm_topk: bool = True) -> torch.Tensor:
    """moe_ffn_dense_reference's function by a grouped dispatch (the module
    docstring): x [T, H] -> [T, H] in x's dtype. The products touch only
    the picked experts' weights and rows."""
    t, h = x.shape
    e = params["router"].shape[1]
    ids, gates = router_gates(x, params["router"], top_k, norm_topk)
    # Each token's picks in ascending expert id: the dense loop's order.
    ids, order = torch.sort(ids, dim=-1)
    gates = gates.gather(-1, order)
    flat = ids.reshape(-1)  # pair p is token p // k's pick
    n = flat.shape[0]
    perm = torch.sort(flat, stable=True).indices  # the pairs grouped by expert
    counts = torch.zeros(e, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)  # each expert's end row
    inv = torch.empty_like(perm).scatter_(0, perm, torch.arange(n, device=x.device))
    xs = gather_pairs(x, perm // top_k, inv, top_k)
    g = torch._grouped_mm(xs, params["w_gate"], offs=offs)
    u = torch._grouped_mm(xs, params["w_up"], offs=offs)
    a = _act(g.float(), activation).to(x.dtype) * u
    ys = torch._grouped_mm(a, params["w_down"], offs=offs)
    y = ys.index_select(0, inv).view(t, top_k, h)
    acc = y[:, 0].float() * gates[:, :1]
    for j in range(1, top_k):  # a fixed order: no atomics, the same sum at every run
        acc = acc + y[:, j].float() * gates[:, j:j + 1]
    return acc.to(x.dtype)


def router_aux_loss(x: torch.Tensor, router_w: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """The Switch Transformer's load-balancing loss, E · Σ_e f_e · p_e: f_e
    the share of tokens whose top pick is e, p_e the mean router
    probability of e (1 at uniform dispatch). top_k is unused, as in the
    JAX function."""
    e = router_w.shape[1]
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    f = F.one_hot(logits.argmax(dim=-1), e).float().mean(dim=0)
    return e * (f * probs.mean(dim=0)).sum()


def moe_ffn(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int = 2,
            group=None, activation: str = "silu", norm_topk: bool = True) -> torch.Tensor:
    """The masked-dense expert-parallel FFN; every rank of `group` calls it
    with the same tokens x [T, H], the router whole and its block of E/n
    experts (rank r: experts r E/n ... (r + 1) E/n - 1) -> [T, H] in x's
    dtype on every rank: the JAX function's loop over the local experts
    (float32 accumulator, ascending expert id) and its psum."""
    n, idx = group_size_rank(group)
    e_local = params["w_gate"].shape[0]
    x = copy_to_group(x, group)
    ids, gates = router_gates(x, copy_to_group(params["router"], group), top_k, norm_topk)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(e_local):
        weight = torch.where(ids == idx * e_local + j, gates, 0.0).sum(dim=-1)
        y = swiglu(x, params["w_gate"][j], params["w_up"][j], params["w_down"][j], activation)
        acc = acc + y.float() * weight[:, None]
    return reduce_from_group(acc, group).to(x.dtype)


def default_capacity(capacity_factor: float, top_k: int, tokens: int, num_experts: int) -> int:
    """A queue's slots, the JAX function's default: ceil(cf k T_local / E)
    (at least 1) rounded up to a multiple of 8."""
    c = max(1, math.ceil(capacity_factor * top_k * tokens / num_experts))
    return -(-c // 8) * 8


def capacity_slots(ids: torch.Tensor, num_experts: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The queue slots of a rank's picks ids [T, k] -> (dest [k T], keep
    [k T]), choice-major (entry c T + t is token t's pick c): an entry's
    position in its expert's queue is the count of earlier entries of the
    same expert, it is kept below `capacity`, and a kept entry's slot is
    expert * capacity + position, a dropped one's num_experts * capacity
    (past the queues). The JAX function's cumsum of one-hots, bit for bit."""
    ids_cm = ids.t().reshape(-1)
    onehot = F.one_hot(ids_cm, num_experts).to(torch.int32)
    pos = (torch.cumsum(onehot, 0) - onehot).gather(1, ids_cm[:, None])[:, 0]
    keep = pos < capacity
    dest = torch.where(keep, ids_cm * capacity + pos, num_experts * capacity)
    return dest, keep


class _SlotCopy(torch.autograd.Function):
    """rows [N, H] into `slots` queue rows by an index copy (dest: each kept
    row's own slot; the dropped ones' index `slots` falls off the end);
    the backward gathers each row's slot of the gradient (0 for a dropped
    one)."""

    @staticmethod
    def forward(ctx, rows, dest, slots):
        ctx.save_for_backward(dest)
        out = rows.new_zeros(slots + 1, rows.shape[1])
        return out.index_copy_(0, dest, rows.contiguous())[:slots]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        return torch.cat([g, g.new_zeros(1, g.shape[1])]).index_select(0, dest), None, None


class _SlotGather(torch.autograd.Function):
    """Each entry's queue row of queue [slots, H] (dest; a dropped entry's
    `slots` reads zeros); the backward copies each kept entry's gradient
    into its own slot."""

    @staticmethod
    def forward(ctx, queue, dest):
        ctx.save_for_backward(dest)
        ctx.slots = queue.shape[0]
        return torch.cat([queue, queue.new_zeros(1, queue.shape[1])]).index_select(0, dest)

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        out = g.new_zeros(ctx.slots + 1, g.shape[1]).index_copy_(0, dest, g.contiguous())
        return out[:ctx.slots], None


def moe_ffn_a2a(x: torch.Tensor, params: Mapping[str, torch.Tensor], top_k: int = 2,
                group=None, capacity_factor: float = 2.0, capacity: int | None = None,
                activation: str = "silu", norm_topk: bool = True) -> torch.Tensor:
    """GShard's all_to_all capacity dispatch (module docstring); every rank
    of `group` calls it with its block of the tokens x [T_local, H], the
    router whole and its block of E/n experts -> [T_local, H] in x's dtype,
    its tokens' outputs.

    capacity: the slots of each (expert, source rank) queue; None for
    default_capacity(capacity_factor, top_k, T_local, E). A pick past its
    expert's capacity is dropped: it adds nothing to its token's output."""
    n, _ = group_size_rank(group)
    e = params["router"].shape[1]
    e_local = params["w_gate"].shape[0]
    if e_local * n != e:
        raise ValueError(f"{e} experts in blocks of {e_local} over {n} ranks")
    t, h = x.shape
    if capacity is None:
        capacity = default_capacity(capacity_factor, top_k, t, e)
    ids, gates = router_gates(x, copy_to_group(params["router"], group), top_k, norm_topk)
    dest, keep = capacity_slots(ids, e, capacity)
    queues = _SlotCopy.apply(x.repeat(top_k, 1), dest, e * capacity)  # [E C, H]
    # expert j's queues go to the rank holding it; each rank gets [n, E/n, C, H]
    got = all_to_all_group(queues.view(n, e_local, capacity, h), group)
    ein = got.transpose(0, 1).reshape(e_local, n * capacity, h)
    g = torch.bmm(ein, params["w_gate"])
    u = torch.bmm(ein, params["w_up"])
    y = torch.bmm(_act(g.float(), activation).to(x.dtype) * u, params["w_down"])
    back = all_to_all_group(y.view(e_local, n, capacity, h).transpose(0, 1).contiguous(), group)
    y_tok = _SlotGather.apply(back.reshape(e * capacity, h), dest)  # [k T, H]
    w = (gates.t().reshape(-1) * keep).view(top_k, t, 1)
    parts = y_tok.float().view(top_k, t, h) * w
    out = parts[0]
    for j in range(1, top_k):  # the picks in order, as the JAX reshape(k, T, H).sum(0)
        out = out + parts[j]
    return out.to(x.dtype)
