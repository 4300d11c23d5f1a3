"""Decode against KV caches split over the ranks of a process group
(counterpart of flashattn_tpu/parallel/serving.py).

Two modes, as in the JAX module:

- heads: K2 is oblivious to the heads it is given, so a rank that holds
  its block of the kv heads (and of the query heads beside them) calls
  decode_attention or paged_decode_attention on it unchanged (the block
  table and the lengths whole on every rank); ``local_cache`` with
  ``head_specs`` cuts a rank's block of a whole cache.
- sequence: each rank holds a contiguous slice of every sequence's
  positions (a cache n times longer than one card holds), runs K2 with its
  LSE over its slice, and the slices' partials merge by the log-sum-exp
  rule: the LSEs' maximum over the ranks, then the sums of w * O and of w
  (w = exp(LSE - max)), the JAX function's pmax and psums
  (``merge_partials``; one process merging its slices: ``lse_merge``). A
  rank whose slice holds none of a sequence has LSE -inf and weight 0.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flashattn_tpu_torch.ops.decode import _decode_attention
from flashattn_tpu_torch.ops.kvcache import KVCache
from flashattn_tpu_torch.parallel.distributed import all_reduce
from flashattn_tpu_torch.parallel.mesh import local_block


def local_cache_lengths(global_len: torch.Tensor, n_shards: int,
                        cap_local: int) -> torch.Tensor:
    """[B] global lengths -> [n_shards, B] int32 local lengths of a
    contiguous split: shard i holds positions [i cap, (i + 1) cap)."""
    i = torch.arange(n_shards, device=global_len.device)[:, None]
    return (global_len[None].long() - i * cap_local).clamp(0, cap_local).to(torch.int32)


def _weights(lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """exp(LSE - m) with m's -inf read as 0 (m_safe): 0 for a slice that saw
    no key, never NaN."""
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    return torch.exp(lse - m_safe)


def _finish(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den == 0, torch.ones_like(den), den)[..., None]


def lse_merge(parts: list[tuple[torch.Tensor, torch.Tensor]]) -> tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """Slices' (O, LSE) held by one process merged by the log-sum-exp rule
    -> (O float32, LSE); a row no slice saw gets O 0 and LSE -inf."""
    lse = torch.stack([l for _, l in parts])
    m = lse.amax(0)
    w = _weights(lse, m)
    den = w.sum(0)
    o = _finish(sum(wi[..., None] * oi.float() for wi, (oi, _) in zip(w, parts)), den)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    return o, torch.where(den > 0, m_safe + torch.log(den), float("-inf"))


def merge_partials(o: torch.Tensor, lse: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slice's (O [..., D], LSE [...]) merged with every other
    rank's of `group` -> O float32, the same on every rank: an all-reduce
    MAX of the LSE, then one SUM of w * O and w together."""
    m = all_reduce(lse.clone(), group, op=dist.ReduceOp.MAX)
    w = _weights(lse, m)
    sums = all_reduce(torch.cat([w[..., None] * o.float(), w[..., None]], dim=-1), group)
    return _finish(sums[..., :-1], sums[..., -1])


def sequence_sharded_decode(q: torch.Tensor, cache: KVCache, group=None,
                            scale: float | None = None,
                            window: int | None = None) -> torch.Tensor:
    """Decode q [B, Hq, D] (the same on every rank of `group`) against this
    rank's slice of a sequence-split cache (its positions from 0, its local
    lengths) -> [B, Hq, D] in q's dtype: K2 with the LSE over the slice,
    merged over the group (merge_partials).

    A sliding window raises ValueError: the slices' positions are local
    (the JAX function asserts the same; split such caches over heads)."""
    if window is not None:
        raise ValueError("a sliding window with a sequence-split cache: split it over heads")
    o, lse = _decode_attention(q[:, :, None], cache, scale, with_lse=True)
    return merge_partials(o[:, :, 0], lse[:, :, 0], group).to(q.dtype)


def shard_cache(cache: KVCache, n_shards: int) -> KVCache:
    """A whole [B, Hkv, S, D] cache with each shard's local lengths ([n, B],
    local_cache_lengths) in place of the global ones: split over the
    sequence by cache_specs, each shard is a cache of its own."""
    s = cache.k.shape[2]
    if s % n_shards:
        raise ValueError(f"{s} positions do not split into {n_shards} shards")
    return dataclasses.replace(
        cache, length=local_cache_lengths(cache.length, n_shards, s // n_shards))


def cache_specs(seq_axis: str) -> dict[str, tuple]:
    """The block of each tensor of a shard_cache'd cache that a rank of
    `seq_axis` holds (local_cache's specs): k and v by positions, their
    scales [B, Hkv, 1, S] by positions, the [n, B] lengths by row."""
    return {"k": (None, None, seq_axis), "v": (None, None, seq_axis),
            "k_scale": (None, None, None, seq_axis), "v_scale": (None, None, None, seq_axis),
            "length": (seq_axis,)}


def head_specs(head_axis: str, paged: bool = False) -> dict[str, tuple]:
    """The specs of a cache split over kv heads (dim 1 of k, v and their
    scales, dense or paged); the lengths and a block table whole."""
    names = ("k_pages", "v_pages") if paged else ("k", "v")
    return {name: (None, head_axis) for name in names + ("k_scale", "v_scale")}


def local_cache(cache, specs: dict[str, tuple], mesh):
    """This rank's block of a cache (KVCache or PagedKVCache) under `specs`
    (cache_specs, head_specs), each tensor contiguous; a field without a
    spec is kept whole."""
    fields = {}
    for f in dataclasses.fields(cache):
        t = getattr(cache, f.name)
        if t is not None and f.name in specs:
            t = local_block(t, specs[f.name], mesh).contiguous()
        fields[f.name] = t
    return type(cache)(**fields)


def sharded_decode_attention(q: torch.Tensor, cache: KVCache, mesh, seq_axis: str = "sp",
                             scale: float | None = None) -> torch.Tensor:
    """The global view: every rank passes q [B, Hq, D] and the whole cache
    (global lengths); each decodes its slice of the positions over
    `seq_axis` and every rank gets the merged [B, Hq, D]."""
    n = mesh.size(seq_axis)
    local = local_cache(shard_cache(cache, n), cache_specs(seq_axis), mesh)
    local = dataclasses.replace(local, length=local.length[0])
    return sequence_sharded_decode(q, local, mesh.group(seq_axis), scale)
