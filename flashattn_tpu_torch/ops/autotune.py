"""The measured fused-or-split backward choice (counterpart of
flashattn_tpu/ops/autotune.py).

``autotune`` times the fused backward (B3) against the split pair (B4 +
B5) on the card at the operands' shape and keeps the winner in a JSON
cache; ``cached_bwd_impl`` returns it, and ops/flash_bwd.py's
``resolve_impl`` takes it for ``impl="auto"``. The cache lives at
``FLASHATTN_TPU_TORCH_AUTOTUNE_CACHE``, or else
``~/.cache/flashattn_tpu_torch/autotune.json``: another file than the JAX
package's, so a TPU winner is never read. Its keys are the JAX module's
(``_key``), on the card's name. No table of winners ships with the package.

Left out: the JAX module's tile sweeps (``BlockSizes``, ``FWD_CONFIGS``,
``BWD_CONFIGS``, ``FUSED_CONFIGS``, ``default_block_sizes``,
``lookup_block_sizes``) and its decode tile (``cached_decode_block_kv``,
``save_decode_block_kv``) choose Pallas tile sizes. The port's kernels
have one tile per head dim, fixed in csrc/, so there is nothing to choose;
they come with the first port kernel that has more than one tile.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import sys

import torch

CACHE_ENV = "FLASHATTN_TPU_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = pathlib.Path.home() / ".cache" / "flashattn_tpu_torch" / "autotune.json"


def cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(CACHE_ENV, str(DEFAULT_CACHE)))


def load_cache() -> dict[str, dict]:
    """The cache file's entries (empty when there is none), read anew at
    each call: resolve_impl reads it at every backward call on the card,
    some tens of microseconds of host time beside a kernel's milliseconds."""
    try:
        return json.loads(cache_path().read_text())
    except FileNotFoundError:
        return {}


def save_entry(key: str, entry: dict) -> None:
    """Add or replace one entry of the cache file."""
    cache = load_cache()
    cache[key] = entry
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(cache, indent=1))
    tmp.replace(path)  # a reader never sees half a file


def device_kind() -> str:
    """The card's name without spaces, as the JAX module reads device_kind."""
    return torch.cuda.get_device_name().replace(" ", "")


def _key(b, hq, hkv, s_q, s_k, d, is_causal, dtype) -> str:
    dt = str(dtype).removeprefix("torch.")
    return f"{device_kind()}|b{b}h{hq}/{hkv}|sq{s_q}sk{s_k}d{d}|c{int(is_causal)}|{dt}"


def cached_bwd_impl(b, hq, hkv, s_q, s_k, d, is_causal, dtype) -> str | None:
    """The measured backward winner ("fused" or "split") for this shape on
    this card, or None when autotune never ran it."""
    entry = load_cache().get(_key(b, hq, hkv, s_q, s_k, d, is_causal, dtype))
    return entry.get("bwd_impl") if entry else None


def autotune(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool = False,
             scale: float | None = None, tune_backward: bool = True, verbose: bool = False,
             force: bool = False) -> dict | None:
    """Time the fused backward against the split one at the shape of q, k
    and v (CUDA tensors), cache the winner and return its entry,
    {"bwd_impl", "fused_ms", "split_ms"}. A cached entry is returned
    without measuring unless `force`. tune_backward=False measures nothing
    (the JAX module then tunes the forward's tiles alone, and K1 has one
    tile a head dim) and returns the cached entry or None. Raises ValueError
    for CPU tensors: the plain versions are not timed."""
    from flashattn_tpu_torch.ops.flash_bwd import flash_attention_backward
    from flashattn_tpu_torch.ops.flash_fwd import flash_attention_forward
    from flashattn_tpu_torch.utils.timing import cuda_time_ms

    if not q.is_cuda:
        raise ValueError(f"autotune times the kernels on the card: q is on {q.device}")
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    key = _key(b, hq, hkv, s_q, s_k, d, is_causal, q.dtype)
    hit = load_cache().get(key)
    if not tune_backward or (hit is not None and not force):
        return hit
    o, lse = flash_attention_forward(q, k, v, is_causal, scale)
    do = q  # any tensor of O's shape times the same work
    times = {impl: cuda_time_ms(functools.partial(
        flash_attention_backward, q, k, v, o, do, lse, is_causal, scale, impl))
        for impl in ("fused", "split")}
    entry = {"bwd_impl": "fused" if times["fused"] <= times["split"] else "split",
             "fused_ms": times["fused"], "split_ms": times["split"]}
    if verbose:
        print(f"[autotune] {key}: fused {times['fused']:.3f} ms, split {times['split']:.3f} ms "
              f"-> {entry['bwd_impl']}", file=sys.stderr)
    save_entry(key, entry)
    return entry
