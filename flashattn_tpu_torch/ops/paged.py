"""Paged KV cache and paged flash-decode (counterpart of
flashattn_tpu/ops/paged.py).

One pool of fixed-size pages is shared by every slot of a batch, so device
memory holds the sum of the live contexts rather than batch x Smax:

  - ``k_pages``/``v_pages``: [num_pages, Hkv, page_size, D];
  - ``block_table``: [B, max_pages_per_seq] int32: logical block j of
    sequence b lives in physical page ``block_table[b, j]``;
  - the decode kernel is K2 itself (csrc/decode.cuh), reading each 64-position
    tile through the table. A paged and a dense cache of the same max_len
    and content give the same output, bit for bit.

Page ownership is decided on the host (``PageAllocator``). As in the dense
cache, every update here writes IN PLACE into the pool, table and lengths;
the bytes written are the JAX package's functional results, bit for bit.
Writes aimed at a page index >= num_pages (the server's sentinel for an
unowned block), at an inactive row or past the table are dropped.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattn_tpu_torch.ops import decode
from flashattn_tpu_torch.ops.common import card_device, cdiv, check_softcap
from flashattn_tpu_torch.ops.flash_fwd import alibi_table
from flashattn_tpu_torch.ops.kvcache import (KVCache, _raw, quantize_tokens,
                                             store_dtype_for)

# Paged K2 launches in this process, in any cache mode (set to 0 by callers
# that count a run), and those with a sliding window, a logit soft-cap or
# ALiBi (counted in both).
LAUNCHES = 0
WINDOW_LAUNCHES = 0
SOFTCAP_LAUNCHES = 0
ALIBI_LAUNCHES = 0

PAGE_MULTIPLE = decode.BLOCK_KV  # a kernel tile never straddles a page


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache of one layer (the pool is shared by all slots)."""

    k_pages: torch.Tensor  # [P, Hkv, page, D]: bf16 | f32 | int8 | fp8
    v_pages: torch.Tensor  # [P, Hkv, page, D]
    block_table: torch.Tensor  # [B, max_pages_per_seq] int32 physical pages
    length: torch.Tensor  # [B] int32: valid tokens per sequence
    k_scale: torch.Tensor | None = None  # [P, Hkv, 1, page] f32 (None unquantized)
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[0]

    @property
    def max_len(self) -> int:
        return self.block_table.shape[1] * self.page_size

    @property
    def batch(self) -> int:
        return self.block_table.shape[0]


def init_paged_cache(
    batch: int,
    num_kv_heads: int,
    num_pages: int,
    page_size: int,
    head_dim: int,
    max_pages_per_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    quant: str | None = None,  # None | "int8" | "fp8"
    device: torch.device | str = "cuda",
) -> PagedKVCache:
    """Allocate the page pool and an all-zeros block table.

    page_size must be a multiple of 64 (the JAX package takes multiples of
    128, which are too)."""
    if page_size <= 0 or page_size % PAGE_MULTIPLE:
        raise ValueError(f"page_size must be a multiple of {PAGE_MULTIPLE}: {page_size}")
    store_dtype, scales = store_dtype_for(quant, dtype)
    device = card_device(device)
    shape = (num_pages, num_kv_heads, page_size, head_dim)

    def ones():
        return torch.ones((num_pages, num_kv_heads, 1, page_size), dtype=torch.float32,
                          device=device)

    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=store_dtype, device=device),
        v_pages=torch.zeros(shape, dtype=store_dtype, device=device),
        block_table=torch.zeros((batch, max_pages_per_seq), dtype=torch.int32,
                                device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ones() if scales else None,
        v_scale=ones() if scales else None,
    )


class PageAllocator:
    """Host-side reference-counted page allocator.

    The server owns one allocator (every layer's table is the same, so pages
    are allocated per sequence, not per layer). Reference counts serve prefix
    caching: a shared prefix's pages are retained once per sequence using
    them and freed when the last reference is released."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._rc = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add a reference to pages already allocated (prefix sharing)."""
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"retain of free page {p}")
            self._rc[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)


def pages_needed(tokens: int, page_size: int) -> int:
    return cdiv(tokens, page_size)


def _as_pages(pages, device) -> torch.Tensor:
    return torch.as_tensor(pages, dtype=torch.int32).to(device)


def set_block_table(cache: PagedKVCache, slot: int, pages, length: int) -> PagedKVCache:
    """Install a sequence's page list (padded to max_pages_per_seq) and its
    length into `slot`, IN PLACE (admission). Returns `cache`."""
    cache.block_table[slot] = _as_pages(pages, cache.block_table.device)
    cache.length[slot] = length
    return cache


def _route_dead(live: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A scatter of n rows of which `live` [n] bool write, in fixed shapes
    (no host read, so a CUDA graph can capture it): returns (src [n], any
    live as a 0-d bool). Row i writes row src[i]'s value to row src[i]'s
    target: itself when live, else the first live row, so a dead row only
    repeats a live row's write (an indexed write has no defined winner
    between different values at one target). With no live row the caller
    writes row 0's target back with what it holds."""
    first = torch.argmax(live.to(torch.int32))  # the first live row, or 0
    src = torch.where(live, torch.arange(live.shape[0], device=live.device), first)
    return src, live.any()


def _put_pages(buf: torch.Tensor, pages: torch.Tensor, blocks: torch.Tensor) -> None:
    """buf[pages[j]] = blocks[j] for the pages < len(buf); the others drop.
    Fixed shapes (a CUDA graph can capture it): a dead entry repeats a live
    one's write."""
    if pages.numel() == 0:
        return
    src, any_live = _route_dead(pages < buf.shape[0])
    idx = pages.long().clamp(max=buf.shape[0] - 1)[src]
    raw = _raw(buf)
    raw[idx] = torch.where(any_live, _raw(blocks)[src], raw[idx])


def write_pages(cache: PagedKVCache, single: KVCache, pages,
                first_block: int = 0) -> PagedKVCache:
    """Shard a single-sequence DENSE cache into pool pages, IN PLACE (no
    table or length update). Logical block first_block + j of the dense
    buffer lands in page pages[j]; entries >= num_pages are dropped, so a
    caller only ever writes pages it owns. A tensor on the cache's device
    (as under calibrate_admit's capture) scatters in fixed shapes; a host
    list or tensor (admission) drops them on the host and writes the owned
    pages alone. Returns `cache`."""
    _, hkv, page, d = cache.k_pages.shape
    nb = len(pages)
    lo = first_block * page
    if single.k.shape[0] != 1 or single.k.shape[2] < lo + nb * page:
        raise ValueError(f"dense cache {tuple(single.k.shape)} holds no {nb} pages "
                         f"of {page} from block {first_block}")
    if single.quantized != cache.quantized:
        raise ValueError("dense and paged caches differ in quantization")

    def shard(buf):  # [1, Hkv, S, D] -> [nb, Hkv, page, D]
        return buf[0, :, lo:lo + nb * page].reshape(hkv, nb, page, d).transpose(0, 1)

    def shard_s(buf):  # [1, Hkv, 1, S] -> [nb, Hkv, 1, page]
        return buf[0, :, 0, lo:lo + nb * page].reshape(hkv, nb, page).transpose(0, 1)[:, :, None]

    if isinstance(pages, torch.Tensor) and pages.device == cache.k_pages.device:
        def put(buf, blocks):
            _put_pages(buf, pages, blocks)
    else:
        pages = pages.tolist() if isinstance(pages, torch.Tensor) else pages
        live = [j for j, p in enumerate(pages) if p < cache.num_pages]
        idx = torch.tensor([pages[j] for j in live], dtype=torch.long).to(cache.k_pages.device)
        # A table row lists its owned pages first: then a slice, no gather.
        sel = slice(0, len(live)) if live == list(range(len(live))) else live

        def put(buf, blocks):
            _raw(buf)[idx] = _raw(blocks)[sel]

    put(cache.k_pages, shard(single.k))
    put(cache.v_pages, shard(single.v))
    if cache.quantized:
        put(cache.k_scale, shard_s(single.k_scale))
        put(cache.v_scale, shard_s(single.v_scale))
    return cache


def write_slot_paged(cache: PagedKVCache, single: KVCache, slot: int,
                     pages) -> PagedKVCache:
    """Install a prefilled single-sequence DENSE cache into `slot`'s pages
    (continuous-batching admission), IN PLACE. `pages` is the slot's table
    row, max_pages_per_seq entries, unowned ones >= num_pages; the dense
    buffer's max_len must be max_pages_per_seq * page_size."""
    if single.k.shape[2] != cache.max_len:
        raise ValueError(f"dense max_len {single.k.shape[2]} != paged {cache.max_len}")
    write_pages(cache, single, pages)
    return set_block_table(cache, slot, pages, int(single.length[0]))


def pages_to_dense(cache: PagedKVCache, pages, max_len: int,
                   length: int = 0) -> KVCache:
    """Gather pool pages back into a new single-sequence DENSE cache of
    capacity max_len: positions [0, n_blocks * page) hold the pages, verbatim
    (quantized bytes and scales copied, never requantized); the rest is zeros,
    and ones for the scales. Seeds a suffix prefill with a shared prefix."""
    _, hkv, page, d = cache.k_pages.shape
    pages = _as_pages(pages, cache.k_pages.device).long()
    n = pages.shape[0] * page
    if max_len < n:
        raise ValueError(f"max_len {max_len} < {n} gathered positions")

    def gather(buf, fill):  # [P, Hkv, page, X] -> [1, Hkv, max_len, X]
        g = _raw(buf)[pages].transpose(0, 1).reshape(1, hkv, n, buf.shape[-1])
        out = torch.full((1, hkv, max_len, buf.shape[-1]), fill, dtype=g.dtype,
                         device=buf.device)
        out[:, :, :n] = g
        return out.view(buf.dtype)

    def gather_s(buf):  # [P, Hkv, 1, page] -> [1, Hkv, 1, max_len]
        return gather(buf.transpose(2, 3), 1.0).transpose(2, 3).contiguous()

    return KVCache(
        k=gather(cache.k_pages, 0), v=gather(cache.v_pages, 0),
        length=torch.full((1,), length, dtype=torch.int32, device=cache.length.device),
        k_scale=gather_s(cache.k_scale) if cache.quantized else None,
        v_scale=gather_s(cache.v_scale) if cache.quantized else None,
    )


def append_paged(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 active: torch.Tensor | None = None) -> PagedKVCache:
    """Append T tokens per sequence at its current length through the table,
    IN PLACE: token t of sequence b lands in page table[b, (len_b + t) //
    page] at row (len_b + t) % page. Sequences must own the pages. Tokens of
    inactive rows, past the table, or aimed at a sentinel entry are dropped,
    so a masked append never touches the pool. Fixed shapes throughout: a
    CUDA graph can capture it. Returns `cache`."""
    b, hkv, t, d = k_new.shape
    page = cache.page_size
    if cache.quantized:
        k_q, k_s = quantize_tokens(k_new, cache.k_pages.dtype)
        v_q, v_s = quantize_tokens(v_new, cache.v_pages.dtype)
    else:
        k_q = k_new.to(cache.k_pages.dtype)
        v_q = v_new.to(cache.v_pages.dtype)
    length = cache.length.long()
    pos = length[:, None] + torch.arange(t, device=length.device)  # [B, T] logical
    logical = pos // page
    max_pages = cache.block_table.shape[1]
    pids = torch.gather(cache.block_table.long(), 1, logical.clamp(max=max_pages - 1))
    live = (logical < max_pages) & (pids < cache.num_pages)
    if active is not None:
        live &= active[:, None]
    # Fixed shapes, dead tokens routed onto a live one's write: no host read.
    src, any_live = _route_dead(live.reshape(-1))
    pids = pids.reshape(-1).clamp(max=cache.num_pages - 1)[src]
    offs = (pos % page).reshape(-1)[src]

    def put(buf, rows):  # rows [B*T, Hkv, X] in token order
        raw = _raw(buf)
        raw[pids, :, offs, :] = torch.where(any_live, _raw(rows)[src], raw[pids, :, offs, :])

    put(cache.k_pages, k_q.transpose(1, 2).reshape(b * t, hkv, d))
    put(cache.v_pages, v_q.transpose(1, 2).reshape(b * t, hkv, d))
    if cache.quantized:  # scales [B, Hkv, 1, T] -> rows [B*T, Hkv, 1]
        put(cache.k_scale.transpose(2, 3), k_s.permute(0, 3, 1, 2).reshape(b * t, hkv, 1))
        put(cache.v_scale.transpose(2, 3), v_s.permute(0, 3, 1, 2).reshape(b * t, hkv, 1))
    cache.length += t if active is None else t * active.to(torch.int32)
    return cache


def paged_to_dense_reference(cache: PagedKVCache) -> KVCache:
    """The batch's dense view through the table (plain version of the
    kernel's indirection). Entries past the pool (the server's sentinel) are
    clamped to a real page. Only the padding rows of a chunk that runs past
    a sequence's owned pages can see those positions; the kernel counts them
    as holding no key, and those rows' outputs are garbage in both."""
    table = cache.block_table.long().clamp(max=cache.num_pages - 1)  # [B, maxp]
    b, maxp = table.shape

    def gather(buf):  # [P, Hkv, page, X] -> [B, Hkv, maxp * page, X]
        g = _raw(buf)[table]  # [B, maxp, Hkv, page, X]
        return g.transpose(1, 2).reshape(b, buf.shape[1], maxp * buf.shape[2],
                                         buf.shape[3]).view(buf.dtype)

    def gather_s(buf):  # [P, Hkv, 1, page] -> [B, Hkv, 1, maxp * page]
        return gather(buf.transpose(2, 3)).transpose(2, 3)

    return KVCache(
        k=gather(cache.k_pages), v=gather(cache.v_pages), length=cache.length,
        k_scale=gather_s(cache.k_scale) if cache.quantized else None,
        v_scale=gather_s(cache.v_scale) if cache.quantized else None,
    )


def paged_decode_reference(q: torch.Tensor, cache: PagedKVCache, scale: float | None = None,
                           requant_block: int | None = None, window: int | None = None,
                           sink: int = 0, logit_softcap: float | None = None,
                           alibi: bool = False, alibi_slopes: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version of the paged K2: the pages gathered through the table,
    then the dense plain version. An int8 pool requantizes P per page by
    default, as the JAX paged kernel does (its block is the page)."""
    return decode.decode_attention_reference(q, paged_to_dense_reference(cache), scale,
                                             requant_block or cache.page_size, window, sink,
                                             logit_softcap, alibi, alibi_slopes)


def _paged_decode(q: torch.Tensor, cache: PagedKVCache, scale: float | None,
                  window: int | None, sink: int, logit_softcap: float | None, alibi: bool,
                  alibi_slopes: torch.Tensor | None) -> torch.Tensor:
    decode.check_window(window, sink)
    cap = check_softcap(logit_softcap)
    b, hq, t, d = q.shape
    p, hkv, page, dk = cache.k_pages.shape
    if b != cache.batch or dk != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the paged cache "
                         f"{tuple(cache.k_pages.shape)}, batch {cache.batch}")
    if q.device.type == "cpu":
        return paged_decode_reference(q, cache, scale, window=window, sink=sink,
                                      logit_softcap=cap, alibi=alibi, alibi_slopes=alibi_slopes)
    slopes = alibi_table(alibi, alibi_slopes, hq, q.device, cap)
    if scale is None:
        scale = 1.0 / d**0.5
    o, _ = decode.launch(q, cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale,
                         cache.length, cache.block_table, cache.max_len, scale, window, sink,
                         cap, slopes)
    global LAUNCHES, WINDOW_LAUNCHES, SOFTCAP_LAUNCHES, ALIBI_LAUNCHES
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    SOFTCAP_LAUNCHES += cap is not None
    ALIBI_LAUNCHES += slopes is not None
    return o


def paged_decode_attention(
    q: torch.Tensor,
    cache: PagedKVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """One new token per sequence against the paged cache:
    q [B, Hq, D] -> [B, Hq, D]. CPU tensors take the plain version (the
    pages gathered through the table, then the dense plain version); CUDA
    tensors launch K2 through the table, under decode_attention's rules
    (window, sink, soft-cap and ALiBi included; a sink tile is read through
    its own page)."""
    return _paged_decode(q[:, :, None], cache, scale, window, sink, logit_softcap, alibi,
                         alibi_slopes)[:, :, 0]


def paged_decode_attention_chunk(
    q: torch.Tensor,
    cache: PagedKVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """T new tokens per sequence, causal within the chunk, against the paged
    cache (chunked prefill): q [B, Hq, T, D] -> [B, Hq, T, D]. The chunk's
    K/V must already be appended."""
    return _paged_decode(q, cache, scale, window, sink, logit_softcap, alibi, alibi_slopes)
