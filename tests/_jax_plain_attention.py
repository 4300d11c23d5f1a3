"""Plain jnp attention for the JAX side of the parallel layer's CPU tests.

The JAX package's rings (flashattn_tpu/parallel/ring.py) and Ulysses call
its Pallas kernels once a hop; in interpret mode on the CPU one ring case
takes 15 to 110 s there. ``plain_kernels`` swaps, for one test, the names
those modules call (flash_attention_forward, flash_attention_backward,
flash_attention, flash_attention_varlen) for the plain functions below,
which compute what the kernels compute in float32: the scaled logits, the
soft-cap, ALiBi at the call's alignment (pos_offset or the traced
dyn_pos_offset), the causal mask, the window (its left edge alone without
the causal mask), segment ids, and dropout by the JAX package's own
dropout_keep_mask on the call's array rows and columns; the backward from
the given O and LSE as the kernels rebuild P. The JAX package's rotation,
merge, hop pruning, zigzag offsets and seed folding run as they are. These
plain functions are held against the JAX package's kernels in interpret
mode on the calls that the rings and Ulysses make in those tests
(tests/test_torch_ring_hops.py, test_torch_zigzag_hops.py,
test_torch_ring_4ranks_hops.py, test_torch_ulysses_hops.py), and the
kernels against the port's plain versions elsewhere
(tests/test_torch_dyn_offset.py and the other test_torch_* kernel files).
"""

import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np

from flashattn_tpu.ops.common import dropout_keep_mask
from flashattn_tpu.ops.flash_fwd import default_alibi_slopes


def _terms(q, k, is_causal=False, scale=None, window=None, logit_softcap=None, alibi=False,
           alibi_slopes=None, dropout_rate=0.0, dropout_seed=None, segment_ids=None,
           pos_offset=None, dyn_pos_offset=None):
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    scale = 1.0 / d**0.5 if scale is None else scale
    off = (dyn_pos_offset if dyn_pos_offset is not None
           else s_k - s_q if pos_offset is None else pos_offset)
    kx = jnp.repeat(k, hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), kx.astype(jnp.float32)) * scale
    t = None
    if logit_softcap:
        t = jnp.tanh(s / logit_softcap)
        s = logit_softcap * t
    rows = jnp.arange(s_q)[:, None]
    cols = jnp.arange(s_k)[None, :]
    if alibi:
        slopes = default_alibi_slopes(hq) if alibi_slopes is None else alibi_slopes
        s = s + slopes.astype(jnp.float32)[None, :, None, None] * (cols - rows - off)
    mask = jnp.ones((1, 1, s_q, s_k), bool)
    if is_causal:
        mask = mask & (cols <= rows + off)
    if window is not None:
        mask = mask & (cols >= rows + off - window + 1)
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        mask = mask & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    keep = None
    if dropout_rate > 0.0:
        bh = jnp.arange(b)[:, None, None, None] * hq + jnp.arange(hq)[None, :, None, None]
        keep = dropout_keep_mask(jnp.asarray(dropout_seed, jnp.int32).reshape(()), bh,
                                 rows, cols, dropout_rate)
    return s, t, mask, keep, scale


def _dropped(x, keep, rate):
    return x if keep is None else jnp.where(keep, x * np.float32(1.0 / (1.0 - rate)), 0.0)


def plain_forward(q, k, v, is_causal=False, scale=None, block_sizes=None, interpret=None,
                  debug=False, segment_ids=None, dropout_rate=0.0, dropout_seed=None,
                  window=None, logit_softcap=None, alibi=False, alibi_slopes=None,
                  pos_offset=None, dyn_pos_offset=None, need_lse=True):
    """flash_attention_forward's (O, LSE)."""
    s, _, mask, keep, _ = _terms(q, k, is_causal, scale, window, logit_softcap, alibi,
                                 alibi_slopes, dropout_rate, dropout_seed, segment_ids,
                                 pos_offset, dyn_pos_offset)
    s = jnp.where(mask, s, -jnp.inf)
    m = s.max(-1, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.exp(s - m_safe)
    l = p.sum(-1, keepdims=True)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    vx = jnp.repeat(v, q.shape[1] // v.shape[1], axis=1).astype(jnp.float32)
    o = jnp.einsum("bhqk,bhkd->bhqd", _dropped(p, keep, dropout_rate) / l_safe, vx)
    lse = jnp.where(l[..., 0] == 0.0, -jnp.inf, m_safe[..., 0] + jnp.log(l_safe[..., 0]))
    return o.astype(q.dtype), (lse if need_lse else None)


def plain_backward(q, k, v, o, do, lse, is_causal=False, scale=None, block_sizes=None,
                   interpret=None, debug=False, segment_ids=None, dropout_rate=0.0,
                   dropout_seed=None, window=None, logit_softcap=None, alibi=False,
                   alibi_slopes=None, impl="auto", pos_offset=None, dyn_pos_offset=None):
    """flash_attention_backward's (dQ, dK, dV) from the given O and LSE."""
    s, t, mask, keep, scale = _terms(q, k, is_causal, scale, window, logit_softcap, alibi,
                                     alibi_slopes, dropout_rate, dropout_seed, segment_ids,
                                     pos_offset, dyn_pos_offset)
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g = hq // hkv
    fin = jnp.isfinite(lse)[..., None]
    p = jnp.where(mask & fin, jnp.exp(s - jnp.where(fin, lse[..., None], 0.0)), 0.0)
    delta = (do.astype(jnp.float32) * o.astype(jnp.float32)).sum(-1, keepdims=True)
    vx = jnp.repeat(v, g, axis=1).astype(jnp.float32)
    kx = jnp.repeat(k, g, axis=1).astype(jnp.float32)
    dp = _dropped(jnp.einsum("bhqd,bhkd->bhqk", do.astype(jnp.float32), vx), keep, dropout_rate)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * ((1.0 - t) * (1.0 + t))
    dq = jnp.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = (jnp.einsum("bhqk,bhqd->bhkd", ds, q.astype(jnp.float32)) * scale)
    dv = jnp.einsum("bhqk,bhqd->bhkd", _dropped(p, keep, dropout_rate), do.astype(jnp.float32))
    dk = dk.reshape(b, hkv, g, s_k, d).sum(2)
    dv = dv.reshape(b, hkv, g, s_k, d).sum(2)
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


def plain_attention(q, k, v, **kw):
    """flash_attention's O (differentiable by jax's autodiff)."""
    return plain_forward(q, k, v, **kw)[0]


def plain_varlen(q, k, v, segment_ids=None, cu_seqlens=None, **kw):
    """flash_attention_varlen's O: padding ids canonicalised (q < 0 -> -1,
    k < 0 -> -2) as the JAX function does."""
    seg_q, seg_k = segment_ids
    segs = (jnp.where(seg_q < 0, -1, seg_q), jnp.where(seg_k < 0, -2, seg_k))
    return plain_forward(q, k, v, segment_ids=segs, **kw)[0]


@contextlib.contextmanager
def plain_kernels():
    """The JAX parallel modules call the plain functions above in place of
    their kernels while the context is open."""
    with mock.patch("flashattn_tpu.parallel.ring.flash_attention_forward", plain_forward), \
            mock.patch("flashattn_tpu.parallel.ring.flash_attention_backward", plain_backward), \
            mock.patch("flashattn_tpu.parallel.ulysses.flash_attention", plain_attention), \
            mock.patch("flashattn_tpu.ops.varlen.flash_attention_varlen", plain_varlen):
        yield
