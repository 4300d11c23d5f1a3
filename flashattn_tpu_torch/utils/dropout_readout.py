"""Read the dropout keep mask out of K1, B3, B4 and B5, to hold it bit for
bit against the plain ops/common.py::dropout_keep_mask.

With q = 0 every score is 0, so every probability of a row is the same:
P = 1 in K1's unnormalised tile, 1 / S_k in the backward's (the calls are
not causal). Then one output of each kernel, given one-hot operands over a
D-wide chunk of keys or queries, takes one of two values, one for a kept
element and one for a dropped one:

- K1: V one-hot over keys [c0, c0 + D) (v[c0 + d] = e_d) gives
  O[r, d] = keep[r, c0 + d] / ((1 - rate) S_k), or 0.
- B4 (the split path's dQ): v[c] = e_0 and dO[r] = e_0 for every row and
  key make dP = 1, and K one-hot over keys [c0, c0 + D) gives
  dQ[r, d] = scale P (keep / (1 - rate) - delta_r) at key c0 + d: positive
  for a kept element, negative for a dropped one (delta_r, the row's kept
  share over 1 - rate, lies between).
- B3 and B5 (dV): dO one-hot over rows [r0, r0 + D) of one q head of each
  GQA group (dO[r0 + d] = e_d) gives dV[c, d] = P keep[r0 + d, c] / (1 -
  rate), or 0.

The forward's O and LSE of the backward calls come from the plain forward,
so each readout sees one kernel alone. Each function returns the mask it
read, [B, Hq, S_q, S_k] bool, from CUDA calls (any device works: on the
CPU the wrappers take their plain versions). `opts`, the calls' other
options, may make P other than uniform while every pair stays visible (a
dyn_pos_offset with a window that reaches every key, ALiBi): a kept
element's output keeps its sign, and a dropped one's stays 0 or negative.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.reference import dropout_keep


def plain_mask(b: int, hq: int, s_q: int, s_k: int, rate: float, seed,
               device) -> torch.Tensor:
    """The plain version's [B, Hq, S_q, S_k] keep mask."""
    return dropout_keep(seed, rate, b, hq, slice(0, hq), s_q, s_k, device)


def _chunk(n: int, d: int, at: int, dtype, device) -> torch.Tensor:
    """[n, d]: rows [at, at + d) the identity, every other row 0."""
    x = torch.zeros((n, d), dtype=dtype, device=device)
    x[at:at + d] = torch.eye(d, dtype=dtype, device=device)[:n - at]
    return x


def forward_mask(b, hq, hkv, s_q, s_k, d, dtype, rate, seed, device, **opts) -> torch.Tensor:
    """K1's mask, S_k / D calls (S_k a multiple of D)."""
    q = torch.zeros((b, hq, s_q, d), dtype=dtype, device=device)
    k = torch.zeros((b, hkv, s_k, d), dtype=dtype, device=device)
    keep = torch.empty((b, hq, s_q, s_k), dtype=torch.bool, device=device)
    for c0 in range(0, s_k, d):
        v = _chunk(s_k, d, c0, dtype, device).expand(b, hkv, s_k, d).contiguous()
        o, _ = flash_fwd.flash_attention_forward(q, k, v, need_lse=False, dropout_rate=rate,
                                                 dropout_seed=seed, **opts)
        keep[..., c0:c0 + d] = o != 0
    return keep


def _plain_o_lse(q, k, v, rate, seed, opts):
    o, lse = flash_fwd.flash_attention_forward_reference(q, k, v, dropout_rate=rate,
                                                         dropout_seed=seed, **opts)
    return o.contiguous(), lse.contiguous()


def dq_mask(b, hq, hkv, s_q, s_k, d, dtype, rate, seed, device, **opts) -> torch.Tensor:
    """B4's mask (the split path's dQ kernel), S_k / D calls of the split
    backward."""
    q = torch.zeros((b, hq, s_q, d), dtype=dtype, device=device)
    v = torch.zeros((b, hkv, s_k, d), dtype=dtype, device=device)
    v[..., 0] = 1
    do = torch.zeros((b, hq, s_q, d), dtype=dtype, device=device)
    do[..., 0] = 1
    keep = torch.empty((b, hq, s_q, s_k), dtype=torch.bool, device=device)
    for c0 in range(0, s_k, d):
        k = _chunk(s_k, d, c0, dtype, device).expand(b, hkv, s_k, d).contiguous()
        o, lse = _plain_o_lse(q, k, v, rate, seed, opts)
        dq, _, _ = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl="split",
                                                      dropout_rate=rate, dropout_seed=seed,
                                                      **opts)
        keep[..., c0:c0 + d] = dq > 0
    return keep


def dv_mask(b, hq, hkv, s_q, s_k, d, dtype, rate, seed, device, impl: str,
            **opts) -> torch.Tensor:
    """B3's (impl "fused") or B5's (impl "split") mask from dV,
    Hq / Hkv x S_q / D calls (S_q a multiple of D)."""
    group = hq // hkv
    q = torch.zeros((b, hq, s_q, d), dtype=dtype, device=device)
    k = torch.zeros((b, hkv, s_k, d), dtype=dtype, device=device)
    v = torch.zeros((b, hkv, s_k, d), dtype=dtype, device=device)
    o, lse = _plain_o_lse(q, k, v, rate, seed, opts)
    keep = torch.empty((b, hq, s_q, s_k), dtype=torch.bool, device=device)
    for g in range(group):
        for r0 in range(0, s_q, d):
            do = torch.zeros((b, hq, s_q, d), dtype=dtype, device=device)
            do[:, g::group] = _chunk(s_q, d, r0, dtype, device)
            _, _, dv = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, impl=impl,
                                                          dropout_rate=rate, dropout_seed=seed,
                                                          **opts)
            # dv [B, Hkv, S_k, D]: column d is row r0 + d of q head hkv * group + g.
            keep[:, g::group, r0:r0 + d] = (dv != 0).transpose(-1, -2)
    return keep
