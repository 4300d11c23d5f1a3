"""The backward kernels and the plain backward, each against float64
attention gradients, on random draws of one card-offset call.

    python -m flashattn_tpu_torch.utils.grad_oracle [--seeds FIRST LAST]
        [--case alibi|window|softcap_hot] [--device cpu]

The calls are chip_smoke.py's card-offset gates (CASES), bf16, the offset
4096 read on the card: "alibi", B 1, Hq 32, Hkv 8, S_q = S_k = 4096, D
128, the window's left edge at 4096 and ALiBi with the standard slopes;
"window", the same without ALiBi; "softcap_hot", GEMMA2_9B's local-layer
pair, B 1, Hq 16, Hkv 8, S 2048, D 256, the window 4096 and the soft-cap
50, q times 30 (the cap saturates). For each seed in [FIRST, LAST) it
draws q, k, v, dO (torch.randn on the card), runs K1 for O and the LSE,
then B3 (fused), B4 + B5 (split) and the plain backward (ops/reference.py:
float32, P and dS rounded to bf16), and prints, for
dQ, dK and dV, each one's largest normalized error (|err| / (atol + rtol
|ref|) under the repo's bf16 gradient gate, rtol 2e-2, atol 5e-2), largest
absolute error and relative L2 error (||err|| / ||ref||) against

- "exact": float64_backward, the gradients of the bf16 inputs in float64
  (scores, LSE, O and delta all in float64);
- "rounded": the same with P and dS rounded to bf16 before the products
  that consume them, as the kernels and the plain version feed them;
- the plain version (the gate's own reading), for the kernels.

On the card by default; with --device cpu the plain versions alone (K1's
and the backward's) on the CPU's own random draws, no kernel."""

from __future__ import annotations

import argparse

import torch

from flashattn_tpu_torch.ops import _build, flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.common import dropout_scale
from flashattn_tpu_torch.ops.reference import alibi_bias, dropout_keep, visible
from flashattn_tpu_torch.utils.verify import verify_results

OFFSET = 4096
GATE = dict(rtol=2e-2, atol=5e-2)
# name: ((B, Hq, Hkv, S, D), the call's options, q's factor)
CASES = {
    "alibi": ((1, 32, 8, 4096, 128), dict(window=4096, alibi=True), 1.0),
    "window": ((1, 32, 8, 4096, 128), dict(window=4096), 1.0),
    "softcap_hot": ((1, 16, 8, 2048, 256), dict(window=4096, logit_softcap=50.0), 30.0),
}


def float64_backward(q, k, v, do, is_causal: bool = False, scale: float | None = None,
                     pos_offset: int | None = None, window: int | None = None,
                     alibi_slopes: torch.Tensor | None = None,
                     logit_softcap: float | None = None, dropout_rate: float = 0.0,
                     dropout_seed=None, round_to: torch.dtype | None = None) -> tuple:
    """dQ, dK, dV in float64 of softmax(S*scale + bias) V at q, k, v, dO
    (the mask of ops/reference.py::visible, the ALiBi bias of alibi_bias),
    one q head at a time: P from float64 scores and their float64 LSE, O
    = P V, delta = rowsum(dO O), dS = P (dO V^T - delta). With a soft-cap
    the logit is cap t for t = tanh(S scale / cap) and dS takes the factor
    1 - t^2 (scale stays on dQ and dK). With dropout, the
    keep mask M of ops/reference.py::dropout_keep and c = 1 / (1 - rate): O
    = c (M P) V, dV = c (M P)^T dO, and dO V^T becomes c M (dO V^T). With
    round_to, P (M P with dropout, c applied after the product) and dS are
    rounded to that dtype before the products dV = P^T dO, dQ = scale dS K
    and dK = scale dS^T Q. A row that sees no key contributes 0."""
    b, hq, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d**0.5 if scale is None else scale
    mask = visible(s_q, s_k, is_causal, pos_offset, window, None, q.device)
    dq = torch.zeros(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for hh in range(hq):
            h = hh // g
            q64, do64 = q[bi, hh].double(), do[bi, hh].double()
            k64, v64 = k[bi, h].double(), v[bi, h].double()
            s = (q64 @ k64.T) * scale
            t = None
            if logit_softcap is not None:
                t = torch.tanh(s / logit_softcap)
                s = logit_softcap * t
            if alibi_slopes is not None:
                s += alibi_bias(alibi_slopes[hh:hh + 1].double(), s_q, s_k,
                                pos_offset)[0, 0].double()
            if mask is not None:
                s = s.masked_fill(~mask[0, 0], float("-inf"))
            lse = torch.logsumexp(s, dim=1, keepdim=True)
            p = torch.exp(s - lse.masked_fill(~torch.isfinite(lse), 0.0))
            del s
            dp, c, kept = do64 @ v64.T, 1.0, p
            if dropout_rate:
                keep = dropout_keep(dropout_seed, dropout_rate, b, hq, slice(hh, hh + 1), s_q,
                                    s_k, q.device)[bi, 0]
                c = dropout_scale(dropout_rate)
                kept = torch.where(keep, p, 0.0)
                dp = torch.where(keep, dp * c, 0.0)
                del keep
            delta = (do64 * ((kept @ v64) * c)).sum(dim=1, keepdim=True)
            ds = p * (dp - delta)
            if t is not None:
                ds *= (1.0 - t) * (1.0 + t)
            del p, dp, t
            if round_to is not None:
                kept, ds = kept.to(round_to).double(), ds.to(round_to).double()
            dq[bi, hh] = (ds @ k64) * scale
            dk[bi, h] += (ds.T @ q64) * scale
            dv[bi, h] += (kept.T @ do64) * c
            del kept, ds
    return dq, dk, dv


def reading(ref, out) -> str:
    """max normalized / max abs / relative L2 error of out against ref."""
    rep = verify_results(ref, out, **GATE)
    ref64 = ref.double()
    l2 = ((out.double() - ref64).norm() / ref64.norm()).item()
    return f"{rep.max_normalized_err:.3f}/{rep.max_abs_err:.4g}/{l2:.4e}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 8), metavar=("FIRST", "LAST"))
    ap.add_argument("--case", default="alibi", choices=tuple(CASES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = args.device
    kernels = ("fused", "split") if dev == "cuda" else ()
    if kernels:
        _build.build_all(["flash_fwd_dynoff", "flash_bwd_dynoff", "flash_bwd_fused_dynoff"])
        torch.backends.cuda.matmul.allow_tf32 = False
    (b, hq, hkv, s, d), kw, q_factor = CASES[args.case]
    slopes = flash_fwd.default_alibi_slopes(hq, dev) if kw.get("alibi") else None
    off_t = torch.tensor([OFFSET], dtype=torch.int32, device=dev)
    print(f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 on {dev}, offset {OFFSET}, {kw}, q times "
          f"{q_factor}; each cell max normalized / max abs / relative L2 error, normalized "
          f"under rtol {GATE['rtol']}, atol {GATE['atol']}", flush=True)
    for seed in range(*args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        q = q * q_factor
        o, lse = flash_fwd.flash_attention_forward(q, k, v, False, dyn_pos_offset=off_t, **kw)
        got = {"plain": flash_bwd.flash_attention_backward_reference(
            q, k, v, o, do, lse, False, dyn_pos_offset=OFFSET, **kw)}
        for impl in kernels:
            got[impl] = flash_bwd.flash_attention_backward(q, k, v, o, do, lse, False, impl=impl,
                                                           dyn_pos_offset=off_t, **kw)
        oracle = dict(window=kw["window"], pos_offset=OFFSET, alibi_slopes=slopes,
                      logit_softcap=kw.get("logit_softcap"))
        exact = float64_backward(q, k, v, do, **oracle)
        rounded = float64_backward(q, k, v, do, round_to=torch.bfloat16, **oracle)
        if kernels:
            torch.cuda.synchronize()
        for i, name in enumerate(("dQ", "dK", "dV")):
            cells = [f"{who} vs exact {reading(exact[i], got[who][i])}, vs rounded "
                     f"{reading(rounded[i], got[who][i])}"
                     + (f", vs plain {reading(got['plain'][i], got[who][i])}"
                        if who != "plain" else "")
                     for who in kernels + ("plain",)]
            print(f"seed {seed} {name} (max |exact| {exact[i].abs().max().item():.3f}): "
                  + "; ".join(cells), flush=True)
        del q, k, v, do, o, lse, got, exact, rounded


if __name__ == "__main__":
    main()
