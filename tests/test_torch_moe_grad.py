"""The gradients of parallel/moe.py's grouped dispatch (moe_ffn_grouped)
against jax.grad of the JAX package's moe_ffn_dense_reference on the same
numpy inputs: dX and the gradient of every routed parameter (the router,
each expert's w_gate, w_up and w_down) of sum(y * dY), for top 1, 2 and 4
of 8 experts, renormalised or full-softmax gates, SiLU or tanh-GELU.

The gather of each token's k rows (moe.gather_pairs) takes its backward as
a fixed-order sum: the gather's dX is bit for bit the float32 sum of the
token's k pair gradients in ascending expert id, rounded once, in float32
and in bf16, and its forward is index_select's, bit for bit.

Tolerances: float32 atol 1e-5, rtol 1e-4 (sums in another order); bf16
rtol 2e-2, atol 5e-2 (the bf16 gradient gates of the verify recipe: both
sides round each product to bf16, in other places). Those gates are set
for gradients of order 1, so dY has a standard deviation of 0.1 and every
gradient here stays below about 3; at 1 the experts' gradients reach 26,
where a bf16 step is 0.125, and each package's bf16 gradients then lie
about 0.1 from the float32 gradients of the same inputs, both alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.parallel.moe import moe_ffn_dense_reference as jax_moe
from flashattn_tpu_torch.parallel import moe
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

T, H, F, E = 40, 64, 96, 8
TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(rtol=2e-2, atol=5e-2)}
CASES = {  # name: (top_k, norm_topk, activation)
    "top2": (2, True, "silu"),
    "top4_softmax_gates": (4, False, "silu"),
    "top1_gelu": (1, True, "gelu_tanh"),
}
NAMES = ("router", "w_gate", "w_up", "w_down")
DY_STD = np.float32(0.1)


def inputs(seed: int, dtype: str) -> dict[str, np.ndarray]:
    """x, dY and init_moe_params' shapes and scales, float32 numpy, each
    rounded to `dtype` (so both packages start from the same values)."""
    rng = np.random.default_rng(seed)
    arrays = {"x": rng.standard_normal((T, H), dtype=np.float32),
              "dy": rng.standard_normal((T, H), dtype=np.float32) * DY_STD,
              "router": rng.standard_normal((H, E), dtype=np.float32) * H**-0.5,
              "w_gate": rng.standard_normal((E, H, F), dtype=np.float32) * H**-0.5,
              "w_up": rng.standard_normal((E, H, F), dtype=np.float32) * H**-0.5,
              "w_down": rng.standard_normal((E, F, H), dtype=np.float32) * F**-0.5}
    cast = getattr(torch, dtype)
    return {k: torch.from_numpy(v).to(cast).float().numpy() for k, v in arrays.items()}


def jax_grads(a: dict, dtype: str, top_k: int, norm_topk: bool, act: str) -> dict:
    jd = getattr(jnp, dtype)
    x = jnp.asarray(a["x"], jd)
    params = {k: jnp.asarray(a[k], jd) for k in NAMES}
    dy = jnp.asarray(a["dy"], jd)

    def loss(x, params):
        y = jax_moe(x, params, top_k, act, norm_topk)
        return jnp.sum(y.astype(jnp.float32) * dy.astype(jnp.float32))

    gx, gp = jax.jit(jax.grad(loss, (0, 1)))(x, params)
    return {"x": np.asarray(gx.astype(jnp.float32)),
            **{k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()}}


def port_grads(a: dict, dtype: str, top_k: int, norm_topk: bool, act: str) -> dict:
    td = getattr(torch, dtype)
    x = torch.from_numpy(a["x"]).to(td).requires_grad_()
    params = {k: torch.from_numpy(a[k]).to(td).requires_grad_() for k in NAMES}
    y = moe.moe_ffn_grouped(x, params, top_k, act, norm_topk)
    (y.float() * torch.from_numpy(a["dy"]).to(td).float()).sum().backward()
    return {"x": x.grad.float(), **{k: p.grad.float() for k, p in params.items()}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_gradients_match_jax(case, dtype):
    top_k, norm_topk, act = CASES[case]
    a = inputs(sorted(CASES).index(case), dtype)
    want = jax_grads(a, dtype, top_k, norm_topk, act)
    got = port_grads(a, dtype, top_k, norm_topk, act)
    for name in ("x",) + NAMES:
        rep = verify_results(want[name], got[name], **TOL[dtype])
        assert rep.passed, f"d{name}: {rep}"
    # every expert is reached: each one's gradient is compared, not zeros
    assert all(float(got["w_down"][e].abs().max()) > 0 for e in range(E)) or top_k == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [2, 4])
def test_gather_backward_is_a_fixed_order_float32_sum(top_k, dtype, monkeypatch):
    """Inside moe_ffn_grouped, the gather's output is x.index_select(0,
    src) bit for bit, and its dX is bit for bit the sum, for each token,
    of its k pair gradients (row inv[t k + j] of the gather's output
    gradient, j in ascending expert id) in float32, rounded once."""
    a = inputs(7, str(dtype).removeprefix("torch."))
    seen = {}
    gather = moe.gather_pairs

    def spy(x, src, inv, k):
        leaf = x.detach().requires_grad_()  # the gather's own dX lands here
        out = gather(leaf, src, inv, k)
        out.retain_grad()
        seen.update(leaf=leaf, src=src, inv=inv, out=out)
        return out

    monkeypatch.setattr(moe, "gather_pairs", spy)
    x = torch.from_numpy(a["x"]).to(dtype)
    params = {k: torch.from_numpy(a[k]).to(dtype).requires_grad_() for k in NAMES}
    y = moe.moe_ffn_grouped(x, params, top_k)
    (y.float() * torch.from_numpy(a["dy"]).to(dtype).float()).sum().backward()
    out, inv = seen["out"], seen["inv"]
    assert torch.equal(out.detach(), x.index_select(0, seen["src"]))
    pairs = out.grad[inv].view(T, top_k, H)
    want = pairs[:, 0].float()
    for j in range(1, top_k):
        want = want + pairs[:, j].float()
    assert torch.equal(seen["leaf"].grad, want.to(dtype))
    assert seen["leaf"].grad.dtype == dtype
