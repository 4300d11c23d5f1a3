"""Rematerialisation in the port's training forward (models/llama.py remat=),
against the port without remat and against the JAX package's
loss_fn(..., remat=...), unpacked and on packed rows; what the backward
recomputes under each policy; the fake implementations of the registered
operators that the policies name.

Float32, the port on its plain paths and the JAX package on its interpret
path. Tolerances: with remat against without, loss and gradients within
rel 1e-6 / atol 1e-6 (tests/test_train.py::test_remat_grads_identical's;
on the CPU they come out bit for bit equal); against JAX,
tests/test_torch_train.py's: loss rel 1e-5, gradients atol 1e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models.config import ModelConfig as JaxConfig
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.ops import attention
from flashattn_tpu_torch.utils.verify import verify_results

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

KW = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
          num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=128)
JCFG = JaxConfig(dtype=jnp.float32, **KW)
CFG = ModelConfig(dtype=torch.float32, **KW)
POLICIES = [True, "dots", "attn"]
OPS = torch.ops.flashattn_tpu_torch


def jax_params(seed=0):
    return jax_llama.init_params(JCFG, jax.random.PRNGKey(seed))


def port_model(params) -> llama.Llama:
    model = llama.Llama(CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def tokens(b=2, s=48, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, (b, s + 1), dtype=np.int32)


def packed_ids(b=2, s=48):
    """Three documents a row, off the tile multiples, and trailing padding."""
    ids = np.full((b, s + 1), -1, np.int32)
    ids[:, :13], ids[:, 13:30], ids[:, 30:44] = 0, 1, 2
    return ids


def loss_and_grads(model, toks, remat, segment_ids=None):
    model.zero_grad(set_to_none=True)
    loss = llama.loss_fn(model, torch.from_numpy(toks), segment_ids=segment_ids, remat=remat)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def assert_same(a, b):
    (la, ga), (lb, gb) = a, b
    torch.testing.assert_close(la, lb, rtol=1e-6, atol=1e-6)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_matches_no_remat(remat):
    model, toks = port_model(jax_params()), tokens()
    assert_same(loss_and_grads(model, toks, remat), loss_and_grads(model, toks, False))


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_matches_jax(remat):
    params, toks = jax_params(), tokens(seed=3)
    value_and_grad = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(2, 6))
    jloss, jgrads = value_and_grad(params, jnp.asarray(toks), JCFG, None, None, None, remat)
    loss, grads = loss_and_grads(port_model(params), toks, remat)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, g in grads.items():
        rep = verify_results(ref[name], g, atol=1e-5, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"


@pytest.mark.parametrize("remat", POLICIES)
def test_packed_remat(remat):
    """Packed rows (segment ids through ops/varlen.py) with remat: equal to
    the port without it, and to JAX's packed loss with the same policy."""
    params, toks, ids = jax_params(seed=2), tokens(seed=4), packed_ids()
    model = port_model(params)
    got = loss_and_grads(model, toks, remat, torch.from_numpy(ids))
    assert_same(got, loss_and_grads(model, toks, False, torch.from_numpy(ids)))
    jloss = jax.jit(jax_llama.loss_fn, static_argnums=(2, 6))(
        params, jnp.asarray(toks), JCFG, None, None, jnp.asarray(ids), remat)
    assert float(got[0]) == pytest.approx(float(jloss), rel=1e-5)


class CountOps(TorchDispatchMode):
    """Counts the operators dispatched while it is active, by name."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# remat -> (attention forwards, attention_operands calls: each is the q, k
# and v projections) that the backward recomputes a layer.
RECOMPUTED = {False: (0, 0), True: (1, 1), "dots": (1, 0), "attn": (0, 0)}


@pytest.mark.parametrize("route", ["kernels", "plain"])
@pytest.mark.parametrize("remat", [False, *POLICIES])
def test_backward_recomputes(remat, route, monkeypatch):
    """The operators the backward runs again: under "attn" no attention
    forward and no q/k/v projection; under True and "dots" one attention
    forward a layer, and the projections under True alone. The plain route
    (plain_flash_attention, flash_fwd_plain) is kept alike."""
    if route == "plain":
        monkeypatch.setattr(llama, "flash_attention", attention.plain_flash_attention)
    op = "flashattn_tpu_torch.flash_fwd.default" if route == "kernels" else \
        "flashattn_tpu_torch.flash_fwd_plain.default"
    model = port_model(jax_params())
    loss = llama.loss_fn(model, torch.from_numpy(tokens()), remat=remat)
    with CountOps() as fwd_count:
        llama.loss_fn(model, torch.from_numpy(tokens()), remat=remat)
    with CountOps() as count:
        loss.backward()
    layers = CFG.num_layers
    assert fwd_count.calls[op] == layers
    assert fwd_count.calls["flashattn_tpu_torch.attention_operands.default"] == layers
    attn, operands = RECOMPUTED[remat]
    assert count.calls.get(op, 0) == attn * layers
    assert count.calls.get("flashattn_tpu_torch.attention_operands.default", 0) == \
        operands * layers


def test_projections_saved_under_dots():
    """"dots" keeps every projection's product: the backward's mm calls are
    those without remat (the gradients' own); True adds each layer's wo,
    w_gate and w_up products again (the recompute stops once w_down's
    inputs are saved, before its product, which no backward needs)."""
    model, toks = port_model(jax_params()), tokens()
    counts = {}
    for remat in (False, "dots", True):
        loss = llama.loss_fn(model, torch.from_numpy(toks), remat=remat)
        with CountOps() as count:
            loss.backward()
        counts[remat] = count.calls.get("aten.mm.default", 0)
    assert counts["dots"] == counts[False]
    assert counts[True] == counts[False] + 3 * CFG.num_layers


def test_remat_without_gradient_and_unknown_policy():
    model, toks = port_model(jax_params()), torch.from_numpy(tokens()[:, :-1])
    with torch.no_grad():
        want = llama.forward(model, toks)
        for remat in POLICIES:
            assert torch.equal(llama.forward(model, toks, remat=remat), want)
    with pytest.raises(ValueError, match="remat"):
        llama.forward(model, toks, remat="everything")


def rope_inputs(b=2, s=24, h=64, nq=4, nkv=2, d=16, dtype=torch.float32, seed=0):
    """xn, the three projection weights, the RoPE tables and the config."""
    g = torch.Generator().manual_seed(seed)
    xn = torch.randn(b, s, h, generator=g).to(dtype)
    ws = [(torch.randn(h, n * d, generator=g) / h**0.5).to(dtype) for n in (nq, nkv, nkv)]
    cfg = ModelConfig(dtype=dtype, vocab_size=8, hidden_size=h, intermediate_size=8,
                      num_layers=1, num_heads=nq, num_kv_heads=nkv, head_dim=d)
    cos, sin = llama.rope_tables(cfg, torch.arange(s))
    return xn, ws, cos, sin, cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_operands_against_autograd(dtype):
    """The operator's outputs are the projections + apply_rope's bit for bit; its
    registered backward matches autograd through them (bf16: the same
    roundings, the three dxn terms summed in another order)."""
    xn, ws, cos, sin, cfg = rope_inputs(dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (xn, *ws)]
    out = llama.attention_operands(*leaves, cos, sin, cfg.num_heads, cfg.num_kv_heads)
    layer = llama.LlamaLayer(cfg, device="cpu")
    with torch.no_grad():
        for p, w in zip((layer.wq, layer.wk, layer.wv), ws):
            p.copy_(w)
    xn_ref = xn.clone().requires_grad_()
    b, s = xn.shape[:2]
    q, k, v = ((xn_ref @ w).view(b, s, -1, cfg.head_dim).transpose(1, 2)
               for w in (layer.wq, layer.wk, layer.wv))
    ref = (llama.apply_rope(q, cos, sin), llama.apply_rope(k, cos, sin), v)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(t.shape, generator=g).to(dtype) for t in ref]
    got = torch.autograd.grad(out, leaves, cots)
    want = torch.autograd.grad(ref, (xn_ref, layer.wq, layer.wk, layer.wv), cots)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
    assert torch.equal(got[1], want[1])  # dwq: one product, the same one


def test_fake_implementations():
    """Shapes and dtypes from the operators' fake implementations."""
    with FakeTensorMode():
        q = torch.empty(2, 8, 40, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 2, 56, 64, dtype=torch.bfloat16)
        seg_q, seg_k = torch.empty(2, 40, dtype=torch.int32), torch.empty(2, 56, dtype=torch.int32)
        for op in (OPS.flash_fwd, OPS.flash_fwd_plain):
            o, lse = op(q, k, k, seg_q, seg_k, True, None, None, 16, 50.0)
            assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
            assert (lse.shape, lse.dtype) == ((2, 8, 40), torch.float32)
        xn = torch.empty(3, 40, 96, dtype=torch.bfloat16)
        wq = torch.empty(96, 4 * 32, dtype=torch.bfloat16)
        wkv = torch.empty(96, 32, dtype=torch.bfloat16)
        cos = sin = torch.empty(40, 16)
        q, k, v = OPS.attention_operands(xn, wq, wkv, wkv, cos, sin, 4, 1)
        assert q.shape == (3, 4, 40, 32) and k.shape == v.shape == (3, 1, 40, 32)
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16


def test_operators_pass_opcheck():
    """torch.library.opcheck: the schemas, the fake implementations against
    the real ones and attention_operands' autograd registration."""
    xn, ws, cos, sin, _ = rope_inputs(s=8)
    torch.library.opcheck(OPS.attention_operands.default,
                          (xn.requires_grad_(), *ws, cos, sin, 4, 2),
                          test_utils=("test_schema", "test_autograd_registration",
                                      "test_faketensor"))
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(1, 4, 8, 32, generator=g), torch.randn(1, 2, 8, 32, generator=g)
    for op in (OPS.flash_fwd, OPS.flash_fwd_plain):
        torch.library.opcheck(op.default, (q, k, k, None, None, True, None, None, 4, None),
                              test_utils=("test_schema", "test_faketensor"))
