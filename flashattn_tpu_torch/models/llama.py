"""Llama-style decoder (counterpart of flashattn_tpu/models/llama.py).

The parameters keep the JAX package's names and its [in, out] layout
(``x @ w``), so a JAX parameter tree converts with a plain copy
(models/convert.py). Attention runs the port's kernels; every other piece is
plain PyTorch. Models are built on the card unless the caller names another
device.

Training takes the JAX package's rematerialisation (``remat`` of
``forward``, ``loss_fn`` and ``sgd_train_step``): each layer runs under
``torch.utils.checkpoint`` (non-reentrant) and its backward recomputes
what the policy did not keep. The policies save operator outputs, so the
pieces they name are operators: the attention forward
(ops/attention.py's ``flash_fwd``) and ``attention_operands`` below, the
q/k/v projections with their biases, the q/k norm and RoPE, which lays q,
k and v out as the kernel takes them.

The model-family fields of the JAX config are ported: Qwen2's q/k/v
biases (``attn_bias``), Qwen3's q/k RMSNorm (``qk_norm``), Llama-3.1's
llama3 RoPE (``rope_scaling``) and Phi-3's longrope (``rope_longrope``);
every site that feeds attention takes q, k and v from ``attention_inputs``.
An ALiBi model (``use_alibi``) carries position in the attention's bias
and not in RoPE: its ``rope_tables`` are (None, None), and every attention
call passes ``alibi``.

A mixture-of-experts config (``num_experts``: Mixtral, Qwen3-MoE,
Qwen2-MoE with its shared expert) holds ``moe`` in each layer in place of
the dense MLP's weights; its FFN is parallel/moe.py's grouped dispatch,
the JAX single-device function (moe_ffn_dense_reference) computed over the
picked experts only.

Parallelism (the JAX functions' ``mesh``): ``forward``, ``loss_fn`` and
``sgd_train_step`` (and models/train.py) take a parallel/mesh.py Mesh over
the ranks of a process group. Every rank passes the global tokens.

- ``data`` and ``sp``: a rank keeps its batch rows and its contiguous
  sequence shard, RoPE at the global positions; the layers' attention runs
  the contiguous ring over ``sp`` (parallel/ring.py). The loss is the
  global mean (each rank's sum over the global count, summed over data and
  sp).
- ``model`` (tensor parallelism, Megatron's layout; ``param_shardings`` and
  ``shard_params`` give each rank its shard of a whole model): q/k/v by
  heads and w_gate/w_up by columns, wo and w_down by rows, the embedding
  by vocabulary rows and the head by vocabulary columns. Before a
  column-split product the normed input passes ``copy_to_group`` (identity
  forward, gradient summed over ``model``), after a row-split one
  ``reduce_from_group`` (sum forward, identity backward); the embedding
  looks up the tokens of its rows and sums over ``model``; the head's
  logits are gathered over ``model``, so the forward returns logits over
  the whole vocabulary, as the JAX forward does. Attention runs K1 and the
  backward kernels on the rank's Hq/n and Hkv/n heads.
- ``ep`` (expert parallelism): a MoE layer's experts split over ``ep``;
  ``cfg.moe_dispatch == "a2a"`` with tokens that split takes the
  all_to_all capacity dispatch (parallel/moe.py::moe_ffn_a2a), else the
  masked-dense one (moe_ffn); the shared expert and the rest of the layer
  are computed on every rank.
- ``pp`` (pipeline parallelism): ``stack_pipeline_params`` groups the
  layers into stages, ``pipeline_forward`` and ``pipeline_loss_fn`` run
  them by parallel/pipeline.py's schedule (with a ``data`` axis beside
  it); forward and loss_fn compute every layer on every rank of ``pp``.

``reduce_gradients`` sums each gradient over the ranks that hold a share of
it (data and sp; pp for the pipeline's embedding and head), and
``global_grad_norm`` is the norm of the whole gradient (the squares of a
split parameter summed over its axes, a replicated one counted once).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from flashattn_tpu_torch.models.config import ModelConfig, check_supported
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.common import card_device
from flashattn_tpu_torch.ops.flash_fwd import default_alibi_slopes
from flashattn_tpu_torch.ops.quant_matmul import (QuantizedLinear, quant_matmul,
                                                  quantize_weights)
from flashattn_tpu_torch.ops.varlen import flash_attention_varlen
from flashattn_tpu_torch.parallel import moe
from flashattn_tpu_torch.parallel.collectives import (copy_to_group, gather_from_group,
                                                      keep_gradient, reduce_from_group,
                                                      split_to_group)
from flashattn_tpu_torch.parallel.distributed import all_reduce
from flashattn_tpu_torch.parallel.mesh import local_block
from flashattn_tpu_torch.parallel.pipeline import (pipeline_apply, stack_stage_params,
                                                   unstack_stage_params)
from flashattn_tpu_torch.parallel.ring import ring_flash_attention

# Projections eligible for weight-only quantization: everything but the
# embedding (a gather, not a product) and the norms.
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class LlamaLayer(nn.Module):
    """One decoder block's parameters."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        super().__init__()
        device = card_device(device)
        h, hd = cfg.hidden_size, cfg.head_dim
        nq, nkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))

        self.attn_norm = param(h)
        self.wq = param(h, nq * hd)
        self.wk = param(h, nkv * hd)
        self.wv = param(h, nkv * hd)
        self.wo = param(nq * hd, h)
        self.mlp_norm = param(h)
        if cfg.num_experts:  # routed experts (and a shared one) in place of the MLP
            self.moe = moe.Experts(h, f, cfg.num_experts, cfg.moe_shared_intermediate,
                                   cfg.dtype, device)
        else:
            self.w_gate = param(h, f)
            self.w_up = param(h, f)
            self.w_down = param(f, h)
        if cfg.attn_bias:  # Qwen2's additive q/k/v biases
            self.bq = param(nq * hd)
            self.bk = param(nkv * hd)
            self.bv = param(nkv * hd)
        if cfg.use_post_norms:  # Gemma-2's sandwich norms on each block's output
            self.post_attn_norm = param(h)
            self.post_mlp_norm = param(h)
        if cfg.qk_norm:  # Qwen3's per-head RMSNorm of q and k over head_dim
            self.q_norm = param(hd)
            self.k_norm = param(hd)


class Llama(nn.Module):
    """Parameters of the decoder: ``embed``, ``final_norm``, ``lm_head``
    (untied configs) and ``layers.{i}.{wq, wk, ...}`` (a MoE layer's
    experts under ``layers.{i}.moe``: moe.Experts).

    The computation lives in the functions of this module and in
    models/generate.py, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        super().__init__()
        check_supported(cfg)
        device = card_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, h, dtype=cfg.dtype, device=device))
        self.final_norm = nn.Parameter(torch.empty(h, dtype=cfg.dtype, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(h, cfg.vocab_size, dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def shardings(self) -> dict[str, tuple]:
        """Each parameter's split over the mesh axes (param_shardings)."""
        return param_shardings(self.cfg)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> Llama:
    """A model with random weights: normal draws scaled by fan-in**-0.5 in
    float32, cast to cfg.dtype; norms start at the identity. `generator`
    must live on `device` (torch draws on the generator's device)."""
    model = Llama(cfg, device)
    device = model.device

    def dense(p: nn.Parameter, fan_in: int) -> None:
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        p.copy_(x * fan_in**-0.5)

    h = cfg.hidden_size
    dense(model.embed, h)
    model.final_norm.fill_(1.0 - cfg.norm_offset)
    if not cfg.tie_embeddings:
        dense(model.lm_head, h)
    for layer in model.layers:
        layer.attn_norm.fill_(1.0 - cfg.norm_offset)
        layer.mlp_norm.fill_(1.0 - cfg.norm_offset)
        if cfg.use_post_norms:
            layer.post_attn_norm.fill_(1.0 - cfg.norm_offset)
            layer.post_mlp_norm.fill_(1.0 - cfg.norm_offset)
        if cfg.qk_norm:
            layer.q_norm.fill_(1.0 - cfg.norm_offset)
            layer.k_norm.fill_(1.0 - cfg.norm_offset)
        if cfg.attn_bias:
            for b in (layer.bq, layer.bk, layer.bv):
                b.zero_()
        dense(layer.wq, h)
        dense(layer.wk, h)
        dense(layer.wv, h)
        dense(layer.wo, cfg.num_heads * cfg.head_dim)
        if cfg.num_experts:
            drawn = moe.init_moe_params(generator, h, cfg.intermediate_size, cfg.num_experts,
                                        cfg.dtype)
            for name, value in drawn.items():
                getattr(layer.moe, name).copy_(value)
            if cfg.moe_shared_intermediate:
                shared = layer.moe.shared
                dense(shared.w_gate, h)
                dense(shared.w_up, h)
                dense(shared.w_down, cfg.moe_shared_intermediate)
                dense(layer.moe.shared_gate, h)
        else:
            dense(layer.w_gate, h)
            dense(layer.w_up, h)
            dense(layer.w_down, cfg.intermediate_size)
    return model


def proj(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ w with w in [in, out] layout: a QuantizedLinear goes through the
    int8/int4 kernels (ops/quant_matmul.py), a plain weight through
    torch.matmul (cuBLAS on the card, as the JAX package leaves its dense
    projections to XLA)."""
    if isinstance(w, QuantizedLinear):
        y = quant_matmul(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype)
        return y.reshape(*x.shape[:-1], w.out_features)
    return torch.matmul(x, w)


@torch.no_grad()
def quantize_params(model: Llama, bits: int = 8) -> Llama:
    """Weight-only quantization of every projection and of an untied
    lm_head, IN PLACE: each becomes a QuantizedLinear module (buffers ``w``
    and ``scale``, quantized as the JAX package's quantize_params does). The
    embedding and the norms stay in the compute dtype, and so does a MoE
    layer's ``moe`` (router and experts): the JAX function quantizes a
    layer's top-level projections only. Returns `model`."""
    def swap(module: nn.Module, name: str) -> None:
        qw = quantize_weights(getattr(module, name), bits)
        delattr(module, name)  # a parameter slot takes no module
        setattr(module, name, qw)

    if not model.cfg.tie_embeddings:
        swap(model, "lm_head")
    for layer in model.layers:
        for key in _QUANT_KEYS:
            if key in layer._parameters:  # a MoE layer has no dense MLP weights
                swap(layer, key)
    return model


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if offset:
        return ((offset + w.float()) * normed).to(x.dtype)
    return normed.to(x.dtype) * w


def _tp(mesh) -> bool:
    return mesh is not None and mesh.size("model") > 1


def embed_tokens(model: Llama, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The tokens' embeddings; under a "model" axis the rank holds a block
    of the vocabulary's rows: it looks up the tokens inside it (zeros for
    the others) and the blocks are summed over the axis."""
    cfg = model.cfg
    if _tp(mesh):
        rows = model.embed.shape[0]
        local = tokens - mesh.index("model") * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(inside, local, 0), model.embed)
        x = reduce_from_group(torch.where(inside[..., None], x, 0.0), mesh.group("model"))
    else:
        x = F.embedding(tokens, model.embed)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    return x


def lm_logits(x: torch.Tensor, model: Llama, mesh=None) -> torch.Tensor:
    """Final norm -> head -> optional final soft-cap; float32 logits.

    A plain head's product runs in the model's dtype and is cast afterwards,
    so bf16 models carry bf16-rounded logits; a quantized head writes f32
    logits, as the JAX package's does. Under a "model" axis the rank's head
    holds a block of the vocabulary's columns and the logits are gathered
    over the axis: every rank returns the whole vocabulary's."""
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.norm_eps, cfg.norm_offset)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    if _tp(mesh):
        x = copy_to_group(x, mesh.group("model"))
    if isinstance(head, QuantizedLinear):  # f32 straight from the accumulator
        logits = proj(x, head, out_dtype=torch.float32)
    else:
        logits = proj(x, head).float()
    if _tp(mesh):
        logits = gather_from_group(logits, mesh.group("model"), -1)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """positions [..., S] -> (cos, sin) [..., S, head_dim/2] float32.

    With cfg.rope_longrope (Phi-3) the frequencies divide by the long
    factor set once the call's largest position passes the original
    context (the JAX rule: a maximum over the whole call, batch included),
    else by the short set, and cos and sin scale by the attention factor.
    The choice is made on the device (torch.where over both sets), so a
    captured decode step makes it anew at each replay. With
    cfg.rope_scaling (Llama-3.1) the long wavelengths stretch by the
    factor, the short ones stay and the band between interpolates. Nothing
    here copies from the host: a CUDA graph can capture it. An ALiBi model
    (cfg.use_alibi) has no RoPE: (None, None)."""
    if cfg.use_alibi:
        return None, None
    half = cfg.head_dim // 2
    device = positions.device
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    theta = torch.full((), cfg.rope_theta, dtype=torch.float32, device=device)
    freqs = torch.pow(theta, exponent)
    if cfg.rope_longrope is not None:
        short_f, long_f, orig_max, attn_factor = cfg.rope_longrope
        short = freqs / _factor_table(tuple(short_f), device)
        long = freqs / _factor_table(tuple(long_f), device)
        freqs = torch.where(positions.max() + 1 > orig_max, long, short)
        angles = positions[..., None].float() * freqs
        return torch.cos(angles) * attn_factor, torch.sin(angles) * attn_factor
    if cfg.rope_scaling is not None:
        factor, low_f, high_f, orig_max = cfg.rope_scaling
        wavelen = 2.0 * math.pi / freqs
        smooth = ((orig_max / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        freqs = (1.0 - smooth) * freqs / factor + smooth * freqs
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


@functools.lru_cache(maxsize=None)
def _factor_table(factors: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A longrope factor set as a float32 tensor on `device`, made once (at
    the first, eager call: a capture then reads it without a host copy)."""
    with torch.inference_mode(False):  # an ordinary tensor, whatever the caller's mode
        return torch.tensor(factors, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [S, D/2] or [B, S, D/2]. Rotate-half."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_b, sin_b = cos[None, None], sin[None, None]
    else:
        cos_b, sin_b = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b], dim=-1)
    return out.to(x.dtype)


def _mlp_block(layer: LlamaLayer, x: torch.Tensor, cfg: ModelConfig,
               mesh=None) -> torch.Tensor:
    xn = rms_norm(x, layer.mlp_norm, cfg.norm_eps, cfg.norm_offset)
    if cfg.num_experts:
        return _moe_block(layer.moe, xn, cfg, mesh)
    if _tp(mesh):  # w_gate and w_up split by columns, w_down by rows
        xn = copy_to_group(xn, mesh.group("model"))
    gate = proj(xn, layer.w_gate).float()
    act = (F.gelu(gate, approximate="tanh") if cfg.mlp_activation == "gelu_tanh"
           else F.silu(gate))
    out = proj(act.to(x.dtype) * proj(xn, layer.w_up), layer.w_down)
    return reduce_from_group(out, mesh.group("model")) if _tp(mesh) else out


def _moe_block(experts: moe.Experts, xn: torch.Tensor, cfg: ModelConfig,
               mesh=None) -> torch.Tensor:
    """The MoE FFN of the normed xn [..., H]: the routed experts by the
    grouped dispatch (under an "ep" axis by moe_ffn_a2a when
    cfg.moe_dispatch is "a2a" and the tokens split over it, else by the
    masked-dense moe_ffn, the rank holding its block of the experts), plus,
    with cfg.moe_shared_intermediate (Qwen2-MoE), the always-on shared
    expert times sigmoid(xn shared_gate), both in float32 and the routed
    output rounded first, as the JAX layer adds them."""
    flat = xn.reshape(-1, xn.shape[-1])
    args = (experts.routed(), cfg.top_k_experts)
    if mesh is not None and mesh.size("ep") > 1:
        group = mesh.group("ep")
        if cfg.moe_dispatch == "a2a" and flat.shape[0] % mesh.size("ep") == 0:
            # tokens split over ep: each rank dispatches its block and gets it back
            out = gather_from_group(moe.moe_ffn_a2a(
                split_to_group(flat, group, 0), *args, group=group,
                capacity_factor=cfg.moe_capacity_factor, activation=cfg.mlp_activation,
                norm_topk=cfg.moe_norm_topk), group, 0)
        else:
            out = moe.moe_ffn(flat, *args, group=group, activation=cfg.mlp_activation,
                              norm_topk=cfg.moe_norm_topk)
    else:
        out = moe.moe_ffn_grouped(flat, *args, cfg.mlp_activation, cfg.moe_norm_topk)
    if cfg.moe_shared_intermediate:
        sh = experts.shared
        shared_y = moe.swiglu(flat, sh.w_gate, sh.w_up, sh.w_down, cfg.mlp_activation).float()
        coef = torch.sigmoid(torch.matmul(flat.float(), experts.shared_gate.float()))
        out = (out.float() + coef * shared_y).to(xn.dtype)
    return out.view(xn.shape)


def residuals(layer: LlamaLayer, x: torch.Tensor, a: torch.Tensor,
              cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """x plus the attention block's output `a`, then plus the MLP block's;
    with cfg.use_post_norms each output goes through its own RMSNorm first
    (Gemma-2's sandwich norms), as the JAX layer does."""
    def post(name: str, y: torch.Tensor) -> torch.Tensor:
        if not cfg.use_post_norms:
            return y
        return rms_norm(y, getattr(layer, name), cfg.norm_eps, cfg.norm_offset)

    x = x + post("post_attn_norm", a)
    return x + post("post_mlp_norm", _mlp_block(layer, x, cfg, mesh))


def _optional(layer: LlamaLayer, *names: str) -> tuple:
    """The layer's parameters of these names, None where a config has none."""
    return tuple(getattr(layer, name, None) for name in names)


def _heads(xn, w, bias, heads: int, head_dim: int) -> torch.Tensor:
    """One projection (plus its bias) of xn [B, S, H] as [B, heads, S, D]."""
    b, s = xn.shape[:2]
    y = proj(xn, w)
    if bias is not None:
        y = y + bias
    return y.view(b, s, heads, head_dim).transpose(1, 2)


def _operands(xn, wq, wk, wv, cos, sin, num_heads: int, num_kv_heads: int, bq=None, bk=None,
              bv=None, q_norm=None, k_norm=None, norm_eps: float = 0.0,
              norm_offset: float = 0.0, head_dim: int | None = None):
    """attention_inputs' arithmetic, in the JAX package's order: the
    projections and their biases, the q/k RMSNorm, RoPE on q and k (none
    when cos is None: an ALiBi model)."""
    head_dim = head_dim or wq.shape[1] // num_heads
    q = _heads(xn, wq, bq, num_heads, head_dim)
    k = _heads(xn, wk, bk, num_kv_heads, head_dim)
    v = _heads(xn, wv, bv, num_kv_heads, head_dim).contiguous()  # as the kernels take it
    if q_norm is not None:
        q = rms_norm(q, q_norm, norm_eps, norm_offset)
        k = rms_norm(k, k_norm, norm_eps, norm_offset)
    if cos is None:  # in the kernel's layout, as apply_rope leaves them
        return q.contiguous(), k.contiguous(), v
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_inputs(layer: LlamaLayer, xn: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, cfg: ModelConfig):
    """The attention kernel's q [B, Hq, S, D] and k, v [B, Hkv, S, D] from
    the normed input xn [B, S, H]: the projections, the q/k/v biases
    (cfg.attn_bias), the q/k RMSNorm (cfg.qk_norm) and RoPE on q and k, in
    the JAX package's order. Every site that feeds attention (the layer's
    forward, prefill, decode_step, chunk_step) takes its operands from
    here. Plain weights go through the attention_operands operator, whose
    outputs remat="attn" keeps and whose backward is registered;
    quantized weights (no gradient) run the same function directly."""
    args = (xn, layer.wq, layer.wk, layer.wv, cos, sin, cfg.num_heads, cfg.num_kv_heads,
            *_optional(layer, "bq", "bk", "bv", "q_norm", "k_norm"), cfg.norm_eps,
            cfg.norm_offset)
    if isinstance(layer.wq, QuantizedLinear):
        return _operands(*args, head_dim=cfg.head_dim)
    return attention_operands(*args)


def rope_backward(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The gradient through apply_rope (a rotation by the same angles, so
    the inverse one), computed as autograd computes it: in float32, each
    half rounded to g's dtype; g itself without RoPE (cos None)."""
    if cos is None:
        return g
    half = g.shape[-1] // 2
    if cos.dim() == 2:
        cos_b, sin_b = cos[None, None], sin[None, None]
    else:
        cos_b, sin_b = cos[:, None], sin[:, None]
    g1, g2 = g[..., :half].float(), g[..., half:].float()
    return torch.cat([(g1 * cos_b + g2 * sin_b).to(g.dtype),
                      (g2 * cos_b - g1 * sin_b).to(g.dtype)], dim=-1)


def rms_norm_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float,
                      offset: float, need_w: bool):
    """(d x, d w) of rms_norm(x, w, eps, offset) for the output gradient g,
    as autograd forms them (d w None unless need_w)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_(need_w)
        y = rms_norm(x, w, eps, offset)
        grads = torch.autograd.grad(y, (x, w) if need_w else (x,), g)
    return grads[0], (grads[1] if need_w else None)


@torch.library.custom_op(
    "flashattn_tpu_torch::attention_operands", mutates_args=(),
    schema="(Tensor xn, Tensor wq, Tensor wk, Tensor wv, Tensor? cos, Tensor? sin, "
           "int num_heads, int num_kv_heads, Tensor? bq=None, Tensor? bk=None, "
           "Tensor? bv=None, Tensor? q_norm=None, Tensor? k_norm=None, "
           "float norm_eps=0.0, float norm_offset=0.0) -> (Tensor, Tensor, Tensor)")
def attention_operands(xn, wq, wk, wv, cos, sin, num_heads, num_kv_heads, bq=None, bk=None,
                       bv=None, q_norm=None, k_norm=None, norm_eps=0.0, norm_offset=0.0):
    """The attention kernel's q, k and v from the normed input xn [B, S, H]:
    the projections and their biases, the q/k RMSNorm, RoPE on q and k,
    the [B, H, S, D] layout (attention_inputs' arithmetic). One operator, so
    that remat="attn" keeps its outputs, the kernel's operands, and its
    recompute runs no projection."""
    return _operands(xn, wq, wk, wv, cos, sin, num_heads, num_kv_heads, bq, bk, bv, q_norm,
                     k_norm, norm_eps, norm_offset)


@attention_operands.register_fake
def _(xn, wq, wk, wv, cos, sin, num_heads, num_kv_heads, bq=None, bk=None, bv=None,
      q_norm=None, k_norm=None, norm_eps=0.0, norm_offset=0.0):
    b, s = xn.shape[:2]
    d = wq.shape[1] // num_heads
    return (xn.new_empty(b, num_heads, s, d), xn.new_empty(b, num_kv_heads, s, d),
            xn.new_empty(b, num_kv_heads, s, d))


def _operands_setup(ctx, inputs, output):
    xn, wq, wk, wv, cos, sin, num_heads, num_kv_heads, bq, bk, _, q_norm, k_norm, eps, \
        offset = inputs
    ctx.save_for_backward(xn, wq, wk, wv, cos, sin, bq, bk, q_norm, k_norm)
    ctx.heads, ctx.norm = (num_heads, num_kv_heads), (eps, offset)


def _operands_backward(ctx, dq, dk, dv):
    """The gradients of xn, the weights, the biases and the q/k norms from
    those of q, k and v: the RoPE backward, then the RMSNorm backward over
    D (from the q and k projections, recomputed), then the projections'
    products as torch.matmul's autograd forms them; a bias's gradient is
    its projection's summed over B and S."""
    xn, wq, wk, wv, cos, sin, bq, bk, q_norm, k_norm = ctx.saved_tensors
    (nq, nkv), (eps, offset) = ctx.heads, ctx.norm
    # One flag an argument the caller passed (the optional ones may be left out).
    need = ctx.needs_input_grad + (False,) * (15 - len(ctx.needs_input_grad))
    b, s, h = xn.shape
    d = wq.shape[1] // nq
    gq, gk = rope_backward(dq, cos, sin), rope_backward(dk, cos, sin)
    dnorms = [None, None]
    if q_norm is not None:
        gq, dnorms[0] = rms_norm_backward(_heads(xn, wq, bq, nq, d), q_norm, gq, eps, offset,
                                          need[11])
        gk, dnorms[1] = rms_norm_backward(_heads(xn, wk, bk, nkv, d), k_norm, gk, eps, offset,
                                          need[12])
    grads = [g.transpose(1, 2).reshape(b * s, -1) for g in (gq, gk, dv)]
    weights = (wq, wk, wv)
    dxn = None
    if need[0]:
        for g, w in zip(grads, weights):
            term = g.mm(w.t())
            dxn = term if dxn is None else dxn + term
        dxn = dxn.view(b, s, h)
    x2 = xn.reshape(b * s, h).t()
    dws = [x2.mm(g) if need[1 + i] else None for i, g in enumerate(grads)]
    dbs = [g.sum(0) if need[8 + i] else None for i, g in enumerate(grads)]
    out = (dxn, *dws, None, None, None, None, *dbs, *dnorms, None, None)
    return out[:len(ctx.needs_input_grad)]


attention_operands.register_autograd(_operands_backward, setup_context=_operands_setup)


def layer_window(cfg: ModelConfig, layer_idx: int) -> int | None:
    """Per-layer sliding window: Gemma-2-style 'alternate' puts the window
    on even layers and full attention on odd ones."""
    if cfg.window_pattern is None:
        return cfg.attn_window
    return cfg.attn_window if layer_idx % 2 == 0 else None


def _attn_block(layer: LlamaLayer, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cfg: ModelConfig, window: int | None = None,
                segment_ids: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """The attention block; under a "model" axis cfg is local_config's (the
    rank's heads) and an ALiBi model takes its heads' slopes of the whole
    table."""
    b, s, _ = x.shape
    xn = rms_norm(x, layer.attn_norm, cfg.norm_eps, cfg.norm_offset)
    slopes = None
    if _tp(mesh):  # q, k, v split by heads, wo by rows
        xn = copy_to_group(xn, mesh.group("model"))
        if cfg.use_alibi:
            h = cfg.num_heads
            slopes = default_alibi_slopes(h * mesh.size("model"))[
                mesh.index("model") * h:(mesh.index("model") + 1) * h].to(x.device)
    q, k, v = attention_inputs(layer, xn, cos, sin, cfg)
    opts = dict(scale=cfg.attn_scale, window=window, logit_softcap=cfg.logit_softcap,
                alibi=cfg.use_alibi, alibi_slopes=slopes)
    if mesh is not None and mesh.size("sp") > 1:  # x is this rank's sequence shard
        o = ring_flash_attention(q, k, v, mesh.group("sp"), is_causal=True,
                                 segment_ids=None if segment_ids is None
                                 else (segment_ids, segment_ids), **opts)
    elif segment_ids is not None:
        o = flash_attention_varlen(q, k, v, segment_ids=segment_ids, is_causal=True, **opts)
    else:
        o = flash_attention(q, k, v, is_causal=True, **opts)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    out = proj(o, layer.wo)
    return reduce_from_group(out, mesh.group("model")) if _tp(mesh) else out


def document_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Each token's position within its packed document: [B, S] ids ->
    [B, S] int64 positions that restart where the id changes."""
    b, s = segment_ids.shape
    pos = torch.arange(s, device=segment_ids.device).expand(b, s)
    change = torch.ones_like(segment_ids, dtype=torch.bool)
    change[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.cummax(torch.where(change, pos, torch.zeros_like(pos)), dim=1).values
    return pos - starts


def check_segment_ids(segment_ids, tokens: torch.Tensor) -> torch.Tensor:
    """segment_ids as a tensor on the tokens' device, shaped like them."""
    seg = torch.as_tensor(segment_ids, device=tokens.device)
    if seg.shape != tokens.shape:
        raise ValueError(f"segment_ids {tuple(seg.shape)} must be shaped like the tokens "
                         f"{tuple(tokens.shape)}")
    return seg


def _layer(layer: LlamaLayer, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           cfg: ModelConfig, window: int | None, segment_ids: torch.Tensor | None,
           mesh=None) -> torch.Tensor:
    """One decoder block (the JAX forward's layer_fn)."""
    return residuals(layer, x, _attn_block(layer, x, cos, sin, cfg, window, segment_ids, mesh),
                     cfg, mesh)


REMAT_POLICIES = (True, "dots", "attn")  # and False (or any falsy value): no remat


def _saved_ops(remat) -> list | None:
    """The operators whose outputs a remat policy keeps: None for remat=True
    (only the layer's input), the projections' products for "dots"
    (dots_with_no_batch_dims_saveable; the q/k/v ones are inside
    attention_operands), the attention kernel's operands and outputs for
    "attn" (the JAX package's flash_resid: q, k, v, O and LSE)."""
    ops = torch.ops.flashattn_tpu_torch
    if remat == "dots":
        return [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                ops.attention_operands.default]
    if remat == "attn":
        return [ops.attention_operands.default, ops.flash_fwd.default,
                ops.flash_fwd_plain.default]
    return None


def layers_forward(model: Llama, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   segment_ids: torch.Tensor | None = None, remat=False,
                   mesh=None) -> torch.Tensor:
    """The decoder blocks on the embedded x [B, S, H], each with its window.

    With remat (and a gradient to take) each block runs under
    torch.utils.checkpoint and keeps only its input and what the policy
    names (_saved_ops); its backward recomputes the rest: True recomputes
    the whole block, attention kernel included, "dots" the elementwise work
    and the attention kernel, "attn" everything but the q/k/v projections
    and the attention kernel. Under a mesh x, cos, sin and segment_ids are
    this rank's shards and attention runs the ring over "sp"; under a
    "model" axis the layers are the rank's shards (local_config)."""
    if remat and remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be False or one of {REMAT_POLICIES}, got {remat!r}")
    cfg = local_config(model.cfg, mesh)
    layer_fn = _layer
    if remat and torch.is_grad_enabled():
        saved = _saved_ops(remat)
        context_fn = (functools.partial(create_selective_checkpoint_contexts, saved)
                      if saved else None)
        layer_fn = functools.partial(
            checkpoint, _layer, use_reentrant=False, preserve_rng_state=False,
            **({"context_fn": context_fn} if context_fn else {}))
    for i, layer in enumerate(model.layers):
        x = layer_fn(layer, x, cos, sin, cfg, layer_window(cfg, i), segment_ids, mesh)
    return x


def forward(model: Llama, tokens: torch.Tensor, segment_ids=None,
            remat=False, mesh=None) -> torch.Tensor:
    """Training/prefill forward: tokens [B, S] -> float32 logits [B, S, vocab].

    Differentiable: attention goes through the flash autograd Function, whose
    backward runs the backward kernels (with each layer's window). With
    segment_ids [B, S] the rows are packed documents: attention stays within
    a document (ops/varlen.py; ids < 0 are padding) and RoPE positions
    restart at each boundary. A soft-capped model (cfg.logit_softcap,
    Gemma-2) trains too, packed or not: the backward kernels take the cap.

    remat (rematerialisation, packed or not): False keeps every layer's
    activations for the backward; True keeps only each layer's input and
    recomputes the layer in the backward, attention kernel included; "dots"
    also keeps the projections' outputs, so the backward replays the
    elementwise work and the attention kernel; "attn" keeps the attention
    kernel's residuals (q, k, v as the kernel takes them, O and LSE), so
    the backward runs no attention forward and no q/k/v projection but
    recomputes the rest (layers_forward). Each trades the activations'
    memory for time; the loss and gradients stay as without remat.

    mesh (a parallel/mesh.py Mesh; module docstring): tokens (and
    segment_ids) are the global [B, S] on every rank, and the result is
    this rank's logits [B / data, S / sp, vocab]: its batch rows and its
    sequence shard, at the global positions, over the whole vocabulary
    (under a "model" axis `model` is the rank's shard_params shard)."""
    if segment_ids is not None:
        segment_ids = check_segment_ids(segment_ids, tokens)
    cos, sin = input_tables(model.cfg, tokens, segment_ids)
    if mesh is not None:
        check_mesh(mesh)
        tokens = shard_rows(tokens, mesh)
        if segment_ids is not None:
            segment_ids = shard_rows(segment_ids, mesh)
        if cos is not None:  # [S, D/2] or per row [B, S, D/2]
            cos, sin = ((shard_rows(t, mesh) if t.dim() == 3 else
                         shard_rows(t[None], mesh, batch=False)[0]) for t in (cos, sin))
    x = embed_tokens(model, tokens, mesh)
    return lm_logits(layers_forward(model, x, cos, sin, segment_ids, remat, mesh), model, mesh)


def input_tables(cfg: ModelConfig, tokens: torch.Tensor,
                 segment_ids: torch.Tensor | None = None):
    """The RoPE tables of a training or prefill input tokens [B, S]:
    positions 0..S-1, or restarting at each document of segment_ids."""
    positions = (torch.arange(tokens.shape[1], device=tokens.device) if segment_ids is None
                 else document_positions(segment_ids))
    return rope_tables(cfg, positions)


def loss_fn(model: Llama, tokens: torch.Tensor, segment_ids=None,
            remat=False, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens[:, :-1] -> tokens[:, 1:]
    (tokens [B, S+1]), a float32 scalar.

    With segment_ids [B, S+1] (packed documents) the predictions across a
    document boundary and those from padding (ids < 0) are left out of the
    mean, which runs over the valid ones (at least 1).

    mesh: the global tokens on every rank, shifted before the split (S must
    split over "sp", B over "data"); each rank's sum of its predictions'
    losses over the global count, summed over data and sp: every rank
    returns the global mean, and its backward gives this rank's share of
    the gradients (reduce_gradients sums them)."""
    seg_in = None
    if segment_ids is not None:
        segment_ids = check_segment_ids(segment_ids, tokens)
        seg_in = segment_ids[:, :-1]
    logits = forward(model, tokens[:, :-1], seg_in, remat=remat, mesh=mesh)
    targets = tokens[:, 1:].long()
    valid = None
    if segment_ids is not None:
        valid = (segment_ids[:, :-1] == segment_ids[:, 1:]) & (segment_ids[:, :-1] >= 0)
    count = targets.numel() if valid is None else valid.sum().clamp(min=1)
    if mesh is not None:
        targets = shard_rows(targets, mesh)
        valid = None if valid is None else shard_rows(valid, mesh)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mesh is None and valid is None:
        return nll.mean()
    total = (nll if valid is None else torch.where(valid, nll, 0.0)).sum() / count
    return total if mesh is None else _SumOverRanks.apply(total, mesh, ("data", "sp"))


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's value over the mesh's `axes`; the gradient
    passes to each rank's own term unchanged (the loss is the sum of the
    ranks' terms)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.detach().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


AXES = ("data", "sp", "model", "pp", "ep")


def check_mesh(mesh) -> None:
    """A mesh the model takes: any of the axes "data" (batch rows), "sp"
    (sequence shards), "model" (tensor parallelism), "pp" (pipeline stages:
    pipeline_forward; forward computes every layer on each of its ranks)
    and "ep" (experts); another axis above size 1 raises ValueError."""
    unknown = [a for a in mesh.active() if a not in AXES]
    if unknown:
        raise ValueError(f"the model takes the axes {AXES}, not {unknown}")


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config a rank's layers compute with: under a "model" axis of n
    ranks, num_heads / n and num_kv_heads / n (the rank's heads); cfg
    itself otherwise."""
    if not _tp(mesh):
        return cfg
    n = mesh.size("model")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               num_kv_heads=cfg.num_kv_heads // n)


def param_shardings(cfg: ModelConfig) -> dict[str, tuple]:
    """Each parameter of a whole model (state-dict name) -> the mesh axis
    each of its dimensions splits over (None: whole), the JAX function's
    PartitionSpecs: Megatron's layout over "model" (q/k/v and their biases
    by columns, i.e. heads; wo by rows; w_gate and w_up by columns, w_down
    by rows; the embedding by vocabulary rows, the head by vocabulary
    columns), the routed experts over "ep", everything else whole."""
    layer = {"attn_norm": (None,), "wq": (None, "model"), "wk": (None, "model"),
             "wv": (None, "model"), "wo": ("model", None), "mlp_norm": (None,)}
    if cfg.attn_bias:
        layer.update(bq=("model",), bk=("model",), bv=("model",))
    if cfg.use_post_norms:
        layer.update(post_attn_norm=(None,), post_mlp_norm=(None,))
    if cfg.qk_norm:
        layer.update(q_norm=(None,), k_norm=(None,))
    if cfg.num_experts:
        layer["moe.router"] = (None, None)
        for name in ("w_gate", "w_up", "w_down"):
            layer[f"moe.{name}"] = ("ep", None, None)
        if cfg.moe_shared_intermediate:
            for name in ("shared.w_gate", "shared.w_up", "shared.w_down", "shared_gate"):
                layer[f"moe.{name}"] = (None, None)
    else:
        layer.update(w_gate=(None, "model"), w_up=(None, "model"), w_down=("model", None))
    specs = {"embed": ("model", None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    for i in range(cfg.num_layers):
        specs.update({f"layers.{i}.{name}": spec for name, spec in layer.items()})
    return specs


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner), leaf, nn.Parameter(value))


@torch.no_grad()
def shard_params(model: Llama, mesh) -> Llama:
    """This rank's shard of a whole model under `mesh` (param_shardings'
    blocks over "model" and "ep", copied): a Llama of the same config whose
    split parameters are the rank's blocks. Raises ValueError for a
    quantized model, or when the heads, the kv heads or the vocabulary do
    not split over "model" (the MLP's width and the experts: local_block
    raises)."""
    cfg = model.cfg
    if isinstance(model.layers[0].wq, QuantizedLinear):
        raise ValueError("shard an unquantized model (the JAX package shards plain weights)")
    n = mesh.size("model")
    for what, size in (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
                       ("vocab_size", cfg.vocab_size)):
        if size % n:
            raise ValueError(f"{what} {size} does not split over model ({n} ranks)")
    specs = param_shardings(cfg)
    shard = Llama(cfg, device="meta")
    for name, p in model.named_parameters():
        _set_param(shard, name, local_block(p.detach(), specs[name], mesh).clone())
    return shard


def shard_rows(x: torch.Tensor, mesh, batch: bool = True) -> torch.Tensor:
    """This rank's block of a global [B, S, ...] tensor: rows over "data"
    (with `batch`), contiguous sequence shards over "sp"."""
    if batch:
        b, n = x.shape[0], mesh.size("data")
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} data ranks")
        x = x.narrow(0, mesh.index("data") * (b // n), b // n)
    s, n = x.shape[1], mesh.size("sp")
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} sp ranks")
    return x.narrow(1, mesh.index("sp") * (s // n), s // n)


def _summed_axes(model: nn.Module, name: str, mesh) -> tuple[str, ...]:
    """The axes over which a parameter's gradient is a share to be summed:
    data and sp always; pp for a pipeline's embedding, final norm and head
    (stage 0 holds the embedding's share, the last stage the head's). A
    parameter split over model, ep or pp holds its own block's gradient
    whole, and a whole one gets the same gradient on every rank of model
    (copy_to_group) and ep (moe_ffn's)."""
    axes = ("data", "sp")
    if isinstance(model, PipelineLlama) and not name.startswith("stages."):
        axes += ("pp",)
    return tuple(a for a in axes if mesh.size(a) > 1)


def reduce_gradients(model: nn.Module, mesh=None) -> None:
    """Sum each parameter's gradient over the ranks that hold a share of it,
    in place: without a mesh over every rank of the process group; under a
    mesh over _summed_axes. One all-reduce a set of axes and a dtype, of
    the gradients laid end to end."""
    sets: dict = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            axes = None if mesh is None else _summed_axes(model, name, mesh)
            sets.setdefault(axes, []).append(p.grad)
    for axes, grads in sets.items():
        if axes == ():
            continue
        for dtype in dict.fromkeys(g.dtype for g in grads):
            same = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in same])
            flat = all_reduce(flat) if axes is None else mesh.all_reduce(flat, axes)
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))


def global_grad_norm(model: nn.Module, mesh) -> torch.Tensor:
    """The norm of the whole model's gradient under `mesh`, after
    reduce_gradients: the squares of a parameter split over model, pp or ep
    summed over those axes, a whole one's counted once; a float32 scalar
    on the gradients' device."""
    specs = model.shardings()
    sums: dict = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            axes = tuple(a for a in specs[name] if a and mesh.size(a) > 1)
            sq = p.grad.float().square().sum()
            sums[axes] = sums[axes] + sq if axes in sums else sq
    total = sum(mesh.all_reduce(sq, axes) if axes else sq for axes, sq in sums.items())
    return torch.sqrt(total)


def sgd_train_step(model: Llama, tokens: torch.Tensor, lr: float = 1e-3,
                   remat=False, mesh=None) -> tuple[torch.Tensor, Llama]:
    """Loss, gradients and a plain SGD update -> (loss, model); `remat` and
    `mesh` as in forward and loss_fn (under a mesh the gradients are summed
    over the ranks before the update, so every rank's parameters stay
    equal).

    The JAX function returns new parameters; this one updates the model in
    place (p -= lr * g in the parameters' dtype) and returns it."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, remat=remat, mesh=mesh)
    loss.backward()
    if mesh is not None:
        reduce_gradients(model, mesh)
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad.to(p.dtype))
            p.grad = None
    return loss.detach(), model


# ---------------- pipeline parallelism (GPipe over a "pp" mesh axis) ----


class PipelineLlama(nn.Module):
    """stack_pipeline_params' model: ``embed``, ``final_norm`` and
    ``lm_head`` as a Llama's, and ``stages``, a LlamaLayer whose every
    parameter is stacked [stages, layers_per_stage, ...] (the JAX tree's
    "stages" leaves); a rank of a "pp" axis holds its own stage alone,
    [1, layers_per_stage, ...]."""

    def __init__(self, model: Llama, n_stages: int, stage: int | None):
        super().__init__()
        cfg = model.cfg
        layers = list(model.layers)
        if len(layers) % n_stages:
            raise ValueError(f"{len(layers)} layers do not split into {n_stages} stages")
        k = len(layers) // n_stages
        self.cfg, self.n_stages, self.layers_per_stage, self.stage = cfg, n_stages, k, stage
        for name in ("embed", "final_norm", "lm_head"):
            if hasattr(model, name):
                setattr(self, name, nn.Parameter(getattr(model, name).detach().clone()))
        kept = range(n_stages) if stage is None else [stage]
        names = [name for name, _ in layers[0].named_parameters()]
        with torch.no_grad():
            self.stages = LlamaLayer(cfg, "meta")
            per_stage = [{name: torch.stack([layer.get_parameter(name)
                                             for layer in layers[s * k:(s + 1) * k]])
                          for name in names} for s in kept]
            for name, t in stack_stage_params(per_stage).items():
                _set_param(self.stages, name, t.detach().clone())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def shardings(self) -> dict[str, tuple]:
        """The stacked layers split over "pp" by their leading axis; the
        embedding, final norm and head whole on every rank."""
        return {name: (("pp",) + (None,) * (p.dim() - 1) if name.startswith("stages.")
                       else (None,) * p.dim())
                for name, p in self.named_parameters()}


def stack_pipeline_params(model: Llama, n_stages: int, mesh=None) -> PipelineLlama:
    """Regroup a whole model for the pipeline: cfg.num_layers layers split
    into n_stages equal stages, each stage's layers stacked on a leading
    axis, the stages stacked on one before it (a copy of the weights).
    Under a mesh with a "pp" axis of n_stages ranks the rank keeps its own
    stage's block alone."""
    stage = None
    if mesh is not None and "pp" in mesh.axis_names:
        if mesh.size("pp") != n_stages:
            raise ValueError(f"{n_stages} stages over a pp axis of {mesh.size('pp')} ranks")
        stage = mesh.index("pp")
    return PipelineLlama(model, n_stages, stage)


class _StageLayer:
    """Layer i of a stage's parameters ({name: [layers_per_stage, ...]}),
    read as a LlamaLayer is: each attribute the named tensor's row i, a MoE
    layer's ``moe`` (and its ``shared``) a view of its own."""

    def __init__(self, params: dict[str, torch.Tensor], i: int, prefix: str = ""):
        self._params, self._i, self._prefix = params, i, prefix

    def __getattr__(self, name: str):
        key = self._prefix + name
        if key in self._params:
            return self._params[key][self._i]
        if any(k.startswith(key + ".") for k in self._params):
            return _StageLayer(self._params, self._i, key + ".")
        raise AttributeError(name)

    def routed(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in moe.ROUTED}


def pipeline_forward(model: PipelineLlama, tokens: torch.Tensor, mesh,
                     num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """Training forward with the layers pipelined over the mesh's "pp" axis
    (parallel/pipeline.py): tokens [B, S], the global batch on every rank
    -> float32 logits [B / data, S, vocab], this rank's batch rows (a
    "data" axis beside "pp" splits them; each rank's rows then split into
    num_microbatches microbatches). The embedding and the head run on every
    rank outside the pipeline; each stage applies its layers_per_stage
    layers (_attn_block: K1, and the backward kernels in the backward).
    `model` is stack_pipeline_params' under the same mesh.

    The logits are the same on every rank of "pp"; their gradient is taken
    on the last stage's rank alone, so a loss that every rank computes
    gives the embedding and the head one share each (reduce_gradients sums
    them over "pp")."""
    cfg = model.cfg
    if cfg.window_pattern is not None:
        raise ValueError("a per-layer window pattern needs global layer indices; a pipeline "
                         "stage sees its own (as the JAX function asserts)")
    other = [a for a in mesh.active() if a not in ("pp", "data")]
    if other or "pp" not in mesh.axis_names:
        raise ValueError(f"the pipeline takes a pp axis and a data axis, not {other}")
    if model.stage != mesh.index("pp"):
        raise ValueError("the model holds another rank's stages: build it with "
                         "stack_pipeline_params(model, n_stages, mesh) under this mesh")
    tokens = shard_rows(tokens, mesh)
    b, s = tokens.shape
    if b % num_microbatches:
        raise ValueError(f"{b} rows a rank do not split into {num_microbatches} microbatches")
    x = embed_tokens(model, tokens)
    cos, sin = input_tables(cfg, tokens)

    def stage_fn(stage: dict[str, torch.Tensor], x_mb: torch.Tensor) -> torch.Tensor:
        for i in range(model.layers_per_stage):
            x_mb = _layer(_StageLayer(stage, i), x_mb, cos, sin, cfg, cfg.attn_window, None)
        return x_mb

    stage = unstack_stage_params(dict(model.stages.named_parameters()))
    y = pipeline_apply(stage_fn, stage, x.view(num_microbatches, b // num_microbatches, s, -1),
                       mesh.group("pp"), remat=remat)
    logits = lm_logits(y.reshape(b, s, -1), model)
    n = mesh.size("pp")
    return keep_gradient(logits, mesh.index("pp") == n - 1) if n > 1 else logits


def pipeline_loss_fn(model: PipelineLlama, tokens: torch.Tensor, mesh,
                     num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, S+1] through
    pipeline_forward: every rank returns the global mean (each rank's sum
    over the global count, summed over "data")."""
    logits = pipeline_forward(model, tokens[:, :-1], mesh, num_microbatches, remat)
    targets = shard_rows(tokens[:, 1:].long(), mesh)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
    if mesh.size("data") == 1:
        return nll.mean()
    return _SumOverRanks.apply(nll.sum() / tokens[:, 1:].numel(), mesh, ("data",))
