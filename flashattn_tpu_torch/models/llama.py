"""Llama-style decoder (counterpart of flashattn_tpu/models/llama.py).

The parameters keep the JAX package's names and its [in, out] layout
(``x @ w``), so a JAX parameter tree converts with a plain copy
(models/convert.py). Attention runs the port's kernels; every other piece is
plain PyTorch. Models are built on the card unless the caller names another
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flashattn_tpu_torch.models.config import ModelConfig, check_supported
from flashattn_tpu_torch.ops.attention import flash_attention
from flashattn_tpu_torch.ops.common import card_device, unported
from flashattn_tpu_torch.ops.quant_matmul import (QuantizedLinear, quant_matmul,
                                                  quantize_weights)

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
        self.w_gate = param(h, f)
        self.w_up = param(h, f)
        self.w_down = param(f, h)


class Llama(nn.Module):
    """Parameters of the dense decoder: ``embed``, ``final_norm``,
    ``lm_head`` (untied configs) and ``layers.{i}.{wq, wk, ...}``.

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
        dense(layer.wq, h)
        dense(layer.wk, h)
        dense(layer.wv, h)
        dense(layer.wo, cfg.num_heads * cfg.head_dim)
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
    embedding and the norms stay in the compute dtype. Returns `model`."""
    def swap(module: nn.Module, name: str) -> None:
        qw = quantize_weights(getattr(module, name), bits)
        delattr(module, name)  # a parameter slot takes no module
        setattr(module, name, qw)

    if not model.cfg.tie_embeddings:
        swap(model, "lm_head")
    for layer in model.layers:
        for key in _QUANT_KEYS:
            swap(layer, key)
    return model


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if offset:
        return ((offset + w.float()) * normed).to(x.dtype)
    return normed.to(x.dtype) * w


def embed_tokens(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = F.embedding(tokens, model.embed)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    return x


def lm_logits(x: torch.Tensor, model: Llama) -> torch.Tensor:
    """Final norm -> head -> optional final soft-cap; float32 logits.

    A plain head's product runs in the model's dtype and is cast afterwards,
    so bf16 models carry bf16-rounded logits; a quantized head writes f32
    logits, as the JAX package's does."""
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.norm_eps, cfg.norm_offset)
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    if isinstance(head, QuantizedLinear):  # f32 straight from the accumulator
        logits = proj(x, head, out_dtype=torch.float32)
    else:
        logits = proj(x, head).float()
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """positions [..., S] -> (cos, sin) [..., S, head_dim/2] float32."""
    half = cfg.head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    # A fill, not a copy from the host: a CUDA graph can capture it.
    theta = torch.full((), cfg.rope_theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(theta, exponent)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


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


def _mlp_block(layer: LlamaLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xn = rms_norm(x, layer.mlp_norm, cfg.norm_eps, cfg.norm_offset)
    gate = proj(xn, layer.w_gate).float()
    act = (F.gelu(gate, approximate="tanh") if cfg.mlp_activation == "gelu_tanh"
           else F.silu(gate))
    return proj(act.to(x.dtype) * proj(xn, layer.w_up), layer.w_down)


def qkv(layer: LlamaLayer, xn: torch.Tensor, cfg: ModelConfig):
    """Projections of xn [B, S, H] -> q [B, Hq, S, D], k/v [B, Hkv, S, D]
    (before RoPE); v is made contiguous for the kernels."""
    b, s = xn.shape[:2]
    q = proj(xn, layer.wq).view(b, s, cfg.num_heads, cfg.head_dim)
    k = proj(xn, layer.wk).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = proj(xn, layer.wv).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2).contiguous()


def _attn_block(layer: LlamaLayer, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    xn = rms_norm(x, layer.attn_norm, cfg.norm_eps, cfg.norm_offset)
    q, k, v = qkv(layer, xn, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, is_causal=True, scale=cfg.attn_scale)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return proj(o, layer.wo)


def forward(model: Llama, tokens: torch.Tensor, segment_ids=None,
            remat=False) -> torch.Tensor:
    """Training/prefill forward: tokens [B, S] -> float32 logits [B, S, vocab].

    Differentiable: attention goes through the flash autograd Function, whose
    backward runs the backward kernels. Packed documents (`segment_ids`) and
    rematerialisation (`remat`) are not ported yet and raise."""
    if segment_ids is not None:
        raise unported("packed-document segment_ids", "A4")
    if remat is not False:
        raise unported(f"remat={remat!r}", "A3b")
    cfg = model.cfg
    x = embed_tokens(model, tokens)
    cos, sin = rope_tables(cfg, torch.arange(tokens.shape[1], device=tokens.device))
    for layer in model.layers:
        x = x + _attn_block(layer, x, cos, sin, cfg)
        x = x + _mlp_block(layer, x, cfg)
    return lm_logits(x, model)


def loss_fn(model: Llama, tokens: torch.Tensor, segment_ids=None,
            remat=False) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens[:, :-1] -> tokens[:, 1:]
    (tokens [B, S+1]), a float32 scalar."""
    if segment_ids is not None:
        raise unported("packed-document segment_ids", "A4")
    logits = forward(model, tokens[:, :-1], remat=remat)
    targets = tokens[:, 1:].long()
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def sgd_train_step(model: Llama, tokens: torch.Tensor, lr: float = 1e-3,
                   remat=False) -> tuple[torch.Tensor, Llama]:
    """Loss, gradients and a plain SGD update -> (loss, model).

    The JAX function returns new parameters; this one updates the model in
    place (p -= lr * g in the parameters' dtype) and returns it."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, remat=remat)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad.to(p.dtype))
            p.grad = None
    return loss.detach(), model
