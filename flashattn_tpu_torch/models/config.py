"""Model configs (counterpart of flashattn_tpu/models/config.py).

``ModelConfig`` keeps every field of the JAX config so that a config moves
between the packages unchanged; ``dtype`` is a torch dtype. The port runs
the Llama path with sliding windows (per layer with
``window_pattern="alternate"``), attention sinks, the attention logit
soft-cap, Gemma-2's post-norms, Qwen3's q/k RMSNorm, Qwen2's q/k/v biases,
the llama3 and longrope RoPE variants and the mixture-of-experts FFN on one
device (``num_experts``, ``top_k_experts``, ``moe_norm_topk``,
``moe_shared_intermediate``; ``moe_dispatch`` and ``moe_capacity_factor``
choose a dispatcher over an ``ep`` mesh only, as in the JAX package, and
keep their defaults here) and ALiBi (``use_alibi``: RoPE off, the standard
slopes' bias in the prefill, decode and backward kernels, packed rows
too); ``check_supported`` rejects a value it does not know.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    max_seq_len: int = 4096
    attn_window: int | None = None
    num_experts: int = 0
    top_k_experts: int = 2
    moe_dispatch: str = "a2a"
    moe_capacity_factor: float = 2.0
    moe_norm_topk: bool = True
    moe_shared_intermediate: int = 0
    logit_softcap: float | None = None
    use_alibi: bool = False
    attn_sink: int = 0
    attn_bias: bool = False
    window_pattern: str | None = None
    final_logit_softcap: float | None = None
    mlp_activation: str = "silu"  # or "gelu_tanh"
    use_post_norms: bool = False
    scale_embeddings: bool = False
    attn_scale: float | None = None
    norm_offset: float = 0.0
    qk_norm: bool = False
    rope_scaling: tuple[float, float, float, int] | None = None
    rope_longrope: tuple | None = None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a config value the port does not know."""
    if cfg.window_pattern not in (None, "alternate"):
        raise ValueError(f"unknown window_pattern {cfg.window_pattern!r}")
    if cfg.mlp_activation not in ("silu", "gelu_tanh"):
        raise ValueError(f"unknown mlp_activation {cfg.mlp_activation!r}")


# TinyLlama-1.1B-like geometry, the serving path's model.
LLAMA_1B = ModelConfig()

# ~150M draft-model geometry (same vocab family as LLAMA_1B).
LLAMA_150M = ModelConfig(
    hidden_size=1024,
    intermediate_size=2816,
    num_layers=8,
    num_heads=16,
    num_kv_heads=4,
    head_dim=64,
)

# Mistral-7B geometry: GQA + 4096-token sliding-window attention.
MISTRAL_7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    max_seq_len=8192,
    attn_window=4096,
)

# Llama-3-8B geometry (the JAX package's BASELINE config 5, "8B decode").
LLAMA_8B = ModelConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    max_seq_len=8192,
)

# Llama-3.1-8B: the same geometry; the llama3 RoPE remap unlocks 128k context.
LLAMA31_8B = dataclasses.replace(
    LLAMA_8B,
    rope_scaling=(8.0, 1.0, 4.0, 8192),
    max_seq_len=131072,
)

# Gemma-2-9B geometry: alternating 4096-token local / global attention,
# sandwich norms, GeGLU, attn+final soft-caps, scaled tied embeddings
# (flashattn_tpu/models/config.py GEMMA2_9B, field for field).
GEMMA2_9B = ModelConfig(
    vocab_size=256128,
    hidden_size=3584,
    intermediate_size=14336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    rope_theta=10000.0,
    norm_eps=1e-6,
    max_seq_len=8192,
    tie_embeddings=True,
    attn_window=4096,
    window_pattern="alternate",
    logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu_tanh",
    use_post_norms=True,
    scale_embeddings=True,
    attn_scale=256**-0.5,  # query_pre_attn_scalar = head_dim
    norm_offset=1.0,
)

# Qwen3-8B geometry: per-head q/k RMSNorm, explicit head_dim.
QWEN3_8B = ModelConfig(
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    max_seq_len=32768,
    qk_norm=True,
)

# Tiny config for tests.
TINY = ModelConfig(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    max_seq_len=512,
)

# Tiny Mixtral-style MoE config for tests (the JAX package's TINY_MOE).
TINY_MOE = ModelConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    max_seq_len=256,
    num_experts=4,
    top_k_experts=2,
    moe_capacity_factor=8.0,  # the JAX preset's; read only by a dispatcher over an ep mesh
)
