"""Checkpoints -> state dict of models/llama.py::Llama.

  - ``params_from_jax``: a JAX parameter tree. Both packages keep
    projections in [in, out] layout under the same names, so the conversion
    is a plain copy: no transposes, no renames beyond flattening
    ``layers[i][name]`` into ``layers.{i}.{name}`` (Gemma-2's
    ``post_attn_norm`` and ``post_mlp_norm`` included; a MoE layer's nested
    ``moe`` tree into ``layers.{i}.moe.{router, ..., shared.w_gate}``).
    Weight-only quantized projections keep their bytes too (int8, or the
    packed int4 layout).
  - ``config_from_hf`` and ``params_from_hf``: a Hugging Face Llama-family
    checkpoint (Llama, Llama-3.1's llama3 RoPE, Mistral, Qwen2's biases,
    Qwen3's q/k norm, Phi-3's fused projections and longrope, Gemma,
    Gemma-2, and the mixture-of-experts families Mixtral, Qwen3-MoE and
    Qwen2-MoE with its shared expert), as the JAX package's
    models/convert.py maps it: HF stores a projection as [out, in], so
    every one transposes; HF's RoPE is the same rotate-half convention; HF
    keeps one entry an expert and projection, and the port stacks them on
    axis 0, each copied into its slice of a tensor made at the layer's
    first entry of that projection. The config comes from a transformers
    config object or from the plain dict of a ``config.json``.
  - ``load_hf_dir``: a checkpoint directory (``config.json`` and single or
    sharded ``*.safetensors``, or ``pytorch_model*.bin``) read with neither
    transformers nor safetensors installed, one tensor at a time, so the
    host never holds a second copy of the weights (nor a stacked copy of
    the experts: each entry goes to the device, into its slice).
  - The command line writes the port's checkpoint (``model.pt``, a
    ``torch.save`` of the state dict, and ``config.json``), which
    ``load_converted`` reads back:

        python -m flashattn_tpu_torch.models.convert --src HF_DIR --dst OUT_DIR

    It converts to bf16, the dtype the port serves in.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import mmap
import re
import struct
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from flashattn_tpu_torch.models.config import ModelConfig
from flashattn_tpu_torch.models.llama import Llama

def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree of numpy arrays into a state dict.

    Load the result with ``Llama(cfg).load_state_dict(state_dict)``; the
    tensors keep the arrays' dtypes (convert with ``np.asarray`` first when
    the tree holds JAX arrays)."""
    state_dict: dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "layers":
            for i, layer in enumerate(value):
                _put_tree(state_dict, f"layers.{i}.", layer)
        else:
            _put(state_dict, name, value)
    return state_dict


def _put_tree(state_dict: dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    """Every leaf of a (nested: a MoE layer's ``moe``) dict under `prefix`."""
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            _put_tree(state_dict, f"{prefix}{key}.", leaf)
        else:
            _put(state_dict, prefix + key, leaf)


def _put(state_dict: dict[str, torch.Tensor], name: str, leaf) -> None:
    """A plain array, or a weight-only quantized projection: an object with
    the fields ``w``, ``scale``, ``bits`` and ``k`` (the JAX package's
    QuantizedLinear), whose bytes become ``<name>.w`` and ``<name>.scale``
    of a model quantized with llama.quantize_params at the same bits."""
    if all(hasattr(leaf, f) for f in ("w", "scale", "bits", "k")):
        state_dict[f"{name}.w"] = _tensor(leaf.w)
        state_dict[f"{name}.scale"] = _tensor(leaf.scale)
    else:
        state_dict[name] = _tensor(leaf)


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: go through f32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


# ---------------- Hugging Face checkpoints ----------------


def _field(hf_config, name: str, default=None):
    """A field of a transformers config object or of a config.json dict."""
    if isinstance(hf_config, Mapping):
        return hf_config.get(name, default)
    return getattr(hf_config, name, default)


def config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    """Map a transformers config (object, or the dict of its config.json)
    onto ModelConfig. Llama conventions by default; Gemma and Gemma-2
    (offset norms, GeGLU, scaled embeddings; Gemma-2's alternating window,
    soft-caps, post-norms and query_pre_attn_scalar), Qwen2 (q/k/v biases),
    Qwen3 (per-head q/k RMSNorm, explicit head_dim), llama3 and longrope
    RoPE detected from model_type and rope_scaling. A config.json leaves
    out what equals transformers' base defaults, so a field missing from a
    dict takes that default (tie_word_embeddings: True). Mixture-of-experts
    families map as in the JAX package, every layer a MoE layer (a config
    with dense layers among them raises), with one difference: the Qwen MoE
    families' intermediate_size is their expert width,
    ``moe_intermediate_size``, where the JAX function keeps HF's
    ``intermediate_size`` (Qwen3-30B-A3B: 768, not 6144). The JAX forward
    takes the experts' shapes from the weights; the port's model allocates
    them from the config (ROADMAP §C). Mixtral's intermediate_size is
    already its expert width."""
    def get(name, default=None):
        return _field(hf_config, name, default)

    mt = get("model_type", "")
    extra: dict[str, Any] = {}
    if mt == "gemma":
        extra = dict(mlp_activation="gelu_tanh", scale_embeddings=True, norm_offset=1.0)
    if mt == "gemma2":
        extra = dict(
            window_pattern="alternate",  # HF layer_types: even layers slide
            logit_softcap=get("attn_logit_softcapping"),
            final_logit_softcap=get("final_logit_softcapping"),
            mlp_activation="gelu_tanh",
            use_post_norms=True,
            scale_embeddings=True,
            attn_scale=get("query_pre_attn_scalar") ** -0.5,
            norm_offset=1.0,
        )
    if mt == "qwen3":
        extra = dict(qk_norm=True)
    if mt == "mixtral":
        extra = dict(num_experts=get("num_local_experts"),
                     top_k_experts=get("num_experts_per_tok"))
    intermediate = get("intermediate_size")
    if mt in ("qwen3_moe", "qwen2_moe"):
        if get("decoder_sparse_step", 1) != 1 or get("mlp_only_layers"):
            raise NotImplementedError(
                f"{mt}: dense MLP layers among the MoE layers (decoder_sparse_step "
                f"{get('decoder_sparse_step', 1)}, mlp_only_layers {get('mlp_only_layers')}) "
                "are not supported, as in the JAX package")
        extra = dict(num_experts=get("num_experts"), top_k_experts=get("num_experts_per_tok"),
                     moe_norm_topk=bool(get("norm_topk_prob")))
        intermediate = get("moe_intermediate_size")
        if mt == "qwen3_moe":
            extra["qk_norm"] = True
        else:
            extra["moe_shared_intermediate"] = int(get("shared_expert_intermediate_size"))
    rs = get("rope_scaling")
    rs_type = rs.get("rope_type", rs.get("type")) if rs else None
    if rs_type == "llama3":
        extra["rope_scaling"] = (float(rs["factor"]), float(rs["low_freq_factor"]),
                                 float(rs["high_freq_factor"]),
                                 int(rs["original_max_position_embeddings"]))
    elif rs_type in ("longrope", "su"):
        # transformers' _compute_longrope_parameters: the default attention
        # factor is sqrt(1 + ln(factor) / ln(original)).
        orig = int(get("original_max_position_embeddings", None)
                   or get("max_position_embeddings"))
        factor = get("max_position_embeddings") / orig
        attn_factor = rs.get("attention_factor")
        if attn_factor is None:
            attn_factor = (1.0 if factor <= 1.0
                           else math.sqrt(1.0 + math.log(factor) / math.log(orig)))
        extra["rope_longrope"] = (tuple(float(f) for f in rs["short_factor"]),
                                  tuple(float(f) for f in rs["long_factor"]),
                                  orig, float(attn_factor))
    elif rs_type not in (None, "default"):
        raise NotImplementedError(
            f"rope_scaling type {rs!r} not supported (llama3/longrope only)")
    heads = get("num_attention_heads")
    return ModelConfig(
        **extra,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=intermediate,
        num_layers=get("num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads") or heads,
        # Gemma/Qwen3-style configs carry a head_dim that need not equal
        # hidden_size // num_heads.
        head_dim=get("head_dim") or get("hidden_size") // heads,
        rope_theta=get("rope_theta", 10000.0),
        norm_eps=get("rms_norm_eps"),
        dtype=dtype,
        tie_embeddings=bool(get("tie_word_embeddings", True)),
        max_seq_len=get("max_position_embeddings"),
        # Mistral/Gemma-style sliding window when present and enabled.
        attn_window=get("sliding_window") if get("use_sliding_window", True) else None,
        # Llama exposes attention_bias; the Qwen2 family has q/k/v biases.
        attn_bias=bool(get("attention_bias", False) or mt in ("qwen2", "qwen2_moe")),
    )


_LAYER_KEY = re.compile(r"model\.layers\.(\d+)\.(.+)")
# One expert's projection: Mixtral's block_sparse_moe.experts.j.w1/w3/w2, the
# Qwen MoE families' mlp.experts.j.gate_proj/up_proj/down_proj.
_EXPERT_KEY = re.compile(r"(?:block_sparse_moe|mlp)\.experts\.(\d+)\.(\w+)\.weight")
_EXPERT_PROJ = {"w1": "w_gate", "w3": "w_up", "w2": "w_down", "gate_proj": "w_gate",
                "up_proj": "w_up", "down_proj": "w_down"}
_LINEAR = {  # HF [out, in] weights -> the port's [in, out] parameters
    "self_attn.q_proj.weight": "wq", "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv", "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate", "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
}
_VECTOR = {  # as they are
    "input_layernorm.weight": "attn_norm", "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.bias": "bk", "self_attn.v_proj.bias": "bv",
    "self_attn.q_norm.weight": "q_norm", "self_attn.k_norm.weight": "k_norm",
    # Gemma-2 (use_post_norms) names its pre-MLP norm pre_feedforward_layernorm;
    # its post_attention_layernorm is the attention output's norm.
    "pre_feedforward_layernorm.weight": "mlp_norm",
    "post_feedforward_layernorm.weight": "post_mlp_norm",
}
_MOE_LINEAR = {  # the router and Qwen2-MoE's shared expert, [out, in] -> [in, out]
    "block_sparse_moe.gate.weight": "moe.router", "mlp.gate.weight": "moe.router",
    "mlp.shared_expert.gate_proj.weight": "moe.shared.w_gate",
    "mlp.shared_expert.up_proj.weight": "moe.shared.w_up",
    "mlp.shared_expert.down_proj.weight": "moe.shared.w_down",
    "mlp.shared_expert_gate.weight": "moe.shared_gate",  # [1, H] -> [H, 1]
}


def _hf_entries(name: str, tensor: torch.Tensor, cfg: ModelConfig
               ) -> list[tuple[str, torch.Tensor, int | None]]:
    """The port's (name, view, slot) triples of one HF checkpoint entry, the
    views of `tensor`: [out, in] weights transposed, Phi-3's fused qkv_proj
    and gate_up_proj split; an expert's projection names its stacked
    tensor and its slot (the expert's index), every other entry slot None;
    none for an entry the port keeps no copy of (a tied head, RoPE's
    inv_freq buffers). Raises for an entry with no place in the model."""
    if name == "model.embed_tokens.weight":
        return [("embed", tensor, None)]
    if name == "model.norm.weight":
        return [("final_norm", tensor, None)]
    if name == "lm_head.weight":
        return [] if cfg.tie_embeddings else [("lm_head", tensor.t(), None)]
    m = _LAYER_KEY.fullmatch(name)
    key = m.group(2) if m else ""
    if key.endswith("rotary_emb.inv_freq"):
        return []
    p = f"layers.{m.group(1)}." if m else ""
    expert = _EXPERT_KEY.fullmatch(key)
    if cfg.num_experts and expert and expert.group(2) in _EXPERT_PROJ \
            and int(expert.group(1)) < cfg.num_experts:
        return [(p + "moe." + _EXPERT_PROJ[expert.group(2)], tensor.t(), int(expert.group(1)))]
    if cfg.num_experts and key in _MOE_LINEAR:
        return [(p + _MOE_LINEAR[key], tensor.t(), None)]
    if key in _LINEAR:
        return [(p + _LINEAR[key], tensor.t(), None)]
    if key == "post_attention_layernorm.weight":
        return [(p + ("post_attn_norm" if cfg.use_post_norms else "mlp_norm"), tensor, None)]
    if key in _VECTOR:
        return [(p + _VECTOR[key], tensor, None)]
    if key == "self_attn.qkv_proj.weight":  # Phi-3: [q; k; v] rows
        nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        return [(p + "wq", tensor[:nq].t(), None), (p + "wk", tensor[nq:nq + nkv].t(), None),
                (p + "wv", tensor[nq + nkv:].t(), None)]
    if key == "mlp.gate_up_proj.weight":  # Phi-3: [gate; up] rows
        half = tensor.shape[0] // 2
        return [(p + "w_gate", tensor[:half].t(), None), (p + "w_up", tensor[half:].t(), None)]
    raise ValueError(f"checkpoint entry {name!r} has no place in the port's Llama model")


def _copy(view: torch.Tensor, dtype: torch.dtype, device=None) -> torch.Tensor:
    """A contiguous copy of `view` in `dtype` on `device` (the view's if None)."""
    out = torch.empty(view.shape, dtype=dtype, device=view.device if device is None else device)
    return out.copy_(view)


class _StateDict:
    """A state dict of Llama(cfg) in cfg.dtype, built from _hf_entries'
    triples on the views' device: a whole tensor copied, or an expert's
    projection copied into its slot of the stacked [num_experts, ...]
    tensor, made at the first entry that names it."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.out: dict[str, torch.Tensor] = {}
        self.slots: dict[str, set[int]] = {}

    def put(self, key: str, view: torch.Tensor, slot: int | None) -> None:
        if slot is None:
            self.out[key] = _copy(view, self.cfg.dtype)
            return
        if key not in self.out:
            self.out[key] = torch.empty((self.cfg.num_experts, *view.shape),
                                        dtype=self.cfg.dtype, device=view.device)
            self.slots[key] = set()
        self.out[key][slot].copy_(view)
        self.slots[key].add(slot)

    def result(self) -> dict[str, torch.Tensor]:
        """The state dict; raises where a stacked tensor lacks an expert."""
        for key, slots in self.slots.items():
            if len(slots) != self.cfg.num_experts:
                missing = sorted(set(range(self.cfg.num_experts)) - slots)
                raise ValueError(f"the checkpoint lacks experts {missing} of {key}")
        return self.out


def params_from_hf(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig
                   ) -> dict[str, torch.Tensor]:
    """An HF Llama-family state dict -> a state dict of Llama(cfg), in
    cfg.dtype on the tensors' device: weights transposed, fused
    projections split, experts stacked, Gemma-2's norm names followed,
    q_norm/k_norm and the biases carried, a tied head dropped. New
    tensors: the input is not changed and shares no memory with the
    result."""
    out = _StateDict(cfg)
    for name, tensor in state_dict.items():
        for key, view, slot in _hf_entries(name, tensor, cfg):
            out.put(key, view, slot)
    return out.result()


def llama_from_state_dict(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor]) -> Llama:
    """A Llama whose parameters ARE the state dict's tensors (assigned, no
    copy; the model lives where they do). Every parameter must be there."""
    model = Llama(cfg, device="meta")
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model


_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


def read_safetensors(path: str | Path) -> Iterator[tuple[str, torch.Tensor]]:
    """The (name, tensor) entries of one .safetensors file, each a view of
    the file mapped copy-on-write (pages read when touched): an 8-byte
    little-endian header length, a JSON header of dtype, shape and byte
    offsets, then the raw little-endian bytes. BF16, F16 and F32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        size = dtype.itemsize
        flat = (torch.frombuffer(buf, dtype=dtype, count=(end - start) // size,
                                 offset=8 + n + start)
                if end > start else torch.empty(0, dtype=dtype))
        yield name, flat.view(info["shape"])


def _shards(path: Path, single: str, index: str, pattern: str) -> list[Path]:
    if (path / index).exists():
        weight_map = json.loads((path / index).read_text())["weight_map"]
        return [path / f for f in sorted(set(weight_map.values()))]
    if (path / single).exists():
        return [path / single]
    return sorted(path.glob(pattern))


def read_hf_tensors(path: str | Path) -> Iterator[tuple[str, torch.Tensor]]:
    """Every (name, tensor) of a checkpoint directory's weights, one file at
    a time: ``model.safetensors`` or the shards named by
    ``model.safetensors.index.json`` (else any ``*.safetensors``), or
    failing those ``pytorch_model.bin`` and its shards
    (``torch.load(weights_only=True)``, memory-mapped)."""
    path = Path(path)
    files = _shards(path, "model.safetensors", "model.safetensors.index.json",
                    "*.safetensors")
    if files:
        for f in files:
            yield from read_safetensors(f)
        return
    files = _shards(path, "pytorch_model.bin", "pytorch_model.bin.index.json",
                    "pytorch_model*.bin")
    if not files:
        raise FileNotFoundError(f"{path}: no *.safetensors or pytorch_model*.bin weights")
    for f in files:
        yield from torch.load(f, map_location="cpu", weights_only=True, mmap=True).items()


def load_hf_dir(path: str | Path, dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cuda") -> tuple[Llama, ModelConfig]:
    """A Hugging Face checkpoint directory -> (Llama on `device`, its config),
    with neither transformers nor safetensors: ``config.json`` through
    config_from_hf, the weights through read_hf_tensors and _hf_entries,
    tensor by tensor (each one copied to the device, then transposed, split
    or copied into its expert's slot there and cast to `dtype`), so the host
    holds one tensor at a time beside the mapped files."""
    path = Path(path)
    cfg = config_from_hf(json.loads((path / "config.json").read_text()), dtype)
    device = torch.device(device)
    params = _StateDict(cfg)
    for name, tensor in read_hf_tensors(path):
        if not _hf_entries(name, tensor, cfg):  # kept nowhere: not copied
            continue
        raw = tensor.to(device)  # as stored; transposed, split or stacked on the device
        for key, view, slot in _hf_entries(name, raw, cfg):
            params.put(key, view, slot)
    return llama_from_state_dict(cfg, params.result()), cfg


# ---------------- the port's converted checkpoints ----------------


def save_converted(model: Llama, dst: str | Path) -> None:
    """``dst/model.pt`` (torch.save of the state dict) and ``dst/config.json``
    (the ModelConfig's fields, dtype by its torch name: "bfloat16")."""
    out = Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), out / "model.pt")
    fields = dataclasses.asdict(model.cfg)
    fields["dtype"] = str(model.cfg.dtype).removeprefix("torch.")
    (out / "config.json").write_text(json.dumps(fields, indent=1))


def load_config(dst: str | Path) -> ModelConfig:
    """A converted checkpoint's config.json -> ModelConfig. JSON turns tuples
    into lists; they come back as (nested) tuples, so the config stays
    hashable and equal to the one converted (rope_scaling, rope_longrope)."""
    fields = json.loads((Path(dst) / "config.json").read_text())
    fields["dtype"] = getattr(torch, fields["dtype"])

    def tuplify(x):
        return tuple(tuplify(e) for e in x) if isinstance(x, list) else x

    return ModelConfig(**{k: tuplify(v) for k, v in fields.items()})


def load_converted(dst: str | Path, device: torch.device | str = "cuda"
                   ) -> tuple[Llama, ModelConfig]:
    """A converted checkpoint -> (Llama on `device`, its config)."""
    cfg = load_config(dst)
    state = torch.load(Path(dst) / "model.pt", map_location="cpu", weights_only=True,
                       mmap=True)
    params = {k: v.to(device=device, copy=True) for k, v in state.items()}
    return llama_from_state_dict(cfg, params), cfg


def convert(src: str | Path, dst: str | Path) -> ModelConfig:
    """An HF checkpoint directory -> the port's bf16 checkpoint in `dst`, on
    the host (load_hf_dir on the CPU, then save_converted)."""
    model, cfg = load_hf_dir(src, torch.bfloat16, device="cpu")
    save_converted(model, dst)
    return cfg


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="Hugging Face checkpoint directory")
    ap.add_argument("--dst", required=True, help="output directory")
    args = ap.parse_args(argv)
    cfg = convert(args.src, args.dst)
    print(f"converted {args.src} -> {args.dst}: {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, bf16")


if __name__ == "__main__":
    main()
