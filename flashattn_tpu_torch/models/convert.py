"""JAX parameter tree -> state dict of models/llama.py::Llama.

Both packages keep projections in [in, out] layout under the same names, so
the conversion is a plain copy: no transposes, no renames beyond flattening
``layers[i][name]`` into ``layers.{i}.{name}`` (Gemma-2's ``post_attn_norm``
and ``post_mlp_norm`` included). Weight-only quantized projections keep
their bytes too (int8, or the packed int4 layout).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree of numpy arrays into a state dict.

    Load the result with ``Llama(cfg).load_state_dict(state_dict)``; the
    tensors keep the arrays' dtypes (convert with ``np.asarray`` first when
    the tree holds JAX arrays)."""
    state_dict: dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        if name == "layers":
            for i, layer in enumerate(value):
                for key, leaf in layer.items():
                    _put(state_dict, f"layers.{i}.{key}", leaf)
        else:
            _put(state_dict, name, value)
    return state_dict


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
