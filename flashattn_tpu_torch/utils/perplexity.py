"""Perplexity through the decode path: the quality gate of the JAX
package's tests/test_quant_ppl.py (BASELINE.json's north star: FP8-KV
decode within 0.1 ppl of bf16) as functions of the port.

``decode_ppl`` teacher-forces a batch of sequences through the serving
path: ``generate.prefill`` on the first token, then one
``generate.decode_step`` a token, on a dense KV cache of the model's dtype
or quantized ("int8", "fp8"), and returns exp of the mean next-token NLL.
``train_ppl`` is exp of the training loss (``llama.loss_fn``) on the same
tokens, the number the decode path must reproduce. On CUDA tensors the
model's kernels run (K1 in the prefill, K2 in each step, qmm8/qmm4 for
quantized weights); on CPU tensors their plain versions.
"""

from __future__ import annotations

import math

import torch

from flashattn_tpu_torch.models import generate, llama
from flashattn_tpu_torch.models.llama import Llama


@torch.inference_mode()
def decode_ppl(model: Llama, tokens: torch.Tensor, quant: str | None = None,
               max_len: int = 128) -> float:
    """exp(mean NLL) of tokens[:, 1:] given their prefixes, through prefill
    (tokens[:, :1]) and tokens.shape[1] - 2 decode steps on caches of
    `max_len` positions (quantized by `quant`). tokens [B, S + 1] int on the
    model's device. The NLL is summed in float64 on the device, one host
    read at the end."""
    b, s1 = tokens.shape
    caches = generate.init_caches(model, b, max_len, quant=quant)
    logits, caches = generate.prefill(model, tokens[:, :1], caches)
    nll = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for t in range(1, s1):
        target = tokens[:, t]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll -= logp.gather(-1, target[:, None].long()).double().sum()
        if t < s1 - 1:
            positions = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
            logits, caches = generate.decode_step(model, target, positions, caches)
    return math.exp(float(nll) / (b * (s1 - 1)))


@torch.no_grad()
def train_ppl(model: Llama, tokens: torch.Tensor) -> float:
    """exp of the training loss (llama.loss_fn: the mean next-token NLL of
    tokens [B, S + 1]) through the training forward."""
    return math.exp(float(llama.loss_fn(model, tokens)))
