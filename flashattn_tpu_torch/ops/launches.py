"""Every kernel wrapper's launch counter, read and advanced together, and
the CUDA-graph capture that keeps them true.

A wrapper adds one to its module's counter when it launches its kernel. A
call captured into a CUDA graph runs the wrapper but launches nothing: the
kernel runs at each replay. So ``capture`` takes the capture's counts back
and the code that replays the graph adds them again at every replay
(``advance``); the counters then keep counting launches on the card.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

import torch

# Counter name -> (module, attribute). A launch with a sliding window counts
# in its kernel's counter and in the matching "_window" one, a launch with
# segment ids in the matching "_segments" one, a launch with a logit
# soft-cap in the matching "_softcap" one, a launch with ALiBi in the
# matching "_alibi" one (and a K1 launch with ALiBi and segment ids in
# "flash_fwd_alibi_segments"), a launch with attention dropout in the
# matching "_dropout" one, a launch that reads its q/k alignment on the card
# (dyn_pos_offset) in the matching "_dynoff" one, a K2 launch that writes the
# LSE in "decode_lse", a qmm8/qmm4 launch in the a8 mode in the matching
# "_a8" one.
COUNTERS = {
    "flash_fwd": ("flashattn_tpu_torch.ops.flash_fwd", "LAUNCHES"),
    "flash_fwd_window": ("flashattn_tpu_torch.ops.flash_fwd", "WINDOW_LAUNCHES"),
    "flash_fwd_segments": ("flashattn_tpu_torch.ops.flash_fwd", "SEGMENT_LAUNCHES"),
    "flash_fwd_softcap": ("flashattn_tpu_torch.ops.flash_fwd", "SOFTCAP_LAUNCHES"),
    "flash_fwd_alibi": ("flashattn_tpu_torch.ops.flash_fwd", "ALIBI_LAUNCHES"),
    "flash_fwd_alibi_segments": ("flashattn_tpu_torch.ops.flash_fwd", "ALIBI_SEGMENT_LAUNCHES"),
    "flash_fwd_dropout": ("flashattn_tpu_torch.ops.flash_fwd", "DROPOUT_LAUNCHES"),
    "flash_fwd_dynoff": ("flashattn_tpu_torch.ops.flash_fwd", "DYNOFF_LAUNCHES"),
    "decode": ("flashattn_tpu_torch.ops.decode", "LAUNCHES"),
    "decode_window": ("flashattn_tpu_torch.ops.decode", "WINDOW_LAUNCHES"),
    "decode_softcap": ("flashattn_tpu_torch.ops.decode", "SOFTCAP_LAUNCHES"),
    "decode_alibi": ("flashattn_tpu_torch.ops.decode", "ALIBI_LAUNCHES"),
    "decode_lse": ("flashattn_tpu_torch.ops.decode", "LSE_LAUNCHES"),
    "decode_int8": ("flashattn_tpu_torch.ops.decode", "INT8_LAUNCHES"),
    "decode_fp8": ("flashattn_tpu_torch.ops.decode", "FP8_LAUNCHES"),
    "paged_decode": ("flashattn_tpu_torch.ops.paged", "LAUNCHES"),
    "paged_decode_window": ("flashattn_tpu_torch.ops.paged", "WINDOW_LAUNCHES"),
    "paged_decode_softcap": ("flashattn_tpu_torch.ops.paged", "SOFTCAP_LAUNCHES"),
    "paged_decode_alibi": ("flashattn_tpu_torch.ops.paged", "ALIBI_LAUNCHES"),
    "qmm8": ("flashattn_tpu_torch.ops.quant_matmul", "QMM8_LAUNCHES"),
    "qmm4": ("flashattn_tpu_torch.ops.quant_matmul", "QMM4_LAUNCHES"),
    "qmm8_a8": ("flashattn_tpu_torch.ops.quant_matmul", "QMM8_A8_LAUNCHES"),
    "qmm4_a8": ("flashattn_tpu_torch.ops.quant_matmul", "QMM4_A8_LAUNCHES"),
    "quantize_rows": ("flashattn_tpu_torch.ops.quant_matmul", "QUANTIZE_ROWS_LAUNCHES"),
    "flash_bwd_fused": ("flashattn_tpu_torch.ops.flash_bwd_fused", "LAUNCHES"),
    "flash_bwd_fused_window": ("flashattn_tpu_torch.ops.flash_bwd_fused", "WINDOW_LAUNCHES"),
    "flash_bwd_fused_segments": ("flashattn_tpu_torch.ops.flash_bwd_fused", "SEGMENT_LAUNCHES"),
    "flash_bwd_fused_softcap": ("flashattn_tpu_torch.ops.flash_bwd_fused", "SOFTCAP_LAUNCHES"),
    "flash_bwd_fused_alibi": ("flashattn_tpu_torch.ops.flash_bwd_fused", "ALIBI_LAUNCHES"),
    "flash_bwd_fused_dropout": ("flashattn_tpu_torch.ops.flash_bwd_fused", "DROPOUT_LAUNCHES"),
    "flash_bwd_fused_dynoff": ("flashattn_tpu_torch.ops.flash_bwd_fused", "DYNOFF_LAUNCHES"),
    "flash_bwd_dq": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_LAUNCHES"),
    "flash_bwd_dq_window": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_WINDOW_LAUNCHES"),
    "flash_bwd_dq_segments": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_SEGMENT_LAUNCHES"),
    "flash_bwd_dq_softcap": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_SOFTCAP_LAUNCHES"),
    "flash_bwd_dq_alibi": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_ALIBI_LAUNCHES"),
    "flash_bwd_dq_dropout": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_DROPOUT_LAUNCHES"),
    "flash_bwd_dq_dynoff": ("flashattn_tpu_torch.ops.flash_bwd", "DQ_DYNOFF_LAUNCHES"),
    "flash_bwd_dkv": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_LAUNCHES"),
    "flash_bwd_dkv_window": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_WINDOW_LAUNCHES"),
    "flash_bwd_dkv_segments": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_SEGMENT_LAUNCHES"),
    "flash_bwd_dkv_softcap": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_SOFTCAP_LAUNCHES"),
    "flash_bwd_dkv_alibi": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_ALIBI_LAUNCHES"),
    "flash_bwd_dkv_dropout": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_DROPOUT_LAUNCHES"),
    "flash_bwd_dkv_dynoff": ("flashattn_tpu_torch.ops.flash_bwd", "DKV_DYNOFF_LAUNCHES"),
}


def read() -> dict[str, int]:
    """Every counter's value, by name."""
    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in COUNTERS.items()}


def reset() -> None:
    """Set every counter to 0."""
    advance({name: -n for name, n in read().items()})


def advance(deltas: dict[str, int], times: int = 1) -> None:
    """Add `times` x deltas[name] to each named counter."""
    for name, n in deltas.items():
        mod, attr = COUNTERS[name]
        module = importlib.import_module(mod)
        setattr(module, attr, getattr(module, attr) + times * n)


def capture(fn: Callable[[], Any]) -> tuple[torch.cuda.CUDAGraph, Any, dict[str, int]]:
    """Capture fn() into a new CUDA graph on a side stream: returns (the
    graph, fn's output, which lives in the graph's memory pool, and the
    launches the captured wrappers counted, taken back from the counters:
    no kernel ran). Each replay of the graph then calls ``advance`` with
    them. Run fn once eagerly first, so the kernels and the libraries'
    state are loaded outside the capture. torch.cuda.graph is not used: it
    empties the allocator's cache before it captures, and the eager work
    after the capture (a server's next admission) would then call cudaMalloc
    anew."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    before = read()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                out = fn()
            finally:
                graph.capture_end()
    finally:
        after = read()
        counted = {name: after[name] - before[name] for name in after
                   if after[name] != before[name]}
        advance({name: -n for name, n in counted.items()})
    torch.cuda.current_stream().wait_stream(side)
    return graph, out, counted
