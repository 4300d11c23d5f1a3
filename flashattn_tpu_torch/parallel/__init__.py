"""The port's counterpart of flashattn_tpu/parallel/: the single-device
mixture-of-experts FFN (moe.py). The expert-parallel dispatchers, rings,
Ulysses, the pipeline and sharded serving need a mesh of several cards
(ROADMAP A9)."""

from flashattn_tpu_torch.parallel.moe import (init_moe_params, moe_ffn, moe_ffn_a2a,
                                              moe_ffn_dense_reference, moe_ffn_grouped,
                                              router_aux_loss, router_gates)

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_a2a", "moe_ffn_dense_reference",
           "moe_ffn_grouped", "router_aux_loss", "router_gates"]
