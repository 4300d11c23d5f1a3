"""The port's counterpart of flashattn_tpu/parallel/: the multi-device layer
over torch.distributed process groups.

- ``ring_flash_attention`` / ``zigzag_ring_flash_attention`` (ring.py):
  K/V shards rotate around the group's ranks while each rank's queries
  merge online-softmax partials; ``ulysses_flash_attention`` (ulysses.py)
  re-shards sequence -> heads by all-to-all instead.
- ``make_mesh`` / ``sharded_ring_attention`` (mesh.py): named axes over the
  ranks and the global-view sharded attention;
  ``initialize_distributed`` / ``pod_mesh`` (distributed.py): start-up.
  Ranks run on cards of their own (NCCL) or share one, or the CPU (gloo:
  exchanges of tensors on the card are staged through host memory).
- ``pipeline_apply`` / ``stack_stage_params`` (pipeline.py): GPipe's
  schedule over a group, one stage a rank.
- moe.py: the single-device MoE FFN and the expert-parallel dispatchers,
  ``moe_ffn`` (masked-dense) and ``moe_ffn_a2a`` (all_to_all capacity
  dispatch).
- ``sequence_sharded_decode`` / ``sharded_decode_attention`` (serving.py):
  decode against a cache split over the ranks, merged by the LSE rule.
- collectives.py: the tensor-parallel exchanges as autograd Functions.
"""

from flashattn_tpu_torch.parallel.distributed import initialize_distributed, pod_mesh
from flashattn_tpu_torch.parallel.mesh import make_mesh, sharded_ring_attention
from flashattn_tpu_torch.parallel.moe import (init_moe_params, moe_ffn, moe_ffn_a2a,
                                              moe_ffn_dense_reference, moe_ffn_grouped,
                                              router_aux_loss, router_gates)
from flashattn_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from flashattn_tpu_torch.parallel.ring import (ring_flash_attention,
                                               zigzag_ring_flash_attention, zigzag_shard,
                                               zigzag_unshard)
from flashattn_tpu_torch.parallel.serving import (sequence_sharded_decode,
                                                  sharded_decode_attention)
from flashattn_tpu_torch.parallel.ulysses import ulysses_flash_attention

__all__ = ["ring_flash_attention", "zigzag_ring_flash_attention", "zigzag_shard",
           "zigzag_unshard", "ulysses_flash_attention", "make_mesh",
           "sharded_ring_attention", "initialize_distributed", "pod_mesh",
           "pipeline_apply", "stack_stage_params", "init_moe_params", "moe_ffn",
           "moe_ffn_a2a", "moe_ffn_dense_reference", "moe_ffn_grouped", "router_aux_loss",
           "router_gates", "sequence_sharded_decode", "sharded_decode_attention"]
