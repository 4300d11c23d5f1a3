"""The port's counterpart of flashattn_tpu/parallel/: context parallelism
over torch.distributed process groups and the single-device
mixture-of-experts FFN.

- ``ring_flash_attention`` / ``zigzag_ring_flash_attention`` (ring.py):
  K/V shards rotate around the group's ranks while each rank's queries
  merge online-softmax partials; ``ulysses_flash_attention`` (ulysses.py)
  re-shards sequence -> heads by all-to-all instead.
- ``make_mesh`` / ``sharded_ring_attention`` (mesh.py): named axes over the
  ranks and the global-view sharded attention;
  ``initialize_distributed`` / ``pod_mesh`` (distributed.py): start-up.
  Ranks run on cards of their own (NCCL) or share one, or the CPU (gloo:
  exchanges of tensors on the card are staged through host memory).
- moe.py: the single-device MoE FFN. The expert-parallel dispatchers, the
  pipeline, tensor parallelism and sharded serving are not ported yet
  (ROADMAP A9).
"""

from flashattn_tpu_torch.parallel.distributed import initialize_distributed, pod_mesh
from flashattn_tpu_torch.parallel.mesh import make_mesh, sharded_ring_attention
from flashattn_tpu_torch.parallel.moe import (init_moe_params, moe_ffn, moe_ffn_a2a,
                                              moe_ffn_dense_reference, moe_ffn_grouped,
                                              router_aux_loss, router_gates)
from flashattn_tpu_torch.parallel.ring import (ring_flash_attention,
                                               zigzag_ring_flash_attention, zigzag_shard,
                                               zigzag_unshard)
from flashattn_tpu_torch.parallel.ulysses import ulysses_flash_attention

__all__ = ["ring_flash_attention", "zigzag_ring_flash_attention", "zigzag_shard",
           "zigzag_unshard", "ulysses_flash_attention", "make_mesh",
           "sharded_ring_attention", "initialize_distributed", "pod_mesh",
           "init_moe_params", "moe_ffn", "moe_ffn_a2a", "moe_ffn_dense_reference",
           "moe_ffn_grouped", "router_aux_loss", "router_gates"]
