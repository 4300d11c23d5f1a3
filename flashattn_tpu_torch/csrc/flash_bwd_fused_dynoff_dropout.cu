// B3 with the q/k alignment read from the card and attention dropout, the
// fused backward (csrc/flash_bwd_fused.cuh holds the kernels and their
// design): the library of the instantiations with kDyn and kDropout, every
// kind of flash_bwd_fused_dynoff.cu with dropout. Replaces, with
// flash_bwd_fused.cu, the TPU kernel
// flashattn_tpu/ops/flash_bwd_fused.py::_fused_bwd_kernel with its
// dyn_pos_offset and its dropout (flash_bwd_fused.py:236-247, :368, :404).
#include "flash_bwd_fused.cuh"

// fused_launch_impl<slopes != NULL, true, true>'s contract
// (flash_bwd_fused.cuh): the dropout's arguments as
// flash_bwd_fused_dropout.cu takes them, then the offset as
// flash_bwd_fused_dynoff.cu takes it.
extern "C" int flash_bwd_fused_launch(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq_acc, void* dk,
                                      void* dv, void* delta, const int* seg_q, const int* seg_k,
                                      const int2* ranges_q, const int2* ranges_k,
                                      const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int dtype, int is_causal, int offset, int window,
                                      float scale, float scale_log2, float cap_log2,
                                      const int* seed, unsigned threshold, float dropout_scale,
                                      const int* dyn_offset, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? fused_launch_impl<true, true, true>
                                      : fused_launch_impl<false, true, true>;
  return impl(q, k, v, o, dout, lse, dq_acc, dk, dv, delta, seg_q, seg_k, ranges_q, ranges_k,
              slopes, B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2,
              cap_log2, drop, dyn_offset, stream);
}
