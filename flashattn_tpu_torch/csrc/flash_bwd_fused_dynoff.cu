// B3 with the q/k alignment read from the card, the fused backward
// (csrc/flash_bwd_fused.cuh holds the kernels and their design): the library
// of the kDyn instantiations, the bf16 kernel at D 64 and 128 with the
// window's left edge, ALiBi or both, each with and without segment ids.
// Replaces, with flash_bwd_fused.cu, the TPU kernel
// flashattn_tpu/ops/flash_bwd_fused.py::_fused_bwd_kernel with its
// dyn_pos_offset (flash_bwd_fused.py:357, :368, :404): the zigzag ring's
// always-visible chunk pair.
#include "flash_bwd_fused.cuh"

// fused_launch_impl<slopes != NULL, false, true>'s contract
// (flash_bwd_fused.cuh); `offset` is not read: the int32 at dyn_offset on
// the device is.
extern "C" int flash_bwd_fused_launch(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq_acc, void* dk,
                                      void* dv, void* delta, const int* seg_q, const int* seg_k,
                                      const int2* ranges_q, const int2* ranges_k,
                                      const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int dtype, int is_causal, int offset, int window,
                                      float scale, float scale_log2, float cap_log2,
                                      const int* dyn_offset, void* stream) {
  const auto impl = slopes != nullptr ? fused_launch_impl<true, false, true>
                                      : fused_launch_impl<false, false, true>;
  return impl(q, k, v, o, dout, lse, dq_acc, dk, dv, delta, seg_q, seg_k, ranges_q, ranges_k,
              slopes, B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2,
              cap_log2, fat::Dropout{}, dyn_offset, stream);
}
