// B3 with attention dropout, the fused backward (csrc/flash_bwd_fused.cuh
// holds the kernels and their design): the library of the dropout
// instantiations, every bf16 kind of flash_bwd_fused.cu and
// flash_bwd_fused_alibi.cu with kDropout (no mask, the window, segment ids;
// the soft-cap or ALiBi) and the float32 kernel's. Replaces, with
// flash_bwd_fused.cu, the TPU kernel
// flashattn_tpu/ops/flash_bwd_fused.py::_fused_bwd_kernel with its dropout
// (flash_bwd_fused.py:236-247).
#include "flash_bwd_fused.cuh"

// fused_launch_impl<slopes != NULL, true, false>'s contract
// (flash_bwd_fused.cuh); the dropout's int32 seed is read from `seed` on the
// device; keep iff the hash >= threshold; scale 1 / (1 - rate).
extern "C" int flash_bwd_fused_launch(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq_acc, void* dk,
                                      void* dv, void* delta, const int* seg_q, const int* seg_k,
                                      const int2* ranges_q, const int2* ranges_k,
                                      const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int dtype, int is_causal, int offset, int window,
                                      float scale, float scale_log2, float cap_log2,
                                      const int* seed, unsigned threshold,
                                      float dropout_scale, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? fused_launch_impl<true, true, false>
                                      : fused_launch_impl<false, true, false>;
  return impl(q, k, v, o, dout, lse, dq_acc, dk, dv, delta, seg_q, seg_k, ranges_q, ranges_k,
              slopes, B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2,
              cap_log2, drop, nullptr, stream);
}
