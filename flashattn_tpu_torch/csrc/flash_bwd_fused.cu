// B3, the fused backward (csrc/flash_bwd_fused.cuh holds the kernels and
// their design), replacing the TPU kernel
// flashattn_tpu/ops/flash_bwd_fused.py::_fused_bwd_kernel: the library of
// every instantiation without ALiBi, dropout or the offset on the card
// (bf16 and float32, no mask, the window, segment ids, the soft-cap).
// flash_bwd_fused_alibi.cu, flash_bwd_fused_dropout.cu and
// flash_bwd_fused_dynoff.cu build the ALiBi, the dropout and the
// device-offset instantiations into libraries of their own, compiled beside
// this one.
#include "flash_bwd_fused.cuh"

// fused_launch_impl<false, false, false>'s contract (flash_bwd_fused.cuh); slopes must be null.
extern "C" int flash_bwd_fused_launch(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq_acc, void* dk,
                                      void* dv, void* delta, const int* seg_q, const int* seg_k,
                                      const int2* ranges_q, const int2* ranges_k,
                                      const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int dtype, int is_causal, int offset, int window,
                                      float scale, float scale_log2, float cap_log2,
                                      void* stream) {
  return fused_launch_impl<false, false, false>(q, k, v, o, dout, lse, dq_acc, dk, dv, delta, seg_q,
                                       seg_k, ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq, Sk, D,
                                       dtype, is_causal, offset, window, scale, scale_log2,
                                       cap_log2, fat::Dropout{}, nullptr, stream);
}
