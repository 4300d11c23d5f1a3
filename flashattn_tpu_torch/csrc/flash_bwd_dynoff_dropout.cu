// B4 and B5 with the q/k alignment read from the card and attention
// dropout, the split backward (csrc/flash_bwd_split.cuh holds the kernels
// and their design): the library of the instantiations with kDyn and
// kDropout, every kind of flash_bwd_dynoff.cu with dropout. Replaces, with
// flash_bwd.cu, the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dq_kernel
// and ::_dkv_kernel with their dyn_pos_offset and their dropout
// (flash_bwd.py:253-263, :396-437, :576-580, :613).
#include "flash_bwd_split.cuh"

// dq_launch_impl<slopes != NULL, true, true>'s contract
// (flash_bwd_split.cuh): the dropout's arguments as flash_bwd_dropout.cu
// takes them, then the offset as flash_bwd_dynoff.cu takes it.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   const int* seg_q, const int* seg_k, const int2* ranges_q,
                                   const int2* ranges_k, const float* slopes, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int dtype, int is_causal,
                                   int offset, int window, float scale, float scale_log2,
                                   float cap_log2, const int* seed, unsigned threshold,
                                   float dropout_scale, const int* dyn_offset, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? dq_launch_impl<true, true, true>
                                      : dq_launch_impl<false, true, true>;
  return impl(q, k, v, o, dout, lse, dq, delta, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, drop,
              dyn_offset, stream);
}

// dkv_launch_impl<slopes != NULL, true, true>'s contract
// (flash_bwd_split.cuh), the dropout's and the offset's arguments as
// flash_bwd_dq_launch takes them.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* seg_q, const int* seg_k,
                                    const int2* ranges_q, const int2* ranges_k,
                                    const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int dtype, int is_causal, int offset, int window,
                                    float scale, float scale_log2, float cap_log2,
                                    const int* seed, unsigned threshold, float dropout_scale,
                                    const int* dyn_offset, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? dkv_launch_impl<true, true, true>
                                      : dkv_launch_impl<false, true, true>;
  return impl(q, k, v, dout, lse, delta, dk, dv, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, drop,
              dyn_offset, stream);
}
