// B4 and B5 with ALiBi, the split backward (csrc/flash_bwd_split.cuh holds
// the kernels and their design): the library of the ALiBi instantiations
// (the bf16 kernels' kAlibi: no mask, the window, segment ids with or
// without a window; never with the soft-cap); the float32 kernels take
// ALiBi as a runtime argument. Replaces, with flash_bwd.cu, the TPU kernels
// flashattn_tpu/ops/flash_bwd.py::_dq_kernel and ::_dkv_kernel with their
// alibi slopes.
#include "flash_bwd_split.cuh"

// dq_launch_impl<true, false, false>'s contract (flash_bwd_split.cuh); slopes must not be null.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   const int* seg_q, const int* seg_k, const int2* ranges_q,
                                   const int2* ranges_k, const float* slopes, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int dtype, int is_causal,
                                   int offset, int window, float scale, float scale_log2,
                                   float cap_log2, void* stream) {
  return dq_launch_impl<true, false, false>(
      q, k, v, o, dout, lse, dq, delta, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq,
      Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, fat::Dropout{},
      nullptr, stream);
}

// dkv_launch_impl<true, false, false>'s contract (flash_bwd_split.cuh); slopes must not be null.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* seg_q, const int* seg_k,
                                    const int2* ranges_q, const int2* ranges_k,
                                    const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int dtype, int is_causal, int offset, int window,
                                    float scale, float scale_log2, float cap_log2,
                                    void* stream) {
  return dkv_launch_impl<true, false, false>(
      q, k, v, dout, lse, delta, dk, dv, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq,
      Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, fat::Dropout{},
      nullptr, stream);
}
