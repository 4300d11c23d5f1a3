// B4 and B5 with attention dropout, the split backward
// (csrc/flash_bwd_split.cuh holds the kernels and their design): the library
// of the dropout instantiations, every bf16 kind of flash_bwd.cu and
// flash_bwd_alibi.cu with kDropout (no mask, the window, segment ids; the
// soft-cap or ALiBi) and the float32 kernels'. Replaces, with flash_bwd.cu,
// the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dq_kernel and
// ::_dkv_kernel with their dropout (flash_bwd.py:253-263, :396-437).
#include "flash_bwd_split.cuh"

// dq_launch_impl<slopes != NULL, true, false>'s contract
// (flash_bwd_split.cuh); the dropout's int32 seed is read from `seed` on the
// device; keep iff the hash >= threshold; scale 1 / (1 - rate).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   const int* seg_q, const int* seg_k, const int2* ranges_q,
                                   const int2* ranges_k, const float* slopes, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int dtype, int is_causal,
                                   int offset, int window, float scale, float scale_log2,
                                   float cap_log2, const int* seed, unsigned threshold,
                                   float dropout_scale, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? dq_launch_impl<true, true, false>
                                      : dq_launch_impl<false, true, false>;
  return impl(q, k, v, o, dout, lse, dq, delta, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, drop,
              nullptr, stream);
}

// dkv_launch_impl<slopes != NULL, true, false>'s contract
// (flash_bwd_split.cuh), the dropout's arguments as flash_bwd_dq_launch
// takes them.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* seg_q, const int* seg_k,
                                    const int2* ranges_q, const int2* ranges_k,
                                    const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int dtype, int is_causal, int offset, int window,
                                    float scale, float scale_log2, float cap_log2,
                                    const int* seed, unsigned threshold,
                                    float dropout_scale, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  const auto impl = slopes != nullptr ? dkv_launch_impl<true, true, false>
                                      : dkv_launch_impl<false, true, false>;
  return impl(q, k, v, dout, lse, delta, dk, dv, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2, drop,
              nullptr, stream);
}
