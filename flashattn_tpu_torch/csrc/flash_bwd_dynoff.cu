// B4 and B5 with the q/k alignment read from the card, the split backward
// (csrc/flash_bwd_split.cuh holds the kernels and their design): the
// library of the kDyn instantiations without dropout, the bf16 dQ and dK/dV
// kernels at D 64, 128 and 256 with the window's left edge, ALiBi, both, or
// the window with the soft-cap, each with and without segment ids, and the
// float32 kernels'. Replaces, with flash_bwd.cu, the TPU kernels
// flashattn_tpu/ops/flash_bwd.py::_dq_kernel and ::_dkv_kernel with their
// dyn_pos_offset (flash_bwd.py:576-580, :613): the zigzag ring's
// always-visible chunk pair. flash_bwd_dynoff_dropout.cu builds the same
// kinds with dropout.
#include "flash_bwd_split.cuh"

// dq_launch_impl<slopes != NULL, false, true>'s contract
// (flash_bwd_split.cuh); `offset` is not read: the int32 at dyn_offset on
// the device is.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   const int* seg_q, const int* seg_k, const int2* ranges_q,
                                   const int2* ranges_k, const float* slopes, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D, int dtype, int is_causal,
                                   int offset, int window, float scale, float scale_log2,
                                   float cap_log2, const int* dyn_offset, void* stream) {
  const auto impl = slopes != nullptr ? dq_launch_impl<true, false, true>
                                      : dq_launch_impl<false, false, true>;
  return impl(q, k, v, o, dout, lse, dq, delta, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2,
              fat::Dropout{}, dyn_offset, stream);
}

// dkv_launch_impl<slopes != NULL, false, true>'s contract
// (flash_bwd_split.cuh), the offset as flash_bwd_dq_launch takes it.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const int* seg_q, const int* seg_k,
                                    const int2* ranges_q, const int2* ranges_k,
                                    const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int dtype, int is_causal, int offset, int window,
                                    float scale, float scale_log2, float cap_log2,
                                    const int* dyn_offset, void* stream) {
  const auto impl = slopes != nullptr ? dkv_launch_impl<true, false, true>
                                      : dkv_launch_impl<false, false, true>;
  return impl(q, k, v, dout, lse, delta, dk, dv, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq,
              Hkv, Sq, Sk, D, dtype, is_causal, offset, window, scale, scale_log2, cap_log2,
              fat::Dropout{}, dyn_offset, stream);
}
