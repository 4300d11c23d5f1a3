// K1, the flash-attention forward (csrc/flash_fwd.cuh holds the kernels and
// their design), replacing the TPU kernels
// flashattn_tpu/ops/flash_fwd.py::_fwd_kernel and
// flashattn_tpu/ops/flash_fwd_grid4.py::_grid4_kernel: the library of every
// instantiation without dropout (bf16 and float32; the window, segment ids,
// the soft-cap, ALiBi). flash_fwd_dropout.cu builds the dropout
// instantiations into a library of their own, compiled beside this one.
#include "flash_fwd.cuh"

// fwd_launch_impl<false, false>'s contract (flash_fwd.cuh).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, const int* seg_q, const int* seg_k,
                                const int2* ranges_q, const int2* ranges_k,
                                const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                int D, int dtype, int is_causal, int offset, int window,
                                float scale_log2, float cap_log2, void* stream) {
  return fwd_launch_impl<false, false>(q, k, v, o, lse, seg_q, seg_k, ranges_q, ranges_k,
                                       slopes, B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset,
                                       window, scale_log2, cap_log2, fat::Dropout{}, nullptr,
                                       stream);
}
