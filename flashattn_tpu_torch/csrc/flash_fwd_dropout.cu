// K1 with attention dropout (csrc/flash_fwd.cuh holds the kernels and their
// design): the library of the dropout instantiations (the bf16 kernel's
// kDropout beside every window, segment-id, soft-cap and ALiBi kind it
// has, and the float32 kernel's). Replaces, with flash_fwd.cu, the TPU
// kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel with its dropout
// (flash_fwd.py:378-392).
#include "flash_fwd.cuh"

// fwd_launch_impl<true, false>'s contract (flash_fwd.cuh); the dropout's int32
// seed is read from `seed` on the device; keep iff the hash >= threshold;
// O scaled by dropout_scale.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, const int* seg_q, const int* seg_k,
                                const int2* ranges_q, const int2* ranges_k,
                                const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                int D, int dtype, int is_causal, int offset, int window,
                                float scale_log2, float cap_log2, const int* seed,
                                unsigned threshold, float dropout_scale, void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  return fwd_launch_impl<true, false>(q, k, v, o, lse, seg_q, seg_k, ranges_q, ranges_k,
                                      slopes, B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset,
                                      window, scale_log2, cap_log2, drop, nullptr, stream);
}
