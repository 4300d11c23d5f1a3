// K1 with the q/k alignment read from the card and attention dropout
// (csrc/flash_fwd.cuh holds the kernels and their design): the library of
// the instantiations with kDyn and kDropout, every kind of
// flash_fwd_dynoff.cu with dropout. Replaces, with flash_fwd.cu, the TPU
// kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel with its
// dyn_pos_offset and its dropout (flash_fwd.py:378-392, :617-622): the
// zigzag ring's always-visible chunk pair in a dropout run. The keep mask
// hashes the arrays' rows and columns, whatever the offset, as the JAX
// kernel's does.
#include "flash_fwd.cuh"

// fwd_launch_impl<true, true>'s contract (flash_fwd.cuh): the dropout's
// arguments as flash_fwd_dropout.cu takes them, then the offset as
// flash_fwd_dynoff.cu takes it.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, const int* seg_q, const int* seg_k,
                                const int2* ranges_q, const int2* ranges_k,
                                const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                int D, int dtype, int is_causal, int offset, int window,
                                float scale_log2, float cap_log2, const int* seed,
                                unsigned threshold, float dropout_scale, const int* dyn_offset,
                                void* stream) {
  const fat::Dropout drop{seed, threshold, dropout_scale};
  return fwd_launch_impl<true, true>(q, k, v, o, lse, seg_q, seg_k, ranges_q, ranges_k, slopes,
                                     B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset, window,
                                     scale_log2, cap_log2, drop, dyn_offset, stream);
}
