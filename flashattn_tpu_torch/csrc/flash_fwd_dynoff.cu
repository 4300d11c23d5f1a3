// K1 with the q/k alignment read from the card (csrc/flash_fwd.cuh holds
// the kernels and their design): the library of the kDyn instantiations
// without dropout, the bf16 kernel at D 64, 128 and 256 with the window's
// left edge, ALiBi, both, or the window with the soft-cap, each with and
// without segment ids, and the float32 kernel's. Replaces, with
// flash_fwd.cu, the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel
// with its dyn_pos_offset (flash_fwd.py:510-515, :617-622): the zigzag
// ring's always-visible chunk pair, whose offset depends on the rank and
// the hop. flash_fwd_dynoff_dropout.cu builds the same kinds with dropout.
#include "flash_fwd.cuh"

// fwd_launch_impl<false, true>'s contract (flash_fwd.cuh); `offset` is not
// read: the int32 at dyn_offset on the device is.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, const int* seg_q, const int* seg_k,
                                const int2* ranges_q, const int2* ranges_k,
                                const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk,
                                int D, int dtype, int is_causal, int offset, int window,
                                float scale_log2, float cap_log2, const int* dyn_offset,
                                void* stream) {
  return fwd_launch_impl<false, true>(q, k, v, o, lse, seg_q, seg_k, ranges_q, ranges_k, slopes,
                                      B, Hq, Hkv, Sq, Sk, D, dtype, is_causal, offset, window,
                                      scale_log2, cap_log2, fat::Dropout{}, dyn_offset, stream);
}
