// K2, flash-decode (csrc/decode.cuh holds the kernels and their design),
// replacing the TPU kernels flashattn_tpu/ops/decode.py::_decode_kernel and
// flashattn_tpu/ops/paged.py::_paged_decode at D 256 (GEMMA2_9B's head
// dim): the library of every D 256 instantiation without ALiBi, as
// decode.cu holds those of D 64 and 128 (decode.cuh, kD256).
#include "decode.cuh"

// decode_launch_impl<false, true>'s contract (decode.cuh); slopes must be null.
extern "C" int decode_launch(const void* q, const void* k, const void* v, const void* k_scale,
                             const void* v_scale, const void* length, const void* table,
                             const void* slopes, void* part_m, void* part_l, void* part_acc,
                             void* o, void* lse, int B, int Hq, int Hkv, int Tc, int Smax, int D,
                             int dtype, int kv_dtype, int max_pages, int page, int num_pages,
                             int split_len, int num_splits, int window, int sink,
                             float scale_log2, float inv_cap, float cap_log2, void* stream) {
  return decode_launch_impl<false, true>(
      q, k, v, k_scale, v_scale, length, table, slopes, part_m, part_l, part_acc, o, lse, B, Hq,
      Hkv, Tc, Smax, D, dtype, kv_dtype, max_pages, page, num_pages, split_len, num_splits,
      window, sink, scale_log2, inv_cap, cap_log2, stream);
}
