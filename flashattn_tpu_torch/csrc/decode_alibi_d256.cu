// K2, flash-decode with ALiBi (csrc/decode.cuh holds the kernels and their
// design): the library of the ALiBi instantiations at D 256, as
// decode_alibi.cu holds those of D 64 and 128 (decode.cuh, kD256).
// Replaces, with decode.cu and its siblings, the TPU kernels
// flashattn_tpu/ops/decode.py::_decode_kernel and
// flashattn_tpu/ops/paged.py::_paged_decode with their alibi_hq slopes.
#include "decode.cuh"

// decode_launch_impl<true, true>'s contract (decode.cuh); slopes must not be
// null.
extern "C" int decode_launch(const void* q, const void* k, const void* v, const void* k_scale,
                             const void* v_scale, const void* length, const void* table,
                             const void* slopes, void* part_m, void* part_l, void* part_acc,
                             void* o, void* lse, int B, int Hq, int Hkv, int Tc, int Smax, int D,
                             int dtype, int kv_dtype, int max_pages, int page, int num_pages,
                             int split_len, int num_splits, int window, int sink,
                             float scale_log2, float inv_cap, float cap_log2, void* stream) {
  return decode_launch_impl<true, true>(
      q, k, v, k_scale, v_scale, length, table, slopes, part_m, part_l, part_acc, o, lse, B, Hq,
      Hkv, Tc, Smax, D, dtype, kv_dtype, max_pages, page, num_pages, split_len, num_splits,
      window, sink, scale_log2, inv_cap, cap_log2, stream);
}
