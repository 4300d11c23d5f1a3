// Shared device helpers for the hand-written attention kernels.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace fat {

// Finite large-negative logit for masked entries (same constant as
// ops/common.py::MASK_VALUE): a masked-minus-max difference never forms
// -inf - -inf, so no NaN can enter the running statistics.
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

// Element types the kernels take; the Python wrappers pass these codes.
enum DType : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kFp8 = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P as the P.V product consumes it: rounded to the input dtype, as the TPU
// kernels feed the MXU (bf16 P for bf16 inputs, f32 P for f32 inputs). The
// softmax row sum l keeps the unrounded P.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Widen one 16-byte chunk (4 floats or 8 bf16, in memory order) to fp32.
template <typename T> __device__ __forceinline__ void widen16(const uint4& raw, float* out);
template <> __device__ __forceinline__ void widen16<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <> __device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy a [kRows][D] tile from global memory (16-byte aligned rows of d
// elements, d <= D a multiple of 16 bytes) into shared memory as fp32 times
// `scale`, with row stride `ld`; rows at or past n_rows and the columns at
// and past d (a head dim below its compiled tile D) are zero-filled, so
// they add nothing to a dot product over D. Each thread issues all of its
// 16-byte loads before it stores any, so their latencies overlap instead of
// adding up.
template <typename T, int kRows, int D, int kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int n_rows, int d,
                                          float* __restrict__ dst, int ld,
                                          float scale = 1.f) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kElems;
  constexpr int kChunks = kRows * kChunksPerRow;
  constexpr int kPerThread = (kChunks + kThreads - 1) / kThreads;
  static_assert(D % kElems == 0, "rows must be whole 16-byte chunks");
  static_assert(kThreads % kChunksPerRow == 0, "a thread keeps its column");
  constexpr int kRowStep = kThreads / kChunksPerRow;
  const int row0 = threadIdx.x / kChunksPerRow, col = (threadIdx.x % kChunksPerRow) * kElems;
  const bool col_ok = col < d;
  const T* from = src + row0 * d + col;
  uint4 raw[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = threadIdx.x + j * kThreads;
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    if (c < kChunks && row0 + j * kRowStep < n_rows && col_ok)
      raw[j] = __ldg(reinterpret_cast<const uint4*>(from));
    from += kRowStep * d;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < kChunks) {
      float f[kElems];
      widen16<T>(raw[j], f);
      float* row = dst + (c / kChunksPerRow) * ld + (c % kChunksPerRow) * kElems;
#pragma unroll
      for (int e = 0; e < kElems; ++e) row[e] = f[e] * scale;
    }
  }
}

// Head dims: every kernel is compiled for a tile of D in {64, 128, 256}
// columns and takes the true head dim d at run time, d 32 in the 64 tile
// and d 80 and 96 in the 128 tile. Global strides and buffers are d wide;
// the columns from d to D are loaded as zeros (they add nothing to
// S = Q K^T or dP = dO V^T, so O, dQ, dK and dV get zeros there) and never
// stored. d is a multiple of 16, so a cache row of one-byte values is whole
// 16-byte chunks, and a bf16 fragment's 8 columns are all in or all out.
__host__ __device__ constexpr int head_tile(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }
inline bool head_dim_ok(int d) { return d > 0 && d <= 256 && d % 16 == 0; }

// c += a . b on the tensor cores: one m16n8k16 bf16 product, fp32
// accumulators, fragments in the layouts of the PTX ISA.
__device__ __forceinline__ void mma_16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the tensor cores: one m16n8k32 int8 product, int32
// accumulators (exact), fragments in the layouts of the PTX ISA.
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tanh(x) for the logit soft-cap of K1 and K2: s = tanh(s / cap) * cap, as
// 1 - 2 / (2^(2 x log2 e) + 1) with ex2.approx and rcp.approx (two MUFU
// instructions; relative error about 2^-21, absolute error near 0 a few ulp
// of 1). tanh.approx.f32 (one MUFU.TANH, relative error about 2^-11: with
// cap 50 up to 0.035 in a logit's exp2 domain) fails K1's float32 gate.
// 2^(2x log2 e) = inf gives 1, 0 gives -1.
__device__ __forceinline__ float softcap_tanh(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * 2.8853900817779268f));  // 2 log2(e)
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

// (lo, hi) rounded to bf16 and packed: lo in the low half (lower index).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8, and r[m] receives matrix m in fragment layout
// (transposed with ldsm_x4_t).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Lane offsets into a row-major tile (row stride ld) for the two ldmatrix
// patterns, at the 16 x 16 block whose top-left element is `base`:
// kRowsFirst: matrices (r0,c0), (r8,c0), (r0,c8), (r8,c8): an A fragment, or
//   with .trans the B fragments of two n-tiles from a [k][n] tile;
// !kRowsFirst: matrices (r0,c0), (r0,c8), (r8,c0), (r8,c8): the B fragments
//   of two n-tiles from an [n][k] tile, or with .trans an A fragment from a
//   [k][m] tile.
template <bool kRowsFirst>
__device__ __forceinline__ int lane_offset(int lane, int ld) {
  return kRowsFirst ? (lane & 15) * ld + (lane >> 4) * 8
                    : ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// Packed-document segment ids come with each 32-position block's id range
// (min, max), [B, ceil(S / 32)] int2 (ops/flash_fwd.py::kernel_segments).
// Two tiles whose ranges are disjoint share no id, whatever the ids' order,
// so their pair attends to nothing; a pair whose ranges are one and the
// same id needs no id mask.
constexpr int kRangeRows = 32;

// Blocks of ranges in one batch row of S positions.
__device__ __forceinline__ int range_blocks(int S) { return (S + kRangeRows - 1) / kRangeRows; }

// The id range of positions [p0, p0 + n) within [0, S) from one batch row's
// block ranges; p0 and n multiples of kRangeRows, p0 < S.
__device__ __forceinline__ int2 id_range(const int2* __restrict__ ranges, int p0, int n, int S) {
  const int end = min(p0 + n, S);
  int2 r = __ldg(ranges + p0 / kRangeRows);
  for (int t = p0 / kRangeRows + 1; t * kRangeRows < end; ++t) {
    const int2 x = __ldg(ranges + t);
    r.x = min(r.x, x.x);
    r.y = max(r.y, x.y);
  }
  return r;
}

__device__ __forceinline__ bool ids_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }
__device__ __forceinline__ bool one_id(int2 a, int2 b) {
  return a.x == a.y && b.x == b.y && a.x == b.x;
}

// Attention dropout's keep mask (ops/common.py::dropout_keep_mask, the JAX
// package's flashattn_tpu/ops/common.py::dropout_keep_mask, bit for bit): a
// pure function of the int32 seed, bh = b * Hq + the query head, the
// query's row and the key's column in the arrays, so K1 and the backward
// kernels each regenerate it and none stores it. The hash on uint32:
// h = (row * 0x9E3779B1) ^ (col * 0x85EBCA77) ^ (seed + bh * 0x27D4EB2F),
// then xxhash's avalanche; an element is kept iff h >= threshold. A kernel
// forms the head term once, each row's term (row * 0x9E3779B1 ^ the head
// term) once a row and each column's once a column, so a score costs the
// xor, the avalanche (2 IMAD, 3 shifts, 3 xors) and the compare.
struct Dropout {
  const int* seed;     // the int32 seed, on the device
  unsigned threshold;  // uint32(rate * 2^32)
  float scale;         // 1 / (1 - rate), float32
};

// seed + bh * 0x27D4EB2F.
__device__ __forceinline__ unsigned dropout_head(const Dropout& d, int bh) {
  return static_cast<unsigned>(__ldg(d.seed)) + static_cast<unsigned>(bh) * 0x27D4EB2Fu;
}
__device__ __forceinline__ unsigned dropout_row(int row, unsigned head) {
  return static_cast<unsigned>(row) * 0x9E3779B1u ^ head;
}
__device__ __forceinline__ unsigned dropout_col(int col) {
  return static_cast<unsigned>(col) * 0x85EBCA77u;
}
// The column term of col + i from col's: (col + i) * c = col * c + i * c mod 2^32.
__device__ __forceinline__ unsigned dropout_col_step(unsigned col_term, int i) {
  return col_term + static_cast<unsigned>(i) * 0x85EBCA77u;
}
__device__ __forceinline__ bool dropout_keep(unsigned row_term, unsigned col_term,
                                             unsigned threshold) {
  unsigned h = row_term ^ col_term;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h >= threshold;
}

// Let a kernel ask for up to the device's opt-in maximum of dynamic shared
// memory (above 48 KB needs this), less its static shared memory. Set once
// per kernel, so that launches captured into a CUDA graph make no attribute
// call; a failure is cleared from the runtime's last error, so that it
// reaches only this kernel's callers.
template <auto Kernel>
inline cudaError_t allow_max_smem() {
  static const cudaError_t err = [] {
    int dev = 0, bytes = 0;
    cudaFuncAttributes attr{};
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, Kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes - static_cast<int>(attr.sharedSizeBytes));
    if (e != cudaSuccess) cudaGetLastError();
    return e;
  }();
  return err;
}

}  // namespace fat

// Message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
