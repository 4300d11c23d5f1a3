// qmm8 / qmm4: weight-only quantized matmul y = (x @ W) * scale for Hopper
// (sm_90a), x [M, K] bf16/f32, W int8 [K, N] or int4 nibble-packed [K/2, N]
// (byte row r holds row r in its low nibble and row r + K/2 in its high
// one), scale [1, N] f32 per output channel, y [M, N] bf16/f32.
//
// Replaces the TPU kernels flashattn_tpu/ops/quant_matmul.py::_qmm8_kernel
// (:81) and ::_qmm4_kernel (:123), launched by quant_matmul (:175; calls
// :244 and :260), without the a8 mode (quantize_activations).
//
// What bounds it on the card: at decode (M = the batch, a few rows) the
// weight bytes, read once; in a prefill or a prompt chunk (M in the
// hundreds) the operations, 2 M K N.
//
// What the design does about it: the weights stay in 8 or 4 bits in device
// memory and are widened in shared memory, never written back. Each CTA
// owns a BM x 64 tile of y (BM = 16 for M <= 16, else 64) and walks K in
// tiles of 64 logical rows: 256 threads load one 16-byte chunk of weight
// bytes each (int4: the 32 packed rows of a tile give its 64 rows, the low
// nibbles pairing with x[:, r] and the high ones with x[:, K/2 + r], as the
// JAX kernel slices x in half-K streams), sign-extend them to fp32 in shared
// memory beside the x tile, and accumulate in fp32 on the CUDA cores (int8
// and int4 values and bf16 activations multiply exactly in fp32). The scale
// multiplies the accumulator once at the end, then the cast to y's type:
// the JAX order. Rows past M are masked, never padded. The tensor cores
// (mma/wgmma on bf16 fragments, exact for these values) are later work.
#include "common.cuh"

namespace {

constexpr int kBN = 64;  // output columns per CTA
constexpr int kBK = 64;  // logical weight rows per K tile
constexpr int kThreads = 256;

template <typename X, typename O, int kBits, int kBM>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const X* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, O* __restrict__ y, int M, int K, int N) {
  constexpr int kRows = kBits == 8 ? kBK : kBK / 2;  // weight byte rows per tile
  constexpr int kTM = kBM / 16;                      // output rows per thread
  constexpr int kChunksPerRow = kBN / 16;            // 16-byte chunks per byte row
  __shared__ __align__(16) float xs[kBK][kBM];       // x tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN];       // widened weight tile
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int half = K / 2;
  const int num_tiles = (kBits == 8 ? K : half) / kRows;

  float acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < num_tiles; ++kt) {
    const int p0 = kt * kRows;  // first weight byte row of the tile
    if (tid < kRows * kChunksPerRow) {
      const int row = tid / kChunksPerRow, chunk = tid % kChunksPerRow;
      const int col = n0 + chunk * 16;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (col < N)
        raw = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(p0 + row) * N + col));
      const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int byte = static_cast<int>((words[e / 4] >> (8 * (e % 4))) & 0xffu);
        if constexpr (kBits == 8) {
          ws[row][chunk * 16 + e] = static_cast<float>(static_cast<int8_t>(byte));
        } else {
          ws[row][chunk * 16 + e] = static_cast<float>(((byte & 0xf) ^ 8) - 8);
          ws[kRows + row][chunk * 16 + e] = static_cast<float>(((byte >> 4) ^ 8) - 8);
        }
      }
    }
    // x columns of the tile: [p0, p0 + 64) for int8; for int4 the low half
    // [p0, p0 + 32) then the high half [K/2 + p0, K/2 + p0 + 32).
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, j = e % kBK;
      const int col = (kBits == 8 || j < kRows) ? p0 + j : half + p0 + (j - kRows);
      xs[j][m] = m0 + m < M ? fat::to_f(x[static_cast<size_t>(m0 + m) * K + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[j][tx * 4]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = xs[j][ty * kTM + i];
        acc[i][0] = fmaf(a, wv.x, acc[i][0]);
        acc[i][1] = fmaf(a, wv.y, acc[i][1]);
        acc[i][2] = fmaf(a, wv.z, acc[i][2]);
        acc[i][3] = fmaf(a, wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) y[static_cast<size_t>(m) * N + n] = fat::from_f<O>(acc[i][c] * scale[n]);
    }
  }
}

template <typename X, typename O, int kBits>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, int M, int K,
                   int N, cudaStream_t stream) {
  const int bn = (N + kBN - 1) / kBN;
  if (M <= 16) {
    qmm_kernel<X, O, kBits, 16><<<dim3(bn, (M + 15) / 16), kThreads, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<O*>(y), M, K, N);
  } else {
    qmm_kernel<X, O, kBits, 64><<<dim3(bn, (M + 63) / 64), kThreads, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<O*>(y), M, K, N);
  }
  return cudaGetLastError();
}

template <typename X, typename O>
cudaError_t dispatch_bits(int bits, const void* x, const void* w, const void* scale, void* y,
                          int M, int K, int N, cudaStream_t s) {
  if (bits == 8) return launch<X, O, 8>(x, w, scale, y, M, K, N, s);
  if (bits == 4) return launch<X, O, 4>(x, w, scale, y, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M,K] of x_dtype; w int8 [K,N] (bits 8) or [K/2,N] (bits 4); scale [1,N]
// f32; y [M,N] of out_dtype. All contiguous on the device, w 16-byte
// aligned, K a multiple of 64, N of 16, 0 < M < 65536 * 16. Returns the CUDA
// error code (0 = success).
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* scale, void* y,
                                   int M, int K, int N, int bits, int x_dtype, int out_dtype,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || N % 16 != 0 || (M + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == fat::kBF16 && out_dtype == fat::kBF16)
    err = dispatch_bits<__nv_bfloat16, __nv_bfloat16>(bits, x, w, scale, y, M, K, N, s);
  else if (x_dtype == fat::kBF16 && out_dtype == fat::kF32)
    err = dispatch_bits<__nv_bfloat16, float>(bits, x, w, scale, y, M, K, N, s);
  else if (x_dtype == fat::kF32 && out_dtype == fat::kBF16)
    err = dispatch_bits<float, __nv_bfloat16>(bits, x, w, scale, y, M, K, N, s);
  else if (x_dtype == fat::kF32 && out_dtype == fat::kF32)
    err = dispatch_bits<float, float>(bits, x, w, scale, y, M, K, N, s);
  return static_cast<int>(err);
}
