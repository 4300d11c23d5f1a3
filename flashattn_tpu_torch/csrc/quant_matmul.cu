// qmm8 / qmm4: quantized matmul y = (x @ W) * scale for Hopper (sm_90a),
// x [M, K] bf16/f32, W int8 [K, N] or int4 nibble-packed [K/2, N] (byte row
// r holds row r in its low nibble and row r + K/2 in its high one), scale
// [1, N] f32 per output channel, y [M, N] bf16/f32; in the a8 mode
// (W8A8, W4A8) x is first quantized per row to int8 and
// y = ((x_q @ W) * scale) * x_scale.
//
// Replaces the TPU kernels flashattn_tpu/ops/quant_matmul.py::_qmm8_kernel
// (:81) and ::_qmm4_kernel (:123), launched by quant_matmul (:175; calls
// :244 and :260), with and without the a8 mode (quantize_activations,
// :223-231).
//
// What bounds it on the card: at decode (M = the batch, a few rows) the
// weight bytes, read once, and the latency of getting enough of them in
// flight; in a prefill or a prompt chunk (M in the hundreds) the
// operations, 2 M K N. On an H100 the split-K kernel takes about the same
// time for int8 and int4 at half the bytes (qmm8 reads its weights at about
// a third of HBM's rate, qmm4 at a sixth): its chain bounds it, the partial
// sums' round trip through the workspace and the second launch, which a
// bf16 cuBLAS GEMM does not pay; the tensor-core kernel reaches about a
// tenth of the bf16 peak with one 64 x 128 tile a CTA on mma.sync (wgmma
// and larger tiles are later work). The a8 mode adds a pass over x (read
// in its type, written and read again as int8), and its products run at
// the int8 peak, twice the bf16 one.
//
// What the design does about it. The weights stay in 8 or 4 bits in device
// memory and are widened on the chip, never written back; every product is
// exact in fp32 (int8/int4 values times bf16 or f32 activations) or on the
// tensor cores (int8 and int4 values are exact in bf16), the sums are fp32,
// and the scale multiplies each sum once at the end before the cast to y's
// type: the JAX order. Rows past M are masked, never padded. qmm8 and qmm4
// share each design; int4 keeps the JAX half-split pairing, the low nibble
// of byte row r with x[:, r] and the high one with x[:, K/2 + r].
//
// - M <= 16 (decode): split-K on the CUDA cores (qmm_splitk_kernel). A CTA
//   of 4 warps owns 128 columns and one K-slice of split_rows byte rows
//   (the wrapper picks it so that the grid has several CTAs an SM); lane l
//   reads columns 4l..4l+3 of a byte row as one 4-byte load, 16 rows in
//   flight a warp, and widens them in registers (int4: both nibbles of
//   each byte, ((b & 0xf) ^ 8) - 8 and ((b >> 4) ^ 8) - 8); x's slice is
//   the only tile in shared memory (int4: columns [k0, k0 + rows) and
//   [K/2 + k0, K/2 + k0 + rows)). The 4 warps' sums meet in shared memory
//   in a fixed order, each split writes its fp32 partial sums to a
//   workspace [splits, M, N], and qmm_reduce_kernel adds the splits in
//   split order, scales and casts. No atomics: two calls give bitwise-equal
//   results.
// - M > 16 with bf16 x (prefill, chunks): mma.sync m16n8k16 with fp32
//   accumulators (qmm_mma_kernel). A CTA of 4 warps owns a 64 x 128 tile of
//   y, each warp 32 x 64; per K step of 32 logical rows (int8: 32 byte rows;
//   int4: 16 byte rows, whose low nibbles pair with x's columns
//   [p0, p0 + 16) and high nibbles with [K/2 + p0, K/2 + p0 + 16)) the x
//   tile and the raw weight bytes arrive by cp.async in a double buffer,
//   each thread widens the weight bytes it copied to bf16 in shared memory,
//   and the fragments come by ldmatrix (the weights through .trans).
// - f32 x with M > 16: the CUDA-core kernel (qmm_kernel). Each CTA owns a
//   64 x 64 tile of y and walks K in tiles of 64 logical rows: 256 threads
//   load one 16-byte chunk of weight bytes each (int4: the 32 packed rows
//   of a tile give its 64 rows), sign-extend them to fp32 in shared memory
//   beside the x tile, and accumulate in fp32. f32 x is not exact in bf16,
//   so it stays off the tensor cores.
//
// The a8 mode, bf16 and f32 x alike, two launches:
// - quantize_rows_kernel (quantize_rows_launch), one CTA a row: the f32
//   amax over K, x_scale = max(amax * f32(1/127), 1e-10) (the product XLA
//   compiles the JAX package's amax / 127 into), x_q = clip(rint(x /
//   x_scale), +-127) with a true f32 division (__fdiv_rn) rounded half to
//   even: the JAX package's jitted bits.
// - then the product on x_q and x_scale (quant_matmul_a8_launch), at
//   M <= 16: qmm_splitk_a8_kernel, the split-K design on int8 x: x_q's
//   slice in shared memory as words of 4 columns, each lane's 4 x 4 block
//   of weight bytes (4 byte rows of its 4 columns; int4 nibbles
//   sign-extended to bytes first) transposed in registers by __byte_perm,
//   __dp4a into int32 sums, an int32 workspace, and qmm_reduce_kernel<O,
//   true> adding the splits in int32, converting once to f32, then times
//   the channel scale, then times x_scale: the JAX finalize's order.
// - M > 16: qmm_a8_mma_kernel, mma.sync m16n8k32 s8 x s8 -> s32 on the
//   tensor cores, the bf16 kernel's 64 x 128 tiles and warps, 64 logical
//   rows a K step (int4: 32 byte rows, whose nibbles the copying thread
//   unpacks to int8 in shared memory). The weights are [K, N], N
//   contiguous, but the int8 B fragment wants 4 consecutive k of one column
//   in a register, and ldmatrix .trans moves 16-bit elements only: each
//   lane points ldmatrix .trans at the weight rows k0 + {0, 1, 4, 5, 8, 9,
//   12, 13} (then + 2, + 16, + 18), so that a lane receives 2 x 2 bytes
//   (rows 4t, 4t + 1 or 4t + 2, 4t + 3 of columns 2g, 2g + 1), and
//   __byte_perm picks the even and the odd column's 4 rows: each 16-column
//   group is two n-tiles, its even and its odd columns. The tile's rows
//   are 128 bytes with their 16-byte chunks XOR-swizzled by the row, so
//   the 8 rows of each matrix fall in 8 different bank groups.
// - The int32 sums are exact: |sum| <= K * 127 * 127 < 2^31 for
//   K <= 133,144 (the wrapper raises past K 133,000; LLAMA_8B's largest K,
//   14,336, gives at most 231 M). So the result does not depend on the
//   split plan or the tile order, and equals the plain version's exact
//   integer product bit for bit. The JAX kernel adds each K block's int32
//   dot to an f32 sum; the two agree while the partial sums stay below
//   2^24.
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // output rows per CTA
constexpr int kBN = 64;  // output columns per CTA
constexpr int kBK = 64;  // logical weight rows per K tile
constexpr int kThreads = 256;

template <typename X, typename O, int kBits>
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

// ---- M <= 16: split-K on the CUDA cores ----

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitCols = 128;     // columns a CTA: 4 a lane
constexpr int kSplitBatch = 16;     // weight byte rows a warp has in flight
constexpr int kSplitRowsMax = 512;  // x columns of a split's slice in shared memory
static_assert(kSplitWarps * kSplitBatch == kBK, "a K tile is one batch of every warp");

template <int kM>
constexpr size_t splitk_smem_bytes() {
  // x's slice [kSplitRowsMax][kM], the warps' sums [kSplitWarps][kM][kSplitCols].
  return sizeof(float) * kM * (kSplitRowsMax + kSplitWarps * kSplitCols);
}

// Partial sums of byte rows [k0, k0 + split_rows) of x @ W for one split
// (blockIdx.y) and 128 columns (blockIdx.x) into ws[split][m][n], m < M.
// kM >= M is the rows of x computed (those past M are zeros). int8: byte
// row r is logical row r; int4: it holds logical rows r and K/2 + r.
template <typename X, int kM, int kBits>
__global__ void __launch_bounds__(kSplitThreads)
qmm_splitk_kernel(const X* __restrict__ x, const int8_t* __restrict__ w,
                  float* __restrict__ ws, int M, int K, int N, int split_rows) {
  constexpr int kHalves = kBits == 8 ? 1 : 2;  // x columns a byte row pairs with
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [kHalves * rows][kM]
  float* sums = xs + kSplitRowsMax * kM;   // [kSplitWarps][kM][kSplitCols]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * kSplitCols, split = blockIdx.y;
  const int k0 = split * split_rows;
  const int half = K / 2;
  const int rows = min(split_rows, (kBits == 8 ? K : half) - k0);  // a multiple of 16

  // x's slice, transposed: entry j < rows is column k0 + j; for int4, entry
  // rows + j is column K/2 + k0 + j.
  for (int e = tid; e < kM * kHalves * rows; e += kSplitThreads) {
    const int m = e / (kHalves * rows), j = e % (kHalves * rows);
    const int col = j < rows ? k0 + j : half + k0 + (j - rows);
    xs[j * kM + m] = m < M ? fat::to_f(x[static_cast<size_t>(m) * K + col]) : 0.f;
  }
  __syncthreads();

  const int col = n0 + 4 * lane;
  const bool live = col < N;  // N % 16 == 0: a lane's 4 columns are all in or all out
  const int8_t* wcol = w + static_cast<size_t>(k0) * N + col;
  float acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int r0 = warp * kSplitBatch; r0 < rows; r0 += kSplitWarps * kSplitBatch) {
    unsigned raw[kSplitBatch];
#pragma unroll
    for (int i = 0; i < kSplitBatch; ++i)
      raw[i] = live ? __ldg(reinterpret_cast<const unsigned*>(
                          wcol + static_cast<size_t>(r0 + i) * N))
                    : 0u;
#pragma unroll
    for (int i = 0; i < kSplitBatch; ++i) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        float wv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int byte = static_cast<int>((raw[i] >> (8 * c)) & 0xffu);
          if constexpr (kBits == 8)
            wv[c] = static_cast<float>(static_cast<int8_t>(byte));
          else
            wv[c] = static_cast<float>(h == 0 ? ((byte & 0xf) ^ 8) - 8 : ((byte >> 4) ^ 8) - 8);
        }
        const float* xr = xs + (h * rows + r0 + i) * kM;
#pragma unroll
        for (int m = 0; m < kM; m += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + m);
          const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m + mm][c] = fmaf(xm[mm], wv[c], acc[m + mm][c]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m)
    *reinterpret_cast<float4*>(sums + (warp * kM + m) * kSplitCols + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  // Thread t sums column n0 + t over the warps, in warp order.
  const int n = n0 + tid;
  if (n >= N) return;
  for (int m = 0; m < M; ++m) {
    float sum = sums[m * kSplitCols + tid];
#pragma unroll
    for (int v = 1; v < kSplitWarps; ++v) sum += sums[(v * kM + m) * kSplitCols + tid];
    ws[(static_cast<size_t>(split) * M + m) * N + n] = sum;
  }
}

// ---- the a8 mode: x quantized per row, int8 products, int32 sums ----

constexpr int kA8KMax = 133000;        // |sum| <= K * 127 * 127 < 2^31 up to K 133,144
constexpr float kInvInt8Max = 0x1.020408p-7f;  // f32(1 / 127), correctly rounded
constexpr float kScaleFloor = 0x1.b7cdfep-34f;  // f32(1e-10)
constexpr int kQuantThreads = 256;

// Four consecutive values of x as f32 (an 8- or 16-byte load).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16), v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16), v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// x_q [M, K] int8 and x_scale [M] f32 from x [M, K], one CTA a row, bit for
// bit the JAX package's jitted quantization: amax = max |x| in f32, scale =
// max(amax * f32(1/127), 1e-10), q = clip(round_half_even(x / scale), -127,
// 127) with a true f32 division.
template <typename X>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const X* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ x_scale, int K) {
  __shared__ float warp_amax[kQuantThreads / 32];
  const int tid = threadIdx.x;
  const X* xr = x + static_cast<size_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int j = 4 * tid; j < K; j += 4 * kQuantThreads) {
    float v[4];
    load4(xr + j, v);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) warp_amax[tid / 32] = amax;
  __syncthreads();
  amax = warp_amax[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_amax[w]);
  const float scale = fmaxf(__fmul_rn(amax, kInvInt8Max), kScaleFloor);
  int8_t* qr = xq + static_cast<size_t>(blockIdx.x) * K;
  for (int j = 4 * tid; j < K; j += 4 * kQuantThreads) {
    float v[4];
    load4(xr + j, v);
    unsigned packed = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v[c], scale))));
      packed |= (static_cast<unsigned>(q) & 0xffu) << (8 * c);
    }
    *reinterpret_cast<unsigned*>(qr + j) = packed;
  }
  if (tid == 0) x_scale[blockIdx.x] = scale;
}

// Four signed nibbles (one a byte, 0..15) sign-extended to four int8.
__device__ __forceinline__ unsigned sext_nibbles(unsigned v) {
  return v | ((v & 0x08080808u) * 0x1eu);
}
__device__ __forceinline__ unsigned low_nibbles(unsigned b) {
  return sext_nibbles(b & 0x0f0f0f0fu);
}
__device__ __forceinline__ unsigned high_nibbles(unsigned b) {
  return sext_nibbles((b >> 4) & 0x0f0f0f0fu);
}

// A 4 x 4 byte transpose: r[i] holds byte c of row i, t[c] gets byte i of
// column c.
__device__ __forceinline__ void transpose4(const unsigned* r, unsigned* t) {
  const unsigned a = __byte_perm(r[0], r[1], 0x5140u), b = __byte_perm(r[2], r[3], 0x5140u);
  const unsigned c = __byte_perm(r[0], r[1], 0x7362u), d = __byte_perm(r[2], r[3], 0x7362u);
  t[0] = __byte_perm(a, b, 0x5410u);
  t[1] = __byte_perm(a, b, 0x7632u);
  t[2] = __byte_perm(c, d, 0x5410u);
  t[3] = __byte_perm(c, d, 0x7632u);
}

// qmm_splitk_kernel on int8 x: the int32 partial sums of byte rows
// [k0, k0 + split_rows) of x_q @ W for one split (blockIdx.y) and 128
// columns (blockIdx.x) into ws[split][m][n], m < M. A lane's 4 columns of 4
// byte rows are transposed into one word a column, whose 4 bytes meet the
// word of x_q's 4 columns in one __dp4a.
template <int kM, int kBits>
__global__ void __launch_bounds__(kSplitThreads)
qmm_splitk_a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                     int* __restrict__ ws, int M, int K, int N, int split_rows) {
  constexpr int kHalves = kBits == 8 ? 1 : 2;
  extern __shared__ __align__(16) int a8_smem[];
  int* xw = a8_smem;                            // [kHalves * rows / 4][kM]: 4 columns a word
  int* sums = xw + kSplitRowsMax / 4 * kM;      // [kSplitWarps][kM][kSplitCols]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * kSplitCols, split = blockIdx.y;
  const int k0 = split * split_rows;
  const int half = K / 2;
  const int rows = min(split_rows, (kBits == 8 ? K : half) - k0);  // a multiple of 32
  const int words = kHalves * rows / 4;

  // x_q's slice: word j < rows / 4 is columns k0 + 4 j .. + 3; for int4,
  // word rows / 4 + j is columns K/2 + k0 + 4 j .. + 3.
  for (int e = tid; e < kM * words; e += kSplitThreads) {
    const int m = e / words, j = 4 * (e % words);
    const int col = j < rows ? k0 + j : half + k0 + (j - rows);
    xw[(j / 4) * kM + m] =
        m < M ? *reinterpret_cast<const int*>(xq + static_cast<size_t>(m) * K + col) : 0;
  }
  __syncthreads();

  const int col = n0 + 4 * lane;
  const bool live = col < N;  // N % 16 == 0: a lane's 4 columns are all in or all out
  const int8_t* wcol = w + static_cast<size_t>(k0) * N + col;
  int acc[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;

  for (int r0 = warp * kSplitBatch; r0 < rows; r0 += kSplitWarps * kSplitBatch) {
    unsigned raw[kSplitBatch];
#pragma unroll
    for (int i = 0; i < kSplitBatch; ++i)
      raw[i] = live ? __ldg(reinterpret_cast<const unsigned*>(
                          wcol + static_cast<size_t>(r0 + i) * N))
                    : 0u;
#pragma unroll
    for (int i0 = 0; i0 < kSplitBatch; i0 += 4) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        unsigned r[4], t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = kBits == 8 ? raw[i0 + i] : h == 0 ? low_nibbles(raw[i0 + i])
                                                   : high_nibbles(raw[i0 + i]);
        transpose4(r, t);
        const int* xr = xw + ((h * rows + r0 + i0) / 4) * kM;
#pragma unroll
        for (int m = 0; m < kM; m += 4) {
          const int4 xv = *reinterpret_cast<const int4*>(xr + m);
          const int xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m + mm][c] = __dp4a(static_cast<int>(t[c]), xm[mm], acc[m + mm][c]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m)
    *reinterpret_cast<int4*>(sums + (warp * kM + m) * kSplitCols + 4 * lane) =
        make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int n = n0 + tid;
  if (n >= N) return;
  for (int m = 0; m < M; ++m) {
    int sum = sums[m * kSplitCols + tid];
#pragma unroll
    for (int v = 1; v < kSplitWarps; ++v) sum += sums[(v * kM + m) * kSplitCols + tid];
    ws[(static_cast<size_t>(split) * M + m) * N + n] = sum;
  }
}

// y = (sum over splits, in split order, of ws[split]) * scale: four
// consecutive entries of y a thread. kA8: ws is int32, summed exactly,
// converted to f32 once, then times scale, then times x_scale of the row.
template <typename O, bool kA8>
__global__ void __launch_bounds__(256)
qmm_reduce_kernel(const void* __restrict__ ws_raw, const float* __restrict__ scale,
                  const float* __restrict__ x_scale, O* __restrict__ y, int M, int N,
                  int splits) {
  using Acc4 = std::conditional_t<kA8, int4, float4>;
  const Acc4* ws = static_cast<const Acc4*>(ws_raw);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (4 * i >= mn) return;
  Acc4 acc = ws[i];
  for (int s = 1; s < splits; ++s) {
    const Acc4 p = ws[s * mn / 4 + i];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const int n = static_cast<int>((4 * i) % N);
  const float sums[4] = {static_cast<float>(acc.x), static_cast<float>(acc.y),
                         static_cast<float>(acc.z), static_cast<float>(acc.w)};
  const float xs = kA8 ? x_scale[(4 * i) / N] : 1.f;
  O* out = y + 4 * i;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float v = sums[c] * scale[n + c];
    out[c] = fat::from_f<O>(kA8 ? v * xs : v);
  }
}

// ---- M > 16, bf16 x: the tensor cores ----

constexpr int kMmaThreads = 128;
constexpr int kMmaBM = 64, kMmaBN = 128, kMmaBK = 32;  // kMmaBK: logical rows a K step
constexpr int kXP = kMmaBK + 8;  // x tile row stride (bf16): conflict-free ldmatrix
constexpr int kWP = kMmaBN + 8;  // widened weight tile row stride (bf16)

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// 16 weight bytes widened to 16 bf16 in shared memory, each byte through
// `widen`.
template <typename F>
__device__ __forceinline__ void widen16(bf16* dst, const uint4& r, F widen) {
  const unsigned words[4] = {r.x, r.y, r.z, r.w};
  unsigned packed[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned word = words[e / 2] >> (16 * (e % 2));
    packed[e] = fat::pack_bf16(widen(word & 0xffu), widen((word >> 8) & 0xffu));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

template <typename O, int kBits>
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, O* __restrict__ y, int M, int K, int N) {
  // Byte rows of a K step: int4 packs its 32 logical rows into 16.
  constexpr int kRawRows = kBits == 8 ? kMmaBK : kMmaBK / 2;
  constexpr int kRawChunks = kRawRows * kMmaBN / 16 / kMmaThreads;  // 16-byte chunks a thread
  __shared__ __align__(16) bf16 xs[2][kMmaBM][kXP];
  __shared__ __align__(16) int8_t raw[2][kRawRows][kMmaBN];
  __shared__ __align__(16) bf16 wb[2][kMmaBK][kWP];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // this warp's 32 x 64 block
  const int half = K / 2;
  const int n_k = K / kMmaBK;

  // Thread tid copies x chunks tid and tid + 128 (of 4 a row) and weight
  // chunks tid (+ 128 for int8; of 8 a row); it widens the weight chunks it
  // copied, so that no barrier stands between the copy and the widening.
  // x's columns of step kt: [32 kt, 32 kt + 32) for int8; for int4 the
  // low half [16 kt, 16 kt + 16) then the high half [K/2 + 16 kt, ...).
  auto load = [&](int kt, int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kMmaThreads;
      const int xr = c / 4, xc = (c % 4) * 8;
      const int col = kBits == 8 ? kt * kMmaBK + xc
                                 : (xc < 16 ? kt * 16 + xc : half + kt * 16 + xc - 16);
      const bool xv = m0 + xr < M;
      fat::cp_async16(&xs[buf][xr][xc], xv ? x + static_cast<size_t>(m0 + xr) * K + col : x,
                      xv);
      if (j < kRawChunks) {
        const int wr = c / 8, wc = (c % 8) * 16;
        const bool wv = n0 + wc < N;
        fat::cp_async16(&raw[buf][wr][wc],
                        wv ? w + static_cast<size_t>(kt * kRawRows + wr) * N + n0 + wc : w, wv);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  load(0, 0);
  fat::cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    fat::cp_async_wait_all();  // this thread's copies of step kt are in
#pragma unroll
    for (int j = 0; j < kRawChunks; ++j) {
      const int c = tid + j * kMmaThreads;
      const int wr = c / 8, wc = (c % 8) * 16;
      const uint4 r = *reinterpret_cast<const uint4*>(&raw[buf][wr][wc]);
      if constexpr (kBits == 8) {
        widen16(&wb[buf][wr][wc], r,
                [](unsigned b) { return static_cast<float>(static_cast<int8_t>(b)); });
      } else {  // low nibbles are logical row wr, high nibbles row 16 + wr
        widen16(&wb[buf][wr][wc], r, [](unsigned b) {
          return static_cast<float>(static_cast<int>((b & 0xfu) ^ 8u) - 8);
        });
        widen16(&wb[buf][16 + wr][wc], r, [](unsigned b) {
          return static_cast<float>(static_cast<int>((b >> 4) ^ 8u) - 8);
        });
      }
    }
    __syncthreads();  // step kt's tiles are visible; every warp is done with step kt - 1
    if (kt + 1 < n_k) load(kt + 1, buf ^ 1);
    fat::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        fat::ldsm_x4(a[mt], &xs[buf][wm + 16 * mt][16 * ks] + fat::lane_offset<true>(lane, kXP));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        fat::ldsm_x4_t(b, &wb[buf][16 * ks][wn + 16 * np] + fat::lane_offset<true>(lane, kWP));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fat::mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          fat::mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // Element e of acc[mt][nt]: row wm + 16 mt + g + 8 (e / 2), column
  // wn + 8 nt + 2 tig + e % 2 of the tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + wm + 16 * mt + g + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn + 8 * nt + 2 * tig;
        if (n < N)
          store2(y + static_cast<size_t>(m) * N + n, acc[mt][nt][2 * i] * scale[n],
                 acc[mt][nt][2 * i + 1] * scale[n + 1]);
      }
    }
}

// ---- M > 16 in the a8 mode: the int8 tensor cores ----

constexpr int kA8BK = 64;           // logical rows a K step: two m16n8k32 products
constexpr int kA8XLd = kA8BK + 16;  // x_q tile row stride (bytes): conflict-free ldmatrix

// The weight tile is [kA8BK][kMmaBN] bytes, 128-byte rows whose 16-byte
// chunk c sits at c ^ a8_swizzle(k). The rows one ldmatrix matrix reads,
// k0 + {0, 1, 4, 5, 8, 9, 12, 13} (+ 2), get 8 different swizzles.
__device__ __forceinline__ int a8_swizzle(int k) { return (k & 1) | ((k >> 1) & 6); }

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(fat::pack_bf16(v[0], v[1]), fat::pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename O, int kBits>
__global__ void __launch_bounds__(kMmaThreads)
qmm_a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
                  const int8_t* __restrict__ w, const float* __restrict__ scale,
                  O* __restrict__ y, int M, int K, int N) {
  // Byte rows of a K step: int4 packs its 64 logical rows into 32.
  constexpr int kRawRows = kBits == 8 ? kA8BK : kA8BK / 2;
  constexpr int kWChunks = kRawRows * kMmaBN / 16 / kMmaThreads;  // 16-byte chunks a thread
  __shared__ __align__(16) int8_t xs[2][kMmaBM][kA8XLd];
  __shared__ __align__(16) int8_t wb[2][kA8BK][kMmaBN];
  __shared__ __align__(16) int8_t raw[2][kBits == 8 ? 1 : kRawRows][kMmaBN];  // int4's bytes
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // this warp's 32 x 64 block
  const int half = K / 2;
  const int n_k = K / kA8BK;

  // Thread tid copies x_q chunks tid and tid + 128 (of 4 a row) and weight
  // chunks tid + 128 j (of 8 a row); int8 weights go straight to their
  // swizzled place, int4 bytes to `raw`, which the same thread unpacks.
  // x_q's columns of step kt: [64 kt, 64 kt + 64) for int8; for int4 the
  // low half [32 kt, 32 kt + 32) then the high half [K/2 + 32 kt, ...).
  auto load = [&](int kt, int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kMmaThreads;
      const int xr = c / 4, xc = (c % 4) * 16;
      const int col = kBits == 8 ? kt * kA8BK + xc
                                 : (xc < 32 ? kt * 32 + xc : half + kt * 32 + xc - 32);
      const bool xv = m0 + xr < M;
      fat::cp_async16(&xs[buf][xr][xc], xv ? xq + static_cast<size_t>(m0 + xr) * K + col : xq,
                      xv);
    }
#pragma unroll
    for (int j = 0; j < kWChunks; ++j) {
      const int c = tid + j * kMmaThreads;
      const int wr = c / 8, wc = c % 8;
      const bool wv = n0 + 16 * wc < N;
      const int8_t* src = wv ? w + static_cast<size_t>(kt * kRawRows + wr) * N + n0 + 16 * wc : w;
      if constexpr (kBits == 8)
        fat::cp_async16(&wb[buf][wr][16 * (wc ^ a8_swizzle(wr))], src, wv);
      else
        fat::cp_async16(&raw[buf][wr][16 * wc], src, wv);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  // This lane's weight row for ldmatrix .trans: matrix lane / 8 of a k32
  // step holds rows {0, 1, 4, 5, 8, 9, 12, 13} + (0, 2, 16, 18)[lane / 8].
  const int mi = lane / 8, li = lane % 8;
  const int krow = 16 * (mi / 2) + 2 * (mi % 2) + 4 * (li / 2) + (li % 2);

  load(0, 0);
  fat::cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    fat::cp_async_wait_all();  // this thread's copies of step kt are in
    if constexpr (kBits == 4) {  // low nibbles are logical row wr, high nibbles row 32 + wr
#pragma unroll
      for (int j = 0; j < kWChunks; ++j) {
        const int c = tid + j * kMmaThreads;
        const int wr = c / 8, wc = c % 8;
        const uint4 r = *reinterpret_cast<const uint4*>(&raw[buf][wr][16 * wc]);
        *reinterpret_cast<uint4*>(&wb[buf][wr][16 * (wc ^ a8_swizzle(wr))]) =
            make_uint4(low_nibbles(r.x), low_nibbles(r.y), low_nibbles(r.z), low_nibbles(r.w));
        *reinterpret_cast<uint4*>(&wb[buf][32 + wr][16 * (wc ^ a8_swizzle(32 + wr))]) =
            make_uint4(high_nibbles(r.x), high_nibbles(r.y), high_nibbles(r.z),
                       high_nibbles(r.w));
      }
    }
    __syncthreads();  // step kt's tiles are visible; every warp is done with step kt - 1
    if (kt + 1 < n_k) load(kt + 1, buf ^ 1);
    fat::cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kA8BK / 32; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        fat::ldsm_x4(a[mt], reinterpret_cast<const bf16*>(
                                &xs[buf][wm + 16 * mt + (lane & 15)][32 * ks + 16 * (lane >> 4)]));
      const int k = 32 * ks + krow;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // r[m]: rows 4 tig + (0, 1) of matrix m's row set, columns 2 g and
        // 2 g + 1 of this 16-column group, as two 16-bit halves.
        unsigned r[4];
        const int chunk = (wn + 16 * np) / 16;
        fat::ldsm_x4_t(r, reinterpret_cast<const bf16*>(&wb[buf][k][16 * (chunk ^ a8_swizzle(k))]));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // n-tile 2 np: the group's even columns; 2 np + 1: its odd ones.
          fat::mma_s8(acc[mt][2 * np], a[mt], __byte_perm(r[0], r[1], 0x6420u),
                      __byte_perm(r[2], r[3], 0x6420u));
          fat::mma_s8(acc[mt][2 * np + 1], a[mt], __byte_perm(r[0], r[1], 0x7531u),
                      __byte_perm(r[2], r[3], 0x7531u));
        }
      }
    }
  }

  // Element e of acc[mt][2 np + h]: row wm + 16 mt + g + 8 (e / 2), column
  // wn + 16 np + 4 tig + 2 (e % 2) + h of the tile: a thread's 4 consecutive
  // columns a row.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + wm + 16 * mt + g + 8 * i;
      if (m >= M) continue;
      const float xs_m = x_scale[m];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = n0 + wn + 16 * np + 4 * tig;
        if (n >= N) continue;  // N % 16 == 0: the 4 columns are all in or all out
        const int* ev = acc[mt][2 * np];
        const int* od = acc[mt][2 * np + 1];
        const int sums[4] = {ev[2 * i], od[2 * i], ev[2 * i + 1], od[2 * i + 1]};
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = static_cast<float>(sums[c]) * scale[n + c] * xs_m;
        store4(y + static_cast<size_t>(m) * N + n, v);
      }
    }
}

template <typename X, int kM, int kBits>
cudaError_t launch_splitk(const void* x, const void* w, void* ws, int M, int K, int N,
                          int split_rows, int splits, cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<qmm_splitk_kernel<X, kM, kBits>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kSplitCols - 1) / kSplitCols, splits);
  qmm_splitk_kernel<X, kM, kBits><<<grid, kSplitThreads, splitk_smem_bytes<kM>(), stream>>>(
      static_cast<const X*>(x), static_cast<const int8_t*>(w), static_cast<float*>(ws), M, K, N,
      split_rows);
  return cudaGetLastError();
}

template <typename X, typename O, int kBits>
cudaError_t launch_qmm(const void* x, const void* w, const void* scale, void* y, void* ws,
                       int M, int K, int N, int split_rows, cudaStream_t stream) {
  if (M <= 16) {
    // split_rows byte rows; an int4 split's x slice is twice as wide.
    constexpr int kHalves = kBits == 8 ? 1 : 2;
    if (ws == nullptr || split_rows <= 0 || split_rows % kBK != 0 ||
        split_rows * kHalves > kSplitRowsMax)
      return cudaErrorInvalidValue;
    const int byte_rows = kBits == 8 ? K : K / 2;
    const int splits = (byte_rows + split_rows - 1) / split_rows;
    cudaError_t err;
    if (M <= 4)
      err = launch_splitk<X, 4, kBits>(x, w, ws, M, K, N, split_rows, splits, stream);
    else if (M <= 8)
      err = launch_splitk<X, 8, kBits>(x, w, ws, M, K, N, split_rows, splits, stream);
    else
      err = launch_splitk<X, 16, kBits>(x, w, ws, M, K, N, split_rows, splits, stream);
    if (err != cudaSuccess) return err;
    const int quads = M * N / 4;
    qmm_reduce_kernel<O, false><<<(quads + 255) / 256, 256, 0, stream>>>(
        ws, static_cast<const float*>(scale), nullptr, static_cast<O*>(y), M, N, splits);
  } else if constexpr (std::is_same_v<X, bf16>) {
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
    qmm_mma_kernel<O, kBits><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<O*>(y), M, K, N);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_kernel<X, O, kBits><<<grid, kThreads, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<O*>(y), M, K, N);
  }
  return cudaGetLastError();
}

template <typename X, typename O>
cudaError_t dispatch_bits(int bits, const void* x, const void* w, const void* scale, void* y,
                          void* ws, int M, int K, int N, int split_rows, cudaStream_t s) {
  if (bits == 8) return launch_qmm<X, O, 8>(x, w, scale, y, ws, M, K, N, split_rows, s);
  if (bits == 4) return launch_qmm<X, O, 4>(x, w, scale, y, ws, M, K, N, split_rows, s);
  return cudaErrorInvalidValue;
}

template <int kM, int kBits>
cudaError_t launch_splitk_a8(const int8_t* xq, const void* w, void* ws, int M, int K, int N,
                             int split_rows, int splits, cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<qmm_splitk_a8_kernel<kM, kBits>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kSplitCols - 1) / kSplitCols, splits);
  qmm_splitk_a8_kernel<kM, kBits><<<grid, kSplitThreads, splitk_smem_bytes<kM>(), stream>>>(
      xq, static_cast<const int8_t*>(w), static_cast<int*>(ws), M, K, N, split_rows);
  return cudaGetLastError();
}

// y = ((x_q @ W) * scale) * x_scale from x_q and x_scale (quantize_rows_kernel's).
template <typename O, int kBits>
cudaError_t launch_a8(const int8_t* xq, const float* x_scale, const void* w, const void* scale,
                      void* y, void* ws, int M, int K, int N, int split_rows,
                      cudaStream_t stream) {
  if (M <= 16) {
    constexpr int kHalves = kBits == 8 ? 1 : 2;
    if (ws == nullptr || split_rows <= 0 || split_rows % kBK != 0 ||
        split_rows * kHalves > kSplitRowsMax)
      return cudaErrorInvalidValue;
    const int byte_rows = kBits == 8 ? K : K / 2;
    const int splits = (byte_rows + split_rows - 1) / split_rows;
    cudaError_t err;
    if (M <= 4)
      err = launch_splitk_a8<4, kBits>(xq, w, ws, M, K, N, split_rows, splits, stream);
    else if (M <= 8)
      err = launch_splitk_a8<8, kBits>(xq, w, ws, M, K, N, split_rows, splits, stream);
    else
      err = launch_splitk_a8<16, kBits>(xq, w, ws, M, K, N, split_rows, splits, stream);
    if (err != cudaSuccess) return err;
    const int quads = M * N / 4;
    qmm_reduce_kernel<O, true><<<(quads + 255) / 256, 256, 0, stream>>>(
        ws, static_cast<const float*>(scale), x_scale, static_cast<O*>(y), M, N, splits);
  } else {
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
    qmm_a8_mma_kernel<O, kBits><<<grid, kMmaThreads, 0, stream>>>(
        xq, x_scale, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        static_cast<O*>(y), M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace

// x [M,K] of x_dtype (bf16 or f32, 16-byte aligned) -> x_q [M,K] int8 and
// x_scale [M] f32, the a8 mode's row quantization. K a multiple of 4,
// 0 < M < 2^31. Returns the CUDA error code (0 = success).
extern "C" int quantize_rows_launch(const void* x, void* xq, void* x_scale, int M, int K,
                                    int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<int8_t*>(xq);
  auto xs = static_cast<float*>(x_scale);
  if (x_dtype == fat::kBF16)
    quantize_rows_kernel<bf16><<<M, kQuantThreads, 0, s>>>(static_cast<const bf16*>(x), q, xs,
                                                           K);
  else if (x_dtype == fat::kF32)
    quantize_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(static_cast<const float*>(x), q, xs,
                                                            K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The a8 mode's product: y = ((x_q @ w) * scale) * x_scale from x_q [M,K]
// int8 and x_scale [M] f32 (quantize_rows_launch's), y [M,N] of out_dtype.
// w, scale, ws, split_rows and the shape limits as quant_matmul_launch's, ws
// an int32 workspace, and K <= 133,000 (int32 sums).
extern "C" int quant_matmul_a8_launch(const void* xq, const void* x_scale, const void* w,
                                      const void* scale, void* y, void* ws, int M, int K, int N,
                                      int bits, int out_dtype, int split_rows, void* stream) {
  if (M <= 0 || K <= 0 || K % kBK != 0 || K > kA8KMax || N <= 0 || N % 16 != 0 ||
      (M + 63) / 64 > 65535 || (bits != 8 && bits != 4) ||
      (out_dtype != fat::kBF16 && out_dtype != fat::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const int8_t*>(xq);
  auto xs = static_cast<const float*>(x_scale);
  cudaError_t err;
  if (out_dtype == fat::kBF16)
    err = bits == 8 ? launch_a8<bf16, 8>(q, xs, w, scale, y, ws, M, K, N, split_rows, s)
                    : launch_a8<bf16, 4>(q, xs, w, scale, y, ws, M, K, N, split_rows, s);
  else
    err = bits == 8 ? launch_a8<float, 8>(q, xs, w, scale, y, ws, M, K, N, split_rows, s)
                    : launch_a8<float, 4>(q, xs, w, scale, y, ws, M, K, N, split_rows, s);
  return static_cast<int>(err);
}

// x [M,K] of x_dtype; w int8 [K,N] (bits 8) or [K/2,N] (bits 4); scale [1,N]
// f32; y [M,N] of out_dtype. All contiguous on the device, w 16-byte
// aligned, K a multiple of 64, N of 16, 0 < M < 65536 * 16. For M <= 16,
// split_rows (a multiple of 64 byte rows, at most 512 for bits 8 and 256 for
// bits 4) is the K-slice of a split and ws an fp32 workspace
// [ceil(byte rows / split_rows), M, N]; otherwise both are unused. Returns
// the CUDA error code (0 = success).
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* scale, void* y,
                                   void* ws, int M, int K, int N, int bits, int x_dtype,
                                   int out_dtype, int split_rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || N % 16 != 0 || (M + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == fat::kBF16 && out_dtype == fat::kBF16)
    err = dispatch_bits<bf16, bf16>(bits, x, w, scale, y, ws, M, K, N, split_rows, s);
  else if (x_dtype == fat::kBF16 && out_dtype == fat::kF32)
    err = dispatch_bits<bf16, float>(bits, x, w, scale, y, ws, M, K, N, split_rows, s);
  else if (x_dtype == fat::kF32 && out_dtype == fat::kBF16)
    err = dispatch_bits<float, bf16>(bits, x, w, scale, y, ws, M, K, N, split_rows, s);
  else if (x_dtype == fat::kF32 && out_dtype == fat::kF32)
    err = dispatch_bits<float, float>(bits, x, w, scale, y, ws, M, K, N, split_rows, s);
  return static_cast<int>(err);
}
