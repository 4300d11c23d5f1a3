// K1: flash-attention forward, O and the natural-log LSE, for Hopper (sm_90a).
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_fwd.py::_fwd_kernel
// (launcher flash_attention_forward, :469) and
// flashattn_tpu/ops/flash_fwd_grid4.py::_grid4_kernel (launcher
// flash_attention_forward_grid4, :267) on their common plain subset: causal
// (bottom-right, or by pos_offset) or not, GQA, ragged S_q/S_k, optional LSE.
// The TPU's two grid shapes, its wavefront meta arrays, h_fuse and the
// ones-column row sum are Mosaic designs and are not carried over.
//
// What bounds it on the card: at the serving path's prefill shapes
// (S <= a few hundred, D = 64) the work per (q tile, head) is a few MFLOP,
// so the kernel is bound by latency (tile loads, a short kv loop, launch)
// more than by HBM (Q, K, V and O are read or written once per tile) or by
// the tensor cores' rate.
//
// What the design does about it: one CTA per (64-row q tile, q head, batch)
// keeps Q resident and streams 64-column K/V tiles through shared memory,
// each thread issuing all its 16-byte loads of a tile at once; the kv loop
// stops at the causal bound of the tile's last row, so a causal call does
// about half the work of a full one. bf16 runs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate): each of 4 warps owns 16 q rows and
// keeps its Q fragments, S and O in registers; P goes from the S
// accumulators to the A operand of P.V without touching shared memory, and
// V is stored transposed so every B fragment is one 32-bit load. float32
// runs a CUDA-core kernel: four threads per q row, each computing 16 logits
// of the tile and D/4 output columns. Both use the exp2 domain with
// scale*log2(e) folded in, fp32 (m, l) and accumulators, and round P to the
// input dtype for P.V as the TPU kernel feeds its MXU. wgmma/TMA tiles and
// a persistent schedule are later work.
#include "common.cuh"

namespace {

using fat::kMaskValue;

constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // kv columns per tile
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kBlockM;      // 4
constexpr int kColsPerThread = kBlockN / kThreadsPerRow;  // 16

template <int D>
constexpr size_t smem_bytes() {
  // qs [BM][D+1], ks [BN][D+1], vs [BN][D], ps [BM][BN+1], all fp32.
  return sizeof(float) * (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
                          kBlockM * (kBlockN + 1));
}

// Columns [0, kv_limit) can be visible to some row of the q tile at q0.
__device__ __forceinline__ int kv_limit(int q0, int Sq, int Sk, int is_causal, int offset) {
  if (!is_causal) return Sk;
  const int last_row = min(q0 + kBlockM, Sq) - 1;
  return max(0, min(Sk, last_row + offset + 1));
}

// ---- float32: CUDA cores (fp32 FMA over shared-memory tiles) ----

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                 int is_causal, int offset, float scale_log2) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * DP;
  float* vs = ks + kBlockN * DP;
  float* ps = vs + kBlockN * D;

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;  // this thread's row in the tile
  const int t = tid % kThreadsPerRow;  // its lane within the row's group
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const int qi = q0 + r;

  fat::load_tile<float, kBlockM, D, kThreads>(q + q_base + static_cast<size_t>(q0) * D,
                                              Sq - q0, qs, DP, scale_log2);
  const int kv_end = kv_limit(q0, Sq, Sk, is_causal, offset);

  float m = kMaskValue, l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed (and Q stored, first time)
    const size_t tile = kv_base + static_cast<size_t>(n0) * D;
    fat::load_tile<float, kBlockN, D, kThreads>(k + tile, kv_end - n0, ks, DP);
    fat::load_tile<float, kBlockN, D, kThreads>(v + tile, kv_end - n0, vs, D);
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * DP + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(qd, ks[(t + kThreadsPerRow * j) * DP + d], s[j]);
    }

    unsigned live = 0;
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = n0 + t + kThreadsPerRow * j;
      if (c < kv_end && (!is_causal || c <= qi + offset)) {
        live |= 1u << j;
        mx = fmaxf(mx, s[j]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = (live >> j) & 1u ? exp2f(s[j] - m_new) : 0.f;
      psum += p;
      ps[r * PP + t + kThreadsPerRow * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's four threads share one warp

#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockN; ++c) {
      const float p = ps[r * PP + c];
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(p, vs[c * D + t + kThreadsPerRow * i], acc[i]);
    }
  }

  if (qi < Sq) {
    // A row that saw no key has l == 0 and acc == 0: O = 0, LSE = -inf.
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      orow[t + kThreadsPerRow * i] = acc[i] * inv;
    if (lse != nullptr && t == 0) {
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + qi] =
          l > 0.f ? (m + log2f(l)) * fat::kLn2 : -CUDART_INF_F;
    }
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate) ----

constexpr int kMmaThreads = 128;  // 4 warps, 16 q rows each
constexpr int kVtPad = kBlockN + 8;  // Vt row stride (bf16): conflict-free fragments
static_assert(kBlockM == kBlockN, "load_bf16_tile copies kBlockN rows, and loads Q tiles too");

template <int D>
constexpr size_t mma_smem_bytes() {
  // qs [BM][D+8], ks [BN][D+8], vt [D][BN+8], all bf16.
  return sizeof(__nv_bfloat16) * (kBlockM * (D + 8) + kBlockN * (D + 8) + D * kVtPad);
}

using fat::mma_16816;
using fat::pack_bf16;

// Two bf16 at an even element index, as one 32-bit fragment register.
__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Copy rows [0, n_rows) of a contiguous [kBlockN][D] bf16 tile into shared
// memory with row stride D+8 (zero rows past n_rows), or, when kTranspose,
// into dst[d][row] with row stride kVtPad. All 16-byte loads of a thread
// are issued before any store.
template <int D, bool kTranspose>
__device__ __forceinline__ void load_bf16_tile(const __nv_bfloat16* __restrict__ src,
                                               int n_rows, __nv_bfloat16* __restrict__ dst) {
  constexpr int kChunksPerRow = D / 8;
  constexpr int kPerThread = kBlockN * kChunksPerRow / kMmaThreads;
  uint4 raw[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = threadIdx.x + j * kMmaThreads;
    raw[j] = make_uint4(0u, 0u, 0u, 0u);
    if (c / kChunksPerRow < n_rows) raw[j] = __ldg(reinterpret_cast<const uint4*>(src) + c);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = threadIdx.x + j * kMmaThreads;
    const int row = c / kChunksPerRow, col = (c % kChunksPerRow) * 8;
    if (kTranspose) {
      const unsigned w[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
        dst[(col + 2 * i) * kVtPad + row] = __ushort_as_bfloat16(w[i] & 0xffffu);
        dst[(col + 2 * i + 1) * kVtPad + row] = __ushort_as_bfloat16(w[i] >> 16);
      }
    } else {
      *reinterpret_cast<uint4*>(dst + row * (D + 8) + col) = raw[j];
    }
  }
}

// Same contract as flash_fwd_kernel, for bf16. Warp w owns q rows
// [16w, 16w+16) of the tile. Per kv tile it computes S = Q K^T into 8
// accumulator fragments (16 x 64, fp32), scales and masks S in registers,
// runs the online softmax on its two rows per thread (quad shuffles), and
// feeds P straight from the S fragments, rounded to bf16, as the A operand
// of P V. V is stored transposed in shared memory so that every B fragment
// is a 32-bit load.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int is_causal,
                     int offset, float scale_log2) {
  constexpr int KP = D + 8;
  constexpr int kSteps = D / 16;     // k-steps of S = Q K^T
  constexpr int kOutTiles = D / 8;   // n-tiles of O
  constexpr int kSTiles = kBlockN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * KP;
  __nv_bfloat16* vt = ks + kBlockN * KP;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, thread in group
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  load_bf16_tile<D, false>(q + q_base + static_cast<size_t>(q0) * D, Sq - q0, qs);
  __syncthreads();
  unsigned qf[kSteps][4];
  {
    const __nv_bfloat16* qw = qs + (warp * 16 + g) * KP + tig * 2;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qf[kk][0] = ld_pair(qw + kk * 16);
      qf[kk][1] = ld_pair(qw + 8 * KP + kk * 16);
      qf[kk][2] = ld_pair(qw + kk * 16 + 8);
      qf[kk][3] = ld_pair(qw + 8 * KP + kk * 16 + 8);
    }
  }
  const int kv_end = kv_limit(q0, Sq, Sk, is_causal, offset);

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // previous tile consumed
    const size_t tile = kv_base + static_cast<size_t>(n0) * D;
    load_bf16_tile<D, false>(k + tile, kv_end - n0, ks);
    load_bf16_tile<D, true>(v + tile, kv_end - n0, vt);
    __syncthreads();

    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * KP + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_16816(s[j], qf[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
    }

    // Element e of fragment j sits at row row0 + 8*(e/2), column
    // n0 + 8j + 2*tig + e%2.
    unsigned live = 0;
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + j * 8 + tig * 2 + (e & 1);
        const int r = row0 + (e >> 1) * 8;
        if (c < kv_end && (!is_causal || c <= r + offset)) {
          live |= 1u << (j * 4 + e);
          s[j][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (j * 4 + e)) & 1u ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = alpha[i] * l[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, one 16-column slice of P per k-step.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * kVtPad + kk * 16 + tig * 2;
        mma_16816(acc[n], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    // A row that saw no key has l == 0 and acc == 0: O = 0, LSE = -inf.
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = o + q_base + static_cast<size_t>(r) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && tig == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + r] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * fat::kLn2 : -CUDART_INF_F;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int Hq, int Hkv, int Sq, int Sk, int is_causal, int offset,
                       float scale_log2, cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<flash_fwd_kernel<D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), Hq,
      Hkv, Sq, Sk, is_causal, offset, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int Hq, int Hkv, int Sq, int Sk, int is_causal, int offset,
                        float scale_log2, cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<flash_fwd_mma_kernel<D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, mma_smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Hq, Hkv, Sq, Sk, is_causal, offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], o like q, lse [B,Hq,Sq] fp32 or NULL; all
// contiguous on the device, q, k and v 16-byte aligned. Row r sees column c
// iff !is_causal or c <= r + offset. bf16 runs on the tensor cores, float32
// on the FMA kernel. Returns the CUDA error code of the launch (0 = success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                int dtype, int is_causal, int offset, float scale_log2,
                                void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == fat::kBF16 && D == 64)
    err = launch_bf16<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, is_causal, offset, scale_log2, s);
  else if (dtype == fat::kBF16 && D == 128)
    err = launch_bf16<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, is_causal, offset, scale_log2, s);
  else if (dtype == fat::kF32 && D == 64)
    err = launch_f32<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, is_causal, offset, scale_log2, s);
  else if (dtype == fat::kF32 && D == 128)
    err = launch_f32<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, is_causal, offset, scale_log2, s);
  return static_cast<int>(err);
}
