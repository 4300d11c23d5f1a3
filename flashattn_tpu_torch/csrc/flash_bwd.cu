// Flash-attention backward, split path, for Hopper (sm_90a): the dQ kernel
// (with delta) and the dK/dV kernel, run one after the other.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dq_kernel (B4)
// and ::_dkv_kernel (B5) (launcher flash_attention_backward, :467) on the
// plain subset: causal (bottom-right, or by pos_offset) or not, GQA, ragged
// S_q/S_k, rows that see no key. The TPU's wavefront meta arrays and its
// pre-scaled operands are Mosaic designs and are not carried over.
//
// What bounds it on the card: at the training shapes (S 2048, D 64) each
// q tile of the dQ kernel and each kv tile of the dK/dV kernel recompute
// S and dP over tens of tiles, so the work is arithmetic (about 2.5x the
// forward's FLOPs over the two kernels); HBM traffic is Q, K, V, O, dO once
// per tile pair. The dK/dV kernel runs bf16 on the tensor cores
// (flash_bwd_mma.cuh: mma.sync m16n8k16, bf16 operands in shared memory,
// cp.async double buffer of the q tiles), so it is bound by the rate of
// mma.sync and the barriers a tile pair. The dQ kernel, and float32 in both,
// run on the CUDA cores in fp32 over shared-memory tiles (flash_bwd.cuh),
// bound by shared-memory loads (about one per FMA); the dQ kernel on the
// tensor cores is later work.
//
// What the design does about it: one CTA per (64-row q tile, q head, batch)
// for dQ, the kv loop cut at the tile's causal bound, heavy causal tiles
// launched first; one CTA per (64-row kv tile, kv head, batch) for dK/dV,
// looping over the GQA group's q heads and the live q tiles, dK and dV in
// registers until one write, heavy causal tiles launched first in bf16. No
// atomics: two runs give bitwise-equal outputs, which makes this the
// deterministic path.
#include <type_traits>

#include "flash_bwd_mma.cuh"

namespace {

using fat::bwd::kBlock;
using fat::bwd::kColsPerThread;
using fat::bwd::kPP;
using fat::bwd::kThreads;
using fat::bwd::kThreadsPerRow;

template <int D>
constexpr size_t dq_smem_bytes() {
  // qs, dos (the q tile), ks, vs (the kv tile), [D+1] rows; dS [64][65].
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kPP);
}

// dQ of one q tile of one q head, and delta = rowsum(dO * O) of its rows,
// written to delta [B, Hq, Sq] for the dK/dV kernel. Rows that see no key
// get dQ = 0.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int Hq, int Hkv, int Sq, int Sk, int is_causal,
                    int offset, float scale, float scale_log2) {
  constexpr int DP = D + 1;
  constexpr int kDims = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * DP;
  float* ks = dos + kBlock * DP;
  float* vs = ks + kBlock * DP;
  float* dss = vs + kBlock * DP;

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;
  const int t = tid % kThreadsPerRow;
  // Causal tiles late in the sequence run the longest kv loops: launch them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  const size_t q_base = stat_base * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const int qi = q0 + r;

  fat::load_tile<T, kBlock, D, kThreads>(q + q_base + static_cast<size_t>(q0) * D, Sq - q0, qs, DP);
  fat::load_tile<T, kBlock, D, kThreads>(dout + q_base + static_cast<size_t>(q0) * D, Sq - q0,
                                         dos, DP);

  // delta of row qi: each of its four threads sums D/4 products, then the quad.
  float row_delta = 0.f, lse2 = CUDART_INF_F;
  if (qi < Sq) {
    const T* orow = o + q_base + static_cast<size_t>(qi) * D + t;
    const T* dorow = dout + q_base + static_cast<size_t>(qi) * D + t;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      row_delta = fmaf(fat::to_f(dorow[kThreadsPerRow * i]), fat::to_f(orow[kThreadsPerRow * i]),
                       row_delta);
    lse2 = fat::bwd::lse_log2(lse[stat_base + qi]);
  }
  row_delta += __shfl_xor_sync(0xffffffffu, row_delta, 1);
  row_delta += __shfl_xor_sync(0xffffffffu, row_delta, 2);
  if (qi < Sq && t == 0) delta[stat_base + qi] = row_delta;

  // Columns [0, kv_end) can be visible to some row of the tile.
  int kv_end = Sk;
  if (is_causal) kv_end = max(0, min(Sk, min(q0 + kBlock, Sq) - 1 + offset + 1));

  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kBlock) {
    __syncthreads();  // previous kv tile consumed (and Q, dO stored, first time)
    const size_t tile = kv_base + static_cast<size_t>(n0) * D;
    fat::load_tile<T, kBlock, D, kThreads>(k + tile, kv_end - n0, ks, DP);
    fat::load_tile<T, kBlock, D, kThreads>(v + tile, kv_end - n0, vs, DP);
    __syncthreads();

    // S and dP: q row r against kv columns t + 4j.
    float s[kColsPerThread], dp[kColsPerThread];
    fat::bwd::two_score_rows<D>(qs, dos, ks, vs, r, t, s, dp);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = t + kThreadsPerRow * j;
      const int col = n0 + c;
      const bool live = col < kv_end && (!is_causal || col <= qi + offset);
      const float p = live ? exp2f(s[j] * scale_log2 - lse2) : 0.f;
      dss[r * kPP + c] = fat::round_to<T>(p * (dp[j] - row_delta));
    }
    __syncwarp();  // row r's four threads wrote all of its dS
    fat::bwd::row_times_tile<D>(dss, r, t, ks, acc);  // dQ += dS K
  }

  if (qi < Sq) {
    T* row = dq + q_base + static_cast<size_t>(qi) * D + t;
#pragma unroll
    for (int i = 0; i < kDims; ++i) row[kThreadsPerRow * i] = fat::from_f<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Hq, int Hkv, int Sq, int Sk, int is_causal, int offset, float scale,
                     float scale_log2) {
  fat::bwd::dkv_tile<T, D, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, Hq, Hkv, Sq, Sk,
                                  is_causal, offset, scale, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(fat::bwd::mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int Sq, int Sk,
                         int is_causal, int offset, float scale, float scale_log2) {
  fat::bwd::mma::dkv_tile<D, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, Hq, Hkv, Sq, Sk,
                                    is_causal, offset, scale, scale_log2);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int B, int Hq,
                      int Hkv, int Sq, int Sk, int is_causal, int offset, float scale,
                      cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<flash_bwd_dq_kernel<T, D>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlock - 1) / kBlock, Hq, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), Hq, Hkv, Sq, Sk, is_causal, offset, scale,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
                       int Hkv, int Sq, int Sk, int is_causal, int offset, float scale,
                       cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaError_t err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    namespace mma = fat::bwd::mma;
    err = fat::allow_max_smem<flash_bwd_dkv_mma_kernel<D>>();
    if (err != cudaSuccess) return err;
    const dim3 grid(Hkv, B, (Sk + mma::kBc - 1) / mma::kBc);
    flash_bwd_dkv_mma_kernel<D><<<grid, mma::kThreads, mma::smem_bytes<D, false>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq,
        Sk, is_causal, offset, scale, scale_log2);
  } else {
    err = fat::allow_max_smem<flash_bwd_dkv_kernel<T, D>>();
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + kBlock - 1) / kBlock, Hkv, B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, fat::bwd::dkv_smem_bytes<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Sq,
        Sk, is_causal, offset, scale, scale_log2);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int Sq, int Sk) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0;
}

}  // namespace

// q, o, dout, dq [B,Hq,Sq,D]; k, v [B,Hkv,Sk,D]; lse and delta [B,Hq,Sq]
// fp32; all contiguous on the device, the [.., D] tensors 16-byte aligned.
// Row r sees column c iff !is_causal or c <= r + offset. Writes dq (q's
// dtype, scale applied) and delta. Returns the CUDA error code (0 = success).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                                   int is_causal, int offset, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == fat::kBF16 && D == 64)
    err = launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk,
                                       is_causal, offset, scale, s);
  else if (dtype == fat::kBF16 && D == 128)
    err = launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk,
                                        is_causal, offset, scale, s);
  else if (dtype == fat::kF32 && D == 64)
    err = launch_dq<float, 64>(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, is_causal,
                               offset, scale, s);
  else if (dtype == fat::kF32 && D == 128)
    err = launch_dq<float, 128>(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, is_causal,
                                offset, scale, s);
  return static_cast<int>(err);
}

// Same layout; reads the delta written by flash_bwd_dq_launch and writes dk
// (scale applied) and dv in k's dtype, every row, summed over each kv head's
// q heads.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                                    int D, int dtype, int is_causal, int offset, float scale,
                                    void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == fat::kBF16 && D == 64)
    err = launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
                                        is_causal, offset, scale, s);
  else if (dtype == fat::kBF16 && D == 128)
    err = launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
                                         is_causal, offset, scale, s);
  else if (dtype == fat::kF32 && D == 64)
    err = launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
                                is_causal, offset, scale, s);
  else if (dtype == fat::kF32 && D == 128)
    err = launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
                                 is_causal, offset, scale, s);
  return static_cast<int>(err);
}
