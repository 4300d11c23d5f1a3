// K2: flash-decode, T new query tokens per sequence against a bf16/f32 KV
// cache with ragged lengths, for Hopper (sm_90a).
//
// Replaces the TPU kernel flashattn_tpu/ops/decode.py::_decode_kernel
// (launcher _decode_attention, :351, reached through decode_attention :233
// and decode_attention_chunk :268) for an unquantized cache without window,
// sink, soft-cap, ALiBi or LSE output.
//
// What bounds it on the card: HBM bandwidth. Each step streams the live part
// of the cache once (K and V, [length, D] per kv head) and does only
// 4 * G * T * D FLOPs per cached token, far below the card's
// FLOP-per-byte balance. At the serving batch (B = 4, Hkv = 4) the TPU
// design's grid of one program per (batch, kv head) would fill 16 of 132
// SMs, and a single SM cannot pull enough bytes to saturate HBM.
//
// What the design does about it: split-KV. The grid is (B, Hkv, splits);
// each CTA takes the G*T query rows of one (batch, kv head) group, so the
// group's q heads share one read of the cache (row r is head r / T, token
// r % T at position length - T + r % T, and sees keys at positions <= its
// own), and streams one slice of [0, length) in 64-token tiles, each thread
// issuing all its 16-byte loads of a tile at once. It writes fp32 partial
// (m, l, acc) to scratch; a second small kernel merges the
// slices with the log-sum-exp algebra. Slices past a row's length exit at
// once, so a ragged batch streams only its live bytes. Cache rows at or
// past `length` are never read: a recycled slot may hold NaN there, and no
// 0 * NaN can reach a sum. A row that sees no key gets O = 0.
#include "common.cuh"

namespace {

using fat::kMaskValue;

constexpr int kBlockN = 64;  // cache positions per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Shared memory of the split kernel, in floats: qs [R][D+1], ks [BN][D+1],
// vs [BN][D], ps [R][BN+1], acc [R][D], and m, l, alpha [R].
size_t split_smem_bytes(int R, int D) {
  return sizeof(float) * (static_cast<size_t>(R) * (D + 1) + kBlockN * (D + 1) +
                          kBlockN * D + static_cast<size_t>(R) * (kBlockN + 1) +
                          static_cast<size_t>(R) * D + 3 * static_cast<size_t>(R));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int Hq, int Hkv, int Tc, int Smax,
                    int split_len, float scale_log2) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  const int G = Hq / Hkv;
  const int R = G * Tc;
  const int b = blockIdx.x, hk = blockIdx.y, sp = blockIdx.z;
  const int num_splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int len = min(length[b], Smax);
  const int start = sp * split_len;
  const int end = min(start + split_len, len);
  // Partial-result row index of (b, hk, sp, r) is part_base + r.
  const size_t part_base = ((static_cast<size_t>(b) * Hkv + hk) * num_splits + sp) * R;

  if (start >= end) {  // slice wholly past this sequence's length
    for (int r = tid; r < R; r += kThreads) {
      part_m[part_base + r] = kMaskValue;
      part_l[part_base + r] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + R * DP;
  float* vs = ks + kBlockN * DP;
  float* ps = vs + kBlockN * D;
  float* acc = ps + R * PP;
  float* st_m = acc + R * D;
  float* st_l = st_m + R;
  float* st_a = st_l + R;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    const int hq = hk * G + r / Tc, tt = r % Tc;
    qs[r * DP + dd] =
        fat::to_f(q[((static_cast<size_t>(b) * Hq + hq) * Tc + tt) * D + dd]) * scale_log2;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    st_m[r] = kMaskValue;
    st_l[r] = 0.f;
  }
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Smax * D;

  for (int n0 = start; n0 < end; n0 += kBlockN) {
    const int n_live = min(kBlockN, end - n0);
    __syncthreads();  // previous tile consumed; q, acc and stats stored
    // Rows at or past `length` are never loaded (n_live stops at `end`).
    const size_t tile = kv_base + static_cast<size_t>(n0) * D;
    fat::load_tile<T, kBlockN, D, kThreads>(k + tile, n_live, ks, DP);
    fat::load_tile<T, kBlockN, D, kThreads>(v + tile, n_live, vs, D);
    __syncthreads();

    // Logits of the tile; masked entries hold kMaskValue.
    for (int i = tid; i < R * kBlockN; i += kThreads) {
      const int r = i / kBlockN, c = i % kBlockN;
      const int row_pos = len - Tc + r % Tc;
      float s = kMaskValue;
      if (c < n_live && n0 + c <= row_pos) {
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qs[r * DP + d], ks[c * DP + d], s);
      }
      ps[r * PP + c] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row; lanes hold columns lane and lane+32.
    for (int r = warp; r < R; r += kWarps) {
      const int row_pos = len - Tc + r % Tc;
      const bool live0 = lane < n_live && n0 + lane <= row_pos;
      const bool live1 = lane + 32 < n_live && n0 + lane + 32 <= row_pos;
      const float s0 = ps[r * PP + lane], s1 = ps[r * PP + lane + 32];
      float mx = fmaxf(live0 ? s0 : kMaskValue, live1 ? s1 : kMaskValue);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = st_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = live0 ? exp2f(s0 - m_new) : 0.f;
      const float p1 = live1 ? exp2f(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * PP + lane] = fat::round_to<T>(p0);
      ps[r * PP + lane + 32] = fat::round_to<T>(p1);
      __syncwarp();  // all lanes read m_prev/l before lane 0 rewrites them
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        st_a[r] = alpha;
        st_l[r] = alpha * st_l[r] + sum;
        st_m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, dd = i % D;
      float a = acc[i] * st_a[r];
      for (int c = 0; c < n_live; ++c) a = fmaf(ps[r * PP + c], vs[c * D + dd], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int r = tid; r < R; r += kThreads) {
    part_m[part_base + r] = st_m[r];
    part_l[part_base + r] = st_l[r];
  }
  for (int i = tid; i < R * D; i += kThreads) part_acc[part_base * D + i] = acc[i];
}

// One CTA of D threads per (b, hk, r) row: O = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp2(m_s - max m) over the slices that saw a key (l_s > 0).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc, T* __restrict__ o,
                                    int Hq, int Hkv, int Tc, int D, int num_splits) {
  const int G = Hq / Hkv;
  const int R = G * Tc;
  const int r = blockIdx.x % R;
  const int bh = blockIdx.x / R;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int dd = threadIdx.x;
  const size_t base = static_cast<size_t>(bh) * num_splits * R + r;

  float mmax = kMaskValue;
  for (int s = 0; s < num_splits; ++s)
    if (part_l[base + static_cast<size_t>(s) * R] > 0.f)
      mmax = fmaxf(mmax, part_m[base + static_cast<size_t>(s) * R]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const size_t idx = base + static_cast<size_t>(s) * R;
    const float l = part_l[idx];
    if (l > 0.f) {  // slices that saw no key wrote no accumulator
      const float w = exp2f(part_m[idx] - mmax);
      den = fmaf(w, l, den);
      num = fmaf(w, part_acc[idx * D + dd], num);
    }
  }
  const int hq = hk * G + r / Tc, tt = r % Tc;
  o[((static_cast<size_t>(b) * Hq + hq) * Tc + tt) * D + dd] =
      fat::from_f<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* length,
                   void* part_m, void* part_l, void* part_acc, void* o, int B, int Hq,
                   int Hkv, int Tc, int Smax, int split_len, int num_splits,
                   float scale_log2, cudaStream_t stream) {
  const int R = (Hq / Hkv) * Tc;
  const size_t smem = split_smem_bytes(R, D);
  cudaError_t err = fat::allow_max_smem<decode_split_kernel<T, D>>();
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, D><<<dim3(B, Hkv, num_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), Hq, Hkv, Tc, Smax,
      split_len, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<B * Hkv * R, D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(o), Hq, Hkv, Tc, D, num_splits);
  return cudaGetLastError();
}

}  // namespace

// q [B,Hq,T,D]; k/v [B,Hkv,Smax,D]; length [B] int32; part_m/part_l
// [B,Hkv,splits,R] fp32 and part_acc [B,Hkv,splits,R,D] fp32 scratch; o like
// q. All contiguous on the device, k and v 16-byte aligned;
// split_len * num_splits >= Smax and split_len is a multiple of 64. A G*T
// too large for one CTA's shared memory fails the launch. Returns the CUDA error code (0 = success).
extern "C" int decode_launch(const void* q, const void* k, const void* v, const void* length,
                             void* part_m, void* part_l, void* part_acc, void* o, int B,
                             int Hq, int Hkv, int Tc, int Smax, int D, int dtype,
                             int split_len, int num_splits, float scale_log2, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tc <= 0 || Smax <= 0 || split_len <= 0 ||
      split_len % kBlockN != 0 || num_splits <= 0 ||
      static_cast<long long>(split_len) * num_splits < Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == fat::kBF16 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, length, part_m, part_l, part_acc, o, B, Hq, Hkv, Tc, Smax, split_len, num_splits, scale_log2, s);
  else if (dtype == fat::kBF16 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, length, part_m, part_l, part_acc, o, B, Hq, Hkv, Tc, Smax, split_len, num_splits, scale_log2, s);
  else if (dtype == fat::kF32 && D == 64)
    err = launch<float, 64>(q, k, v, length, part_m, part_l, part_acc, o, B, Hq, Hkv, Tc, Smax, split_len, num_splits, scale_log2, s);
  else if (dtype == fat::kF32 && D == 128)
    err = launch<float, 128>(q, k, v, length, part_m, part_l, part_acc, o, B, Hq, Hkv, Tc, Smax, split_len, num_splits, scale_log2, s);
  return static_cast<int>(err);
}
