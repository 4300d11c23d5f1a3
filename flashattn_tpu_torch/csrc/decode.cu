// K2: flash-decode, T new query tokens per sequence against a KV cache with
// ragged lengths, for Hopper (sm_90a). The cache is bf16/f32, int8 or fp8
// (e4m3), dense [B, Hkv, Smax, D] or paged: pages [P, Hkv, page, D] read
// through a block table [B, max_pages].
//
// Replaces the TPU kernel flashattn_tpu/ops/decode.py::_decode_kernel
// (launcher _decode_attention, :351, reached through decode_attention :233
// and decode_attention_chunk :268) and its paged form
// flashattn_tpu/ops/paged.py::_paged_decode (:378, reached through
// paged_decode_attention :332 and paged_decode_attention_chunk :360), without
// window, sink, soft-cap, ALiBi or LSE output.
//
// What bounds it on the card: HBM bandwidth. Each step streams the live part
// of the cache once (K and V, [length, D] per kv head, one byte a value when
// quantized) and does only 4 * G * T * D operations per cached token, far
// below the card's operation-per-byte balance. At the serving batch (B = 4,
// Hkv = 4) the TPU design's grid of one program per (batch, kv head) would
// fill 16 of 132 SMs, and a single SM cannot pull enough bytes to saturate
// HBM.
//
// What the design does about it: split-KV. The grid is (B, Hkv x row blocks,
// splits); each CTA takes up to 64 of the G*T query rows of one (batch, kv
// head) group, so the group's q heads share one read of the cache (row r is
// head r / T, token r % T at position length - T + r % T, and sees keys at
// positions <= its own), and streams one slice of [0, length) in 64-token
// tiles, each thread issuing all its 16-byte loads of a tile at once. The
// row tiling bounds shared memory whatever T is (a chunk of T = 256 tokens
// at G = 8 is 2048 rows: 32 row blocks, each streaming its slice). Each CTA
// writes fp32 partial (m, l, acc) to scratch; a second small kernel merges
// the slices with the log-sum-exp algebra. Slices past a row's length exit
// at once, so a ragged batch streams only its live bytes. Cache rows at or
// past `length` are never read: a recycled slot may hold NaN there (or fp8
// NaN codes), and no 0 * NaN can reach a sum. A row that sees no key gets
// O = 0.
//
// Quantized modes, in the JAX kernel's order of operations:
// - int8: q arrives quantized per row (int8 rows and q_scale, made by the
//   wrapper as prep_decode_q does). s = int(q . k) * (q_scale * k_scale[pos]);
//   the integer products are exact in fp32 (|sum| <= 127 * 127 * 128 < 2^24).
//   Per row and tile, pvs = p * v_scale[pos], rmax = max(pvs) (1 where 0),
//   p8 = rint(pvs * (127 / rmax)) and pv = int(p8 . v) * (rmax / 127); l sums
//   p, not pvs. The JAX kernel requantizes P over a block of block_kv
//   positions (4096, clamped to Smax); this kernel requantizes per 64-position
//   tile, whose row maximum is never above the block's, so its steps are
//   finer.
// - fp8: k and v convert exactly (cuda_fp8.h); k_scale multiplies the logits
//   before the softmax, v_scale multiplies P before P . V (P not rounded, as
//   the JAX kernel feeds f32 converted values).
// Paged: a tile of 64 positions never straddles a page (the page size is a
// multiple of 64), so the tile base is taken through the table,
// table[b, n0 / page] row n0 % page. A table entry outside [0, P) (the
// server's sentinel for a block it does not own, which a chunk's padding
// can reach) is never dereferenced: its tile counts as holding no key.
// Slices and tile order are those of the dense cache of the same max_len,
// so the two give the same bits.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using fat::kMaskValue;

constexpr int kBlockN = 64;    // cache positions per tile
constexpr int kRowBlock = 64;  // query rows per CTA
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum class Mode { kPlain, kInt8, kFp8 };
template <typename C>
constexpr Mode kModeOf = std::is_same_v<C, int8_t>          ? Mode::kInt8
                         : std::is_same_v<C, __nv_fp8_e4m3> ? Mode::kFp8
                                                            : Mode::kPlain;

struct Args {
  const void* q;  // [B, Hq, T, D] in T, or int8 rows [B, Hkv, R, D] (int8 mode)
  const void* k;
  const void* v;
  const float* q_scale;  // [B, Hkv, R] (int8 mode)
  const float* k_scale;  // dense [B, Hkv, 1, Smax], paged [P, Hkv, 1, page]
  const float* v_scale;
  const int* length;  // [B]
  const int* table;   // [B, max_pages], or null for a dense cache
  float* part_m;      // [B, Hkv, splits, R]
  float* part_l;
  float* part_acc;  // [B, Hkv, splits, R, D]
  void* o;          // [B, Hq, T, D] in T
  int B, Hq, Hkv, Tc, Smax, max_pages, page, num_pages, split_len, num_splits, row_blocks;
  float scale_log2;
};

// Shared memory of the split kernel, in floats, for `rb` rows: qs [rb][D+1],
// ks [BN][D+1], vs [BN][D], ps [rb][BN+1], acc [rb][D], m, l, alpha, the
// int8 P factor and q_scale [rb], k_scale and v_scale [BN].
size_t split_smem_bytes(int rb, int D) {
  return sizeof(float) * (static_cast<size_t>(rb) * (D + 1) + kBlockN * (D + 1) +
                          kBlockN * D + static_cast<size_t>(rb) * (kBlockN + 1) +
                          static_cast<size_t>(rb) * D + 5 * static_cast<size_t>(rb) +
                          2 * kBlockN);
}

template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Args a) {
  constexpr Mode kMode = kModeOf<C>;
  using QT = std::conditional_t<kMode == Mode::kInt8, int8_t, T>;
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const C* __restrict__ k = static_cast<const C*>(a.k);
  const C* __restrict__ v = static_cast<const C*>(a.v);
  const int R = (a.Hq / a.Hkv) * a.Tc;
  const int RB = min(kRowBlock, R);  // rows the shared-memory layout holds
  const int b = blockIdx.x, hk = blockIdx.y / a.row_blocks;
  const int r0 = (blockIdx.y % a.row_blocks) * kRowBlock;
  const int nr = min(kRowBlock, R - r0);
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int len = min(a.length[b], a.Smax);
  const int start = sp * a.split_len;
  const int end = min(start + a.split_len, len);
  // Partial-result row index of (b, hk, sp, r0 + r) is part_base + r.
  const size_t part_base =
      ((static_cast<size_t>(b) * a.Hkv + hk) * a.num_splits + sp) * R + r0;

  if (start >= end) {  // slice wholly past this sequence's length
    for (int r = tid; r < nr; r += kThreads) {
      a.part_m[part_base + r] = kMaskValue;
      a.part_l[part_base + r] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + RB * DP;
  float* vs = ks + kBlockN * DP;
  float* ps = vs + kBlockN * D;
  float* acc = ps + RB * PP;
  float* st_m = acc + RB * D;
  float* st_l = st_m + RB;
  float* st_a = st_l + RB;
  float* st_f = st_a + RB;  // int8 mode: rmax / 127 of the current tile
  float* qsc = st_f + RB;
  float* ksc = qsc + RB;
  float* vsc = ksc + kBlockN;

  // [B, Hq, T, D] is [B, Hkv, R, D] in memory: row r of group hk.
  const size_t q_row = (static_cast<size_t>(b) * a.Hkv + hk) * R + r0;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    const QT x = q[(q_row + r) * D + dd];
    if constexpr (kMode == Mode::kInt8)
      qs[r * DP + dd] = static_cast<float>(x);
    else
      qs[r * DP + dd] = fat::to_f(x) * a.scale_log2;
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
    st_m[r] = kMaskValue;
    st_l[r] = 0.f;
    if constexpr (kMode == Mode::kInt8) qsc[r] = a.q_scale[q_row + r];
  }
  const size_t dense_base = (static_cast<size_t>(b) * a.Hkv + hk) * a.Smax;

  for (int n0 = start; n0 < end; n0 += kBlockN) {
    int n_live = min(kBlockN, end - n0);
    // Index of the tile's first position among the rows of k/v (and of the
    // scales): dense row b, hk; or page table[b, n0 / page], row n0 % page.
    size_t base = dense_base + n0;
    if (a.table != nullptr) {
      const int pid = a.table[static_cast<size_t>(b) * a.max_pages + n0 / a.page];
      if (pid < 0 || pid >= a.num_pages) n_live = 0;  // unowned block: no key
      base = (static_cast<size_t>(max(pid, 0)) * a.Hkv + hk) * a.page + n0 % a.page;
    }
    __syncthreads();  // previous tile consumed; q, acc and stats stored
    // Rows at or past `length` are never loaded (n_live stops at `end`).
    fat::load_tile<C, kBlockN, D, kThreads>(k + base * D, n_live, ks, DP);
    fat::load_tile<C, kBlockN, D, kThreads>(v + base * D, n_live, vs, D);
    if constexpr (kMode != Mode::kPlain) {
      for (int c = tid; c < kBlockN; c += kThreads) {
        ksc[c] = c < n_live ? a.k_scale[base + c] : 0.f;
        vsc[c] = c < n_live ? a.v_scale[base + c] : 0.f;
      }
    }
    __syncthreads();

    // Logits of the tile (log2 domain); masked entries hold kMaskValue.
    for (int i = tid; i < nr * kBlockN; i += kThreads) {
      const int r = i / kBlockN, c = i % kBlockN;
      const int row_pos = len - a.Tc + (r0 + r) % a.Tc;
      float s = kMaskValue;
      if (c < n_live && n0 + c <= row_pos) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * DP + d], ks[c * DP + d], dot);
        if constexpr (kMode == Mode::kInt8)
          s = dot * (qsc[r] * ksc[c]);
        else if constexpr (kMode == Mode::kFp8)
          s = dot * ksc[c];
        else
          s = dot;
      }
      ps[r * PP + c] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row; lanes hold columns lane and lane+32.
    for (int r = warp; r < nr; r += kWarps) {
      const int row_pos = len - a.Tc + (r0 + r) % a.Tc;
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
      if constexpr (kMode == Mode::kInt8) {
        // P x v_scale requantized to int8 over the row's tile.
        const float pv0 = p0 * vsc[lane], pv1 = p1 * vsc[lane + 32];
        float rmax = fmaxf(pv0, pv1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        rmax = rmax == 0.f ? 1.f : rmax;
        const float mul = 127.f / rmax;
        ps[r * PP + lane] = rintf(pv0 * mul);
        ps[r * PP + lane + 32] = rintf(pv1 * mul);
        if (lane == 0) st_f[r] = rmax / 127.f;
      } else if constexpr (kMode == Mode::kFp8) {
        ps[r * PP + lane] = p0 * vsc[lane];
        ps[r * PP + lane + 32] = p1 * vsc[lane + 32];
      } else {
        ps[r * PP + lane] = fat::round_to<T>(p0);
        ps[r * PP + lane + 32] = fat::round_to<T>(p1);
      }
      __syncwarp();  // all lanes read m_prev/l before lane 0 rewrites them
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        st_a[r] = alpha;
        st_l[r] = alpha * st_l[r] + sum;
        st_m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D, dd = i % D;
      if constexpr (kMode == Mode::kInt8) {
        float dot = 0.f;  // an integer below 2^24: exact
        for (int c = 0; c < n_live; ++c) dot = fmaf(ps[r * PP + c], vs[c * D + dd], dot);
        acc[i] = acc[i] * st_a[r] + dot * st_f[r];
      } else {
        float x = acc[i] * st_a[r];
        for (int c = 0; c < n_live; ++c) x = fmaf(ps[r * PP + c], vs[c * D + dd], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

  for (int r = tid; r < nr; r += kThreads) {
    a.part_m[part_base + r] = st_m[r];
    a.part_l[part_base + r] = st_l[r];
  }
  for (int i = tid; i < nr * D; i += kThreads) a.part_acc[part_base * D + i] = acc[i];
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
  // [B, Hkv, R, D] is [B, Hq, T, D] in memory.
  o[(static_cast<size_t>(bh) * R + r) * D + dd] = fat::from_f<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, typename C, int D>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int R = (a.Hq / a.Hkv) * a.Tc;
  a.row_blocks = (R + kRowBlock - 1) / kRowBlock;
  if (static_cast<long long>(a.Hkv) * a.row_blocks > 65535 || a.num_splits > 65535)
    return cudaErrorInvalidConfiguration;
  const size_t smem = split_smem_bytes(std::min(R, kRowBlock), D);
  cudaError_t err = fat::allow_max_smem<decode_split_kernel<T, C, D>>();
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, C, D>
      <<<dim3(a.B, a.Hkv * a.row_blocks, a.num_splits), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<a.B * a.Hkv * R, D, 0, stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.o), a.Hq, a.Hkv, a.Tc, D,
      a.num_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_cache(const Args& a, int dtype, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == fat::kInt8) return launch<T, int8_t, D>(a, s);
  if (kv_dtype == fat::kFp8) return launch<T, __nv_fp8_e4m3, D>(a, s);
  if (kv_dtype == dtype) return launch<T, T, D>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,Hq,T,D] of `dtype` (int8 rows [B,Hkv,R,D] with q_scale [B,Hkv,R] in
// the int8 mode); k/v of `kv_dtype`: dense [B,Hkv,Smax,D] (table null) or
// pages [P,Hkv,page,D] with table [B,max_pages] int32 and
// Smax = max_pages * page, page a multiple of 64, num_pages = P (table
// entries outside [0, P) hold no key); k_scale/v_scale f32
// [B,Hkv,1,Smax] or [P,Hkv,1,page] for a quantized cache; length [B] int32;
// part_m/part_l [B,Hkv,splits,R] and part_acc [B,Hkv,splits,R,D] fp32
// scratch; o like q. All contiguous on the device, k and v 16-byte aligned;
// split_len * num_splits >= Smax and split_len is a multiple of 64. Returns
// the CUDA error code (0 = success).
extern "C" int decode_launch(const void* q, const void* k, const void* v, const void* q_scale,
                             const void* k_scale, const void* v_scale, const void* length,
                             const void* table, void* part_m, void* part_l, void* part_acc,
                             void* o, int B, int Hq, int Hkv, int Tc, int Smax, int D,
                             int dtype, int kv_dtype, int max_pages, int page, int num_pages,
                             int split_len, int num_splits, float scale_log2, void* stream) {
  const bool quantized = kv_dtype == fat::kInt8 || kv_dtype == fat::kFp8;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tc <= 0 || Smax <= 0 || split_len <= 0 ||
      split_len % kBlockN != 0 || num_splits <= 0 ||
      static_cast<long long>(split_len) * num_splits < Smax ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)) ||
      (kv_dtype == fat::kInt8 && q_scale == nullptr) ||
      (table != nullptr && (page <= 0 || page % kBlockN != 0 ||
                            static_cast<long long>(max_pages) * page != Smax)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), static_cast<const int*>(length),
         static_cast<const int*>(table), static_cast<float*>(part_m),
         static_cast<float*>(part_l), static_cast<float*>(part_acc), o, B, Hq, Hkv, Tc,
         Smax, max_pages, page, num_pages, split_len, num_splits, 0, scale_log2};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == fat::kBF16 && D == 64)
    err = dispatch_cache<__nv_bfloat16, 64>(a, dtype, kv_dtype, s);
  else if (dtype == fat::kBF16 && D == 128)
    err = dispatch_cache<__nv_bfloat16, 128>(a, dtype, kv_dtype, s);
  else if (dtype == fat::kF32 && D == 64)
    err = dispatch_cache<float, 64>(a, dtype, kv_dtype, s);
  else if (dtype == fat::kF32 && D == 128)
    err = dispatch_cache<float, 128>(a, dtype, kv_dtype, s);
  return static_cast<int>(err);
}
