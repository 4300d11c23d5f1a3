// CUDA-core tile machinery of the flash-attention backward kernels for
// float32: B4's dQ kernel (flash_bwd.cu) and the dK/dV tile of B3
// (flash_bwd_fused.cu) and B5 (flash_bwd.cu). bf16 runs on the tensor cores
// instead (flash_bwd_mma.cuh, and flash_bwd.cu's flash_bwd_dq_mma_kernel).
//
// Every kernel here is compiled for a head-dim tile D of 64, 128 or 256
// columns and takes the true head dim d (32 in the 64 tile, 80 and 96 in
// the 128 tile; common.cuh head_tile) at run time: rows of d elements in
// device memory, the columns up to D loaded as zeros, the outputs stored
// to d. Every kernel here works on square score tiles of Tile<D>::kRows rows
// (64, or 32 at D 256, whose 64-row tiles would pass the card's shared
// memory) with 4 threads a row: thread (r = tid / 4, t = tid % 4) owns row r
// of the tile and the columns t, t + 4, ..., so a row's four threads sit in
// one warp and meet with quad shuffles or __syncwarp. Tiles are widened to
// fp32 in shared memory (row stride D + 1, conflict-free column walks);
// products run on the CUDA cores with fp32 accumulators. P and dS are
// rounded to the input dtype before the products that consume them, as the
// TPU kernels feed their MXU. With a logit soft-cap (cap_log2 > 0, a
// uniform branch: float32 is the kernels' exact gate, not a fast path) the
// logit is tanh(s * scale_log2) * cap_log2 with scale_log2 = scale / cap,
// and dS takes the tanh's derivative (1 - t)(1 + t). ALiBi (slopes not
// null, a uniform branch too) adds slope * log2(e) * (c - r - offset) to
// the scaled logit with one FMA, as K1's float32 kernel does; the bias has
// no gradient, so dS keeps its formula. Dropout (kDropout, a template flag:
// the dropout libraries instantiate it) rebuilds K1's keep mask M
// (common.cuh dropout_keep) and with c = 1 / (1 - rate) takes dP to c M dP
// before dS = P (dP - delta), and M P into dV, c folded into dV's write.
#pragma once

#include "common.cuh"

namespace fat {
namespace bwd {

constexpr int kThreadsPerRow = 4;

// The float32 tile of head dim D.
template <int D>
struct Tile {
  static constexpr int kRows = D == 256 ? 32 : 64;  // q rows and kv rows per tile
  static constexpr int kThreads = kThreadsPerRow * kRows;
  static constexpr int kCols = kRows / kThreadsPerRow;  // score columns a thread
  static constexpr int kPP = kRows + 1;  // row stride of the [kRows][kRows] P / dS tiles
};

// What a bf16 instantiation masks beyond the causal bound: nothing, a
// sliding window, or segment ids (with a window when one is given). Each
// kind runs none of the code of the kinds after it.
enum MaskKind : int { kNoMask = 0, kWindowMask = 1, kSegmentMask = 2 };

// ALiBi in the bf16 backward kernels forms each score's bias as K1's bf16
// kernel does (flash_fwd.cu consume), term for term, since P is rebuilt
// from K1's LSE: K1's kv tiles are kFwdTileN<D> columns, and a score at
// column c = n0 + 8j + 2t + e (n0 the tile's first column, t = lane % 4)
// of row r takes row_term = slope_log2 * (n0 + 2t - r - offset), then
// bias = fmaf(slope_log2, 8j + e, row_term), then the logit
// fmaf(s, scale_log2, bias). At S 8192 the steepest standard slope's bias
// nears 10^4 in the log2 domain, where another rounding would show in P.
template <int D>
__host__ __device__ constexpr int fwd_tile_n() {
  return D > 128 ? 64 : 128;  // flash_fwd.cu FwdLayout::kTileN
}

// Column c's split in K1's bias: its tile's first column plus 2t, and its
// offset 8j + e from there (c & 6 is 2t: n0 and 8j are multiples of 8).
template <int D>
__device__ __forceinline__ int alibi_inner(int c) {
  return (c & (fwd_tile_n<D>() - 1)) - (c & 6);
}

// s[j] = a[r] . c[col_j], e[j] = b[r] . f[col_j] for this thread's
// columns col_j = t + 4j, over fp32 shared-memory tiles of row stride D+1.
template <int D>
__device__ __forceinline__ void two_score_rows(const float* __restrict__ a,
                                               const float* __restrict__ b,
                                               const float* __restrict__ c,
                                               const float* __restrict__ f, int r, int t,
                                               float* s, float* e) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int j = 0; j < Tile<D>::kCols; ++j) s[j] = e[j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float ad = a[r * DP + d];
    const float bd = b[r * DP + d];
#pragma unroll
    for (int j = 0; j < Tile<D>::kCols; ++j) {
      const int col = (t + kThreadsPerRow * j) * DP + d;
      s[j] = fmaf(ad, c[col], s[j]);
      e[j] = fmaf(bd, f[col], e[j]);
    }
  }
}

// acc[i] += sum_c w[r][c] * x[c][t + 4i] over the tile's columns c:
// one row of (w . x) for this thread's D/4 output columns.
template <int D>
__device__ __forceinline__ void row_times_tile(const float* __restrict__ w, int r, int t,
                                               const float* __restrict__ x, float* acc) {
  constexpr int DP = D + 1;
  for (int c = 0; c < Tile<D>::kRows; ++c) {
    const float wc = w[r * Tile<D>::kPP + c];
#pragma unroll
    for (int i = 0; i < D / kThreadsPerRow; ++i)
      acc[i] = fmaf(wc, x[c * DP + t + kThreadsPerRow * i], acc[i]);
  }
}

// A row's LSE in the log2 domain for exp2(s * scale_log2 - lse2). A row that
// sees no key has LSE = -inf; +inf makes every one of its P exactly 0.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -CUDART_INF_F ? CUDART_INF_F : lse * 1.4426950408889634f;
}

// P and dS of one score (a raw product s = q . k): p = exp2(logit - lse2),
// masked to 0 when !live, with the logit s * scale_log2, or with a soft-cap
// (cap_log2 > 0, a uniform branch; scale_log2 then scale / cap) t *
// cap_log2 for t = tanh(s * scale_log2), the forward's tanh, or with ALiBi
// (slope_log2, the head's slope times log2(e), not 0: a uniform branch; a
// slope of 0 adds nothing either way) s * scale_log2 + slope_log2 * dist,
// dist = c - r - offset; ds = p (dp - delta), times (1 - t)(1 + t) under
// the cap: d(cap tanh(x / cap)) / dx = 1 - t^2, kept precise where |t|
// nears 1. The float32 kernels call it; the bf16 kernels write the same
// arithmetic out per kCap and kAlibi (inlined through this helper, ptxas
// allotted B4's uncapped D 64 kernel differently and it spilled 12 bytes).
__device__ __forceinline__ float2 p_and_ds(float s, float dp, float delta, float lse2, bool live,
                                           float scale_log2, float cap_log2, float slope_log2,
                                           int dist) {
  if (cap_log2 > 0.f) {
    const float tc = softcap_tanh(s * scale_log2);
    const float p = live ? exp2f(tc * cap_log2 - lse2) : 0.f;
    return make_float2(p, p * (dp - delta) * ((1.f - tc) * (1.f + tc)));
  }
  float p;
  if (slope_log2 != 0.f)
    p = live ? exp2f(fmaf(slope_log2, static_cast<float>(dist), s * scale_log2) - lse2) : 0.f;
  else
    p = live ? exp2f(s * scale_log2 - lse2) : 0.f;
  return make_float2(p, p * (dp - delta));
}

// A head's ALiBi slope times log2(e), 0 without ALiBi (slopes null).
__device__ __forceinline__ float slope_log2_of(const float* __restrict__ slopes, int h) {
  return slopes != nullptr ? __ldg(slopes + h) * kLog2e : 0.f;
}

// Shared memory of the dK/dV kernels: K, V (the tile's kv rows), Q, dO (the
// current q tile), P^T and dS^T, and the q tile's LSE and delta.
template <int D>
constexpr size_t dkv_smem_bytes() {
  using L = Tile<D>;
  return sizeof(float) * (4 * L::kRows * (D + 1) + 2 * L::kRows * L::kPP + 2 * L::kRows);
}

// dK and dV of one kv tile (blockIdx.x) of one kv head (blockIdx.y) of one
// batch row (blockIdx.z), summed over the q heads of its GQA group and over
// every q tile with a row that sees the tile: from the causal bound's first
// row to, with a sliding window (window > 0), the last row whose window
// reaches the tile. Segment ids seg_q [B, Sq] and seg_k [B, Sk], when not
// null, mask pairs of two documents; slopes [Hq], when not null, add
// ALiBi (p_and_ds); kDropout applies drop's keep mask. With kFusedDq it
// also adds the tile's dQ contributions, scale applied, into dq_acc (fp32,
// zeroed by the caller)
// with atomics; without it nothing is shared between CTAs and the result is
// bitwise reproducible.
//
// dK and dV stay in registers (thread (r, t) owns kv row r, columns t + 4i)
// until one write each; kv rows that no q row sees are written as zeros.
template <typename T, int D, bool kFusedDq, bool kDropout>
__device__ __forceinline__ void dkv_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, float* __restrict__ dq_acc,
                                         const int* __restrict__ seg_q,
                                         const int* __restrict__ seg_k,
                                         const float* __restrict__ slopes, int Hq, int Hkv,
                                         int Sq, int Sk, int d, int is_causal, int offset,
                                         int window, float scale, float scale_log2,
                                         float cap_log2, const Dropout& drop) {
  constexpr int kBlock = Tile<D>::kRows;
  constexpr int kThreads = Tile<D>::kThreads;
  constexpr int kPP = Tile<D>::kPP;
  constexpr int kColsPerThread = Tile<D>::kCols;
  constexpr int DP = D + 1;
  constexpr int kDims = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * DP;
  float* qs = vs + kBlock * DP;
  float* dos = qs + kBlock * DP;
  float* pt = dos + kBlock * DP;
  float* dst = pt + kBlock * kPP;
  float* lse2s = dst + kBlock * kPP;
  float* deltas = lse2s + kBlock;

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;
  const int t = tid % kThreadsPerRow;
  const int kv0 = blockIdx.x * kBlock;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int kv_row = kv0 + r;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * d;

  // Columns from d to D load as zeros (common.cuh head_tile): S^T and dP^T
  // take nothing from them, and dK's, dV's and dQ's columns there stay 0
  // and are never stored.
  load_tile<T, kBlock, D, kThreads>(k + kv_base + static_cast<size_t>(kv0) * d, Sk - kv0, d, ks,
                                    DP);
  load_tile<T, kBlock, D, kThreads>(v + kv_base + static_cast<size_t>(kv0) * d, Sk - kv0, d, vs,
                                    DP);

  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // Causal: q row qi sees column kv0 iff qi >= kv0 - offset, so q tiles
  // before the one holding that row contribute nothing.
  const int n_q_tiles = (Sq + kBlock - 1) / kBlock;
  const int first_row = is_causal ? max(0, kv0 - offset) : 0;
  const int q_begin = first_row >= Sq ? n_q_tiles : first_row / kBlock;
  // Window: no q row past the last one whose window reaches the tile's last kv row.
  const int last_row = kv0 + kBlock - 1 - offset + window - 1;
  const int q_end = window == 0 ? n_q_tiles
                                : last_row < 0 ? 0 : min(n_q_tiles, last_row / kBlock + 1);
  const int kv_seg = seg_k != nullptr && kv_row < Sk ? seg_k[static_cast<size_t>(b) * Sk + kv_row]
                                                     : 0;
  const unsigned drop_col = kDropout ? dropout_col(kv_row) : 0u;  // the hash's column: kv_row

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float slope_log2 = slope_log2_of(slopes, h);
    const unsigned drop_head = kDropout ? dropout_head(drop, b * Hq + h) : 0u;
    const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * Sq;
    const size_t q_base = stat_base * d;
    for (int qt = q_begin; qt < q_end; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous q tile is consumed (K and V stored, first time)
      load_tile<T, kBlock, D, kThreads>(q + q_base + static_cast<size_t>(q0) * d, Sq - q0, d, qs,
                                        DP);
      load_tile<T, kBlock, D, kThreads>(dout + q_base + static_cast<size_t>(q0) * d, Sq - q0, d,
                                        dos, DP);
      if (tid < kBlock) {
        const int qi = q0 + tid;
        lse2s[tid] = qi < Sq ? lse_log2(lse[stat_base + qi]) : CUDART_INF_F;
        deltas[tid] = qi < Sq ? delta[stat_base + qi] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: kv row r against q columns t + 4j.
      float s[kColsPerThread], dp[kColsPerThread];
      two_score_rows<D>(ks, vs, qs, dos, r, t, s, dp);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = t + kThreadsPerRow * j;
        const int qi = q0 + c;
        const bool live = qi < Sq && kv_row < Sk && (!is_causal || kv_row <= qi + offset) &&
                          (window == 0 || kv_row >= qi + offset - window + 1) &&
                          (seg_q == nullptr || seg_q[static_cast<size_t>(b) * Sq + qi] == kv_seg);
        bool keep = true;  // dropout: dV takes M P, dS is P (c M dP - delta)
        if constexpr (kDropout) {
          keep = dropout_keep(dropout_row(qi, drop_head), drop_col, drop.threshold);
          dp[j] = keep ? dp[j] * drop.scale : 0.f;
        }
        const float2 pd = p_and_ds(s[j], dp[j], deltas[c], lse2s[c], live, scale_log2, cap_log2,
                                   slope_log2, kv_row - qi - offset);
        pt[r * kPP + c] = round_to<T>(keep ? pd.x : 0.f);
        dst[r * kPP + c] = round_to<T>(pd.y);
      }
      __syncwarp();  // row r's four threads wrote all of its P^T and dS^T

      row_times_tile<D>(pt, r, t, dos, dv_acc);  // dV += P^T dO
      row_times_tile<D>(dst, r, t, qs, dk_acc);  // dK += dS^T Q

      if (kFusedDq) {
        __syncthreads();  // every row of dS^T is written
        // Thread (r, t) now owns q row q0 + r: dQ[r] += sum_c dS^T[c][r] K[c].
        const int qi = q0 + r;
        if (qi < Sq) {
          float acc[kDims];
#pragma unroll
          for (int i = 0; i < kDims; ++i) acc[i] = 0.f;
          for (int c = 0; c < kBlock; ++c) {
            const float w = dst[c * kPP + r];
#pragma unroll
            for (int i = 0; i < kDims; ++i)
              acc[i] = fmaf(w, ks[c * DP + t + kThreadsPerRow * i], acc[i]);
          }
          float* row = dq_acc + q_base + static_cast<size_t>(qi) * d + t;
#pragma unroll
          for (int i = 0; i < kDims; ++i)  // dQ's columns at and past d: zeros, not added
            if (t + kThreadsPerRow * i < d) atomicAdd(row + kThreadsPerRow * i, acc[i] * scale);
        }
      }
    }
  }

  if (kv_row < Sk) {
    T* dk_row = dk + kv_base + static_cast<size_t>(kv_row) * d + t;
    T* dv_row = dv + kv_base + static_cast<size_t>(kv_row) * d + t;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      if (t + kThreadsPerRow * i >= d) continue;  // zeros past the head dim, not stored
      dk_row[kThreadsPerRow * i] = from_f<T>(dk_acc[i] * scale);
      dv_row[kThreadsPerRow * i] = from_f<T>(kDropout ? dv_acc[i] * drop.scale : dv_acc[i]);
    }
  }
}

}  // namespace bwd
}  // namespace fat
