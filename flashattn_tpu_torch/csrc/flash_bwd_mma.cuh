// The bf16 dK/dV tile of the flash-attention backward on the tensor cores,
// shared by B3's fused kernel (flash_bwd_fused.cu) and B5's dK/dV kernel
// (flash_bwd.cu). float32 keeps the CUDA-core tile of flash_bwd.cuh.
//
// One CTA owns a 64-row kv tile of one kv head of one batch row; warp w of
// its 4 row warps owns kv rows [16w, 16w+16) of it. At D 256 a warp's dK and
// dV (16 x 256 fp32 each) would not fit its registers beside S^T and dP^T,
// so the CTA has 8 warps: warps w and w + 4 share rows [16w, 16w+16), each
// computes S^T, P^T, dP^T and dS^T of them in full and keeps dK and dV of
// one half of D (as K2 splits O at D 256). The CTA walks the
// q heads of the GQA group and, for each, the q tiles with a row that sees
// the tile (kBr rows a q tile: 64 at D 64, 32 at D 128 and 256): from the causal
// bound's first row and, with a sliding window, up to the last row whose
// window reaches the tile. kMask (flash_bwd.cuh's MaskKind) instantiates
// the window, or segment ids with a window when one is given: a q tile whose
// id range (the 32-position block ranges of common.cuh) is disjoint from
// the kv tile's is loaded but not computed, a pair of one id runs no id
// mask, the others compare ids element by element (the q tile's arrive with
// its LSE, a thread's two kv rows' stay in registers); with kNoMask the tile
// is the causal kernel's alone. Per tile pair, on
// mma.sync m16n8k16 with fp32 accumulators:
//
//   S^T = K Q^T, dP^T = V dO^T      A: K, V; B: Q, dO rows (ldmatrix)
//   P^T = exp2(S^T scale_log2 - lse2), dS^T = P^T (dP^T - delta), masked;
//   with the soft-cap (kCap; scale_log2 then scale / cap) t = tanh(S^T
//   scale_log2) by the forward's tanh (common.cuh softcap_tanh), P^T =
//   exp2(t cap_log2 - lse2), and dS^T times (1 - t)(1 + t); with ALiBi
//   (kAlibi, never with kCap) the logit is S^T scale_log2 plus the bias
//   K1 formed (flash_bwd.cuh fwd_tile_n): a thread's two kv rows (the
//   bias's columns) keep their column terms for the CTA's life, its q
//   columns (the bias's rows) take their row terms once a tile pair, each
//   score one FMA for the bias and one for the scale; dS^T keeps its formula;
//   with dropout (kDropout) K1's keep mask M (common.cuh dropout_keep, its
//   column a thread's kv row, fixed for the CTA's life, its row the q
//   column, whose term is formed once a tile pair): dP^T becomes
//   c M dP^T (c = 1 / (1 - rate)) before dS^T, P^T meets dO as M P^T
//   and c is folded into dV's write
//   dV += P^T dO, dK += dS^T Q      A: P^T and dS^T from the accumulators,
//                                   rounded to bf16; B: dO, Q (ldmatrix.trans)
//   fused only: dS^T to shared memory (bf16), dQ_tile = scale dS K
//   (A: dS^T by ldmatrix.trans, B: K by ldmatrix.trans), added to dq_acc
//   with one float4 atomicAdd per 4 entries.
//
// Operands stay bf16 in shared memory with rows padded by 16 bytes, so each
// 8-row phase of an ldmatrix reads 32 distinct banks. Q, dO, LSE and delta of
// the next q tile arrive by cp.async in a second buffer while the current
// one computes: one barrier a tile pair (two when fused). At D 64 the K and
// V fragments stay in registers for the CTA's life (not in the fused
// kernel with ALiBi); at D 128 they are read from shared memory per k-step,
// which keeps dK, dV, S^T and dP^T in registers without spills. dK and dV stay in registers until one write
// each (scale applied to dK); kv rows that no q row sees are written as 0.
//
// Head dims: D is the compiled tile (64, 128 or 256); the true head dim d
// (32 in the 64 tile, 80 and 96 in the 128 tile; common.cuh head_tile)
// comes at run time. K, V, Q and dO rows are d elements apart in device
// memory and their columns from d to D arrive as zeros (load_tile_async's
// zero fill), so S^T and dP^T are those of d; dK's, dV's and dQ's columns
// from d to D are then zeros and are never stored.
//
// Shared memory: 65,536 B (fused) or 56,320 B (dK/dV) at D 64; 75,264 B or
// 70,144 B at D 128; 140,800 B or 135,680 B at D 256; segment ids add 512 B
// at D 64, 256 B at D 128 and 256. Registers and spills: the compiler report
// (chip_smoke.py phase 1).
#pragma once

#include "flash_bwd.cuh"

namespace fat {
namespace bwd {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // warps a 16-row group each, over a CTA's kv rows
constexpr int kThreads = 32 * kWarps;
constexpr int kBc = 16 * kWarps;  // kv rows a CTA

template <int D>
__host__ __device__ constexpr int q_rows() {
  return D == 64 ? 64 : 32;
}

// Warps that share each 16-row group, each with D / halves() of dK and dV.
template <int D>
__host__ __device__ constexpr int halves() {
  return D == 256 ? 2 : 1;
}

// Threads of the dK/dV tile's CTA.
template <int D>
__host__ __device__ constexpr int threads() {
  return kThreads * halves<D>();
}

template <int D, bool kFusedDq, int kMask>
constexpr size_t smem_bytes() {
  constexpr int kBr = q_rows<D>();
  return sizeof(bf16) * (2 * kBc * (D + 8)                   // K, V
                         + 2 * 2 * kBr * (D + 8)             // Q, dO: two buffers each
                         + (kFusedDq ? kBc * (kBr + 8) : 0))  // dS^T
         + sizeof(float) * 2 * 2 * kBr                       // LSE, delta: two buffers each
         + (kMask == kSegmentMask ? sizeof(int) * 2 * kBr : 0);  // segment ids: two buffers
}

// Rows [0, n_rows) of a [kRows][D] bf16 tile whose rows are d elements
// apart in device memory (d <= D, common.cuh head_tile) into shared memory
// with row stride D + 8, by cp.async from kNThreads threads; rows past
// n_rows and the columns at and past d are zeros. The copy is issued for
// every chunk, zero-filled (cp_async16's valid = false) where there is no
// data, never skipped: a skipped chunk would keep the previous tile's
// values and enter the dot products over D.
template <int kRows, int D, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src, int n_rows, int d,
                                                bf16* __restrict__ dst) {
  constexpr int kChunksPerRow = D / 8;
  constexpr int kChunks = kRows * kChunksPerRow;
  static_assert(kChunks % kNThreads == 0, "whole 16-byte chunks for every thread");
  static_assert(kNThreads % kChunksPerRow == 0, "a thread keeps its column");
  constexpr int kRowStep = kNThreads / kChunksPerRow;
  const int row0 = threadIdx.x / kChunksPerRow, col = (threadIdx.x % kChunksPerRow) * 8;
  const bool col_ok = col < d;
  const bf16* from = src + row0 * d + col;
#pragma unroll
  for (int j = 0; j < kChunks / kNThreads; ++j) {
    const int row = row0 + j * kRowStep;
    const bool valid = row < n_rows && col_ok;
    cp_async16(dst + row * (D + 8) + col, valid ? from : src, valid);
    from += kRowStep * d;
  }
}

// The contract of flash_bwd.cuh's dkv_tile, for bf16, with the grid
// (Hkv, B, kv tiles): blockIdx.z walks the kv tiles, so that a causal
// call's heavy tiles (the first ones) are dispatched first. With kFusedDq
// the dQ contributions are added with scale applied. kNoMask reads neither
// the window nor the segment ids (window 0, seg_q/seg_k null), kWindowMask
// not the ids. Without kCap, cap_log2 is not read; without kAlibi, slopes
// ([Hq] float32) are not; without kDropout, drop is not.
template <int D, bool kFusedDq, int kMask, bool kCap, bool kAlibi, bool kDropout>
__device__ __forceinline__ void dkv_tile(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, float* __restrict__ dq_acc,
                                         const int* __restrict__ seg_q,
                                         const int* __restrict__ seg_k,
                                         const int2* __restrict__ ranges_q,
                                         const int2* __restrict__ ranges_k,
                                         const float* __restrict__ slopes, int Hq, int Hkv,
                                         int Sq, int Sk, int d, int is_causal, int offset,
                                         int window, float scale, float scale_log2,
                                         float cap_log2, const Dropout& drop) {
  static_assert(!(kCap && kAlibi), "ALiBi takes no soft-cap");
  constexpr int kBr = q_rows<D>();
  constexpr int kNThreads = threads<D>();
  constexpr int kNWarps = kNThreads / 32;
  constexpr int KP = D + 8;        // row stride of the K, V, Q and dO tiles
  constexpr int SP = kBr + 8;      // row stride of dS^T
  constexpr int kDSteps = D / 16;  // k-steps of S^T and dP^T
  constexpr int kQTiles = kBr / 8;  // their n-tiles
  constexpr int kQSteps = kBr / 16;  // k-steps of dV and dK
  constexpr int kDTiles = D / 8 / halves<D>();  // their n-tiles: this warp's part of D
  // K's and V's A fragments stay in registers at D 64, but not beside
  // ALiBi's terms or dropout's in the fused kernel (with ALiBi and segment
  // ids it spilled 20 bytes): there they are read per k-step, as at D 128.
  constexpr bool kResident = D == 64 && !(kFusedDq && (kAlibi || kDropout));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBc * KP;
  bf16* qs = vs + kBc * KP;     // [2][kBr][KP]
  bf16* dos = qs + 2 * kBr * KP;  // [2][kBr][KP]
  bf16* dst = dos + 2 * kBr * KP;  // [kBc][SP], fused only
  float* lses = reinterpret_cast<float*>(dst + (kFusedDq ? kBc * SP : 0));  // [2][kBr]
  float* deltas = lses + 2 * kBr;
  int* segs = reinterpret_cast<int*>(deltas + 2 * kBr);  // [2][kBr], kSegmentMask

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, thread in group
  // This warp's kv rows in the tile and its first dK/dV column.
  const int wrow = (halves<D>() == 1 ? warp : warp % kWarps) * 16;
  const int dcol = halves<D>() == 1 ? 0 : (warp / kWarps) * 8 * kDTiles;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * kBc;
  const int group = Hq / Hkv;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * d;

  // Causal: q row qi sees column kv0 iff qi >= kv0 - offset, so q tiles
  // before the one holding that row contribute nothing.
  const int n_q_tiles = (Sq + kBr - 1) / kBr;
  const int first_row = is_causal ? max(0, kv0 - offset) : 0;
  const int q_begin = first_row >= Sq ? n_q_tiles : first_row / kBr;
  // Window: q row qi sees kv row kv0 + kBc - 1 only if
  // qi <= kv0 + kBc - 1 - offset + window - 1, so later q tiles contribute nothing.
  int q_end = n_q_tiles;
  if (kMask != kNoMask && window > 0) {
    const int last_row = kv0 + kBc - 1 - offset + window - 1;
    q_end = last_row < 0 ? 0 : min(n_q_tiles, last_row / kBr + 1);
  }
  const bool seg = kMask == kSegmentMask && seg_q != nullptr;
  const int* seg_q_row = seg ? seg_q + static_cast<size_t>(b) * Sq : nullptr;
  const int n_live = max(0, q_end - q_begin);
  const int n_iters = group * n_live;  // iteration i: q head i / n_live, q tile i % n_live

  // Row (b, h, q0) of the [B, Hq, Sq] statistics for iteration it.
  auto stat_row = [&](int it, int& q0) {
    q0 = (q_begin + it % n_live) * kBr;
    return (static_cast<size_t>(b) * Hq + hk * group + it / n_live) * Sq + q0;
  };
  auto load_q_tile = [&](int it) {
    int q0;
    const size_t row = stat_row(it, q0);
    const int buf = it & 1;
    load_tile_async<kBr, D, kNThreads>(q + row * d, Sq - q0, d, qs + buf * kBr * KP);
    load_tile_async<kBr, D, kNThreads>(dout + row * d, Sq - q0, d, dos + buf * kBr * KP);
    if (tid < 2 * kBr) {
      const int r = tid % kBr;
      const bool valid = q0 + r < Sq;
      const float* src = tid < kBr ? lse : delta;
      float* to = (tid < kBr ? lses : deltas) + buf * kBr + r;
      cp_async4(to, src + (valid ? row + r : 0), valid);
    }
    if (seg && tid < kBr) {
      const bool valid = q0 + tid < Sq;
      cp_async4(segs + buf * kBr + tid, seg_q_row + (valid ? q0 + tid : 0), valid);
    }
  };

  // K's, V's, Q's and dO's columns from d to D are zeros: S^T and dP^T take
  // nothing from them, so dK's, dV's and dQ's columns there are zeros too,
  // and none of them is stored.
  load_tile_async<kBc, D, kNThreads>(k + kv_base + static_cast<size_t>(kv0) * d, Sk - kv0, d, ks);
  load_tile_async<kBc, D, kNThreads>(v + kv_base + static_cast<size_t>(kv0) * d, Sk - kv0, d, vs);
  if (n_iters > 0) load_q_tile(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int a_off = wrow * KP + lane_offset<true>(lane, KP);  // this warp's K/V A fragments
  unsigned kf[kResident ? kDSteps : 1][4], vf[kResident ? kDSteps : 1][4];
  if constexpr (kResident) {
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      ldsm_x4(kf[kk], ks + a_off + kk * 16);
      ldsm_x4(vf[kk], vs + a_off + kk * 16);
    }
  }

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int kv_r0 = kv0 + wrow + g;  // this thread's kv rows: kv_r0, kv_r0 + 8
  int kv_seg[2] = {0, 0};            // and their segment ids
  int2 kv_ids{};                     // the kv tile's id range
  const int2* q_ranges = nullptr;
  if (seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kv_r0 + 8 * i;
      kv_seg[i] = kr < Sk ? __ldg(seg_k + static_cast<size_t>(b) * Sk + kr) : 0;
    }
    kv_ids = id_range(ranges_k + static_cast<size_t>(b) * range_blocks(Sk), kv0, kBc, Sk);
    q_ranges = ranges_q + static_cast<size_t>(b) * range_blocks(Sq);
  }
  // ALiBi's terms as K1 forms them: this thread's kv rows kv_r0 + 8i are
  // the bias's columns, each with its offset in K1's tile, alibi_inner
  // (kv0 and wrow are multiples of 16, so every one shares its tile's start
  // and its 2t = g & 6); a q row r's row term is slope_log2 * (col_base - r).
  float alibi_col[2] = {0.f, 0.f};
  int col_base = 0;
  if constexpr (kAlibi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) alibi_col[i] = static_cast<float>(alibi_inner<D>(kv_r0 + 8 * i));
    col_base = kv_r0 - alibi_inner<D>(kv_r0) - offset;
  }
  // Dropout's column terms: this thread's kv rows kv_r0 + 8i.
  unsigned drop_col[2] = {0u, 0u};
  if constexpr (kDropout) {
#pragma unroll
    for (int i = 0; i < 2; ++i) drop_col[i] = dropout_col(kv_r0 + 8 * i);
  }
  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n_iters) load_q_tile(it + 1);
    cp_async_commit();
    int q0;
    const size_t row0 = stat_row(it, q0);
    const int buf = it & 1;
    const bf16* qb = qs + buf * kBr * KP;
    const bf16* dob = dos + buf * kBr * KP;
    const float* lseb = lses + buf * kBr;
    const float* deltab = deltas + buf * kBr;
    const int* segb = segs + buf * kBr;
    const float slope_log2 = kAlibi ? slope_log2_of(slopes, hk * group + it / n_live) : 0.f;
    const unsigned drop_head =
        kDropout ? dropout_head(drop, b * Hq + hk * group + it / n_live) : 0u;
    bool seg_mask = false;  // the tile pair needs the id mask
    if constexpr (kMask == kSegmentMask) {
      if (seg) {
        const int2 q_ids = id_range(q_ranges, q0, kBr, Sq);
        if (!ids_meet(q_ids, kv_ids)) continue;  // other documents only
        seg_mask = !one_id(q_ids, kv_ids);
      }
    }

    // S^T and dP^T: this warp's 16 kv rows against the tile's kBr q columns.
    float s[kQTiles][4], dp[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const int b_off = lane_offset<false>(lane, KP);
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      unsigned ka[4], va[4];
      if constexpr (kResident) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ka[i] = kf[kk][i], va[i] = vf[kk][i];
      } else {
        ldsm_x4(ka, ks + a_off + kk * 16);
        ldsm_x4(va, vs + a_off + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < kQTiles / 2; ++jp) {
        unsigned bq[4], bd[4];
        ldsm_x4(bq, qb + 16 * jp * KP + kk * 16 + b_off);
        ldsm_x4(bd, dob + 16 * jp * KP + kk * 16 + b_off);
        mma_16816(s[2 * jp], ka, bq[0], bq[1]);
        mma_16816(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma_16816(dp[2 * jp], va, bd[0], bd[1]);
        mma_16816(dp[2 * jp + 1], va, bd[2], bd[3]);
      }
    }

    // Element e of fragment j: kv row kv_r0 + 8 (e / 2), q column
    // 8j + 2 tig + e % 2. P and dS in fp32, rounded to bf16 as the A
    // fragments of dV and dK (fragment j is half of k-step j / 2).
    bool edge = q0 + kBr > Sq || kv0 + kBc > Sk || (is_causal && kv0 + kBc - 1 > q0 + offset);
    if constexpr (kMask != kNoMask)  // the window's left edge crosses the tile, or two ids meet
      edge = edge || seg_mask || (window > 0 && q0 + kBr - 1 + offset - window + 1 > kv0);
    unsigned pa[kQSteps][4], dsa[kQSteps][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 l = *reinterpret_cast<const float2*>(lseb + c);
      const float2 dl = *reinterpret_cast<const float2*>(deltab + c);
      const float lse2[2] = {lse_log2(l.x), lse_log2(l.y)};
      const float dlt[2] = {dl.x, dl.y};
      float row_term[2] = {0.f, 0.f};  // ALiBi's, of q rows q0 + c and q0 + c + 1
      if constexpr (kAlibi) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
          row_term[x] = slope_log2 * static_cast<float>(col_base - (q0 + c + x));
      }
      unsigned drop_row[2] = {0u, 0u};  // dropout's, of q rows q0 + c and q0 + c + 1
      if constexpr (kDropout) {
#pragma unroll
        for (int x = 0; x < 2; ++x) drop_row[x] = dropout_row(q0 + c + x, drop_head);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;  // dropout: dP^T to c M dP^T here, P^T to M P^T below
        if constexpr (kDropout) {
          keep = dropout_keep(drop_row[e & 1], drop_col[e >> 1], drop.threshold);
          dp[j][e] = keep ? dp[j][e] * drop.scale : 0.f;
        }
        bool live = true;
        if (edge) {
          const int qi = q0 + c + (e & 1), kr = kv_r0 + 8 * (e >> 1);
          live = qi < Sq && kr < Sk && (!is_causal || kr <= qi + offset);
          if constexpr (kMask != kNoMask)
            live = live && (window == 0 || kr >= qi + offset - window + 1) &&
                   (!seg_mask || segb[c + (e & 1)] == kv_seg[e >> 1]);
        }
        if constexpr (kCap) {  // p_and_ds's arithmetic, written out as the uncapped one is
          const float tc = softcap_tanh(s[j][e] * scale_log2);
          const float p = live ? exp2f(tc * cap_log2 - lse2[e & 1]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt[e & 1]) * ((1.f - tc) * (1.f + tc));
        } else if constexpr (kAlibi) {  // K1's logit: fmaf(s, scale, fmaf(slope, inner, row))
          const float x = fmaf(s[j][e], scale_log2,
                               fmaf(slope_log2, alibi_col[e >> 1], row_term[e & 1]));
          const float p = live ? exp2f(x - lse2[e & 1]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt[e & 1]);
        } else {
          const float p = live ? exp2f(s[j][e] * scale_log2 - lse2[e & 1]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt[e & 1]);
        }
        if constexpr (kDropout) s[j][e] = keep ? s[j][e] : 0.f;
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(s[j][0], s[j][1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[j][2], s[j][3]);
      dsa[j / 2][2 * (j % 2)] = pack_bf16(dp[j][0], dp[j][1]);
      dsa[j / 2][2 * (j % 2) + 1] = pack_bf16(dp[j][2], dp[j][3]);
      if constexpr (kFusedDq) {
        if (halves<D>() == 1 || warp < kWarps) {  // one warp of each row group writes dS^T
          bf16* r = dst + (wrow + g) * SP + c;
          *reinterpret_cast<unsigned*>(r) = dsa[j / 2][2 * (j % 2)];
          *reinterpret_cast<unsigned*>(r + 8 * SP) = dsa[j / 2][2 * (j % 2) + 1];
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warp's columns, two n-tiles a step.
    const int t_off = lane_offset<true>(lane, KP);
#pragma unroll
    for (int kk = 0; kk < kQSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        unsigned bo[4], bq[4];
        ldsm_x4_t(bo, dob + 16 * kk * KP + dcol + 16 * np + t_off);
        ldsm_x4_t(bq, qb + 16 * kk * KP + dcol + 16 * np + t_off);
        mma_16816(dv_acc[2 * np], pa[kk], bo[0], bo[1]);
        mma_16816(dv_acc[2 * np + 1], pa[kk], bo[2], bo[3]);
        mma_16816(dk_acc[2 * np], dsa[kk], bq[0], bq[1]);
        mma_16816(dk_acc[2 * np + 1], dsa[kk], bq[2], bq[3]);
      }
    }

    if constexpr (kFusedDq) {
      __syncthreads();  // every warp's rows of dS^T are written
      // dQ of the tile = scale dS K: warps split the kBr q rows into 16-row
      // groups and, when fewer groups than warps, D into column groups; at
      // D 128 and 256 a warp's 64 columns go in two passes, which keeps its
      // registers within the file.
      constexpr int kRowGroups = kBr / 16;
      constexpr int kCols = D * kRowGroups / kNWarps;
      constexpr int kPass = D == 64 ? kCols : 32;
      const int qr = (warp % kRowGroups) * 16;
      const bool odd = tig & 1;
      const int qi = q0 + qr + g + (odd ? 8 : 0);
#pragma unroll 1
      for (int dc = (warp / kRowGroups) * kCols, end = dc + kCols; dc < end; dc += kPass) {
        float acc[kPass / 8][4];
#pragma unroll
        for (int n = 0; n < kPass / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk) {
          unsigned a[4];
          ldsm_x4_t(a, dst + 16 * kk * SP + qr + lane_offset<false>(lane, SP));
#pragma unroll
          for (int np = 0; np < kPass / 16; ++np) {
            unsigned bk[4];
            ldsm_x4_t(bk, ks + 16 * kk * KP + dc + 16 * np + t_off);
            mma_16816(acc[2 * np], a, bk[0], bk[1]);
            mma_16816(acc[2 * np + 1], a, bk[2], bk[3]);
          }
        }
        // Lanes tig and tig ^ 1 trade halves, so that each adds four
        // consecutive entries of one row: row g for even tig, g + 8 for odd.
        float* out = dq_acc + (row0 - q0 + qi) * d + dc + 2 * (tig & ~1);
#pragma unroll
        for (int n = 0; n < kPass / 8; ++n) {
          const float y0 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][0] : acc[n][2], 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][1] : acc[n][3], 1);
          const float4 val = odd ? make_float4(y0, y1, acc[n][2], acc[n][3])
                                 : make_float4(acc[n][0], acc[n][1], y0, y1);
          // dq_acc is d wide: columns dc + 8n .. + 7 at and past d hold
          // zeros and are not added (d a multiple of 16).
          if (qi < Sq && dc + 8 * n < d)
            atomicAdd(reinterpret_cast<float4*>(out + 8 * n),
                      make_float4(val.x * scale, val.y * scale, val.z * scale, val.w * scale));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kv_r0 + 8 * i;
    if (kr >= Sk) continue;
    bf16* dk_row = dk + kv_base + static_cast<size_t>(kr) * d + dcol + 2 * tig;
    bf16* dv_row = dv + kv_base + static_cast<size_t>(kr) * d + dcol + 2 * tig;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      if (dcol + 8 * n >= d) continue;  // zeros past the head dim, not stored
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      if constexpr (kDropout)  // c of c M P^T
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * n) = __floats2bfloat162_rn(
            dv_acc[n][2 * i] * drop.scale, dv_acc[n][2 * i + 1] * drop.scale);
      else
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * n) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

}  // namespace mma
}  // namespace bwd
}  // namespace fat
