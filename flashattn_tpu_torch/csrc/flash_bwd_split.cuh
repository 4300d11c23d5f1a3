// Flash-attention backward, split path, for Hopper (sm_90a): the dQ kernel
// (with delta) and the dK/dV kernel, run one after the other. Five
// libraries build from this header: flash_bwd.cu (every instantiation
// without ALiBi, dropout or the offset read on the card), flash_bwd_alibi.cu
// (ALiBi's), flash_bwd_dropout.cu (dropout's, with ALiBi or without),
// flash_bwd_dynoff.cu (kDyn's: the q/k alignment read on the card once a
// CTA, not causal, the window's left edge, ALiBi, the soft-cap, every D and
// dtype; the walks start from it) and flash_bwd_dynoff_dropout.cu (kDyn's
// with dropout), compiled side by side.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dq_kernel (B4)
// and ::_dkv_kernel (B5) (launcher flash_attention_backward, :467) on the
// plain subset: causal (bottom-right, or by pos_offset) or not, GQA, ragged
// S_q/S_k, rows that see no key, the sliding window, packed-document
// segment ids, the logit soft-cap (its exact tanh derivative) and ALiBi, at
// D 64, 128 and 256, and at D 32, 80 and 96 inside those tiles (the true
// head dim at run time, common.cuh head_tile). The TPU's wavefront meta arrays and its pre-scaled
// operands are Mosaic designs and are not carried over.
//
// What bounds it on the card: at the training shapes (S 2048, D 64) each
// q tile of the dQ kernel and each kv tile of the dK/dV kernel recompute
// S and dP over tens of tiles, so the work is arithmetic (about 2.5x the
// forward's FLOPs over the two kernels); HBM traffic is Q, K, V, O, dO once
// per tile pair. In bf16 both kernels run on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators, bf16 operands in shared memory by ldmatrix,
// cp.async double buffers), so they are bound by the rate of mma.sync, the
// exp2 of P and the one barrier a tile pair; wgmma, which alone reaches the
// card's full rate, is later work. float32 runs both on the CUDA cores in
// fp32 over shared-memory tiles (flash_bwd.cuh), bound by shared-memory
// loads (about one per FMA).
//
// What the design does about it: one CTA per (64-row q tile, q head, batch)
// for dQ, the kv loop cut at the tile's causal bound (and, with a window,
// started at the tile of its first row's left edge), heavy causal tiles
// launched first. In bf16 (flash_bwd_dq_mma_kernel, FA2's dQ kernel) warp w
// owns q rows [16w, 16w+16): Q and dO stay in shared memory (their A
// fragments in registers at D 64), K and V tiles of 64 rows stream through a
// cp.async double buffer, S = Q K^T and dP = dO V^T land in accumulators,
// dS = P (dP - delta) is rounded to bf16 in the A-fragment layout straight
// from them (as K1 feeds P to P.V), and dQ += dS K accumulates in registers
// until one write with the scale applied. One CTA per (64-row kv tile, kv
// head, batch) for dK/dV (flash_bwd_mma.cuh in bf16), looping over the GQA
// group's q heads and the live q tiles, dK and dV in registers until one
// write. The window and segment ids are instantiated apart (kMask,
// flash_bwd.cuh's MaskKind): the kernels without them run no code of
// theirs, the windowed ones none of the ids'. With segment ids a tile pair
// whose id ranges (the 32-position block ranges of common.cuh) are
// disjoint is loaded but not computed, a pair of one id runs no id mask,
// and the others compare ids element by element (the kv tile's staged in
// shared memory with it). No atomics: two runs give bitwise-equal outputs,
// which makes this the deterministic path. The soft-cap is a template flag
// of the bf16 kernels (kCap, flash_bwd_mma.cuh): the uncapped ones run none
// of its code; so is ALiBi (kAlibi, never with kCap), whose bias each score
// takes as K1 formed it (flash_bwd.cuh fwd_tile_n: the row terms once a
// tile, one FMA a score), in a library of its own (flash_bwd_alibi.cu), so
// that the instantiations without it keep their code (a runtime flag
// shared by every instantiation slowed the windowed kernels by 23-55 %,
// PERF.md). The float32
// kernels take ALiBi as a runtime argument (flash_bwd.cuh p_and_ds).
// Dropout (the JAX kernels' at flash_bwd.py:253-263 and :396-437) is a
// template flag of every kernel (kDropout), instantiated in its library
// alone: the forward's keep mask rebuilt from the seed (common.cuh
// dropout_keep); the dQ kernel takes dP to c M dP before dS (c = 1 / (1 -
// rate)), its rows' hash terms formed once a CTA and its columns' once a
// tile; the dK/dV tile as flash_bwd_mma.cuh says. At
// D 256 the bf16 dQ kernel streams 32-row kv tiles (a warp's
// 16 x 256 fp32 dQ fills half its registers) and the dK/dV tile runs 8 warps
// (flash_bwd_mma.cuh); the float32 kernels use 32-row tiles (Tile<256>).
#pragma once

#include <type_traits>

#include "flash_bwd_mma.cuh"

namespace {

using fat::bwd::kThreadsPerRow;
using fat::bwd::Tile;

template <int D>
constexpr size_t dq_smem_bytes() {
  // qs, dos (the q tile), ks, vs (the kv tile), [D+1] rows; dS [kRows][kPP].
  return sizeof(float) * (4 * Tile<D>::kRows * (D + 1) + Tile<D>::kRows * Tile<D>::kPP);
}

// dQ of one q tile of one q head, and delta = rowsum(dO * O) of its rows,
// written to delta [B, Hq, Sq] for the dK/dV kernel. Rows that see no key
// get dQ = 0. float32; bf16 runs flash_bwd_dq_mma_kernel.
template <typename T, int D, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(Tile<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, const float* __restrict__ slopes, int Hq,
                    int Hkv, int Sq, int Sk, int d, int is_causal, int offset_arg, int window,
                    float scale, float scale_log2, float cap_log2, const fat::Dropout drop,
                    const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment is read from the card; the kv walk starts from it.
  const int offset = kDyn ? __ldg(dyn_offset) : offset_arg;
  constexpr int kBlock = Tile<D>::kRows;
  constexpr int kThreads = Tile<D>::kThreads;
  constexpr int kPP = Tile<D>::kPP;
  constexpr int kColsPerThread = Tile<D>::kCols;
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
  const float slope_log2 = fat::bwd::slope_log2_of(slopes, h);
  const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  const size_t q_base = stat_base * d;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * d;
  const int qi = q0 + r;
  const int row_seg = seg_q != nullptr && qi < Sq ? seg_q[static_cast<size_t>(b) * Sq + qi] : 0;
  const unsigned drop_row =
      kDropout ? fat::dropout_row(qi, fat::dropout_head(drop, b * Hq + h)) : 0u;

  // Columns from d to D load as zeros (common.cuh head_tile): S and dP take
  // nothing from them, dQ's columns there stay 0 and are not stored.
  fat::load_tile<T, kBlock, D, kThreads>(q + q_base + static_cast<size_t>(q0) * d, Sq - q0, d, qs,
                                         DP);
  fat::load_tile<T, kBlock, D, kThreads>(dout + q_base + static_cast<size_t>(q0) * d, Sq - q0, d,
                                         dos, DP);

  // delta of row qi: each of its four threads sums D/4 products, then the quad.
  float row_delta = 0.f, lse2 = CUDART_INF_F;
  if (qi < Sq) {
    const T* orow = o + q_base + static_cast<size_t>(qi) * d + t;
    const T* dorow = dout + q_base + static_cast<size_t>(qi) * d + t;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      if (t + kThreadsPerRow * i < d)
        row_delta = fmaf(fat::to_f(dorow[kThreadsPerRow * i]),
                         fat::to_f(orow[kThreadsPerRow * i]), row_delta);
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

  // With a window the first kv tile is that of the tile's first row's left edge.
  const int n_first = window > 0 ? max(0, q0 + offset - window + 1) / kBlock * kBlock : 0;
  for (int n0 = n_first; n0 < kv_end; n0 += kBlock) {
    __syncthreads();  // previous kv tile consumed (and Q, dO stored, first time)
    const size_t tile = kv_base + static_cast<size_t>(n0) * d;
    fat::load_tile<T, kBlock, D, kThreads>(k + tile, kv_end - n0, d, ks, DP);
    fat::load_tile<T, kBlock, D, kThreads>(v + tile, kv_end - n0, d, vs, DP);
    __syncthreads();

    // S and dP: q row r against kv columns t + 4j.
    float s[kColsPerThread], dp[kColsPerThread];
    fat::bwd::two_score_rows<D>(qs, dos, ks, vs, r, t, s, dp);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = t + kThreadsPerRow * j;
      const int col = n0 + c;
      const bool live = col < kv_end && (!is_causal || col <= qi + offset) &&
                        (window == 0 || col >= qi + offset - window + 1) &&
                        (seg_k == nullptr || seg_k[static_cast<size_t>(b) * Sk + col] == row_seg);
      if constexpr (kDropout)  // dS = P (c M dP - delta)
        dp[j] = fat::dropout_keep(drop_row, fat::dropout_col(col), drop.threshold)
                    ? dp[j] * drop.scale
                    : 0.f;
      dss[r * kPP + c] = fat::round_to<T>(fat::bwd::p_and_ds(
          s[j], dp[j], row_delta, lse2, live, scale_log2, cap_log2, slope_log2, col - qi - offset).y);
    }
    __syncwarp();  // row r's four threads wrote all of its dS
    fat::bwd::row_times_tile<D>(dss, r, t, ks, acc);  // dQ += dS K
  }

  if (qi < Sq) {
    T* row = dq + q_base + static_cast<size_t>(qi) * d + t;
#pragma unroll
    for (int i = 0; i < kDims; ++i)  // zeros past the head dim, not stored
      if (t + kThreadsPerRow * i < d) row[kThreadsPerRow * i] = fat::from_f<T>(acc[i] * scale);
  }
}

namespace dq_mma {

constexpr int kBr = 64;  // q rows a CTA, 16 a warp

// kv rows a tile: 32 at D 256, where a warp's dQ takes 128 registers.
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D == 256 ? 32 : 64;
}

template <int D, int kMask>
constexpr size_t smem_bytes() {
  // Q, dO [kBr][D+8]; K, V [2][kBc][D+8] (bf16); LSE (log2) and delta [kBr];
  // with segment ids the kv tiles' ids [2][kBc].
  constexpr int kBc = kv_rows<D>();
  return sizeof(__nv_bfloat16) * (2 * kBr + 4 * kBc) * (D + 8) + sizeof(float) * 2 * kBr +
         (kMask == fat::bwd::kSegmentMask ? sizeof(int) * 2 * kBc : 0);
}

}  // namespace dq_mma

// The contract of flash_bwd_dq_kernel, for bf16, on the tensor cores.
// kNoMask reads neither the window nor the segment ids (window 0,
// seg_q/seg_k null), kWindowMask not the ids; kCap the soft-cap, kAlibi
// ALiBi (as the dK/dV tile of flash_bwd_mma.cuh) and kDropout dropout;
// cap_log2, slopes and drop are not read without them.
template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
__device__ __forceinline__ void
dq_mma_cta(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                        const int2* __restrict__ ranges_q, const int2* __restrict__ ranges_k,
                        const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk,
                        int d, int is_causal, int offset_arg, int window, float scale,
                        float scale_log2, float cap_log2, const fat::Dropout drop,
                        const int* __restrict__ dyn_offset) {
  static_assert(!(kCap && kAlibi), "ALiBi takes no soft-cap");
  // kDyn: the q/k alignment is read from the card; the kv walk starts from it.
  const int offset = kDyn ? __ldg(dyn_offset) : offset_arg;
  using bf16 = __nv_bfloat16;
  using dq_mma::kBr;
  constexpr int kBc = dq_mma::kv_rows<D>();
  using fat::bwd::mma::load_tile_async;
  constexpr int KP = D + 8;           // row stride of every tile
  constexpr int kDSteps = D / 16;     // k-steps of S and dP
  constexpr int kKvTiles = kBc / 8;   // their n-tiles
  constexpr int kKvSteps = kBc / 16;  // k-steps of dQ
  constexpr int kDTiles = D / 8;      // its n-tiles
  constexpr bool kResident = D == 64;  // Q and dO A fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBr * KP;
  bf16* ks = dos + kBr * KP;      // [2][kBc][KP]
  bf16* vs = ks + 2 * kBc * KP;   // [2][kBc][KP]
  float* lse2s = reinterpret_cast<float*>(vs + 2 * kBc * KP);
  float* deltas = lse2s + kBr;
  int* segs = reinterpret_cast<int*>(deltas + kBr);  // [2][kBc], kSegmentMask

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, thread in group
  const int wrow = warp * 16;              // this warp's q rows in the tile
  // Causal tiles late in the sequence run the longest kv loops: launch them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBr;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  const size_t q_base = stat_base * d;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * d;

  // Columns [0, kv_end) can be visible to some row of the tile.
  int kv_end = Sk;
  if (is_causal) kv_end = max(0, min(Sk, min(q0 + kBr, Sq) - 1 + offset + 1));
  // The kv loop visits tiles [first, first + n_tiles): with a window from the
  // tile of the first row's left edge.
  const int first =
      kMask != fat::bwd::kNoMask && window > 0 ? max(0, q0 + offset - window + 1) / kBc : 0;
  const int n_tiles = max(0, (kv_end + kBc - 1) / kBc - first);
  const bool seg = kMask == fat::bwd::kSegmentMask && seg_q != nullptr;
  const int* seg_k_row = seg ? seg_k + static_cast<size_t>(b) * Sk : nullptr;
  // K, V (and their segment ids) of loop iteration `it` into buffer it & 1.
  const bf16* k_head = k + kv_base;
  const bf16* v_head = v + kv_base;
  auto load_kv = [&](int it) {
    const int n1 = (first + it) * kBc;
    const int nb = it & 1;
    load_tile_async<kBc, D>(k_head + n1 * d, kv_end - n1, d, ks + nb * kBc * KP);
    load_tile_async<kBc, D>(v_head + n1 * d, kv_end - n1, d, vs + nb * kBc * KP);
    if (seg && tid < kBc) {
      const bool valid = n1 + tid < kv_end;
      fat::cp_async4(segs + nb * kBc + tid, seg_k_row + (valid ? n1 + tid : 0), valid);
    }
  };

  // Q's, dO's, K's and V's columns from d to D are zeros (common.cuh
  // head_tile): S and dP take nothing from them, dQ's columns there are
  // zeros and are not stored.
  load_tile_async<kBr, D>(q + q_base + static_cast<size_t>(q0) * d, Sq - q0, d, qs);
  load_tile_async<kBr, D>(dout + q_base + static_cast<size_t>(q0) * d, Sq - q0, d, dos);
  if (n_tiles > 0) load_kv(0);
  fat::cp_async_commit();

  // delta of each row from O and dO in fp32: two threads a row, D/2 entries
  // each by 16-byte loads (those below d), then the pair; rows past Sq get 0
  // and LSE +inf.
  {
    const int r = tid / 2, qi = q0 + r;
    float acc = 0.f;
    if (qi < Sq) {
      const int c0 = (tid % 2) * (D / 2);  // this thread's first column
      const size_t at = q_base + static_cast<size_t>(qi) * d + c0;
      const uint4* orow = reinterpret_cast<const uint4*>(o + at);
      const uint4* dorow = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        if (c0 + 8 * c >= d) continue;
        float ov[8], dov[8];
        fat::widen16<bf16>(__ldg(orow + c), ov);
        fat::widen16<bf16>(__ldg(dorow + c), dov);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(dov[e], ov[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      deltas[r] = acc;
      lse2s[r] = qi < Sq ? fat::bwd::lse_log2(lse[stat_base + qi]) : CUDART_INF_F;
      if (qi < Sq) delta[stat_base + qi] = acc;
    }
  }
  fat::cp_async_wait_all();
  __syncthreads();

  // This thread's q rows: qr0 and qr0 + 8.
  const int qr0 = q0 + wrow + g;
  // At D 256, where dQ fills half the registers, the rows' LSE, delta and
  // segment ids are read where used (shared memory, L1) instead of held.
  constexpr bool kLean = D == 256;
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if constexpr (!kLean) {
#pragma unroll
    for (int i = 0; i < 2; ++i) lse2[i] = lse2s[wrow + g + 8 * i], dlt[i] = deltas[wrow + g + 8 * i];
  }
  auto row_lse2 = [&](int i) { return kLean ? lse2s[wrow + g + 8 * i] : lse2[i]; };
  auto row_delta = [&](int i) { return kLean ? deltas[wrow + g + 8 * i] : dlt[i]; };
  int row_seg[2] = {0, 0};  // the rows' segment ids
  auto row_id = [&](int qi) {
    return qi < Sq ? __ldg(seg_q + static_cast<size_t>(b) * Sq + qi) : 0;
  };
  int2 tile_ids{};          // and the q tile's id range
  const int2* kv_ranges = nullptr;
  if (seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (!kLean) row_seg[i] = row_id(qr0 + 8 * i);
    tile_ids = fat::id_range(ranges_q + static_cast<size_t>(b) * fat::range_blocks(Sq), q0, kBr,
                             Sq);
    kv_ranges = ranges_k + static_cast<size_t>(b) * fat::range_blocks(Sk);
  }
  // ALiBi as K1 forms it (flash_bwd.cuh fwd_tile_n): this thread's rows
  // qr0 + 8i take row_term = slope_log2 * (n0' + 2 tig - row - offset) once
  // a kv tile, n0' the first column of K1's tile that holds it, and each
  // score fmaf(slope_log2, (n0 - n0') + 8j + e % 2, row_term). At D 256
  // (kLean) the row terms are formed where used.
  const float slope_log2 = kAlibi ? fat::bwd::slope_log2_of(slopes, h) : 0.f;
  constexpr int kFwdN = fat::bwd::fwd_tile_n<D>();
  // Dropout's terms of this thread's rows qr0 and qr0 + 8 (bh = b * Hq + h).
  unsigned drop_row[2] = {0u, 0u};
  if constexpr (kDropout) {
    const unsigned head = fat::dropout_head(drop, b * Hq + h);
#pragma unroll
    for (int i = 0; i < 2; ++i) drop_row[i] = fat::dropout_row(qr0 + 8 * i, head);
  }
  const int a_off = wrow * KP + fat::lane_offset<true>(lane, KP);  // Q/dO A fragments
  const int b_off = fat::lane_offset<false>(lane, KP);  // K/V rows as B of S and dP
  const int t_off = fat::lane_offset<true>(lane, KP);   // K as B of dQ (.trans)
  unsigned qf[kResident ? kDSteps : 1][4], df[kResident ? kDSteps : 1][4];
  if constexpr (kResident) {
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      fat::ldsm_x4(qf[kk], qs + a_off + kk * 16);
      fat::ldsm_x4(df[kk], dos + a_off + kk * 16);
    }
  }

  float dq_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    fat::cp_async_wait_all();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it + 1 < n_tiles) load_kv(it + 1);
    fat::cp_async_commit();
    const int n0 = (first + it) * kBc;
    const bf16* kb = ks + (it & 1) * kBc * KP;
    const bf16* vb = vs + (it & 1) * kBc * KP;
    const int* segb = segs + (it & 1) * kBc;
    bool seg_mask = false;  // the tile pair needs the id mask
    if constexpr (kMask == fat::bwd::kSegmentMask) {
      if (seg) {
        const int2 kv_ids = fat::id_range(kv_ranges, n0, kBc, Sk);
        if (!fat::ids_meet(tile_ids, kv_ids)) continue;  // other documents only
        seg_mask = !fat::one_id(tile_ids, kv_ids);
      }
    }

    // S and dP: this warp's 16 q rows against the tile's 64 kv columns.
    float s[kKvTiles][4], dp[kKvTiles][4];
#pragma unroll
    for (int j = 0; j < kKvTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      unsigned qa[4], da[4];
      if constexpr (kResident) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i], da[i] = df[kk][i];
      } else {
        fat::ldsm_x4(qa, qs + a_off + kk * 16);
        fat::ldsm_x4(da, dos + a_off + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < kKvTiles / 2; ++jp) {
        unsigned bk[4], bv[4];
        fat::ldsm_x4(bk, kb + 16 * jp * KP + kk * 16 + b_off);
        fat::ldsm_x4(bv, vb + 16 * jp * KP + kk * 16 + b_off);
        fat::mma_16816(s[2 * jp], qa, bk[0], bk[1]);
        fat::mma_16816(s[2 * jp + 1], qa, bk[2], bk[3]);
        fat::mma_16816(dp[2 * jp], da, bv[0], bv[1]);
        fat::mma_16816(dp[2 * jp + 1], da, bv[2], bv[3]);
      }
    }

    // Element e of fragment j: q row qr0 + 8 (e / 2), kv column
    // n0 + 8j + 2 tig + e % 2. dS in fp32, rounded to bf16 as the A
    // fragments of dS K (fragment j is half of k-step j / 2).
    float alibi_base = 0.f;         // n0 - n0', ALiBi's column offset of the tile
    float row_term[2] = {0.f, 0.f};  // ALiBi's, of rows qr0 and qr0 + 8
    const int row_base = (n0 & ~(kFwdN - 1)) + 2 * tig - offset;
    auto alibi_row = [&](int i) {
      return slope_log2 * static_cast<float>(row_base - (qr0 + 8 * i));
    };
    if constexpr (kAlibi) {
      alibi_base = static_cast<float>(n0 & (kFwdN - 1));
      if constexpr (!kLean) row_term[0] = alibi_row(0), row_term[1] = alibi_row(1);
    }
    bool edge = n0 + kBc > kv_end || (is_causal && n0 + kBc - 1 > q0 + offset);
    // The window's left edge crosses the tile, or two ids meet in it.
    if constexpr (kMask != fat::bwd::kNoMask)
      edge = edge || seg_mask || (window > 0 && n0 < q0 + kBr - 1 + offset - window + 1);
    unsigned dsa[kKvSteps][4];
    const unsigned drop_col = kDropout ? fat::dropout_col(n0 + 2 * tig) : 0u;
#pragma unroll
    for (int j = 0; j < kKvTiles; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kDropout)  // dS = P (c M dP - delta)
          dp[j][e] = fat::dropout_keep(drop_row[e >> 1],
                                       fat::dropout_col_step(drop_col, 8 * j + (e & 1)),
                                       drop.threshold)
                         ? dp[j][e] * drop.scale
                         : 0.f;
        bool live = true;
        if (edge) {
          const int col = n0 + 8 * j + 2 * tig + (e & 1), qi = qr0 + 8 * (e >> 1);
          live = col < kv_end && (!is_causal || col <= qi + offset);
          if constexpr (kMask != fat::bwd::kNoMask)
            live = live && (window == 0 || col >= qi + offset - window + 1) &&
                   (!seg_mask || segb[col - n0] == (kLean ? row_id(qi) : row_seg[e >> 1]));
        }
        if constexpr (kCap) {  // p_and_ds's arithmetic, written out as the uncapped one is
          const float tc = fat::softcap_tanh(s[j][e] * scale_log2);
          const float p = live ? exp2f(tc * cap_log2 - row_lse2(e >> 1)) : 0.f;
          ds[e] = p * (dp[j][e] - row_delta(e >> 1)) * ((1.f - tc) * (1.f + tc));
        } else if constexpr (kAlibi) {  // K1's logit: fmaf(s, scale, fmaf(slope, inner, row))
          const float bias =
              fmaf(slope_log2, alibi_base + static_cast<float>(8 * j + (e & 1)),
                   kLean ? alibi_row(e >> 1) : row_term[e >> 1]);
          const float p = live ? exp2f(fmaf(s[j][e], scale_log2, bias) - row_lse2(e >> 1)) : 0.f;
          ds[e] = p * (dp[j][e] - row_delta(e >> 1));
        } else {
          const float p = live ? exp2f(s[j][e] * scale_log2 - row_lse2(e >> 1)) : 0.f;
          ds[e] = p * (dp[j][e] - row_delta(e >> 1));
        }
      }
      dsa[j / 2][2 * (j % 2)] = fat::pack_bf16(ds[0], ds[1]);
      dsa[j / 2][2 * (j % 2) + 1] = fat::pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K, two n-tiles of D a step.
#pragma unroll
    for (int kk = 0; kk < kKvSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kDTiles / 2; ++np) {
        unsigned bk[4];
        fat::ldsm_x4_t(bk, kb + 16 * kk * KP + 16 * np + t_off);
        fat::mma_16816(dq_acc[2 * np], dsa[kk], bk[0], bk[1]);
        fat::mma_16816(dq_acc[2 * np + 1], dsa[kk], bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qr0 + 8 * i;
    if (qi >= Sq) continue;
    bf16* row = dq + q_base + static_cast<size_t>(qi) * d + 2 * tig;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < d)  // zeros past the head dim, not stored
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
  }
}

// dq_mma_cta's kernel. Given maxThreads alone, ptxas trades registers for a
// third CTA an SM where it judges the cost small: once the head dim came at
// run time it took the D 128 window kernels from 240 registers to 168 (3
// CTAs) and they ran 17 % slower (PERF.md, PR 22). Those run as
// flash_bwd_dq_two_cta_mma_kernel, held at two CTAs an SM by its bound
// (ptxas may then use up to 255 registers); every other one as ptxas picks.
#define FA_DQ_MMA_ARGS                                                                           \
  q, k, v, o, dout, lse, dq, delta, seg_q, seg_k, ranges_q, ranges_k, slopes, Hq, Hkv, Sq, Sk, d, \
      is_causal, offset_arg, window, scale, scale_log2, cap_log2, drop, dyn_offset
template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(fat::bwd::mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                        const int2* __restrict__ ranges_q, const int2* __restrict__ ranges_k,
                        const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk,
                        int d, int is_causal, int offset_arg, int window, float scale,
                        float scale_log2, float cap_log2, const fat::Dropout drop,
                        const int* __restrict__ dyn_offset) {
  dq_mma_cta<D, kMask, kCap, kAlibi, kDropout, kDyn>(FA_DQ_MMA_ARGS);
}
template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(fat::bwd::mma::kThreads, 2)
flash_bwd_dq_two_cta_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int2* __restrict__ ranges_q,
    const int2* __restrict__ ranges_k, const float* __restrict__ slopes, int Hq, int Hkv, int Sq,
    int Sk, int d, int is_causal, int offset_arg, int window, float scale, float scale_log2,
    float cap_log2, const fat::Dropout drop, const int* __restrict__ dyn_offset) {
  dq_mma_cta<D, kMask, kCap, kAlibi, kDropout, kDyn>(FA_DQ_MMA_ARGS);
}
#undef FA_DQ_MMA_ARGS

// The dQ kernel of an instantiation: one of the two above, the other never
// instantiated.
template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
constexpr auto dq_mma_kernel() {
  if constexpr (D >= 128 && kMask == fat::bwd::kWindowMask)
    return flash_bwd_dq_two_cta_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>;
  else
    return flash_bwd_dq_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>;
}

template <typename T, int D, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(Tile<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                     const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk, int d,
                     int is_causal, int offset, int window, float scale, float scale_log2,
                     float cap_log2, const fat::Dropout drop,
                     const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment from the card bounds the q walk and masks alike.
  fat::bwd::dkv_tile<T, D, false, kDropout>(q, k, v, dout, lse, delta, dk, dv, nullptr, seg_q,
                                            seg_k, slopes, Hq, Hkv, Sq, Sk, d, is_causal,
                                            kDyn ? __ldg(dyn_offset) : offset, window, scale,
                                            scale_log2, cap_log2, drop);
}

template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(fat::bwd::mma::threads<D>())
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, const int2* __restrict__ ranges_q,
                         const int2* __restrict__ ranges_k, const float* __restrict__ slopes,
                         int Hq, int Hkv, int Sq, int Sk, int d, int is_causal, int offset,
                         int window, float scale, float scale_log2, float cap_log2,
                         const fat::Dropout drop, const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment from the card bounds the q walk and masks alike.
  fat::bwd::mma::dkv_tile<D, false, kMask, kCap, kAlibi, kDropout>(
      q, k, v, dout, lse, delta, dk, dv, nullptr, seg_q, seg_k, ranges_q, ranges_k, slopes, Hq,
      Hkv, Sq, Sk, d, is_causal, kDyn ? __ldg(dyn_offset) : offset, window, scale, scale_log2,
      cap_log2, drop);
}

// The mask and logit arguments every launch passes after the pointers it
// shares.
struct Mask {
  const int* seg_q;  // [B, Sq] int32 or null
  const int* seg_k;  // [B, Sk] int32 or null, null with seg_q
  const int2* ranges_q;  // their block ranges (common.cuh), null with them
  const int2* ranges_k;
  const float* slopes;  // [Hq] float32 ALiBi slopes, or null
  int is_causal, offset, window;
  float scale;       // dQ's and dK's factor
  float scale_log2;  // the logits' factor: scale * log2(e), or scale / cap
  float cap_log2;    // cap * log2(e) with a soft-cap, else 0
  fat::Dropout drop;  // read by the kDropout kernels alone
  const int* dyn_offset;  // the int32 offset on the card, read by the kDyn kernels alone
  int d;  // the head dim, at most the kernels' compiled tile (common.cuh head_tile)
  fat::bwd::MaskKind kind() const {
    return seg_q != nullptr ? fat::bwd::kSegmentMask
                            : window > 0 ? fat::bwd::kWindowMask : fat::bwd::kNoMask;
  }
  bool cap() const { return cap_log2 > 0.f; }
};

template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* dq, void* delta, int B, int Hq,
                          int Hkv, int Sq, int Sk, const Mask& m, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr auto kernel = dq_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>();
  const cudaError_t err = fat::allow_max_smem<kernel>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + dq_mma::kBr - 1) / dq_mma::kBr, Hq, B);
  kernel<<<grid, fat::bwd::mma::kThreads, dq_mma::smem_bytes<D, kMask>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(delta),
          m.seg_q, m.seg_k, m.ranges_q, m.ranges_k, m.slopes, Hq, Hkv, Sq, Sk, m.d, m.is_causal,
          m.offset, m.window, m.scale, m.scale_log2, m.cap_log2, m.drop, m.dyn_offset);
  return cudaGetLastError();
}

// With kAlibi the bf16 kernels of ALiBi (no cap), else those without it;
// with kDropout those of dropout, else those without it; with kDyn those
// that read the offset on the card (a window or ALiBi; the float32 kernel
// too).
template <typename T, int D, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int B, int Hq,
                      int Hkv, int Sq, int Sk, const Mask& m, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using fat::bwd::kNoMask, fat::bwd::kSegmentMask, fat::bwd::kWindowMask;
    const auto kind = m.kind();
    constexpr bool X = kDropout, Y = kDyn;
    if constexpr (kAlibi) {
      const auto fn = kind == kSegmentMask  ? launch_dq_mma<D, kSegmentMask, false, true, X, Y>
                      : kind == kWindowMask ? launch_dq_mma<D, kWindowMask, false, true, X, Y>
                                            : launch_dq_mma<D, kNoMask, false, true, X, Y>;
      return fn(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, m, stream);
    } else if constexpr (kDyn) {  // the window, with or without segment ids and the cap
      const auto fn =
          m.cap() ? (kind == kSegmentMask ? launch_dq_mma<D, kSegmentMask, true, false, X, Y>
                                          : launch_dq_mma<D, kWindowMask, true, false, X, Y>)
                  : (kind == kSegmentMask ? launch_dq_mma<D, kSegmentMask, false, false, X, Y>
                                          : launch_dq_mma<D, kWindowMask, false, false, X, Y>);
      return fn(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, m, stream);
    } else {
      const auto fn =
          m.cap() ? (kind == kSegmentMask  ? launch_dq_mma<D, kSegmentMask, true, false, X, Y>
                     : kind == kWindowMask ? launch_dq_mma<D, kWindowMask, true, false, X, Y>
                                           : launch_dq_mma<D, kNoMask, true, false, X, Y>)
                  : (kind == kSegmentMask  ? launch_dq_mma<D, kSegmentMask, false, false, X, Y>
                     : kind == kWindowMask ? launch_dq_mma<D, kWindowMask, false, false, X, Y>
                                           : launch_dq_mma<D, kNoMask, false, false, X, Y>);
      return fn(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, m, stream);
    }
  } else {
    constexpr auto kernel = flash_bwd_dq_kernel<T, D, kDropout, kDyn>;
    const cudaError_t err = fat::allow_max_smem<kernel>();
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + Tile<D>::kRows - 1) / Tile<D>::kRows, Hq, B);
    kernel<<<grid, Tile<D>::kThreads, dq_smem_bytes<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<T*>(dq), static_cast<float*>(delta), m.seg_q, m.seg_k, m.slopes, Hq, Hkv,
        Sq, Sk, m.d, m.is_causal, m.offset, m.window, m.scale, m.scale_log2, m.cap_log2, m.drop,
        m.dyn_offset);
    return cudaGetLastError();
  }
}

template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
                           int Hkv, int Sq, int Sk, const Mask& m, cudaStream_t stream) {
  namespace mma = fat::bwd::mma;
  using bf16 = __nv_bfloat16;
  const cudaError_t err =
      fat::allow_max_smem<flash_bwd_dkv_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B, (Sk + mma::kBc - 1) / mma::kBc);
  flash_bwd_dkv_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>
      <<<grid, mma::threads<D>(), mma::smem_bytes<D, false, kMask>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
          m.seg_q, m.seg_k, m.ranges_q, m.ranges_k, m.slopes, Hq, Hkv, Sq, Sk, m.d, m.is_causal,
          m.offset, m.window, m.scale, m.scale_log2, m.cap_log2, m.drop, m.dyn_offset);
  return cudaGetLastError();
}

template <typename T, int D, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
                       int Hkv, int Sq, int Sk, const Mask& m, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using fat::bwd::kNoMask, fat::bwd::kSegmentMask, fat::bwd::kWindowMask;
    const auto kind = m.kind();
    constexpr bool X = kDropout, Y = kDyn;
    if constexpr (kAlibi) {
      const auto fn = kind == kSegmentMask  ? launch_dkv_mma<D, kSegmentMask, false, true, X, Y>
                      : kind == kWindowMask ? launch_dkv_mma<D, kWindowMask, false, true, X, Y>
                                            : launch_dkv_mma<D, kNoMask, false, true, X, Y>;
      return fn(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, m, stream);
    } else if constexpr (kDyn) {  // the window, with or without segment ids and the cap
      const auto fn =
          m.cap() ? (kind == kSegmentMask ? launch_dkv_mma<D, kSegmentMask, true, false, X, Y>
                                          : launch_dkv_mma<D, kWindowMask, true, false, X, Y>)
                  : (kind == kSegmentMask ? launch_dkv_mma<D, kSegmentMask, false, false, X, Y>
                                          : launch_dkv_mma<D, kWindowMask, false, false, X, Y>);
      return fn(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, m, stream);
    } else {
      const auto fn =
          m.cap() ? (kind == kSegmentMask  ? launch_dkv_mma<D, kSegmentMask, true, false, X, Y>
                     : kind == kWindowMask ? launch_dkv_mma<D, kWindowMask, true, false, X, Y>
                                           : launch_dkv_mma<D, kNoMask, true, false, X, Y>)
                  : (kind == kSegmentMask  ? launch_dkv_mma<D, kSegmentMask, false, false, X, Y>
                     : kind == kWindowMask ? launch_dkv_mma<D, kWindowMask, false, false, X, Y>
                                           : launch_dkv_mma<D, kNoMask, false, false, X, Y>);
      return fn(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, m, stream);
    }
  } else {
    constexpr auto kernel = flash_bwd_dkv_kernel<T, D, kDropout, kDyn>;
    const cudaError_t err = fat::allow_max_smem<kernel>();
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + Tile<D>::kRows - 1) / Tile<D>::kRows, Hkv, B);
    kernel<<<grid, Tile<D>::kThreads, fat::bwd::dkv_smem_bytes<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), m.seg_q,
        m.seg_k, m.slopes, Hq, Hkv, Sq, Sk, m.d, m.is_causal, m.offset, m.window, m.scale,
        m.scale_log2, m.cap_log2, m.drop, m.dyn_offset);
    return cudaGetLastError();
  }
}

// kAlibi: the library of the ALiBi instantiations, which takes slopes and
// only slopes; else the other, which takes none. kDyn: the libraries of the
// offset on the card, not causal, a window or ALiBi.
template <bool kAlibi, bool kDyn>
bool bad_args(int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype, const Mask& m) {
  const bool seg = m.seg_q != nullptr;
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || m.window < 0 ||
         (m.window > 0 && !m.is_causal && !kDyn) || seg != (m.seg_k != nullptr) ||
         seg != (m.ranges_q != nullptr) || seg != (m.ranges_k != nullptr) || m.cap_log2 < 0.f ||
         (m.slopes != nullptr) != kAlibi || (kAlibi && m.cap()) ||
         !fat::head_dim_ok(D) ||
         (kDyn && (m.is_causal || m.dyn_offset == nullptr || (m.window == 0 && !kAlibi)));
}

}  // namespace

// q, o, dout, dq [B,Hq,Sq,D]; k, v [B,Hkv,Sk,D]; lse and delta [B,Hq,Sq]
// fp32; all contiguous on the device, the [.., D] tensors 16-byte aligned;
// seg_q [B,Sq] and seg_k [B,Sk] int32 segment ids with their block ranges
// ranges_q [B,ceil(Sq/32)] and ranges_k [B,ceil(Sk/32)] int2 (min, max),
// all NULL or none (the float32 kernels read the ids alone); slopes the
// (Hq,) float32 ALiBi table, not NULL in the ALiBi library
// (flash_bwd_alibi.cu) and NULL in the other (flash_bwd.cu), never with a
// soft-cap. Row r sees column c iff !is_causal or c <= r + offset, with
// window > 0 (causal only) c >= r + offset - window + 1, and with segment
// ids seg_q[b][r] == seg_k[b][c]. The logits s (q . k) are s * scale_log2 in
// the exp2 domain (scale_log2 = scale * log2(e)), or with cap_log2 > 0 (the
// soft-cap: cap * log2(e), and scale_log2 then scale / cap)
// tanh(s * scale_log2) * cap_log2, as the forward made them; ALiBi adds
// slopes[h] * log2(e) * (c - r - offset). With kDropout (the library
// flash_bwd_dropout.cu, ALiBi or not) the forward's keep mask of drop
// drops dP in dS. With kDyn (the libraries flash_bwd_dynoff.cu and, with
// kDropout, flash_bwd_dynoff_dropout.cu, ALiBi or not) the offset is the
// int32 at dyn_offset on the device, not `offset`, and the call is not
// causal: the window, needed without ALiBi, is its left edge alone; every
// option and dtype beside it. D, the head dim, is a multiple of 16 up to 256, run in
// the compiled tile of 64, 128 or 256 columns that holds it (common.cuh
// head_tile). Writes dq (q's dtype, scale applied) and delta. Returns the
// CUDA error code (0 = success).
template <bool kAlibi, bool kDropout, bool kDyn>
int dq_launch_impl(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* delta, const int* seg_q, const int* seg_k,
                   const int2* ranges_q, const int2* ranges_k, const float* slopes, int B, int Hq,
                   int Hkv, int Sq, int Sk, int D, int dtype, int is_causal, int offset,
                   int window, float scale, float scale_log2, float cap_log2,
                   const fat::Dropout& drop, const int* dyn_offset, void* stream) {
  const Mask m{seg_q,  seg_k, ranges_q,   ranges_k, slopes,     is_causal, offset,
               window, scale, scale_log2, cap_log2, drop,   dyn_offset, D};
  if (bad_args<kAlibi, kDyn>(B, Hq, Hkv, Sq, Sk, D, dtype, m))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  constexpr bool A = kAlibi, X = kDropout, Y = kDyn;
  const int tile = fat::head_tile(D);  // the compiled tile that takes D
  decltype(&launch_dq<__nv_bfloat16, 64, A, X, Y>) fn =
      dtype == fat::kBF16 ? (tile == 64    ? launch_dq<__nv_bfloat16, 64, A, X, Y>
                             : tile == 128 ? launch_dq<__nv_bfloat16, 128, A, X, Y>
                                           : launch_dq<__nv_bfloat16, 256, A, X, Y>)
      : dtype == fat::kF32 ? (tile == 64    ? launch_dq<float, 64, A, X, Y>
                              : tile == 128 ? launch_dq<float, 128, A, X, Y>
                                            : launch_dq<float, 256, A, X, Y>)
                           : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, o, dout, lse, dq, delta, B, Hq, Hkv, Sq, Sk, m, s));
}

// Same layout, mask and logits; reads the delta written by the dQ launch
// and writes dk (scale applied) and dv in k's dtype, every row, summed over
// each kv head's q heads; with kDropout drops P in dV and dP in dS.
template <bool kAlibi, bool kDropout, bool kDyn>
int dkv_launch_impl(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, const int* seg_q,
                    const int* seg_k, const int2* ranges_q, const int2* ranges_k,
                    const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                    int is_causal, int offset, int window, float scale, float scale_log2,
                    float cap_log2, const fat::Dropout& drop, const int* dyn_offset,
                    void* stream) {
  const Mask m{seg_q,  seg_k, ranges_q,   ranges_k, slopes,     is_causal, offset,
               window, scale, scale_log2, cap_log2, drop,   dyn_offset, D};
  if (bad_args<kAlibi, kDyn>(B, Hq, Hkv, Sq, Sk, D, dtype, m))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  constexpr bool A = kAlibi, X = kDropout, Y = kDyn;
  const int tile = fat::head_tile(D);  // the compiled tile that takes D
  decltype(&launch_dkv<__nv_bfloat16, 64, A, X, Y>) fn =
      dtype == fat::kBF16 ? (tile == 64    ? launch_dkv<__nv_bfloat16, 64, A, X, Y>
                             : tile == 128 ? launch_dkv<__nv_bfloat16, 128, A, X, Y>
                                           : launch_dkv<__nv_bfloat16, 256, A, X, Y>)
      : dtype == fat::kF32 ? (tile == 64    ? launch_dkv<float, 64, A, X, Y>
                              : tile == 128 ? launch_dkv<float, 128, A, X, Y>
                                            : launch_dkv<float, 256, A, X, Y>)
                           : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, m, s));
}
