// K2: flash-decode, T new query tokens per sequence against a KV cache with
// ragged lengths, for Hopper (sm_90a). The cache is bf16/f32, int8 or fp8
// (e4m3), dense [B, Hkv, Smax, D] or paged: pages [P, Hkv, page, D] read
// through a block table [B, max_pages].
//
// Replaces the TPU kernel flashattn_tpu/ops/decode.py::_decode_kernel
// (launcher _decode_attention, :351, reached through decode_attention :233
// and decode_attention_chunk :268) and its paged form
// flashattn_tpu/ops/paged.py::_paged_decode (:378, reached through
// paged_decode_attention :332 and paged_decode_attention_chunk :360), with
// the sliding window, attention sinks, the logit soft-cap and ALiBi, and
// the optional LSE output (the dense launcher's with_lse), at head dims 64,
// 128 and 256, and 32, 80 and 96 inside those tiles: the kernels are
// compiled for a tile D of 64, 128 or 256 columns and take the true head
// dim d at run time (common.cuh head_tile). q, the cache and O are d wide;
// the q columns from d to D are zeros and the cache rows' chunks there are
// zero-filled copies (a row of d values is d * 2 bytes in bf16, d * 4 in
// f32 and d bytes in int8 or fp8: multiples of 16), so the logits are
// those of d, O's columns from d to D are zeros and are never stored, and
// the int8 mode's q scale takes its amax over the d live columns. The
// merge's partial accumulators are d wide.
//
// What bounds it on the card: HBM bandwidth in principle, latency in
// practice. Each step streams the live part of the cache once (K and V,
// [length, D] per kv head, one byte a value when quantized) and does only
// 4 * G * T * D operations per cached token, far below the card's
// operation-per-byte balance; at the serving batch (B = 4, Hkv = 4, a few
// MB of live cache) the whole call is a few microseconds of HBM time, so
// what it costs is launches, the dependent chain of one CTA (load, math,
// write) and the merge of the slices. A chunk (T = 256: 2048 query rows a
// kv head) is the other end: there the products are the work.
//
// What the design does about it (decode_mma_kernel, bf16 q with a bf16,
// int8 or fp8 cache; f32 q with an int8 or fp8 cache):
// - Split-KV. The grid is (B, Hkv x row blocks, splits); each CTA takes up
//   to 16 (G*T <= 16) or 64 of the G*T query rows of one (batch, kv head)
//   group, so the group's q heads share one read of the cache (row r is
//   head r / T, token r % T at position length - T + r % T, and sees keys
//   at positions <= its own), and streams one slice of its live span in
//   64-position tiles. The live span is [0, length), or with a window the
//   sink tiles followed by the tiles from the one holding the earliest
//   row's window edge to the length (live_span: the slices cut a virtual
//   span in which the dead tiles between the sinks and the window are left
//   out, found from the device-side length, so a captured launch stays
//   right as the lengths grow, and a long cache streams O(window + T +
//   sink) bytes, as the JAX kernel's clamped reads do). Slices past a
//   row's span, and tiles past the last position any row of the CTA can
//   see, are skipped, so a ragged batch streams only its live bytes. The
//   slices are a function of the shapes, the window and the sink alone
//   (ops/decode.py::_num_splits), so the paged and the dense cache of one
//   max_len give the same bits.
// - Rows and warps. With 16 rows or fewer (decode: G = 8 at T = 1) the 4
//   warps share the CTA's rows and take 4 tiles at a time, one each, each
//   warp an online softmax of its own; the 4 states merge in shared memory
//   at the end in warp order. With more rows each warp owns 16 of the 64
//   rows and all 4 walk the same tiles. At D 256 a warp holding a 16 x 256
//   fp32 O (128 registers) beside S, P and the int8 mode's requantization
//   spilled, so there two warps share each 16 rows and tile (kHalves): both
//   compute the same S and P over all 256 dims, each P.V into its half of
//   the dims; the CTA takes 2 tiles at a time for up to 16 rows, and 32
//   rows one tile at a time above (their bf16 K and V tiles, 64 positions
//   x 512 bytes, take twice the shared memory of D 128's).
// - Tensor cores. Per tile a warp computes S (16 rows x 64 positions) and
//   P.V on mma.sync, P going from the S accumulators to the A fragments in
//   registers: m16n8k16 bf16 with fp32 accumulators for a bf16 or an fp8
//   cache, m16n8k32 int8 with int32 accumulators for an int8 cache (q8, k,
//   p8 and v as they are). K and V stay in their storage type in shared
//   memory (bf16, or one byte a value) and arrive by cp.async, the next
//   tiles' copy in flight while this tile's math runs (two stages where a
//   CTA walks more than one round of tiles), with their scales; they are
//   read by ldmatrix, one byte a value included. For fp8 a non-transposed
//   ldmatrix of a byte tile gives a lane 4 consecutive values of one key,
//   widened in registers to the bf16 pair of a B fragment (the contraction
//   over D is taken in that order for q and k alike), and a transposed one
//   gives 2 keys x 2 dims, split by byte permutes into the fragments of an
//   even- and an odd-dim n-tile. For int8 the bytes are the fragments; P.V
//   takes its 32 positions a step in the order the S accumulators hold
//   them, and v's transposed tiles are permuted to that order.
// - The merge. Each CTA of a call with several slices writes fp32 partial
//   (m, l, acc); decode_merge_kernel, one warp a row, adds the slices in
//   split order with the log-sum-exp algebra, so the result is
//   deterministic. It is launched as a programmatic dependent (Hopper's
//   griddepcontrol), so its launch overlaps the split kernel's tail. A call
//   with one slice writes O directly. (Merging in the split kernel, by the
//   last CTA of a group to arrive on a ticket counter, measured slower on
//   an H100 than this second launch.)
// Cache rows at or past `length` are never read: their copies are zero
// filled (a recycled slot may hold NaN there, or fp8 NaN codes, and no
// 0 * NaN can reach a sum). A row that sees no key gets O = 0. A slice that
// sees no live position writes its (m, l = 0) and no accumulator; the
// merge skips it.
//
// The soft-cap (a.cap_log2 > 0) turns each dequantized, scaled logit x,
// true units under a cap (q is pre-scaled by scale alone), into
// tanh(x * inv_cap) * cap * log2(e) before the length, window and sink
// masks, as the JAX kernel does (common.cuh softcap_tanh); the kernel
// tests the flag once a tile, and a call without a cap runs no tanh.
//
// ALiBi (a.slopes, the (Hq,) slope table, not null; never with a cap) adds
// slope * log2(e) * (pos - row_pos) to each dequantized logit in the log2
// domain before the masks, the slope of the row's query head (kv_head *
// group + r / T): a row takes its slope and its term at the tile's first
// column once a tile, each logit one FMA by its column's constant offset.
// It is a template flag (kAlibi), with and without the window, so the
// instantiations without it keep their code; they are built into a library
// of their own (decode_alibi.cu; decode.cu holds the others), so that the
// two nvcc runs go side by side. It hides no key, so the walk over the live
// span is unchanged; a
// steep slope (0.84 a position for head 0 of 32) drives a tile's P far
// below the row's maximum, where the int8 mode's requantization takes
// kRmaxMin's rule.
//
// The LSE (a.lse not null, [B, Hq, T] float32, natural log) is (m + log2
// l) * ln 2 of the row's merged state, -inf for a row that sees no key: the
// merge writes it (its kLse instantiation), or with one slice the split
// kernel's epilogue, in a loop of its own after O's.
//
// Modes, in the JAX kernel's order of operations:
// - bf16: s = (q . k) * scale * log2(e) in fp32; P rounded to bf16 before
//   P . V, as the JAX kernel feeds its MXU; l sums the unrounded P.
// - int8: the kernel quantizes q itself, per row as prep_decode_q does:
//   q_pre = float(q) * scale * log2(e), q_scale = max(amax|q_pre| *
//   f32(1/127), 1e-8), q8 = clamp(rint(q_pre / q_scale), +-127) (IEEE
//   division). s = int(q8 . k) * (q_scale * k_scale[pos]), the dot in int32,
//   exact. Per row and 64-position tile, pvs = p * v_scale[pos],
//   rmax = max(pvs) (1 below kRmaxMin), p8 = rint(pvs * (127 / rmax)) and
//   pv = int(p8 . v) * (rmax / 127), exact again; l sums p, not pvs. The
//   JAX kernel requantizes P over a block of block_kv positions (4096,
//   clamped to Smax); this kernel per 64-position tile, whose row maximum is
//   never above the block's, so its steps are finer
//   (decode_attention_reference(requant_block=BLOCK_KV)).
// - fp8: k and v widen exactly to bf16 (every e4m3 code is a bf16);
//   q_pre = bf16(float(q) * scale * log2(e)) as the JAX launcher rounds it
//   to q's type, k_scale multiplies the logits, v_scale multiplies P, and
//   P * v_scale is not rounded: it enters P . V as a bf16 pair hi + lo
//   (hi = bf16(x), lo = bf16(x - hi)), two products, about 16 bits of it.
// Paged: a tile of 64 positions never straddles a page (the page size is a
// multiple of 64), so the tile base is taken through the table,
// table[b, n0 / page] row n0 % page; a sink tile, left of the window, is
// read through its own page like any other. A table entry outside [0, P) (the
// server's sentinel for a block it does not own, which a chunk's padding
// can reach) is never dereferenced: its tile counts as holding no key.
//
// f32 q with an f32 cache (tests only) runs decode_f32_kernel: the same
// split and row tiling on the CUDA cores, tiles widened to fp32 in shared
// memory, and decode_merge_kernel as a second launch.
#pragma once

#include <algorithm>
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using fat::kMaskValue;
using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

constexpr int kBlockN = 64;  // cache positions per tile (the int8 P requantization block)
// A tile whose largest P x v_scale is below 2^-100 requantizes to zeros
// (rmax taken as 1): the JAX kernel's rule for rmax == 0, widened because a
// tile far below the row's maximum can leave rmax subnormal, or so small
// that 127 / rmax overflows and 0 * inf gives NaN.
constexpr float kRmaxMin = 0x1p-100f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum class Mode { kPlain, kInt8, kFp8 };
template <typename C>
constexpr Mode kModeOf = std::is_same_v<C, int8_t> ? Mode::kInt8
                         : std::is_same_v<C, fp8>  ? Mode::kFp8
                                                   : Mode::kPlain;

struct Args {
  const void* q;  // [B, Hq, T, D] in T, which is [B, Hkv, R, D]: row r of group hk
  const void* k;
  const void* v;
  const float* k_scale;  // dense [B, Hkv, 1, Smax], paged [P, Hkv, 1, page]
  const float* v_scale;
  const int* length;  // [B]
  const int* table;   // [B, max_pages], or null for a dense cache
  float* part_m;      // [B, Hkv, splits, R]
  float* part_l;
  float* part_acc;  // [B, Hkv, splits, R, d]
  void* o;          // [B, Hq, T, D] in T
  int B, Hq, Hkv, Tc, Smax, max_pages, page, num_pages, split_len, num_splits, row_blocks;
  int window;  // sliding window (0: none)
  int sink;    // the first `sink` positions stay visible (with a window)
  float scale_log2;  // q's pre-scale: scale * log2(e), or scale under a soft-cap
  float inv_cap;     // 1 / cap, with cap_log2 = cap * log2(e) (0: no soft-cap)
  float cap_log2;
  const float* slopes;  // [Hq] ALiBi slopes, or null
  float* lse;           // [B, Hq, T] in T, which is [B, Hkv, R], or null
  int d;                // the head dim: q, k, v, o and part_acc rows; at most the tile D
};

// Row r of group hk's ALiBi slope in the log2 domain (0 without ALiBi).
__device__ __forceinline__ float row_slope(const Args& a, int hk, int r) {
  return a.slopes != nullptr ? a.slopes[hk * (a.Hq / a.Hkv) + r / a.Tc] * fat::kLog2e : 0.f;
}

// The natural-log LSE of a merged row state (m, l) in the log2 domain.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * fat::kLn2 : -CUDART_INF_F;
}

// ---- shared by both kernels ----

// The one visibility rule: a query row at cache position row_pos sees the
// tile's column c (position pos = n0 + c) when the column is live (inside
// [0, length) and an owned page: c < n_live), not in its future, and with a
// window inside it (pos > row_pos - window) or a sink (pos < sink). Rows
// that are not real (padding of a row block) carry row_pos -1. A caller
// that knows the tile lies inside every row's window (or the sinks) passes
// kWindow false and skips that test.
template <bool kWindow = true>
__device__ __forceinline__ bool visible(const Args& a, int c, int n_live, int pos, int row_pos) {
  return c < n_live && pos <= row_pos &&
         (!kWindow || a.window == 0 || pos > row_pos - a.window || pos < a.sink);
}

// The positions a sequence's rows can see, as the split pass walks them:
// the sink tiles [0, sink_end), then the tiles from the one holding the
// earliest row's window edge, length - T + 1 - window, on. The splits cut
// a virtual span: virtual position v is cache position v below sink_end and
// v + gap from there (gap, a multiple of 64, the dead tiles left out).
// Without a window, or where the window reaches the sinks, gap = 0 and the
// two are one. ops/decode.py::live_span bounds its length.
struct Span {
  int sink_end, gap;
  __device__ __forceinline__ int pos(int v) const { return v < sink_end ? v : v + gap; }
};
__device__ __forceinline__ Span live_span(const Args& a, int len) {
  Span sp{0, 0};
  if (a.window > 0) {
    sp.sink_end = (a.sink + kBlockN - 1) / kBlockN * kBlockN;
    const int edge = max(len - a.Tc + 1 - a.window, 0) / kBlockN * kBlockN;
    sp.gap = max(edge - sp.sink_end, 0);
  }
  return sp;
}

// Row r of a group: token r % T, at cache position length - T + r % T.
__device__ __forceinline__ int row_position(int r, int len, int Tc) { return len - Tc + r % Tc; }

// The largest row position of rows [r0, r0 + nr): no row sees past it.
__device__ __forceinline__ int last_row_position(int r0, int nr, int len, int Tc) {
  int t_hi = Tc - 1;
  if (nr < Tc) {
    const int lo = r0 % Tc, hi = (r0 + nr - 1) % Tc;
    if (lo <= hi) t_hi = hi;
  }
  return len - Tc + t_hi;
}

// Where the tile of positions [n0, n0 + 64) of (b, hk) lives: the index of
// its first row among the rows of k/v (and of the scales), and how many of
// its rows hold keys (0 for a table entry outside the pool).
struct Tile {
  size_t base;
  int n_live;
};
// The table entry of the page holding position n0 (0 for a dense cache).
__device__ __forceinline__ int page_of(const Args& a, int b, int n0) {
  return a.table != nullptr && n0 < a.Smax
             ? a.table[static_cast<size_t>(b) * a.max_pages + n0 / a.page]
             : 0;
}
__device__ __forceinline__ Tile tile_at(const Args& a, int b, int hk, int n0, int end, int pid) {
  Tile t{(static_cast<size_t>(b) * a.Hkv + hk) * a.Smax + n0, min(kBlockN, end - n0)};
  if (a.table != nullptr) {
    if (pid < 0 || pid >= a.num_pages) t.n_live = 0;  // unowned block: no key
    t.base = (static_cast<size_t>(max(pid, 0)) * a.Hkv + hk) * a.page + n0 % a.page;
  }
  return t;
}
__device__ __forceinline__ Tile tile_at(const Args& a, int b, int hk, int n0, int end) {
  return tile_at(a, b, hk, n0, end, page_of(a, b, n0));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The weighted sums of one row's slices (merge_row): den = sum_s w_s l_s,
// num = sum_s w_s acc_s over this lane's dims lane + 32 c, the slices'
// accumulators `ld` apart: D with kFull (rows as wide as the tile, every
// offset a constant), else a.d, the dims at and past it not read. Lanes
// take 32 splits at a time for the weights, then the dims, so that each
// step's loads are in flight together; the partials are read past L1
// (other CTAs wrote them).
template <int D, bool kFull>
__device__ __forceinline__ void merge_splits(const Args& a, size_t row, int R, float mmax,
                                             float (&num)[D / 32], float& den) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int ld = kFull ? D : a.d;
  for (int s0 = 0; s0 < a.num_splits; s0 += 32) {
    const size_t idx = row + static_cast<size_t>(s0 + lane) * R;
    float w = 0.f, l = 0.f;
    if (s0 + lane < a.num_splits) {
      l = __ldcg(a.part_l + idx);
      if (l > 0.f) w = exp2f(__ldcg(a.part_m + idx) - mmax);
    }
    den += warp_sum(w * l);
    const int n = min(32, a.num_splits - s0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(kAll, w, j);
      if (wj > 0.f) {  // uniform over the warp
        const float* acc = a.part_acc + (row + static_cast<size_t>(s0 + j) * R) * ld + lane;
#pragma unroll
        for (int c = 0; c < D / 32; ++c)
          if (kFull || lane + 32 * c < a.d) num[c] = fmaf(wj, __ldcg(acc + 32 * c), num[c]);
      }
    }
  }
}

// One warp merges row `row` (its partial-result index in split 0; the
// splits follow R apart) into out[0, d) (d = a.d, at most the tile D):
// O = sum_s w_s acc_s / sum_s w_s l_s with w_s = exp2(m_s - max m) over
// the slices that saw a key (l_s > 0; the others wrote no accumulator), in
// split order. A fixed order of operations: every caller gets the same
// bits. Full-width rows take merge_splits' constant offsets (a uniform
// branch outside its loops: a per-load test of d cost K2 7-10 % at T 1,
// PERF.md, PR 22). With kLse its lane 0 writes the row's natural-log LSE
// to *lse.
template <typename T, int D, bool kLse>
__device__ __forceinline__ void merge_row(const Args& a, size_t row, int R, T* out,
                                          float* lse) {
  const int lane = threadIdx.x % 32;
  float mmax = kMaskValue;
  for (int s0 = 0; s0 < a.num_splits; s0 += 32) {
    const size_t idx = row + static_cast<size_t>(s0 + lane) * R;
    if (s0 + lane < a.num_splits && __ldcg(a.part_l + idx) > 0.f)
      mmax = fmaxf(mmax, __ldcg(a.part_m + idx));
  }
  mmax = warp_max(mmax);
  constexpr int kPer = D / 32;
  float num[kPer];  // dims lane + 32 c
#pragma unroll
  for (int c = 0; c < kPer; ++c) num[c] = 0.f;
  float den = 0.f;
  if (a.d == D)
    merge_splits<D, true>(a, row, R, mmax, num, den);
  else
    merge_splits<D, false>(a, row, R, mmax, num, den);
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (lane + 32 * c < a.d) out[lane + 32 * c] = fat::from_f<T>(den > 0.f ? num[c] / den : 0.f);
  if constexpr (kLse) {
    if (lane == 0) *lse = row_lse(mmax, den);
  }
}

constexpr int kMergeRows = 4;  // rows a merge CTA, one a warp

// Launched as a programmatic dependent of the split kernel: its CTAs may
// start while the split kernel finishes, and wait here for its partials.
// kLse writes the rows' LSE too (a.lse not null).
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(32 * kMergeRows) decode_merge_kernel(const Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int R = (a.Hq / a.Hkv) * a.Tc;
  const int row = blockIdx.x * kMergeRows + threadIdx.x / 32;  // (b * Hkv + hk) * R + r
  if (row >= a.B * a.Hkv * R) return;
  const size_t bh = row / R;
  merge_row<T, D, kLse>(a, bh * a.num_splits * R + row % R, R,
                        static_cast<T*>(a.o) + static_cast<size_t>(row) * a.d,
                        kLse ? a.lse + row : nullptr);
}

// ---- bf16 q with any cache, f32 q with a quantized one: the tensor cores ----

// Shared memory of decode_mma_kernel: q rows as bf16 [kRows][kQLd] and
// q_scale [kRows], then `stages` stages of kTiles tile slots, each K and V
// [64][kLd] in the cache's type and k_scale, v_scale [64] f32; the final
// merge of the warps' states, [4][16][kRedLd] f32 and m, l [4][16], reuses
// the stage memory. kHalves warps share each 16 rows and tile, each with
// D / kHalves of O's dims.
template <typename C, int D, int kTiles>
struct MmaLayout {
  static constexpr int kHalves = D > 128 ? 2 : 1;
  static constexpr int kRows = 16 * kWarps / (kTiles * kHalves);  // query rows a CTA
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C));
  static constexpr int kLd = kRowBytes + 16;  // conflict-free ldmatrix rows
  static constexpr int kTileBytes = kBlockN * kLd;
  static constexpr int kSlotBytes = 2 * kTileBytes + 2 * kBlockN * 4;
  static constexpr int kStageBytes = kTiles * kSlotBytes;
  static constexpr int kQLd = D + 8;  // bf16
  static constexpr int kQBytes = kRows * kQLd * 2 + kRows * 4;
  static constexpr int kRedLd = D + 4;
  static constexpr int kRedBytes = kWarps * 16 * (kRedLd + 2) * 4;
  static constexpr size_t smem_bytes(int stages) {
    return kQBytes + std::max(stages * kStageBytes, kRedBytes);
  }
};

// Two fp8 cache values (the low and the high byte of `pair`) as the bf16
// pair of a fragment register, exactly (every e4m3 code is an fp16 and a
// bf16).
__device__ __forceinline__ unsigned widen2(unsigned pair) {
  const __half2_raw h =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return fat::pack_bf16(f.x, f.y);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const unsigned char* p) {
  fat::ldsm_x4(r, reinterpret_cast<const bf16*>(p));
}
using fat::mma_s8;

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const unsigned char* p) {
  fat::ldsm_x4_t(r, reinterpret_cast<const bf16*>(p));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(fat::smem_addr(p)));
}

// Column (dim) of element e of P.V accumulator n-tile nt, for lane quad
// position tig. A bf16 cache: n-tile nt is dims 8 nt .. 8 nt + 7. A byte
// cache: each 16 dims form two n-tiles, their even and their odd dims (the
// transposed byte ldmatrix's order).
template <bool kBytes>
__device__ __forceinline__ int acc_dim(int nt, int e, int tig) {
  if constexpr (kBytes)
    return 16 * (nt / 2) + (nt & 1) + 4 * tig + 2 * (e & 1);
  else
    return 8 * nt + 2 * tig + (e & 1);
}

// kWindow instantiates the window and the sinks (a.window > 0): without
// them the kernel keeps the unwindowed one's registers and occupancy.
// kAlibi instantiates ALiBi (a.slopes not null).
template <typename T, typename C, int D, int kTiles, bool kWindow, bool kAlibi>
__global__ void __launch_bounds__(kThreads, 1) decode_mma_kernel(const Args a, int stages) {
  using L = MmaLayout<C, D, kTiles>;
  constexpr Mode kMode = kModeOf<C>;
  constexpr bool kBytes = kMode != Mode::kPlain;
  constexpr int kRows = L::kRows;
  constexpr int kDh = D / L::kHalves;  // O's dims a warp holds
  constexpr int kNt = kDh / 8;         // P.V accumulator n-tiles
  static_assert(kBytes || std::is_same_v<T, bf16>, "a bf16 cache takes bf16 q");
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const unsigned char* __restrict__ kc = static_cast<const unsigned char*>(a.k);
  const unsigned char* __restrict__ vc = static_cast<const unsigned char*>(a.v);
  const int R = (a.Hq / a.Hkv) * a.Tc;
  const int b = blockIdx.x, hk = blockIdx.y / a.row_blocks, rb = blockIdx.y % a.row_blocks;
  const int r0 = rb * kRows, nr = min(kRows, R - r0);
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  // This warp's half of O's dims, row group and tile slot.
  const int half = warp % L::kHalves, rg = warp / L::kHalves / kTiles;
  const int slot = warp / L::kHalves % kTiles;

  // This CTA's q rows, 4 of a warp's at a time (warp w rows w, w + 4, ...;
  // lane l dims l, l + 32, ...); the first 4 into registers first: they do
  // not wait for the length.
  constexpr int kRowsPerWarp = kRows / kWarps;
  constexpr int kBatch = kRowsPerWarp < 4 ? kRowsPerWarp : 4;
  constexpr int kPer = D / 32;
  const T* q_rows = q + ((static_cast<size_t>(b) * a.Hkv + hk) * R + r0) * a.d;
  float qv[kBatch][kPer];
  auto load_q = [&](int i0) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = warp + kWarps * (i0 + i);
#pragma unroll
      for (int j = 0; j < kPer; ++j)  // dims at and past d are zeros
        qv[i][j] = r < nr && lane + 32 * j < a.d ? fat::to_f(q_rows[r * a.d + lane + 32 * j])
                                                 : 0.f;
    }
  };
  load_q(0);

  // So do the page ids of the first round's tiles, at their positions
  // without a window's gap (read again where there is one).
  const int start = sp * a.split_len;  // in the virtual span (live_span)
  int first_pid[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) first_pid[t] = page_of(a, b, start + t * kBlockN);

  const int len = min(a.length[b], a.Smax);
  const Span span = kWindow ? live_span(a, len) : Span{0, 0};
  // No row of this CTA sees at or past `end`, a position in the window
  // part of the span when there is a gap.
  const int end = min(len, last_row_position(r0, nr, len, a.Tc) + 1);
  const int vend = min(start + a.split_len, end - span.gap);
  // Every row of this CTA sees a tile at or after win_full whole, as far
  // as the window goes: only the tiles before it, outside the sinks, run
  // the window's test.
  const int win_full = kWindow ? end - a.window : INT_MIN;
  const int n_tiles = start < vend ? (vend - start + kBlockN - 1) / kBlockN : 0;
  const int rounds = (n_tiles + kTiles - 1) / kTiles;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // int8 mode: int8 rows of kQLdB bytes
  constexpr int kQLdB = 2 * L::kQLd;
  float* qsc = reinterpret_cast<float*>(smem + kRows * L::kQLd * 2);
  unsigned char* stages_mem = smem + L::kQBytes;

  // Copy the tiles of round `round` into stage `stage`: thread tid issues
  // its 16-byte chunks of each slot's K and V (rows past n_live zero
  // filled, never read; the chunks at and past the head dim's row_bytes
  // zero filled too, never skipped: a skipped chunk would keep an earlier
  // tile's bytes, and the products run over the whole tile) and,
  // quantized, one scale. A thread copies the same chunk ch_t of rows
  // row_t, row_t + kRowStep, ...: its addresses step by kRowStep rows.
  constexpr int kChunks = L::kRowBytes / 16;           // a tile row's 16-byte chunks
  constexpr int kEach = kBlockN * kChunks / kThreads;  // a thread's chunks of a tile
  constexpr int kRowStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0, "a thread keeps its chunk of a row");
  const int row_bytes = a.d * static_cast<int>(sizeof(C));  // a cache row in device memory
  const int row_t = tid / kChunks, ch_t = tid % kChunks;
  const bool ch_live = ch_t * 16 < row_bytes;
  auto issue = [&](int round, int stage) {
    unsigned char* st = stages_mem + stage * L::kStageBytes;
#pragma unroll
    for (int s = 0; s < kTiles; ++s) {
      const int t = round * kTiles + s;
      if (t >= n_tiles) continue;
      const int v0 = start + t * kBlockN, n0 = span.pos(v0);
      const Tile tl =
          tile_at(a, b, hk, n0, end, round == 0 && n0 == v0 ? first_pid[s] : page_of(a, b, n0));
      unsigned char* dst = st + s * L::kSlotBytes;
      // Not unrolled: the copy's addresses stay out of the registers that
      // the tile's math needs.
#pragma unroll 1
      for (int kv = 0; kv < 2; ++kv) {
        const unsigned char* src = (kv ? vc : kc) + (tl.base + row_t) * row_bytes + ch_t * 16;
        unsigned char* to = dst + kv * L::kTileBytes + row_t * L::kLd + ch_t * 16;
#pragma unroll 1
        for (int j = 0; j < kEach; ++j) {
          const bool valid = ch_live && row_t + j * kRowStep < tl.n_live;
          fat::cp_async16(to, valid ? src : kc, valid);
          src += kRowStep * row_bytes;
          to += kRowStep * L::kLd;
        }
      }
      if constexpr (kBytes) {
        float* sc = reinterpret_cast<float*>(dst + 2 * L::kTileBytes);  // k_scale, v_scale
        const float* src = tid < kBlockN ? a.k_scale : a.v_scale;
        const int c = tid % kBlockN;
        const bool valid = c < tl.n_live;
        fat::cp_async4(sc + tid, valid ? src + tl.base + c : src, valid);
      }
    }
  };

  // This warp's rows: g and g + 8 of its row group.
  int row_pos[2];
  float q_scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rg * 16 + g + 8 * h;
    row_pos[h] = r < nr ? row_position(r0 + r, len, a.Tc) : -1;
    q_scale[h] = 0.f;
  }
  float slope[2] = {0.f, 0.f};  // ALiBi's, in the log2 domain
  if constexpr (kAlibi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h;
      slope[h] = r < nr ? row_slope(a, hk, r0 + r) : 0.f;
    }
  }
  float o[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  if (rounds > 0) issue(0, 0);
  fat::cp_async_commit();

  // q as the products take them, while the first tiles arrive; rows past
  // nr are zero.
#pragma unroll 1
  for (int i0 = 0; rounds > 0 && i0 < kRowsPerWarp; i0 += kBatch) {
    if (i0 > 0) load_q(i0);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = warp + kWarps * (i0 + i);
      if constexpr (kMode == Mode::kInt8) {
        float amax = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          qv[i][j] *= a.scale_log2;
          amax = fmaxf(amax, fabsf(qv[i][j]));
        }
        const float scale = fmaxf(warp_max(amax) * (1.f / 127.f), 1e-8f);
        int8_t* dst8 = reinterpret_cast<int8_t*>(qs) + r * kQLdB + lane;  // int8 rows
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          dst8[32 * j] = static_cast<int8_t>(
              fminf(fmaxf(rintf(__fdiv_rn(qv[i][j], scale)), -127.f), 127.f));
        if (lane == 0) qsc[r] = scale;
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          qs[r * L::kQLd + lane + 32 * j] =
              __float2bfloat16(kMode == Mode::kPlain ? qv[i][j] : qv[i][j] * a.scale_log2);
      }
    }
  }

  for (int i = 0; i < rounds; ++i) {
    const int stage = stages == 2 ? (i & 1) : 0;
    if (stages == 2 && i + 1 < rounds) issue(i + 1, stage ^ 1);
    fat::cp_async_commit();
    if (stages == 2)
      fat::cp_async_wait_group<1>();
    else
      fat::cp_async_wait_group<0>();
    __syncthreads();  // round i's tiles (and q) are visible to every warp
    if constexpr (kMode == Mode::kInt8) {
      if (i == 0) {
        q_scale[0] = qsc[rg * 16 + g];
        q_scale[1] = qsc[rg * 16 + g + 8];
      }
    }
    const int t = i * kTiles + slot;
    if (t < n_tiles) {
      const int n0 = span.pos(start + t * kBlockN);
      const int n_live = tile_at(a, b, hk, n0, end).n_live;
      const unsigned char* ks = stages_mem + stage * L::kStageBytes + slot * L::kSlotBytes;
      const unsigned char* vs = ks + L::kTileBytes;
      const float* ksc = reinterpret_cast<const float*>(vs + L::kTileBytes);
      const float* vsc = ksc + kBlockN;

      // S = Q K^T: 16 rows x 64 positions, n-tile j is positions 8j..8j+7.
      float s[8][4];
      if constexpr (kMode == Mode::kInt8) {
        // int8 q and k straight from shared memory, 32 dims a step, exact
        // int32 sums.
        int si[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
        const unsigned char* qb = reinterpret_cast<const unsigned char*>(qs) + rg * 16 * kQLdB;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          unsigned qa[4];  // rows 0-7 and 8-15 at bytes 32 kk .. + 15, then + 16 .. + 31
          ldsm_x4(qa, qb + (lane % 8 + 8 * ((lane / 8) & 1)) * kQLdB + 32 * kk + 16 * (lane / 16));
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {  // positions 16 jp .. + 7 and + 8 .. + 15
            unsigned r[4];
            ldsm_x4(r, ks + (8 * (2 * jp + lane / 16) + lane % 8) * L::kLd + 32 * kk +
                           16 * ((lane / 8) & 1));
            mma_s8(si[2 * jp], qa, r[0], r[1]);
            mma_s8(si[2 * jp + 1], qa, r[2], r[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = static_cast<float>(si[j][e]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          unsigned qa[4];
          const bf16* qrow = qs + (rg * 16) * L::kQLd + 16 * kk;
          if constexpr (kBytes) {
            // Dims 4 tig .. 4 tig + 3 of the 16 stand for the fragment's
            // k = 2 tig, 2 tig + 1, 8 + 2 tig, 9 + 2 tig, as for k below.
            const uint2 u0 = *reinterpret_cast<const uint2*>(qrow + g * L::kQLd + 4 * tig);
            const uint2 u1 = *reinterpret_cast<const uint2*>(qrow + (g + 8) * L::kQLd + 4 * tig);
            qa[0] = u0.x;
            qa[1] = u1.x;
            qa[2] = u0.y;
            qa[3] = u1.y;
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // matrix j: positions 8 (4h + j) .., bytes 16 kk ..
              unsigned r[4];
              ldsm_x4(r, ks + (8 * (4 * h + lane / 8) + lane % 8) * L::kLd + 16 * kk);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                fat::mma_16816(s[4 * h + j], qa, widen2(r[j]), widen2(r[j] >> 16));
            }
          } else {
            fat::ldsm_x4(qa, qrow + fat::lane_offset<true>(lane, L::kQLd));
            const bf16* kb = reinterpret_cast<const bf16*>(ks);
            constexpr int kLdK = L::kLd / 2;
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              unsigned r[4];
              fat::ldsm_x4(r, kb + (16 * np) * kLdK + 16 * kk + fat::lane_offset<false>(lane, kLdK));
              fat::mma_16816(s[2 * np], qa, r[0], r[1]);
              fat::mma_16816(s[2 * np + 1], qa, r[2], r[3]);
            }
          }
        }
      }

      // Logits in the log2 domain, masked; the tile's row maxima. Element
      // e of s[j]: row g + 8 (e / 2), column 8 j + 2 tig + e % 2.
      unsigned live = 0u;
      float mx[2] = {kMaskValue, kMaskValue};
      // `bias` is 0 (none), 1 (the soft-cap) or 2 (ALiBi).
      auto logits = [&](auto window, auto bias) {
        constexpr int kBias = decltype(bias)::value;
        float alibi0[2];  // ALiBi at this lane's first column of the tile
        if constexpr (kBias == 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            alibi0[h] = slope[h] * static_cast<float>(n0 + 2 * tig - row_pos[h]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * tig + (e & 1), h = e >> 1;
            float x = s[j][e];
            if constexpr (kMode == Mode::kInt8)
              x *= q_scale[h] * ksc[c];
            else if constexpr (kMode == Mode::kFp8)
              x *= ksc[c];
            else
              x *= a.scale_log2;
            if constexpr (kBias == 1)
              x = fat::softcap_tanh(x * a.inv_cap) * a.cap_log2;
            if constexpr (kBias == 2)
              x += fmaf(slope[h], static_cast<float>(8 * j + (e & 1)), alibi0[h]);
            if (visible<decltype(window)::value>(a, c, n_live, n0 + c, row_pos[h])) {
              live |= 1u << (4 * j + e);
              mx[h] = fmaxf(mx[h], x);
            }
            s[j][e] = x;
          }
      };
      auto run_logits = [&](auto window) {  // the soft-cap's flag, once a tile
        if constexpr (kAlibi)
          logits(window, std::integral_constant<int, 2>{});
        else if (a.cap_log2 > 0.f)
          logits(window, std::integral_constant<int, 1>{});
        else
          logits(window, std::integral_constant<int, 0>{});
      };
      if constexpr (kWindow) {
        if (n0 < win_full && n0 + kBlockN > a.sink) {
          run_logits(std::true_type{});
        } else {
          run_logits(std::false_type{});
        }
      } else {
        run_logits(std::false_type{});
      }
      float alpha[2], f[2] = {1.f, 1.f}, rmax[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      // P (into s), l; quantized: P x v_scale.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tig + (e & 1), h = e >> 1;
          const float p = (live >> (4 * j + e)) & 1u ? exp2f(s[j][e] - m[h]) : 0.f;
          l[h] += p;
          s[j][e] = kBytes ? p * vsc[c] : p;
          if constexpr (kMode == Mode::kInt8) rmax[h] = fmaxf(rmax[h], s[j][e]);
        }
      if constexpr (kMode == Mode::kInt8) {
        // P x v_scale requantized to int8 over the row's tile.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
          rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
          rmax[h] = rmax[h] < kRmaxMin ? 1.f : rmax[h];
          f[h] = rmax[h] / 127.f;
          const float mul = 127.f / rmax[h];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j][2 * h] = rintf(s[j][2 * h] * mul);
            s[j][2 * h + 1] = rintf(s[j][2 * h + 1] * mul);
          }
        }
      }

      if constexpr (kMode == Mode::kInt8) {
        // P.V on int8: p8 (0..127) from the S accumulators as the A
        // fragments of 32 positions a step. Fragment k = 4 tig + i holds
        // position 2 tig + i of the step (i < 2) or 8 + 2 tig + i - 2, and
        // k = 16 + 4 tig + i the same 16 positions on; v's B fragments
        // gather those positions' bytes from transposed ldmatrix tiles.
        unsigned pa8[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2) {  // a0 a1 a2 a3: (row g | g + 8) x (n-tiles 0-1 | 2-3)
            const int j = 4 * kk + 2 * (i2 / 2), e = 2 * (i2 & 1);
            pa8[kk][i2] = static_cast<unsigned>(s[j][e]) | static_cast<unsigned>(s[j][e + 1]) << 8 |
                          static_cast<unsigned>(s[j + 1][e]) << 16 |
                          static_cast<unsigned>(s[j + 1][e + 1]) << 24;
          }
#pragma unroll
        for (int c16 = 0; c16 < kDh / 16; ++c16) {
          const int cb = 16 * (c16 + half * (kDh / 16));  // bytes of this warp's dims
          int pvi[2][4];  // even and odd dims of cb .. cb + 15
#pragma unroll
          for (int j = 0; j < 2; ++j) pvi[j][0] = pvi[j][1] = pvi[j][2] = pvi[j][3] = 0;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            // Matrix m: positions 32 kk + 8 m .. + 7 at bytes cb .. cb + 15.
            unsigned r[4];
            ldsm_x4_t(r, vs + (32 * kk + 8 * (lane / 8) + lane % 8) * L::kLd + cb);
            mma_s8(pvi[0], pa8[kk], __byte_perm(r[0], r[1], 0x6420u),
                   __byte_perm(r[2], r[3], 0x6420u));
            mma_s8(pvi[1], pa8[kk], __byte_perm(r[0], r[1], 0x7531u),
                   __byte_perm(r[2], r[3], 0x7531u));
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[2 * c16 + j][e] =
                  o[2 * c16 + j][e] * alpha[e >> 1] + static_cast<float>(pvi[j][e]) * f[e >> 1];
        }
      } else {
        // P as the A fragments of P.V, per 16-position k-step (fp8: hi and
        // lo halves): element e of s[j] is row g + 8 (e / 2), position
        // 8 j + 2 tig + e % 2.
        constexpr int kParts = kMode == Mode::kFp8 ? 2 : 1;
        auto pack_p = [&](int kk, unsigned (&pk)[kParts][4]) {
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2) {
            const float x0 = s[2 * kk + i2 / 2][2 * (i2 & 1)];
            const float x1 = s[2 * kk + i2 / 2][2 * (i2 & 1) + 1];
            pk[0][i2] = fat::pack_bf16(x0, x1);
            if constexpr (kParts == 2)
              pk[1][i2] = fat::pack_bf16(x0 - fat::round_to<bf16>(x0),
                                         x1 - fat::round_to<bf16>(x1));
          }
        };
        // This warp's dims 16 c16 .. + 15 (2 n-tiles of O) += P's k step
        // kk . V; the dims start at cb of the tile's rows.
        auto pv_step = [&](int c16, int kk, const unsigned (&pk)[kParts][4]) {
          const int cb = 16 * (c16 + half * (kDh / 16));
          unsigned r[4];
          if constexpr (kBytes) {
            // Matrices: positions 16 kk + 0..7 and + 8..15 at bytes
            // cb .. cb + 15. Bytes of r[i]: (pos 2 tig, dim 2 g),
            // (2 tig, 2 g + 1), (2 tig + 1, 2 g), (2 tig + 1, 2 g + 1);
            // permuted to the even dim's pair low, the odd dim's high.
            ldsm_x2_t(r, vs + (16 * kk + lane % 8 + 8 * ((lane / 8) & 1)) * L::kLd + cb);
            const unsigned lo = __byte_perm(r[0], 0u, 0x3120u);
            const unsigned hi = __byte_perm(r[1], 0u, 0x3120u);
            r[0] = widen2(lo);
            r[1] = widen2(hi);
            r[2] = widen2(lo >> 16);
            r[3] = widen2(hi >> 16);
          } else {
            constexpr int kLdV = L::kLd / 2;
            fat::ldsm_x4_t(r, reinterpret_cast<const bf16*>(vs) + (16 * kk) * kLdV + cb +
                                  fat::lane_offset<true>(lane, kLdV));
          }
#pragma unroll
          for (int part = 0; part < kParts; ++part) {
            fat::mma_16816(o[2 * c16], pk[part], r[0], r[1]);
            fat::mma_16816(o[2 * c16 + 1], pk[part], r[2], r[3]);
          }
        };
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
        unsigned pa[4][kParts][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pack_p(kk, pa[kk]);
        // P.V into O, 16 dims (2 n-tiles) at a time.
#pragma unroll
        for (int c16 = 0; c16 < kDh / 16; ++c16)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) pv_step(c16, kk, pa[kk]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (stages == 1 && i + 1 < rounds) issue(i + 1, 0);
  }

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the merge may start

  // The warps' states into shared memory (over the stages), l summed over
  // each row's four lanes; then each CTA row merges its warps in order.
  float* red_acc = reinterpret_cast<float*>(stages_mem);  // [4][16][kRedLd]
  float* red_m = red_acc + kWarps * 16 * L::kRedLd;       // [4][16]
  float* red_l = red_m + kWarps * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_acc[(warp * 16 + g + 8 * (e >> 1)) * L::kRedLd + acc_dim<kBytes>(nt, e, tig)] =
          o[nt][e];
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red_m[warp * 16 + g + 8 * h] = m[h];
      red_l[warp * 16 + g + 8 * h] = l[h];
    }
  }
  __syncthreads();

  const size_t bh = static_cast<size_t>(b) * a.Hkv + hk;
  const size_t part_row = (bh * a.num_splits + sp) * R + r0;
  T* o_rows = static_cast<T*>(a.o) + (bh * R + r0) * a.d;  // this CTA's rows, d apart
  float* acc_rows = a.part_acc + part_row * a.d;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, dd = i % D, rr = r % 16;
    if (dd >= a.d) continue;  // O's dims at and past the head dim: zeros, not stored
    // The warps of row r's group that hold dim dd, one a tile slot, and
    // the dim's place in their accumulators.
    const int w0 = (r / 16) * kTiles * L::kHalves + dd / kDh, dh = dd % kDh;
    constexpr int kStep = L::kHalves;
    float mmax = kMaskValue;
#pragma unroll
    for (int w = w0; w < w0 + kTiles * kStep; w += kStep)
      if (red_l[w * 16 + rr] > 0.f) mmax = fmaxf(mmax, red_m[w * 16 + rr]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = w0; w < w0 + kTiles * kStep; w += kStep) {
      const float lw = red_l[w * 16 + rr];
      if (lw > 0.f) {
        const float wt = exp2f(red_m[w * 16 + rr] - mmax);
        den = fmaf(wt, lw, den);
        num = fmaf(wt, red_acc[(w * 16 + rr) * L::kRedLd + dh], num);
      }
    }
    if (a.num_splits == 1) {
      o_rows[r * a.d + dd] = fat::from_f<T>(den > 0.f ? num / den : 0.f);
    } else {
      if (den > 0.f) acc_rows[r * a.d + dd] = num;  // read only where l > 0
      if (dd == 0) {
        a.part_m[part_row + r] = mmax;
        a.part_l[part_row + r] = den;
      }
    }
  }
  if (a.num_splits == 1 && a.lse != nullptr) {  // the rows' (m, l) as O's loop merged them
    for (int r = tid; r < nr; r += kThreads) {
      const int rr = r % 16, w0 = (r / 16) * kTiles * L::kHalves;
      float mmax = kMaskValue, den = 0.f;
      for (int w = w0; w < w0 + kTiles * L::kHalves; w += L::kHalves)
        if (red_l[w * 16 + rr] > 0.f) mmax = fmaxf(mmax, red_m[w * 16 + rr]);
      for (int w = w0; w < w0 + kTiles * L::kHalves; w += L::kHalves) {
        const float lw = red_l[w * 16 + rr];
        if (lw > 0.f) den = fmaf(exp2f(red_m[w * 16 + rr] - mmax), lw, den);
      }
      a.lse[bh * R + r0 + r] = row_lse(mmax, den);
    }
  }
}

// ---- f32 q and cache: the CUDA cores ----

// Query rows a CTA of decode_f32_kernel: 64, 32 at D 256, where the
// layout's shared memory at 64 rows would pass 227 KB.
template <int D>
constexpr int kF32Rows = D > 128 ? 32 : 64;

// Shared memory of decode_f32_kernel, in floats, for `rb` rows: qs [rb][D+1],
// ks [BN][D+1], vs [BN][D], ps [rb][BN+1], acc [rb][D], m, l, alpha [rb].
size_t f32_smem_bytes(int rb, int D) {
  return sizeof(float) * (static_cast<size_t>(rb) * (D + 1) + kBlockN * (D + 1) +
                          kBlockN * D + static_cast<size_t>(rb) * (kBlockN + 1) +
                          static_cast<size_t>(rb) * D + 3 * static_cast<size_t>(rb));
}

template <int D>
__global__ void __launch_bounds__(kThreads) decode_f32_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const int R = (a.Hq / a.Hkv) * a.Tc;
  const int RB = min(kF32Rows<D>, R);  // rows the shared-memory layout holds
  const int b = blockIdx.x, hk = blockIdx.y / a.row_blocks;
  const int r0 = (blockIdx.y % a.row_blocks) * kF32Rows<D>;
  const int nr = min(kF32Rows<D>, R - r0);
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int len = min(a.length[b], a.Smax);
  const Span span = live_span(a, len);
  const int start = sp * a.split_len;  // [start, vend) of the virtual span
  const int vend = min(start + a.split_len, len - span.gap);
  // Partial-result row index of (b, hk, sp, r0 + r) is part_base + r.
  const size_t part_base =
      ((static_cast<size_t>(b) * a.Hkv + hk) * a.num_splits + sp) * R + r0;

  if (start >= vend) {  // slice wholly past this sequence's span
    for (int r = tid; r < nr; r += kThreads) {
      a.part_m[part_base + r] = kMaskValue;
      a.part_l[part_base + r] = 0.f;
    }
    return;
  }

  extern __shared__ float f32_smem[];
  float* qs = f32_smem;
  float* ks = qs + RB * DP;
  float* vs = ks + kBlockN * DP;
  float* ps = vs + kBlockN * D;
  float* acc = ps + RB * PP;
  float* st_m = acc + RB * D;
  float* st_l = st_m + RB;
  float* st_a = st_l + RB;

  const size_t q_row = (static_cast<size_t>(b) * a.Hkv + hk) * R + r0;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, dd = i % D;  // dims at and past the head dim are zeros
    qs[r * DP + dd] = dd < a.d ? q[(q_row + r) * a.d + dd] * a.scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
    st_m[r] = kMaskValue;
    st_l[r] = 0.f;
  }

  for (int v0 = start; v0 < vend; v0 += kBlockN) {
    const int n0 = span.pos(v0);
    const Tile tl = tile_at(a, b, hk, n0, len);
    const int n_live = tl.n_live;
    __syncthreads();  // previous tile consumed; q, acc and stats stored
    // Rows at or past `length` are never loaded (n_live stops there).
    fat::load_tile<float, kBlockN, D, kThreads>(k + tl.base * a.d, n_live, a.d, ks, DP);
    fat::load_tile<float, kBlockN, D, kThreads>(v + tl.base * a.d, n_live, a.d, vs, D);
    __syncthreads();

    // Logits of the tile (log2 domain); masked entries hold kMaskValue.
    for (int i = tid; i < nr * kBlockN; i += kThreads) {
      const int r = i / kBlockN, c = i % kBlockN;
      float s = kMaskValue;
      if (visible(a, c, n_live, n0 + c, row_position(r0 + r, len, a.Tc))) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * DP + d], ks[c * DP + d], dot);
        s = a.cap_log2 > 0.f ? fat::softcap_tanh(dot * a.inv_cap) * a.cap_log2 : dot;
        if (a.slopes != nullptr)
          s = fmaf(row_slope(a, hk, r0 + r),
                   static_cast<float>(n0 + c - row_position(r0 + r, len, a.Tc)), s);
      }
      ps[r * PP + c] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row; lanes hold columns lane and lane+32.
    for (int r = warp; r < nr; r += kWarps) {
      const int row_pos = row_position(r0 + r, len, a.Tc);
      const bool live0 = visible(a, lane, n_live, n0 + lane, row_pos);
      const bool live1 = visible(a, lane + 32, n_live, n0 + lane + 32, row_pos);
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
      ps[r * PP + lane] = p0;
      ps[r * PP + lane + 32] = p1;
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
      float x = acc[i] * st_a[r];
      for (int c = 0; c < n_live; ++c) x = fmaf(ps[r * PP + c], vs[c * D + dd], x);
      acc[i] = x;
    }
  }
  __syncthreads();

  for (int r = tid; r < nr; r += kThreads) {
    a.part_m[part_base + r] = st_m[r];
    a.part_l[part_base + r] = st_l[r];
  }
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    if (dd < a.d) a.part_acc[(part_base + r) * a.d + dd] = acc[i];  // zeros past d: not stored
  }
}

// ---- launchers ----

// The most virtual positions live_span gives a sequence (ops/decode.py::
// live_span): the sink tiles, the window and T - 1 more positions rounded up
// to a tile, and one tile for the edge tile's positions before the window.
long long live_span_bound(int Smax, int Tc, int window, int sink) {
  if (window == 0) return Smax;
  auto up = [](long long x) { return (x + kBlockN - 1) / kBlockN * kBlockN; };
  return std::min<long long>(Smax, up(sink) + up(static_cast<long long>(window) + Tc - 1) +
                                       kBlockN);
}

int max_smem_optin() {
  static const int bytes = [] {
    int dev = 0, value = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
    return value;
  }();
  return bytes;
}

template <typename T, int D>
cudaError_t launch_merge(const Args& a, cudaStream_t stream) {
  const int R = (a.Hq / a.Hkv) * a.Tc;
  const int rows = a.B * a.Hkv * R;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((rows + kMergeRows - 1) / kMergeRows);
  cfg.blockDim = dim3(32 * kMergeRows);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return a.lse != nullptr ? cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, D, true>, a)
                          : cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, D, false>, a);
}

template <typename T, typename C, int D, int kTiles, bool kWindow, bool kAlibi>
cudaError_t launch_mma(Args a, cudaStream_t stream) {
  using L = MmaLayout<C, D, kTiles>;
  const int R = (a.Hq / a.Hkv) * a.Tc;
  a.row_blocks = (R + L::kRows - 1) / L::kRows;
  if (static_cast<long long>(a.Hkv) * a.row_blocks > 65535 || a.num_splits > 65535)
    return cudaErrorInvalidConfiguration;
  // Two stages where a CTA walks more than one round of tiles and they fit.
  const int rounds = (a.split_len / kBlockN + kTiles - 1) / kTiles;
  const int stages =
      rounds > 1 && L::smem_bytes(2) <= static_cast<size_t>(max_smem_optin()) ? 2 : 1;
  cudaError_t err = fat::allow_max_smem<decode_mma_kernel<T, C, D, kTiles, kWindow, kAlibi>>();
  if (err != cudaSuccess) return err;
  decode_mma_kernel<T, C, D, kTiles, kWindow, kAlibi>
      <<<dim3(a.B, a.Hkv * a.row_blocks, a.num_splits), kThreads, L::smem_bytes(stages),
         stream>>>(a, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.num_splits == 1) return err;
  return launch_merge<T, D>(a, stream);
}

template <int D>
cudaError_t launch_f32(Args a, cudaStream_t stream) {
  const int R = (a.Hq / a.Hkv) * a.Tc;
  a.row_blocks = (R + kF32Rows<D> - 1) / kF32Rows<D>;
  if (static_cast<long long>(a.Hkv) * a.row_blocks > 65535 || a.num_splits > 65535)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = fat::allow_max_smem<decode_f32_kernel<D>>();
  if (err != cudaSuccess) return err;
  decode_f32_kernel<D><<<dim3(a.B, a.Hkv * a.row_blocks, a.num_splits), kThreads,
                         f32_smem_bytes(std::min(R, kF32Rows<D>), D), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<float, D>(a, stream);
}

// Up to 16 query rows a group: 4 tiles at a time, one a warp (2 at D 256,
// two warps a tile); more: 64 rows a CTA, a warp 16 of them (32 rows at
// D 256) (ops/decode.py::_layout); the ALiBi instantiations or the others.
template <typename T, typename C, int D, bool kAlibi>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  constexpr int kFew = MmaLayout<C, D, 1>::kHalves == 2 ? 2 : 4;
  const bool few = (a.Hq / a.Hkv) * a.Tc <= 16;
  if (a.window > 0)
    return few ? launch_mma<T, C, D, kFew, true, kAlibi>(a, stream)
               : launch_mma<T, C, D, 1, true, kAlibi>(a, stream);
  return few ? launch_mma<T, C, D, kFew, false, kAlibi>(a, stream)
             : launch_mma<T, C, D, 1, false, kAlibi>(a, stream);
}

template <typename T, int D, bool kAlibi>
cudaError_t dispatch_cache(const Args& a, int dtype, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == fat::kInt8) return launch_rows<T, int8_t, D, kAlibi>(a, s);
  if (kv_dtype == fat::kFp8) return launch_rows<T, fp8, D, kAlibi>(a, s);
  if (kv_dtype != dtype) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>)
    return launch_f32<D>(a, s);
  else
    return launch_rows<T, T, D, kAlibi>(a, s);
}

// q [B,Hq,T,D] of `dtype`; k/v of `kv_dtype`: dense [B,Hkv,Smax,D] (table
// null) or pages [P,Hkv,page,D] with table [B,max_pages] int32 and
// Smax = max_pages * page, page a multiple of 64, num_pages = P (table
// entries outside [0, P) hold no key); k_scale/v_scale f32
// [B,Hkv,1,Smax] or [P,Hkv,1,page] for a quantized cache; length [B] int32;
// part_m/part_l [B,Hkv,splits,R] and part_acc [B,Hkv,splits,R,D] fp32
// scratch (d = D, the head dim); o like q. All contiguous on the device,
// k and v 16-byte aligned;
// window 0 (none) or the sliding window, sink the always-visible first
// positions (needs a window); split_len a multiple of 64 and
// split_len * num_splits >= the live span (live_span_bound: Smax without a window); scale_log2 q's
// pre-scale and, for a soft-cap, inv_cap = 1 / cap and cap_log2 =
// cap * log2(e) (both 0 without one); slopes the [Hq] float32 ALiBi table
// or null (not with a cap); lse [B,Hq,T] float32 or null. Returns the CUDA
// error code (0 = success). kAlibi: the library of the ALiBi
// instantiations (decode_alibi.cu), which takes slopes and only slopes.
// kD256: the library of the D 256 instantiations (decode_d256.cu,
// decode_alibi_d256.cu), which takes the head dims of the 256 tile; the
// others take those of the 64 and 128 tiles (D a multiple of 16 up to 128:
// 32, 64, 80, 96 and 128 through the Python wrappers). Four libraries,
// compiled side by side, each a quarter of the instantiations.
template <bool kAlibi, bool kD256>
int decode_launch_impl(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, const void* length, const void* table,
                       const void* slopes, void* part_m, void* part_l, void* part_acc, void* o,
                       void* lse, int B, int Hq, int Hkv, int Tc, int Smax, int D, int dtype,
                       int kv_dtype, int max_pages, int page, int num_pages, int split_len,
                       int num_splits, int window, int sink, float scale_log2, float inv_cap,
                       float cap_log2, void* stream) {
  const bool quantized = kv_dtype == fat::kInt8 || kv_dtype == fat::kFp8;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tc <= 0 || Smax <= 0 || split_len <= 0 ||
      !fat::head_dim_ok(D) ||
      split_len % kBlockN != 0 || num_splits <= 0 || window < 0 || sink < 0 ||
      (sink > 0 && window == 0) || inv_cap < 0.f || cap_log2 < 0.f ||
      (inv_cap > 0.f) != (cap_log2 > 0.f) || (slopes != nullptr) != kAlibi ||
      (kAlibi && cap_log2 > 0.f) ||
      static_cast<long long>(split_len) * num_splits < live_span_bound(Smax, Tc, window, sink) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)) ||
      (table != nullptr && (page <= 0 || page % kBlockN != 0 ||
                            static_cast<long long>(max_pages) * page != Smax)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(length), static_cast<const int*>(table),
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), o, B, Hq, Hkv, Tc, Smax, max_pages, page, num_pages,
         split_len, num_splits, 0, window, sink, scale_log2, inv_cap, cap_log2,
         static_cast<const float*>(slopes), static_cast<float*>(lse), D};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const int tile = fat::head_tile(D);  // the compiled tile that takes D
  if constexpr (kD256) {
    if (dtype == fat::kBF16 && tile == 256)
      err = dispatch_cache<bf16, 256, kAlibi>(a, dtype, kv_dtype, s);
    else if (dtype == fat::kF32 && tile == 256)
      err = dispatch_cache<float, 256, kAlibi>(a, dtype, kv_dtype, s);
  } else {
    if (dtype == fat::kBF16 && tile == 64)
      err = dispatch_cache<bf16, 64, kAlibi>(a, dtype, kv_dtype, s);
    else if (dtype == fat::kBF16 && tile == 128)
      err = dispatch_cache<bf16, 128, kAlibi>(a, dtype, kv_dtype, s);
    else if (dtype == fat::kF32 && tile == 64)
      err = dispatch_cache<float, 64, kAlibi>(a, dtype, kv_dtype, s);
    else if (dtype == fat::kF32 && tile == 128)
      err = dispatch_cache<float, 128, kAlibi>(a, dtype, kv_dtype, s);
  }
  return static_cast<int>(err);
}

}  // namespace
