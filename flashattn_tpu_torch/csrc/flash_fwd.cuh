// K1: flash-attention forward, O and the natural-log LSE, for Hopper (sm_90a).
// Four libraries build from this header: flash_fwd.cu (every instantiation
// without dropout or the offset read on the card), flash_fwd_dropout.cu
// (kDropout's), flash_fwd_dynoff.cu (kDyn's: the q/k alignment read from
// the card once a CTA, so one launch shape serves every offset; the call is
// not causal and the window is its left edge alone) and
// flash_fwd_dynoff_dropout.cu (kDyn's with kDropout), side by side.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_fwd.py::_fwd_kernel
// (launcher flash_attention_forward, :469) and
// flashattn_tpu/ops/flash_fwd_grid4.py::_grid4_kernel (launcher
// flash_attention_forward_grid4, :267) on their common plain subset: causal
// (bottom-right, or by pos_offset) or not, GQA, ragged S_q/S_k, optional LSE,
// the sliding window (causal only: row r sees column c iff
// r + offset - window < c <= r + offset), packed-document segment ids
// (row r sees column c only if seg_q[b][r] == seg_k[b][c]), the logit
// soft-cap (s = tanh(s / cap) * cap on the scaled logits, before any mask)
// and ALiBi (slope_h * (c - r - offset) added to the scaled logits, before
// any mask, with or without the window and segment ids; not with the
// soft-cap), and attention dropout beside each of them (the JAX kernel's
// at flash_fwd.py:378-392), at head dims 64, 128 and 256, and 32, 80 and
// 96 at run time inside the compiled tiles (32 in the 64 tile, 80 and 96 in
// the 128 tile; common.cuh head_tile): the maps read the columns past the
// true head dim as zeros, and O is stored to it.
// The TPU's two grid shapes, its wavefront meta arrays, h_fuse and the
// ones-column row sum are Mosaic designs and are not carried over.
//
// What bounds it on the card: at the training shape (B 4, Hq 32, S 2048,
// D 64, causal) a call is 69 GFLOP against 67 MB of q, k, v and O, so the
// bf16 tensor cores bound it (0.07 ms at 989 TFLOP/s). At D 64 the softmax
// costs as much as the products: each kv tile of a 64-row warpgroup is
// 2 MFLOP on the tensor cores and 8192 exponentials on the SM's 16-a-clock
// special-function units, about 1024 clocks each, so the kernel can reach
// the tensor cores' rate only as far as the two overlap. What else keeps it
// from that rate: tile copies the products wait for, and a CTA's prologue
// (Q's copy, the first K tile) and epilogue (O's stores), which no product
// of that CTA covers. At the serving path's prefill shapes (S <= a few
// hundred) a CTA's work is a few MFLOP and that latency bounds it.
//
// What the design does about it (flash_fwd_wgmma_kernel, bf16): a CTA owns
// a q tile of 64 rows (one consumer warpgroup) at D 64 and of 128 rows (two)
// at D 128 and 256. At D 64 three 64-row CTAs share an SM, so one CTA's
// prologue, epilogue and softmax run under another's products; at D 128 and
// 256 a CTA has an SM to itself and its two warpgroups share each K/V tile.
// A kv tile is 128 columns, 64 at D 256 (FwdLayout::kTileN), where Q's
// 64 KB and a two-stage ring of 128-column K and V tiles (256 KB) would not
// fit the SM's 227 KB: the 64-column ring takes 128 KB. There a consumer
// thread holds a 64 x 256 fp32 O (128 registers), S and P of a 64-column
// tile (48): setmaxnreg gives the consumers 240 a thread and the producer
// 24, as at D 128. One producer warp copies Q once and the K and V tiles of
// the kv loop by TMA into
// a two-stage ring with 128-byte swizzle (3-D tensor maps, so the ragged
// last tile of a head reads zeros, not the next head), signalling
// full/empty mbarriers; the next tile's copy runs under the current tile's
// products. Both products run on wgmma with fp32 accumulators: S = Q K^T
// (m64nNk16 with N the tile's columns, Q and K from shared memory,
// K-major), then P stays in registers, rounded to bf16 pairwise (the S
// accumulator layout is the register A-fragment layout), and O += P V
// (m64nDk16, one m64n256k16 at D 256) reads V's row-major
// [keys][D] tile as an MN-major B operand, so V is never transposed. The kv
// loop runs over the tiles the q tile's rows reach, from the last down: the
// at most two tiles that straddle the causal bound or S_k come first and
// are masked, then the tiles every row of the warpgroup sees whole, which
// run no mask code, and with a window last the at most two tiles that
// straddle the window's left edge, masked again. Tiles wholly left of the
// window are neither loaded nor visited. q tiles are dispatched heaviest
// first (the grid's slow axis walks them in descending q0): a tile's kv
// extent never falls as q0 grows, causal (a ramp) or windowed (a ramp up to
// window + the tile's height, then flat), so the short tiles of the ramp
// fill the tail. With segment ids (kSeg) a consumer warpgroup compares its
// rows' id range with each tile's (the 32-position block ranges of
// common.cuh): a tile of other documents only is waited for and released,
// not computed (the producer's walk stays the window's); a tile whose rows
// and columns carry one id runs no id mask; the others compare each
// thread's two row ids, kept in registers, with the tile's column ids, read
// from device memory (L1-cached). With the soft-cap (kCap) the raw scores
// become tanh(s * scale / cap) * cap * log2(e) right after the S product,
// before every mask (common.cuh softcap_tanh): only scale folds before the
// tanh, as in the JAX kernel, and the softmax then runs on the exp2-domain
// logits as they are; without it the kernel has no tanh code at all. With
// ALiBi (kAlibi) every tile's raw scores become s * scale * log2(e) +
// slope * log2(e) * (c - r - offset) before the masks, the interior tiles
// included: a thread's two rows each take their row term (the tile's first
// column of its lanes less the row and the offset, times the slope) once a
// tile, and each score one FMA of the slope by its column's constant
// offset within the tile and one of its raw score by the scale. The kv loop
// walks from the last tile down, where the bias is largest (the causal
// diagonal's, near 0), so the running max is set first and the far tiles'
// biases (about -slope * S) underflow their exponents to 0; a row whose
// first tiles hide every key keeps its max at -inf and alpha 0, as without
// the bias. With segment ids too (packed documents) the bias uses the
// global packed positions, which within a document is the document's own
// distance: the id mask then composes with it unchanged, and a tile of
// other documents is skipped as without the bias. The backward kernels
// rebuild this bias term for term (flash_bwd.cuh fwd_tile_n). With dropout
// (kDropout) the P of each tile, after its row sums have been added to l
// (so l, and the LSE, stay those without dropout) and before it is
// packed to bf16 for P V, keeps the elements common.cuh's dropout_keep
// keeps and is 0 elsewhere; 1 / (1 - rate) is folded into the epilogue's
// 1 / l. A thread's two rows take their hash terms once a CTA and its
// columns once a tile (dropout_col_step folds the fragment's column
// offsets into constants), so a score pays the hash's avalanche alone,
// about ten integer instructions beside two exponent-domain FMAs and an
// exp2: at D 64 as many issue slots as the rest of the softmax. The
// kernels without dropout are instantiated apart and run none of its code.
// No atomics: two calls give the same bits. The softmax
// uses the exp2 domain (row max of the raw scores, one FFMA and one
// MUFU.EX2 per exponent), fp32 (m, l),
// masked scores of -inf with a zero max for rows that have seen no key yet,
// so rows that see no key end with l = 0: O = 0, LSE = -inf. Measured and
// not kept (PERF.md, section 6): issuing the next tile's S with this tile's P V
// so the softmax overlaps it, alone or with two warpgroups taking turns on
// the tensor cores, and a three-stage ring.
//
// float32 runs a CUDA-core kernel (flash_fwd_kernel): four threads per q
// row, each computing 16 logits of the tile and D/4 output columns, P
// rounded to the input dtype for P.V as the TPU kernel feeds its MXU; the
// soft-cap (cap_log2 > 0) and ALiBi (slopes not null) are uniform branches,
// dropout and the offset read on the card the template flags kDropout and
// kDyn.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: declarations only, libcuda is not linked

#include "common.cuh"

namespace {

using fat::kMaskValue;

// float32 kernel: 64-row q tiles, 64-column kv tiles, 256 threads.
constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // kv columns per tile
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kBlockM;      // 4
constexpr int kColsPerThread = kBlockN / kThreadsPerRow;  // 16

template <int D>
constexpr size_t smem_bytes() {
  // qs [BM][D+1], ks [BN][D+1], vs [BN][D], ps [BM][BN+1], all fp32, then
  // the kv tile's segment ids [BN].
  return sizeof(float) * (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
                          kBlockM * (kBlockN + 1) + kBlockN);
}

// Columns [0, kv_limit) can be visible to some row of the block_m-row q
// tile at q0.
__device__ __forceinline__ int kv_limit(int q0, int block_m, int Sq, int Sk, int is_causal,
                                        int offset) {
  if (!is_causal) return Sk;
  const int last_row = min(q0 + block_m, Sq) - 1;
  return max(0, min(Sk, last_row + offset + 1));
}

// The first kv tile of `block_n` columns that a row at or after q0 can see:
// 0, or with a window the tile of the first row's left edge.
__device__ __forceinline__ int kv_first_tile(int q0, int offset, int window, int block_n) {
  return window > 0 ? max(0, q0 + offset - window + 1) / block_n : 0;
}

// ---- float32: CUDA cores (fp32 FMA over shared-memory tiles) ----

template <int D, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, const float* __restrict__ slopes, int Hq,
                 int Hkv, int Sq, int Sk, int d, int is_causal, int offset_arg, int window,
                 float scale_log2, float cap_log2, const fat::Dropout drop,
                 const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment is read from the card once, at the start.
  const int offset = kDyn ? __ldg(dyn_offset) : offset_arg;
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  constexpr int kDimsPerThread = D / kThreadsPerRow;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * DP;
  float* vs = ks + kBlockN * DP;
  float* ps = vs + kBlockN * D;
  int* segs = reinterpret_cast<int*>(ps + kBlockM * PP);

  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerRow;  // this thread's row in the tile
  const int t = tid % kThreadsPerRow;  // its lane within the row's group
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_base = (static_cast<size_t>(b) * Hq + h) * Sq * d;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * Sk * d;
  const int qi = q0 + r;
  const int row_seg = seg_q != nullptr && qi < Sq ? seg_q[static_cast<size_t>(b) * Sq + qi] : 0;
  // Dropout's term of row qi (bh = b * Hq + h).
  const unsigned drop_row =
      kDropout ? fat::dropout_row(qi, fat::dropout_head(drop, b * Hq + h)) : 0u;

  // Columns from d to D load as zeros (common.cuh head_tile): they add
  // nothing to S and leave O's columns there 0, which are not stored.
  fat::load_tile<float, kBlockM, D, kThreads>(q + q_base + static_cast<size_t>(q0) * d,
                                              Sq - q0, d, qs, DP, scale_log2);
  const int kv_end = kv_limit(q0, kBlockM, Sq, Sk, is_causal, offset);

  float m = kMaskValue, l = 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;

  for (int n0 = kv_first_tile(q0, offset, window, kBlockN) * kBlockN; n0 < kv_end;
       n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed (and Q stored, first time)
    const size_t tile = kv_base + static_cast<size_t>(n0) * d;
    fat::load_tile<float, kBlockN, D, kThreads>(k + tile, kv_end - n0, d, ks, DP);
    fat::load_tile<float, kBlockN, D, kThreads>(v + tile, kv_end - n0, d, vs, D);
    if (seg_k != nullptr && tid < kBlockN)
      segs[tid] = n0 + tid < kv_end ? seg_k[static_cast<size_t>(b) * Sk + n0 + tid] : 0;
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
    if (cap_log2 > 0.f) {  // q carries scale / cap: s is the capped logit's tanh argument
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[j] = fat::softcap_tanh(s[j]) * cap_log2;
    }
    if (slopes != nullptr) {  // ALiBi: + slope * log2(e) * (c - row - offset)
      const float slope = slopes[h] * fat::kLog2e;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        s[j] = fmaf(slope, static_cast<float>(n0 + t + kThreadsPerRow * j - qi - offset), s[j]);
    }

    unsigned live = 0;
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = n0 + t + kThreadsPerRow * j;
      if (c < kv_end && (!is_causal || c <= qi + offset) &&
          (window == 0 || c >= qi + offset - window + 1) &&
          (seg_k == nullptr || segs[c - n0] == row_seg)) {
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
      // Dropout acts on the P that meets V alone: l keeps every p.
      const bool keep =
          !kDropout || fat::dropout_keep(drop_row, fat::dropout_col(n0 + t + kThreadsPerRow * j),
                                         drop.threshold);
      ps[r * PP + t + kThreadsPerRow * j] = keep ? p : 0.f;
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
    const float inv = l > 0.f ? (kDropout ? drop.scale : 1.f) / l : 0.f;
    float* orow = o + q_base + static_cast<size_t>(qi) * d;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)  // O's columns at and past d are not stored
      if (t + kThreadsPerRow * i < d) orow[t + kThreadsPerRow * i] = acc[i] * inv;
    if (lse != nullptr && t == 0) {
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + qi] =
          l > 0.f ? (m + log2f(l)) * fat::kLn2 : -CUDART_INF_F;
    }
  }
}

// ---- bf16: wgmma, a TMA-fed K/V ring, one or two consumer warpgroups ----

using fat::pack_bf16;
using fat::smem_addr;

constexpr int kAtom = 64;    // bf16 columns of one 128-byte swizzle atom
constexpr int kStages = 2;   // K/V ring depth

// Shared memory of the kernel with kConsumers warpgroups of 64 q rows. Each
// operand tile is stored as D/64 column atoms of [rows][64] bf16, 128-byte
// rows swizzled as TMA's SWIZZLE_128B writes them; every atom starts on a
// 1024-byte boundary, as the swizzle pattern repeats every 8 rows.
template <int D, int kConsumers>
struct FwdLayout {
  static constexpr int kTileN = D > 128 ? 64 : 128;  // kv columns per tile
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kTileN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // mbarriers, 8 bytes each: Q's, then K's and V's full and the stages' empty ones.
  static constexpr int kQFull = kV + kStages * kTileBytes;
  static constexpr int kKFull = kQFull + 8;
  static constexpr int kVFull = kKFull + 8 * kStages;
  static constexpr int kEmpty = kVFull + 8 * kStages;
  static constexpr int kBytes = kEmpty + 8 * kStages + 1024;  // + the base's alignment
  static_assert(kBytes <= 232448, "an H100 CTA takes at most 227 KB of shared memory");
  // + a producer warpgroup beside two consumer warpgroups; one consumer
  // warpgroup is its own producer, so three 4-warp CTAs share an SM at D 64
  // with 168 registers a thread (see flash_fwd_wgmma_kernel).
  static constexpr int kThreads = kConsumers == 2 ? 384 : 128;
};

// Shared memory is addressed by 32-bit shared-window addresses throughout
// (two registers fewer than a generic pointer each).
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 2^x in one MUFU instruction (denormal results flush to 0; -inf gives 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One [rows][64] bf16 box of a 3-D tensor map (D, S, B*H) at (d0, row0,
// head) into shared memory, completing on `bar`; rows past S read zeros.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int d0, int row0, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row0), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr: start
// address, leading byte offset (K-major: unused; MN-major: the stride from
// one 64-column atom to the next), stride byte offset 1024 (8 rows of 128
// bytes), layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo_bytes) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulators across an
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
#define FA_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_D128 \
  FA_D64, FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88), FA_D8(96), FA_D8(104), FA_D8(112), FA_D8(120)
#define FA_R64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// d (64 x N, fp32) = (accumulate ? d : 0) + A (64 x 16) . B (16 x N),
// A and B bf16 in shared memory, both K-major; N is 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_D32
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    static_assert(N == 128, "S is 64 or 128 columns wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : FA_D64
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (64 x N, fp32) += A (64 x 16, bf16 fragments in registers) . B (16 x N),
// B bf16 in shared memory, MN-major (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : FA_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(N == 256, "O is 64, 128 or 256 columns wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FA_R128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : FA_D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef FA_D8
#undef FA_D32
#undef FA_D64
#undef FA_D128
#undef FA_R32
#undef FA_R64
#undef FA_R128

// The copies a CTA's producer issues (one thread): Q's tile once, and the K
// and V tiles of kv iteration `it` (the loop runs from the last of the
// tiles [first, first + n_tiles) down) into stage it % kStages, each
// completing on its full barrier.
template <int D, int kConsumers>
__device__ __forceinline__ void load_q(unsigned smem, const CUtensorMap* q_map, int q0, int bh) {
  using L = FwdLayout<D, kConsumers>;
  mbar_expect_tx(smem + L::kQFull, L::kQBytes);
#pragma unroll
  for (int a = 0; a < D / kAtom; ++a)
    tma_load(smem + L::kQ + a * L::kBlockM * 128, q_map, smem + L::kQFull, a * kAtom, q0, bh);
}
template <int D, int kConsumers>
__device__ __forceinline__ void load_kv(unsigned smem, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int it, int first,
                                        int n_tiles, int kv_head) {
  using L = FwdLayout<D, kConsumers>;
  constexpr int kTileN = L::kTileN;
  const int s = it % kStages;
  const int n0 = (first + n_tiles - 1 - it) * kTileN;
  const unsigned k_full = smem + L::kKFull + 8 * s, v_full = smem + L::kVFull + 8 * s;
  mbar_expect_tx(k_full, L::kTileBytes);
#pragma unroll
  for (int a = 0; a < D / kAtom; ++a)
    tma_load(smem + L::kK + s * L::kTileBytes + a * kTileN * 128, k_map, k_full, a * kAtom, n0,
             kv_head);
  mbar_expect_tx(v_full, L::kTileBytes);
#pragma unroll
  for (int a = 0; a < D / kAtom; ++a)
    tma_load(smem + L::kV + s * L::kTileBytes + a * kTileN * 128, v_map, v_full, a * kAtom, n0,
             kv_head);
}

// One consumer warpgroup's q rows of the tile at q0: the kv loop over the
// ring's stages, then O and the LSE written from registers. With one
// consumer warpgroup its thread 0 is also the producer: it refills the
// stage the previous tile released while the tensor cores run the next
// S product (k_map and v_map are used only then). kWindow instantiates the
// window's left edge and kSeg the segment ids (seg_q, seg_k: this batch
// row's [Sq] and [Sk]; ranges_q, ranges_k: their block ranges): without
// them the loop is the causal kernel's alone; kCap the soft-cap (scale_log2
// then carries scale / cap, cap_log2 cap * log2(e)); kAlibi ALiBi with this
// head's slope times log2(e), slope_log2; kDropout dropout (drop).
template <int D, int kConsumers, bool kWindow, bool kSeg, bool kCap, bool kAlibi, bool kDropout>
__device__ __forceinline__ void consume(unsigned smem, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, const int* __restrict__ seg_q,
                                        const int* __restrict__ seg_k,
                                        const int2* __restrict__ ranges_q,
                                        const int2* __restrict__ ranges_k, int bh, int kv_head,
                                        int q0, int first, int n_tiles, int Sq, int Sk, int d,
                                        int is_causal, int offset, int window,
                                        float scale_log2, float cap_log2, float slope_log2,
                                        const fat::Dropout& drop) {
  using L = FwdLayout<D, kConsumers>;
  constexpr int kTileN = L::kTileN;
  // The softmax's factor from a score to the exp2 domain: the capped and
  // the biased scores are there already.
  const float mul = kCap || kAlibi ? 1.f : scale_log2;
  const unsigned k_full = smem + L::kKFull, v_full = smem + L::kVFull, empty = smem + L::kEmpty;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Consumer warpgroup wg. Accumulator element 4j + 2i + e of a thread sits
  // at row row0 + 8i and column 8j + 2t + e of its 64-row product.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + g;
  const unsigned q_s = smem + L::kQ + wg * 64 * 128;
  // Every row of this warpgroup sees columns [full_begin, full_end): the
  // tiles inside need no mask. The kv loop, last tile first, takes the
  // n_hi tiles that reach past full_end first and the n_lo that reach
  // below full_begin (the window's left edge) last.
  const int wg_row = q0 + 64 * wg;
  const int full_end = is_causal ? max(0, min(Sk, wg_row + offset + 1)) : Sk;
  const int n_hi = first + n_tiles - min(max(full_end / kTileN, first), first + n_tiles);
  int n_lo = 0;
  if constexpr (kWindow) {
    const int full_begin = wg_row + 63 + offset - window + 1;
    const int lo_free = full_begin > 0 ? (full_begin + kTileN - 1) / kTileN : 0;
    n_lo = min(max(lo_free, first), first + n_tiles) - first;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  int row_seg[2] = {0, 0};       // this thread's rows' segment ids
  int2 wg_ids = make_int2(1, 0);  // the warpgroup's rows' id range (empty past Sq)
  if constexpr (kSeg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) row_seg[i] = row0 + 8 * i < Sq ? __ldg(seg_q + row0 + 8 * i) : 0;
    if (wg_row < Sq) wg_ids = fat::id_range(ranges_q, wg_row, 64, Sq);
  }
  unsigned drop_row[2] = {0u, 0u};  // dropout's terms of this thread's rows
  if constexpr (kDropout) {
    const unsigned head = fat::dropout_head(drop, bh);
#pragma unroll
    for (int i = 0; i < 2; ++i) drop_row[i] = fat::dropout_row(row0 + 8 * i, head);
  }
  // Thread 0 of a lone consumer warpgroup refills the stage that iteration
  // it - 1 released (k_map and v_map are used only here).
  auto refill = [&](int it) {
    if constexpr (kConsumers == 1) {
      const int next = it - 1 + kStages;
      if (threadIdx.x == 0 && it > 0 && next < n_tiles) {
        mbar_wait(empty + 8 * (next % kStages), ((it - 1) / kStages) & 1);
        load_kv<D, kConsumers>(smem, k_map, v_map, next, first, n_tiles, kv_head);
      }
      __syncwarp();  // warp 0 reconverges before the warpgroup-wide wait
    }
  };
  if (n_tiles > 0) mbar_wait(smem + L::kQFull, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const unsigned phase = (it / kStages) & 1;
    const int n0 = (first + n_tiles - 1 - it) * kTileN;
    bool seg_mask = false;  // the tile needs the id mask
    if constexpr (kSeg) {
      const int2 tile_ids = fat::id_range(ranges_k, n0, kTileN, Sk);
      if (!fat::ids_meet(wg_ids, tile_ids)) {  // other documents only: release the stage
        refill(it);
        mbar_wait(k_full + 8 * s, phase);
        mbar_wait(v_full + 8 * s, phase);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        continue;
      }
      seg_mask = !fat::one_id(wg_ids, tile_ids);
    }

    // S = Q K^T (64 x kTileN per warpgroup), raw scores.
    float sc[kTileN / 2];
    const unsigned k_s = smem + L::kK + s * L::kTileBytes;
    mbar_wait(k_full + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = kk / 4, col = (kk % 4) * 32;  // atom, byte column of the 16-wide k slice
      wgmma_ss<kTileN>(sc, sw128_desc(q_s + a * L::kBlockM * 128 + col, 16),
                       sw128_desc(k_s + a * kTileN * 128 + col, 16), kk > 0);
    }
    wgmma_commit();
    refill(it);  // under this S product
    wgmma_wait_all();
    fence_regs(sc);
    if constexpr (kCap) {  // before any mask: masked scores then become -inf
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i)
        sc[i] = fat::softcap_tanh(sc[i] * scale_log2) * cap_log2;
    }
    if constexpr (kAlibi) {  // every tile, before any mask: masked scores then become -inf
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // Element 4j + 2i + e: column n0 + 8j + 2t + e of row row0 + 8i.
        const float row_term =
            slope_log2 * static_cast<float>(n0 + 2 * t - (row0 + 8 * i) - offset);
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = fmaf(x, scale_log2, fmaf(slope_log2, static_cast<float>(8 * j + e), row_term));
          }
      }
    }

    if (seg_mask || it < n_hi || (kWindow && it >= n_tiles - n_lo)) {  // tiles across a bound
      if constexpr (kSeg) {  // a column's id read once for both rows
        int seen[2], from[2];  // row r sees the columns in [from, seen)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + 8 * i;
          seen[i] = is_causal ? min(Sk, r + offset + 1) : Sk;
          from[i] = kWindow ? r + offset - window + 1 : 0;
        }
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * t + e;
            const int col_seg = seg_mask && c < Sk ? __ldg(seg_k + c) : 0;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (c >= seen[i] || (kWindow && c < from[i]) || (seg_mask && col_seg != row_seg[i]))
                sc[4 * j + 2 * i + e] = -CUDART_INF_F;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + 8 * i;
          const int seen = is_causal ? min(Sk, r + offset + 1) : Sk;  // columns < seen
          const int from = kWindow ? r + offset - window + 1 : 0;     // and >= from
#pragma unroll
          for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n0 + 8 * j + 2 * t + e;
              if (c >= seen || (kWindow && c < from)) sc[4 * j + 2 * i + e] = -CUDART_INF_F;
            }
        }
      }
    }

    // Online softmax on this thread's two rows (a row spans a quad).
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row that has seen no key yet keeps max -inf: exponents against 0
      // then give p = 0 and alpha = 0, never NaN.
      m_scaled[i] = mx == -CUDART_INF_F ? 0.f : mx * mul;
      alpha[i] = exp2_ftz(m[i] * mul - m_scaled[i]);
      m[i] = mx;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        sc[4 * j + e] = exp2_ftz(fmaf(sc[4 * j + e], mul, -m_scaled[i]));
        psum[i] += sc[4 * j + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + psum[i];  // this thread's columns
    if constexpr (kDropout) {  // on the P that meets V, after l took it whole
      const unsigned col0 = fat::dropout_col(n0 + 2 * t);
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!fat::dropout_keep(drop_row[e / 2], fat::dropout_col_step(col0, 8 * j + (e & 1)),
                                 drop.threshold))
            sc[4 * j + e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // P rounded to bf16, as register A fragments: k slice kk is columns
    // [16kk, 16kk + 16), accumulator tiles 2kk and 2kk + 1.
    unsigned pa[kTileN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V's [keys][D] tile as an MN-major B operand, 16 keys (2048
    // bytes) a k slice, its 64-column atoms kTileN * 128 bytes apart.
    const unsigned v_s = smem + L::kV + s * L::kTileBytes;
    mbar_wait(v_full + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], sw128_desc(v_s + kk * 16 * 128, kTileN * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    // A row that saw no key has l == 0 and acc == 0: O = 0, LSE = -inf.
    const float inv = l[i] > 0.f ? (kDropout ? drop.scale : 1.f) / l[i] : 0.f;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + r) * d + 2 * t;
    // O's columns at and past d are zeros (TMA filled Q's, K's and V's
    // columns there with zeros) and are not stored: columns 8j .. 8j + 7
    // are all below d or none (d a multiple of 16).
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * Sq + r] =
          l[i] > 0.f ? (m[i] * mul + log2f(l[i])) * fat::kLn2 : -CUDART_INF_F;
  }
}

// bf16 K1. Grid (B*Hq, q tiles), the q tile index descending along y so
// the tiles with the most kv columns start first. Warpgroup w < kConsumers
// owns q rows [q0 + 64w, +64); with two of them a third warpgroup is the
// producer, whose first thread issues every TMA copy, and with one its
// thread 0 issues them between its products. Same contract as
// flash_fwd_kernel; kWindow instantiates the sliding window (window > 0),
// kSeg the segment ids (seg_q and seg_k not null), kCap the soft-cap
// (cap_log2 > 0), kAlibi ALiBi (slopes, the (Hq,) table, not null; never
// with kCap), kDropout dropout (drop). At D 64 the segment ids' registers
// and dropout's together pass the 168 a thread of three CTAs an SM (they
// spilled 8-24 bytes): that kernel runs two CTAs an SM.
template <int D, int kConsumers, bool kWindow, bool kSeg, bool kCap, bool kAlibi, bool kDropout>
__device__ __forceinline__ void fwd_wgmma_cta(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int2* __restrict__ ranges_q,
    const int2* __restrict__ ranges_k, const float* __restrict__ slopes, int Hq, int Hkv, int Sq,
    int Sk, int d, int is_causal, int offset, int window, float scale_log2, float cap_log2,
    const fat::Dropout& drop) {
  static_assert(!(kAlibi && kCap), "ALiBi takes no soft-cap");
  using L = FwdLayout<D, kConsumers>;
  constexpr int kTileN = L::kTileN;
  extern __shared__ unsigned char smem_raw[];
  const unsigned smem = (smem_addr(smem_raw) + 1023) & ~1023u;
  const unsigned q_full = smem + L::kQFull, k_full = smem + L::kKFull,
                 v_full = smem + L::kVFull, empty = smem + L::kEmpty;

  const int bh = blockIdx.x;  // b * Hq + h
  const int kv_head = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int* row_seg_q = kSeg ? seg_q + static_cast<size_t>(bh / Hq) * Sq : nullptr;
  const int* row_seg_k = kSeg ? seg_k + static_cast<size_t>(bh / Hq) * Sk : nullptr;
  const int2* row_ranges_q =
      kSeg ? ranges_q + static_cast<size_t>(bh / Hq) * fat::range_blocks(Sq) : nullptr;
  const int2* row_ranges_k =
      kSeg ? ranges_k + static_cast<size_t>(bh / Hq) * fat::range_blocks(Sk) : nullptr;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBlockM;
  const int first = kWindow ? kv_first_tile(q0, offset, window, kTileN) : 0;
  const int n_tiles = max(
      0, (kv_limit(q0, L::kBlockM, Sq, Sk, is_causal, offset) + kTileN - 1) / kTileN - first);
  const float slope_log2 = kAlibi ? __ldg(slopes + bh % Hq) * fat::kLog2e : 0.f;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (kConsumers == 1) {
    // Thread 0 fills the ring, then refills it from inside the kv loop.
    if (threadIdx.x == 0 && n_tiles > 0) {
      load_q<D, kConsumers>(smem, q_map, q0, bh);
      for (int it = 0; it < min(kStages, n_tiles); ++it)
        load_kv<D, kConsumers>(smem, k_map, v_map, it, first, n_tiles, kv_head);
    }
    consume<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>(
        smem, k_map, v_map, o, lse, row_seg_q, row_seg_k, row_ranges_q, row_ranges_k, bh,
        kv_head, q0, first, n_tiles, Sq, Sk, d, is_causal, offset, window, scale_log2, cap_log2,
        slope_log2, drop);
  } else if (threadIdx.x >= 128 * kConsumers) {
    // Producer warpgroup: Q once, then K and V tile by tile, last tile
    // first. It hands its registers to the consumers (setmaxnreg): 12 warps
    // at launch leave 168 a thread, too few for a 64 x 128 O and a 64 x 128
    // S at D 128, or a 64 x 256 O and a 64 x 64 S at D 256.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      load_q<D, kConsumers>(smem, q_map, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(empty + 8 * (it % kStages), ((it / kStages) & 1) ^ 1);  // round 0 passes at once
        load_kv<D, kConsumers>(smem, k_map, v_map, it, first, n_tiles, kv_head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>(
        smem, k_map, v_map, o, lse, row_seg_q, row_seg_k, row_ranges_q, row_ranges_k, bh,
        kv_head, q0, first, n_tiles, Sq, Sk, d, is_causal, offset, window, scale_log2, cap_log2,
        slope_log2, drop);
  }
}

template <int D, int kConsumers, bool kWindow, bool kSeg, bool kCap, bool kAlibi, bool kDropout>
__global__ void __launch_bounds__(FwdLayout<D, kConsumers>::kThreads,
                                  kConsumers == 1 ? (kSeg && kDropout ? 2 : 3) : 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ seg_q,
                       const int* __restrict__ seg_k, const int2* __restrict__ ranges_q,
                       const int2* __restrict__ ranges_k, const float* __restrict__ slopes,
                       int Hq, int Hkv, int Sq, int Sk, int d, int is_causal, int offset,
                       int window, float scale_log2, float cap_log2, const fat::Dropout drop) {
  fwd_wgmma_cta<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>(
      &q_map, &k_map, &v_map, o, lse, seg_q, seg_k, ranges_q, ranges_k, slopes, Hq, Hkv, Sq, Sk,
      d, is_causal, offset, window, scale_log2, cap_log2, drop);
}

// K1 with the q/k alignment read from the card (dyn_pos_offset): the
// kernel above's CTA with `offset` read once at its start, so one launch
// shape serves every offset and the producer's walk and the consumers'
// start from one value; not causal (the window is its left edge alone).
// A kernel of its own, so that the kernels above keep their parameters;
// the soft-cap's and dropout's come after dyn_offset and their flags last,
// so that the instantiations without them keep the code they had before
// those two were added.
template <int D, int kConsumers, bool kWindow, bool kSeg, bool kAlibi, bool kCap, bool kDropout>
__global__ void __launch_bounds__(FwdLayout<D, kConsumers>::kThreads,
                                  kConsumers == 1 ? (kSeg && kDropout ? 2 : 3) : 1)
flash_fwd_dyn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                           const int2* __restrict__ ranges_q, const int2* __restrict__ ranges_k,
                           const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk,
                           int d, int window, float scale_log2,
                           const int* __restrict__ dyn_offset, float cap_log2,
                           const fat::Dropout drop) {
  fwd_wgmma_cta<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>(
      &q_map, &k_map, &v_map, o, lse, seg_q, seg_k, ranges_q, ranges_k, slopes, Hq, Hkv, Sq, Sk,
      d, 0, __ldg(dyn_offset), window, scale_log2, cap_log2, drop);
}

template <int D, bool kDropout, bool kDyn>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       const int* seg_q, const int* seg_k, const float* slopes, int B, int Hq,
                       int Hkv, int Sq, int Sk, int d, int is_causal, int offset, int window,
                       float scale_log2, float cap_log2, const fat::Dropout& drop,
                       const int* dyn_offset, cudaStream_t stream) {
  const cudaError_t err = fat::allow_max_smem<flash_fwd_kernel<D, kDropout, kDyn>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, Hq, B);
  flash_fwd_kernel<D, kDropout, kDyn><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), seg_q,
      seg_k, slopes, Hq, Hkv, Sq, Sk, d, is_causal, offset, window, scale_log2, cap_log2, drop,
      dyn_offset);
  return cudaGetLastError();
}


// cuTensorMapEncodeTiled, a libcuda function, through the runtime's entry
// point query: the library links nothing but the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map (d, rows, heads) of a contiguous bf16 [heads][rows][d] tensor,
// boxes of [box_rows][64] with 128-byte swizzle; reads past `rows`, and the
// columns of a box at and past d (d 32 in a 64-column box, d 80 and 96 in
// the second atom of the 128-column tile), give 0 (FLOAT_OOB_FILL_NONE
// fills zeros): those columns add nothing to S = Q K^T and O's there are
// never stored. The global strides, d * 2 bytes, are multiples of 16.
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtom), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int kConsumers, bool kWindow, bool kSeg, bool kCap, bool kAlibi, bool kDropout,
          bool kDyn>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        const int* seg_q, const int* seg_k, const int2* ranges_q,
                        const int2* ranges_k, const float* slopes, int B, int Hq, int Hkv,
                        int Sq, int Sk, int d, int is_causal, int offset, int window,
                        float scale_log2, float cap_log2, const fat::Dropout& drop,
                        const int* dyn_offset, cudaStream_t stream) {
  using L = FwdLayout<D, kConsumers>;
  cudaError_t err;
  if constexpr (kDyn)
    err = fat::allow_max_smem<
        flash_fwd_dyn_wgmma_kernel<D, kConsumers, kWindow, kSeg, kAlibi, kCap, kDropout>>();
  else
    err = fat::allow_max_smem<
        flash_fwd_wgmma_kernel<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>>();
  const int q_tiles = (Sq + L::kBlockM - 1) / L::kBlockM;
  if (err == cudaSuccess && q_tiles > 65535) err = cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (err == cudaSuccess) err = make_map(&q_map, q, d, Sq, B * Hq, L::kBlockM);
  if (err == cudaSuccess) err = make_map(&k_map, k, d, Sk, B * Hkv, L::kTileN);
  if (err == cudaSuccess) err = make_map(&v_map, v, d, Sk, B * Hkv, L::kTileN);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, q_tiles);
  auto* out = static_cast<__nv_bfloat16*>(o);
  auto* lse_f = static_cast<float*>(lse);
  if constexpr (kDyn)
    flash_fwd_dyn_wgmma_kernel<D, kConsumers, kWindow, kSeg, kAlibi, kCap, kDropout>
        <<<grid, L::kThreads, L::kBytes, stream>>>(q_map, k_map, v_map, out, lse_f, seg_q, seg_k,
                                                    ranges_q, ranges_k, slopes, Hq, Hkv, Sq, Sk,
                                                    d, window, scale_log2, dyn_offset, cap_log2,
                                                    drop);
  else
    flash_fwd_wgmma_kernel<D, kConsumers, kWindow, kSeg, kCap, kAlibi, kDropout>
        <<<grid, L::kThreads, L::kBytes, stream>>>(q_map, k_map, v_map, out, lse_f, seg_q, seg_k,
                                                    ranges_q, ranges_k, slopes, Hq, Hkv, Sq, Sk,
                                                    d, is_causal, offset, window, scale_log2,
                                                    cap_log2, drop);
  return cudaGetLastError();
}

// The bf16 kernel of head dim D (kConsumers warpgroups) for a window,
// segment ids and a soft-cap, each present or not, or for ALiBi (slopes not
// null) with or without a window and segment ids; kDropout's or not. With
// kDyn (the offset read from dyn_offset on the card) a window, ALiBi or
// both, or the window with the soft-cap, each with or without segment ids.
template <int D, int kConsumers, bool kDropout, bool kDyn>
cudaError_t launch_bf16_any(bool win, bool seg, bool cap, const void* q, const void* k,
                            const void* v, void* o, void* lse, const int* seg_q,
                            const int* seg_k, const int2* ranges_q, const int2* ranges_k,
                            const float* slopes, int B, int Hq, int Hkv, int Sq, int Sk, int d,
                            int is_causal, int offset, int window, float scale_log2,
                            float cap_log2, const fat::Dropout& drop, const int* dyn_offset,
                            cudaStream_t stream) {
  constexpr int C = kConsumers;
  constexpr bool X = kDropout;
  decltype(&launch_bf16<D, C, false, false, false, false, X, kDyn>) fn;
  if constexpr (kDyn) {
    if (!win && slopes == nullptr) return cudaErrorInvalidValue;
    fn = slopes != nullptr ? (win ? (seg ? launch_bf16<D, C, true, true, false, true, X, true>
                                         : launch_bf16<D, C, true, false, false, true, X, true>)
                                  : (seg ? launch_bf16<D, C, false, true, false, true, X, true>
                                         : launch_bf16<D, C, false, false, false, true, X, true>))
         : cap ? (seg ? launch_bf16<D, C, true, true, true, false, X, true>
                      : launch_bf16<D, C, true, false, true, false, X, true>)
               : (seg ? launch_bf16<D, C, true, true, false, false, X, true>
                      : launch_bf16<D, C, true, false, false, false, X, true>);
  } else {
    fn = slopes != nullptr
             ? (win ? (seg ? launch_bf16<D, C, true, true, false, true, X, false>
                           : launch_bf16<D, C, true, false, false, true, X, false>)
                    : (seg ? launch_bf16<D, C, false, true, false, true, X, false>
                           : launch_bf16<D, C, false, false, false, true, X, false>))
         : cap ? (win ? (seg ? launch_bf16<D, C, true, true, true, false, X, false>
                             : launch_bf16<D, C, true, false, true, false, X, false>)
                      : (seg ? launch_bf16<D, C, false, true, true, false, X, false>
                             : launch_bf16<D, C, false, false, true, false, X, false>))
         : win ? (seg ? launch_bf16<D, C, true, true, false, false, X, false>
                      : launch_bf16<D, C, true, false, false, false, X, false>)
               : (seg ? launch_bf16<D, C, false, true, false, false, X, false>
                      : launch_bf16<D, C, false, false, false, false, X, false>);
  }
  return fn(q, k, v, o, lse, seg_q, seg_k, ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq, Sk, d,
            is_causal, offset, window, scale_log2, cap_log2, drop, dyn_offset, stream);
}

}  // namespace

// q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], o like q, lse [B,Hq,Sq] fp32 or NULL; all
// contiguous on the device, q, k and v 16-byte aligned; seg_q [B,Sq] and
// seg_k [B,Sk] int32 segment ids with their block ranges ranges_q
// [B,ceil(Sq/32)] and ranges_k [B,ceil(Sk/32)] int2 (min, max), all NULL or
// none (the float32 kernel reads the ids alone); slopes the (Hq,) float32
// ALiBi table or NULL (not with a soft-cap). Row r sees
// column c iff !is_causal or c <= r + offset, with window > 0 (causal only)
// c >= r + offset - window + 1, and with segment ids
// seg_q[b][r] == seg_k[b][c]. The logits s (q . k) become s * scale_log2 in
// the exp2 domain, or with cap_log2 > 0 (the soft-cap: cap * log2(e), and
// scale_log2 then scale / cap) tanh(s * scale_log2) * cap_log2; ALiBi adds
// slopes[h] * log2(e) * (c - r - offset). With kDropout (the library
// flash_fwd_dropout.cu) P V takes the elements dropout_keep keeps, O is
// scaled by drop.scale, the LSE is that without dropout. With kDyn (the
// libraries flash_fwd_dynoff.cu and, with kDropout, flash_fwd_dynoff_dropout.cu)
// the offset is the int32 at dyn_offset on the device, not `offset`, and
// the call is not causal: the window, needed without ALiBi, is its left
// edge alone (c >= r + offset - window + 1); every option and dtype
// beside it. D, the head dim,
// is a multiple of 16 up to 256; it runs in the tile of 64, 128 or 256
// columns that holds it (common.cuh head_tile). bf16 runs the wgmma kernel
// (q tiles of 64 rows in the 64 tile, 128 in the 128 and 256 tiles),
// float32 the FMA kernel. Returns the CUDA error code of the launch (0 =
// success).
template <bool kDropout, bool kDyn>
int fwd_launch_impl(const void* q, const void* k, const void* v, void* o, void* lse,
                    const int* seg_q, const int* seg_k, const int2* ranges_q,
                    const int2* ranges_k, const float* slopes, int B, int Hq, int Hkv, int Sq,
                    int Sk, int D, int dtype, int is_causal, int offset, int window,
                    float scale_log2, float cap_log2, const fat::Dropout& drop,
                    const int* dyn_offset, void* stream) {
  const bool seg = seg_q != nullptr;
  const bool cap = cap_log2 > 0.f;
  const int tile = fat::head_tile(D);
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || !fat::head_dim_ok(D) ||
      window < 0 || (window > 0 && !is_causal && !kDyn) || seg != (seg_k != nullptr) ||
      seg != (ranges_q != nullptr) || seg != (ranges_k != nullptr) || cap_log2 < 0.f ||
      (slopes != nullptr && cap) ||
      (kDyn && (is_causal || dyn_offset == nullptr || (window == 0 && slopes == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool win = window > 0;
  if (dtype == fat::kBF16 && tile == 64)
    err = launch_bf16_any<64, 1, kDropout, kDyn>(win, seg, cap, q, k, v, o, lse, seg_q, seg_k,
                                                 ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq, Sk,
                                                 D, is_causal, offset, window, scale_log2,
                                                 cap_log2, drop, dyn_offset, s);
  else if (dtype == fat::kBF16 && tile == 128)
    err = launch_bf16_any<128, 2, kDropout, kDyn>(win, seg, cap, q, k, v, o, lse, seg_q, seg_k,
                                                  ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq,
                                                  Sk, D, is_causal, offset, window, scale_log2,
                                                  cap_log2, drop, dyn_offset, s);
  else if (dtype == fat::kBF16 && tile == 256)
    err = launch_bf16_any<256, 2, kDropout, kDyn>(win, seg, cap, q, k, v, o, lse, seg_q, seg_k,
                                                  ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq,
                                                  Sk, D, is_causal, offset, window, scale_log2,
                                                  cap_log2, drop, dyn_offset, s);
  else if (dtype == fat::kF32 && tile == 64)
    err = launch_f32<64, kDropout, kDyn>(q, k, v, o, lse, seg_q, seg_k, slopes, B, Hq, Hkv, Sq,
                                         Sk, D, is_causal, offset, window, scale_log2, cap_log2,
                                         drop, dyn_offset, s);
  else if (dtype == fat::kF32 && tile == 128)
    err = launch_f32<128, kDropout, kDyn>(q, k, v, o, lse, seg_q, seg_k, slopes, B, Hq, Hkv, Sq,
                                          Sk, D, is_causal, offset, window, scale_log2, cap_log2,
                                          drop, dyn_offset, s);
  else if (dtype == fat::kF32 && tile == 256)
    err = launch_f32<256, kDropout, kDyn>(q, k, v, o, lse, seg_q, seg_k, slopes, B, Hq, Hkv, Sq,
                                          Sk, D, is_causal, offset, window, scale_log2, cap_log2,
                                          drop, dyn_offset, s);
  return static_cast<int>(err);
}
