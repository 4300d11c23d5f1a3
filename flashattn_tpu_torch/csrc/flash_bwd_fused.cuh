// Flash-attention backward, fused path, for Hopper (sm_90a): a delta
// pre-pass, then one kernel that computes dQ, dK and dV in one pass. Five
// libraries build from this header: flash_bwd_fused.cu (every instantiation
// without ALiBi, dropout or the offset read on the card),
// flash_bwd_fused_alibi.cu (ALiBi's), flash_bwd_fused_dropout.cu (dropout's,
// with ALiBi or without), flash_bwd_fused_dynoff.cu (kDyn's: the q/k
// alignment read on the card once a CTA, not causal, the window's left edge,
// ALiBi, the soft-cap, every D and dtype) and
// flash_bwd_fused_dynoff_dropout.cu (kDyn's with dropout), side by side.
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_bwd_fused.py::
// _fused_bwd_kernel (launcher flash_attention_backward_fused, :336; B3) on the
// plain subset: causal (bottom-right, or by pos_offset) or not, GQA, ragged
// S_q/S_k, rows that see no key, the sliding window and packed-document segment
// ids (instantiated apart, flash_bwd.cuh's MaskKind: the tile of
// flash_bwd_mma.cuh bounds its q walk by the window and masks pairs of two
// documents), and the logit soft-cap with its exact tanh derivative (kCap, a
// template flag of the bf16 kernel) or ALiBi (kAlibi, the bias as K1 formed it:
// flash_bwd.cuh fwd_tile_n; the float32 kernel takes it as a runtime argument)
// and dropout (kDropout: the forward's keep mask rebuilt from the seed,
// common.cuh dropout_keep; the JAX kernel's at flash_bwd_fused.py:236-247), at D
// 64, 128 and 256 (8 warps a kv tile at D 256, flash_bwd_mma.cuh), and at D 32,
// 80 and 96 in those tiles (the true head dim at run time, common.cuh
// head_tile). On the TPU the dK/dV accumulators of a whole (batch, kv head) stay
// in VMEM while one sequential grid walks the q tiles; no SM holds that, so this
// is the one-pass design of FA2 instead: one CTA per (64-row kv tile, kv head,
// batch) keeps its tile's dK and dV in registers while it walks the GQA group's
// q heads and the live q tiles, computing S, P, dP and dS once per tile pair,
// and adds each tile's dQ contribution, scale applied, into an fp32 buffer with
// atomics. The caller zeroes that buffer and casts it afterwards.
//
// What bounds it on the card: arithmetic, about 2.5x the forward's FLOPs
// (five products a tile pair), so the tensor cores' rate; then the dQ
// reductions into L2 (64 x D fp32 a tile pair). bf16 runs the tensor-core
// tile of flash_bwd_mma.cuh (mma.sync m16n8k16, bf16 operands in shared
// memory, cp.async double buffer of the q tiles, dQ by float4 atomicAdd:
// 16 x D / 4 a tile pair); float32 keeps the CUDA-core tile of
// flash_bwd.cuh (64 x D scalar atomics a tile pair). Compared with the split
// path it computes S and dP once instead of twice. The atomics sum in an
// order that changes between runs, so dQ is not bitwise reproducible; the
// split path (flash_bwd.cu) is the deterministic one.
#pragma once

#include <type_traits>

#include "flash_bwd_mma.cuh"

namespace {

using fat::bwd::Tile;

constexpr int kThreads = 256;  // delta pre-pass
constexpr int kRowsPerCta = kThreads / 32;  // one warp per row

// delta[row] = sum_c dO[row][c] * O[row][c] over rows = B * Hq * Sq, the
// rows d wide (the true head dim; D its compiled tile).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int d) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerCta + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * d;
  const T* dorow = dout + row * d;
  float sum = 0.f;
#pragma unroll
  for (int i = lane; i < D; i += 32)
    if (i < d) sum = fmaf(fat::to_f(dorow[i]), fat::to_f(orow[i]), sum);
#pragma unroll
  for (int m = 16; m > 0; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int D, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(Tile<D>::kThreads)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc,
                       const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                       const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk, int d,
                       int is_causal, int offset, int window, float scale, float scale_log2,
                       float cap_log2, const fat::Dropout drop,
                       const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment from the card bounds the q walk and masks alike.
  fat::bwd::dkv_tile<T, D, true, kDropout>(q, k, v, dout, lse, delta, dk, dv, dq_acc, seg_q,
                                           seg_k, slopes, Hq, Hkv, Sq, Sk, d, is_causal,
                                           kDyn ? __ldg(dyn_offset) : offset, window, scale,
                                           scale_log2, cap_log2, drop);
}

template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
__global__ void __launch_bounds__(fat::bwd::mma::threads<D>())
flash_bwd_fused_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                           const int2* __restrict__ ranges_q, const int2* __restrict__ ranges_k,
                           const float* __restrict__ slopes, int Hq, int Hkv, int Sq, int Sk,
                           int d, int is_causal, int offset, int window, float scale,
                           float scale_log2, float cap_log2, const fat::Dropout drop,
                           const int* __restrict__ dyn_offset) {
  // kDyn: the q/k alignment from the card bounds the q walk and masks alike.
  fat::bwd::mma::dkv_tile<D, true, kMask, kCap, kAlibi, kDropout>(
      q, k, v, dout, lse, delta, dk, dv, dq_acc, seg_q, seg_k, ranges_q, ranges_k, slopes, Hq,
      Hkv, Sq, Sk, d, is_causal, kDyn ? __ldg(dyn_offset) : offset, window, scale, scale_log2,
      cap_log2, drop);
}

template <int D, int kMask, bool kCap, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, void* dq_acc, void* dk, void* dv, const void* delta,
                       const int* seg_q, const int* seg_k, const int2* ranges_q,
                       const int2* ranges_k, const float* slopes, int B, int Hq, int Hkv, int Sq,
                       int Sk, int d, int is_causal, int offset, int window, float scale,
                       float scale_log2, float cap_log2, const fat::Dropout& drop,
                       const int* dyn_offset, cudaStream_t stream) {
  namespace mma = fat::bwd::mma;
  using bf16 = __nv_bfloat16;
  const cudaError_t err = fat::allow_max_smem<
      flash_bwd_fused_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B, (Sk + mma::kBc - 1) / mma::kBc);
  flash_bwd_fused_mma_kernel<D, kMask, kCap, kAlibi, kDropout, kDyn>
      <<<grid, mma::threads<D>(), mma::smem_bytes<D, true, kMask>(), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
          static_cast<float*>(dq_acc), seg_q, seg_k, ranges_q, ranges_k, slopes, Hq, Hkv, Sq,
          Sk, d, is_causal, offset, window, scale, scale_log2, cap_log2, drop, dyn_offset);
  return cudaGetLastError();
}

// With kAlibi the bf16 kernels of ALiBi (no cap), else those without it;
// with kDropout those of dropout, else those without it; with kDyn those
// that read the offset on the card (a window or ALiBi; the float32 kernel
// too).
template <typename T, int D, bool kAlibi, bool kDropout, bool kDyn>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq_acc, void* dk, void* dv, void* delta,
                   const int* seg_q, const int* seg_k, const int2* ranges_q,
                   const int2* ranges_k, const float* slopes, int B, int Hq, int Hkv, int Sq,
                   int Sk, int d, int is_causal, int offset, int window, float scale,
                   float scale_log2, float cap_log2, const fat::Dropout& drop,
                   const int* dyn_offset, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta),
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows,
      d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    namespace bwd = fat::bwd;
    const bool cap = cap_log2 > 0.f;
    constexpr bool X = kDropout, Y = kDyn;
    decltype(&launch_mma<D, bwd::kNoMask, false, kAlibi, X, Y>) fn;
    if constexpr (kAlibi)
      fn = seg_q != nullptr ? launch_mma<D, bwd::kSegmentMask, false, true, X, Y>
           : window > 0     ? launch_mma<D, bwd::kWindowMask, false, true, X, Y>
                            : launch_mma<D, bwd::kNoMask, false, true, X, Y>;
    else if constexpr (kDyn)  // the window, with or without segment ids and the cap
      fn = seg_q != nullptr ? (cap ? launch_mma<D, bwd::kSegmentMask, true, false, X, Y>
                                   : launch_mma<D, bwd::kSegmentMask, false, false, X, Y>)
                            : (cap ? launch_mma<D, bwd::kWindowMask, true, false, X, Y>
                                   : launch_mma<D, bwd::kWindowMask, false, false, X, Y>);
    else
      fn = seg_q != nullptr ? (cap ? launch_mma<D, bwd::kSegmentMask, true, false, X, Y>
                                   : launch_mma<D, bwd::kSegmentMask, false, false, X, Y>)
           : window > 0     ? (cap ? launch_mma<D, bwd::kWindowMask, true, false, X, Y>
                                   : launch_mma<D, bwd::kWindowMask, false, false, X, Y>)
                            : (cap ? launch_mma<D, bwd::kNoMask, true, false, X, Y>
                                   : launch_mma<D, bwd::kNoMask, false, false, X, Y>);
    return fn(q, k, v, dout, lse, dq_acc, dk, dv, delta, seg_q, seg_k, ranges_q, ranges_k, slopes,
              B, Hq, Hkv, Sq, Sk, d, is_causal, offset, window, scale, scale_log2, cap_log2, drop,
              dyn_offset, stream);
  } else {
    err = fat::allow_max_smem<flash_bwd_fused_kernel<T, D, kDropout, kDyn>>();
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + Tile<D>::kRows - 1) / Tile<D>::kRows, Hkv, B);
    flash_bwd_fused_kernel<T, D, kDropout, kDyn>
        <<<grid, Tile<D>::kThreads, fat::bwd::dkv_smem_bytes<D>(), stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
            static_cast<float*>(dq_acc), seg_q, seg_k, slopes, Hq, Hkv, Sq, Sk, d, is_causal,
            offset, window, scale, scale_log2, cap_log2, drop, dyn_offset);
  }
  return cudaGetLastError();
}

}  // namespace

// q, o, dout [B,Hq,Sq,D]; k, v, dk, dv [B,Hkv,Sk,D]; lse and delta [B,Hq,Sq]
// fp32; dq_acc [B,Hq,Sq,D] fp32, zeroed by the caller; all contiguous on the
// device, the [.., D] tensors 16-byte aligned; seg_q [B,Sq] and seg_k [B,Sk]
// int32 segment ids with their block ranges ranges_q [B,ceil(Sq/32)] and
// ranges_k [B,ceil(Sk/32)] int2 (min, max), all NULL or none (the float32
// kernels read the ids alone); slopes the (Hq,) float32 ALiBi table, not NULL in
// the ALiBi library (flash_bwd_fused_alibi.cu) and NULL in the other
// (flash_bwd_fused.cu), never with a soft-cap. Row r sees column c iff
// !is_causal or c <= r + offset, with window > 0 (causal only) c >= r + offset -
// window + 1, and with segment ids seg_q[b][r] == seg_k[b][c]. The logits s (q .
// k) are s * scale_log2 in the exp2 domain (scale_log2 = scale * log2(e)), or
// with cap_log2 > 0 (the soft-cap: cap * log2(e), and scale_log2 then scale /
// cap) tanh(s * scale_log2) * cap_log2, as the forward made them; ALiBi adds
// slopes[h] * log2(e) * (c - r - offset). With kDropout (the library
// flash_bwd_fused_dropout.cu, ALiBi or not) the forward's keep mask of drop
// drops P in dV and dP in dS. With kDyn (the libraries
// flash_bwd_fused_dynoff.cu and, with kDropout, flash_bwd_fused_dynoff_dropout.cu,
// ALiBi or not) the offset is the int32 at dyn_offset on the device, not
// `offset`, and the call is not causal: the window, needed without ALiBi, is
// its left edge alone; every option and dtype beside it. D, the head dim, is
// a multiple of 16 up to 256,
// run in the compiled tile of 64, 128 or 256 columns that holds it (common.cuh
// head_tile); dq_acc is D wide, as q. Writes delta, dk (scale applied) and dv in
// k's dtype, and adds scale * dS.K into dq_acc. Returns the CUDA error code of
// the launches (0 = success).
template <bool kAlibi, bool kDropout, bool kDyn>
int fused_launch_impl(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq_acc, void* dk, void* dv,
                      void* delta, const int* seg_q, const int* seg_k, const int2* ranges_q,
                      const int2* ranges_k, const float* slopes, int B, int Hq, int Hkv, int Sq,
                      int Sk, int D, int dtype, int is_causal, int offset, int window,
                      float scale, float scale_log2, float cap_log2, const fat::Dropout& drop,
                      const int* dyn_offset, void* stream) {
  const bool seg = seg_q != nullptr;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || window < 0 ||
      (window > 0 && !is_causal && !kDyn) || seg != (seg_k != nullptr) ||
      seg != (ranges_q != nullptr) || seg != (ranges_k != nullptr) || cap_log2 < 0.f ||
      (slopes != nullptr) != kAlibi || (kAlibi && cap_log2 > 0.f) ||
      !fat::head_dim_ok(D) ||
      (kDyn && (is_causal || dyn_offset == nullptr || (window == 0 && !kAlibi))))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool A = kAlibi, X = kDropout, Y = kDyn;
  const int tile = fat::head_tile(D);  // the compiled tile that takes D
  decltype(&launch<__nv_bfloat16, 64, A, X, Y>) fn =
      dtype == fat::kBF16 ? (tile == 64    ? launch<__nv_bfloat16, 64, A, X, Y>
                             : tile == 128 ? launch<__nv_bfloat16, 128, A, X, Y>
                                           : launch<__nv_bfloat16, 256, A, X, Y>)
      : dtype == fat::kF32 ? (tile == 64    ? launch<float, 64, A, X, Y>
                              : tile == 128 ? launch<float, 128, A, X, Y>
                                            : launch<float, 256, A, X, Y>)
                           : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, o, dout, lse, dq_acc, dk, dv, delta, seg_q, seg_k,
                             ranges_q, ranges_k, slopes, B, Hq, Hkv, Sq, Sk, D, is_causal,
                             offset, window, scale, scale_log2, cap_log2, drop, dyn_offset,
                             static_cast<cudaStream_t>(stream)));
}
