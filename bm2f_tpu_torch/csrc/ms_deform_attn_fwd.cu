// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_fwd_kernel`
// (bm2f_tpu/ops/deform_attn_pallas.py:102) together with its XLA prep
// `_build_patches_and_indices` (:236): this one kernel computes the whole of
// `ms_deform_attn` (bm2f_tpu_torch/ops/deform_attn.py), from `value`, the
// sampling locations and the softmaxed attention weights to the output.
//
// What bounds it on the H100: bytes. Each input read once and the output
// written once is ~42 MB per call at the main-path shapes (800x800, B=1), or
// ~12.5 us at 3.35 TB/s; the arithmetic (~0.32 GFLOP) would take ~4.8 us at
// 67 TFLOP/s f32. The gather itself re-reads `value`: 4 corner rows of D
// floats for each of the B*Q*M*L*P samples, ~645 MB through L1/L2 per call,
// so the caches, not DRAM, set the pace of this simple design.
//
// What the design does about it: the TPU kernel builds a 2x2-neighbourhood
// patch table four times the size of `value` because a TPU issues gather
// descriptors slowly; on Hopper that table would only add bytes, so this
// kernel samples `value` directly, as the original Deformable-DETR im2col
// did. One warp owns one (b, q, m); lane = channel, so every corner read of
// value[b, s, m, 0:32] is one coalesced 128-byte load and every output row
// one coalesced store. Lanes 0..K-1 each compute one sample's four corner
// indices and weights (zero padding: a corner outside the level is skipped)
// and `__shfl_sync` broadcasts them to the warp. Nothing is staged in
// shared memory and nothing is allocated. Closing the gap to the DRAM bound
// (reusing corner rows across neighbouring queries) is later work.
//
// A bf16 `value` (the bf16 serving path) takes the same kernel instantiated
// on 16-bit rows: it reads bf16 and does all arithmetic in f32, on the f32
// locations and attention weights, into an f32 output, as the Pallas path
// does (its patch table is cast to f32, deform_attn_pallas.py:272). A warp's
// corner read is then 64 bytes, and `value` is half the bytes.

#include "bf16_bits.cuh"
#include "ms_deform_attn_common.cuh"

#include <stdint.h>

namespace {

using msda::kFull;
using msda::kMaxDChunks;
using msda::kWarpsPerBlock;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const Bf16Bits* p) { return load_bf16(p); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_fwd_kernel(const T* __restrict__ value,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn,
                          float* __restrict__ out, msda::Levels lv, int S, int M,
                          int D, int Q, int P, int K, long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // uniform across the warp
  // warp = (b * Q + q) * M + m: the same linear index addresses the
  // (b, q, m) slice of loc (K*2 floats), attn (K floats) and out (D floats)
  const int m = (int)(warp % M);
  const long long b = warp / M / Q;
  const float* loc_w = loc + warp * (long long)K * 2;
  const float* attn_w = attn + warp * (long long)K;
  const long long row_stride = (long long)M * D;  // one pixel of value
  const T* value_bm = value + b * S * row_stride + (long long)m * D;
  const int nd = D >> 5;

  float acc[kMaxDChunks] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (k < K) {
      const int l = k / P;
      const msda::Corners cs = msda::bilinear_corners(
          __ldg(loc_w + 2 * k), __ldg(loc_w + 2 * k + 1), lv.h[l], lv.w[l],
          lv.start[l]);
      const float a = __ldg(attn_w + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        idx[c] = cs.idx[c];
        wt[c] = cs.w[c] * a;
      }
    }
    const int kn = min(32, K - k0);
    for (int j = 0; j < kn; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = __shfl_sync(kFull, idx[c], j);
        const float wc = __shfl_sync(kFull, wt[c], j);
        if (s < 0) continue;  // uniform: every lane holds the same s
        const T* row = value_bm + (long long)s * row_stride;
#pragma unroll
        for (int t = 0; t < kMaxDChunks; ++t)
          if (t < nd) acc[t] += wc * load_f32(row + lane + 32 * t);
      }
    }
  }
  float* o = out + warp * (long long)D;
#pragma unroll
  for (int t = 0; t < kMaxDChunks; ++t)
    if (t < nd) o[lane + 32 * t] = acc[t];
}

template <typename T>
int launch(const T* value, const float* loc, const float* attn, float* out,
           const int* shapes, int B, int S, int M, int D, int Q, int L, int P,
           void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv))
    return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * M;
  if (n_warps == 0) return 0;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ms_deform_attn_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                 (cudaStream_t)stream>>>(
      value, loc, attn, out, lv, S, M, D, Q, P, L * P, n_warps);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), loc (B, Q, M, L, P, 2), attn (B, Q, M, L, P), out
// (B, Q, M*D): contiguous on the device; value f32 (ms_deform_attn_fwd) or
// bf16 (ms_deform_attn_fwd_bf16), everything else f32. shapes: host array of
// L (H, W) pairs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ms_deform_attn_fwd(const void* value, const float* loc,
                                  const float* attn, float* out,
                                  const int* shapes, int B, int S, int M,
                                  int D, int Q, int L, int P, void* stream) {
  return launch(static_cast<const float*>(value), loc, attn, out, shapes, B, S,
                M, D, Q, L, P, stream);
}

extern "C" int ms_deform_attn_fwd_bf16(const void* value, const float* loc,
                                       const float* attn, float* out,
                                       const int* shapes, int B, int S, int M,
                                       int D, int Q, int L, int P,
                                       void* stream) {
  return launch(static_cast<const Bf16Bits*>(value), loc, attn, out, shapes, B,
                S, M, D, Q, L, P, stream);
}
