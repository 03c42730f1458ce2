// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_bwd_kernel`
// (bm2f_tpu/ops/deform_attn_pallas.py:118, reached through `_gather_core_bwd`
// :190) together with the autodiff of its XLA prep
// `_build_patches_and_indices` (:236): from `value`, the sampling locations,
// the attention weights and the gradient of the output, this one kernel
// computes the gradients of all three inputs of `ms_deform_attn`
// (bm2f_tpu_torch/ops/deform_attn.py), the function K1 computes.
//
// What bounds it on the H100: bytes, and in this simple design the atomics.
// At the train-path shapes (1024x1024, B=2: S = Q = 21504, M=8, D=32, L=3,
// P=4) each input read once and each gradient written once is ~231 MB, or
// ~0.069 ms at 3.35 TB/s; the arithmetic (~2.1 GFLOP) would take ~0.03 ms
// at 67 TFLOP/s f32. The scatter into d_value is 528 M f32 atomic adds per
// call (16.5 M warp-wide ones), which L2 executes.
//
// What the design does about it: the TPU kernel scatters into a (S, 4D)
// patch-gradient block held resident across a grid axis that runs in order,
// and folds corner weights with hi/lo MXU dots, because a TPU issues gathers
// slowly and has no atomics. Hopper blocks run in no order, so this kernel
// samples `value` directly, as K1 does, and adds into a zeroed d_value with
// atomicAdd. One warp owns one (b, q, m), lane = channel, as in K1: each
// corner is one coalesced 128-byte read of value, one coalesced run of 32
// atomics into d_value, and one dot product over D reduced with
// __shfl_xor_sync. Lanes 0..K-1 recompute each sample's corners with K1's
// arithmetic (`msda::bilinear_corners`). d_loc and d_attn are written once
// per sample, with no atomics, so they are the same bits on every run;
// d_value's sums run in another order on every run (PERF.md states the
// tolerance). A deterministic or faster scatter (shared-memory tiles, a
// sorted two-pass scatter) is later work.

#include "ms_deform_attn_common.cuh"

namespace {

using msda::kFull;
using msda::kMaxDChunks;
using msda::kWarpsPerBlock;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_bwd_kernel(const float* __restrict__ value,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn,
                          const float* __restrict__ grad_out,
                          float* __restrict__ d_value,
                          float* __restrict__ d_loc,
                          float* __restrict__ d_attn, msda::Levels lv, int S,
                          int M, int D, int Q, int P, int K,
                          long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // uniform across the warp
  // warp = (b * Q + q) * M + m, as in K1: it addresses the (b, q, m) slice
  // of loc / d_loc (K*2 floats), attn / d_attn (K) and grad_out (D)
  const int m = (int)(warp % M);
  const long long b = warp / M / Q;
  const long long row_stride = (long long)M * D;  // one pixel of value
  const long long bm_offset = b * S * row_stride + (long long)m * D;
  const float* value_bm = value + bm_offset;
  float* d_value_bm = d_value + bm_offset;
  const int nd = D >> 5;

  float g[kMaxDChunks];
  const float* g_w = grad_out + warp * (long long)D;
#pragma unroll
  for (int t = 0; t < kMaxDChunks; ++t)
    g[t] = t < nd ? __ldg(g_w + lane + 32 * t) : 0.f;

  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    msda::Corners cs = {{-1, -1, -1, -1}, {0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
    float a = 0.f;
    int H = 0, W = 0;
    if (k < K) {
      const int l = k / P;
      H = lv.h[l];
      W = lv.w[l];
      cs = msda::bilinear_corners(__ldg(loc + (warp * K + k) * 2),
                                  __ldg(loc + (warp * K + k) * 2 + 1), H, W,
                                  lv.start[l]);
      a = __ldg(attn + warp * K + k);
    }
    // lane j ends up holding sample k0 + j's sums over its valid corners:
    // sa = sum_c w_c dot_c, sx = sum_c dw_c/dlx dot_c, sy = sum_c dw_c/dly dot_c
    float mine_a = 0.f, mine_x = 0.f, mine_y = 0.f;
    const int kn = min(32, K - k0);
    for (int j = 0; j < kn; ++j) {
      const float aj = __shfl_sync(kFull, a, j);
      const float lx = __shfl_sync(kFull, cs.lx, j);
      const float ly = __shfl_sync(kFull, cs.ly, j);
      const float hx = 1.f - lx, hy = 1.f - ly;
      // this lane's share (its channels) of the three sums
      float pa = 0.f, px = 0.f, py = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = __shfl_sync(kFull, cs.idx[c], j);
        const float wc = __shfl_sync(kFull, cs.w[c], j);
        if (s < 0) continue;  // uniform: every lane holds the same s
        const float* row = value_bm + (long long)s * row_stride;
        float* d_row = d_value_bm + (long long)s * row_stride;
        const float wa = wc * aj;  // K1's weight of this corner
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxDChunks; ++t) {
          if (t < nd) {
            dot += __ldg(row + lane + 32 * t) * g[t];
            atomicAdd(d_row + lane + 32 * t, wa * g[t]);
          }
        }
        // w_00 = hx hy, w_01 = lx hy, w_10 = hx ly, w_11 = lx ly
        const float dwx = (c & 1) ? ((c & 2) ? ly : hy) : -((c & 2) ? ly : hy);
        const float dwy = (c & 2) ? ((c & 1) ? lx : hx) : -((c & 1) ? lx : hx);
        pa += wc * dot;
        px += dwx * dot;
        py += dwy * dot;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pa += __shfl_xor_sync(kFull, pa, off);
        px += __shfl_xor_sync(kFull, px, off);
        py += __shfl_xor_sync(kFull, py, off);
      }
      if (lane == j) {
        mine_a = pa;
        mine_x = px;
        mine_y = py;
      }
    }
    if (k < K) {
      const long long o = warp * K + k;
      d_attn[o] = mine_a;
      // x = u * W - 0.5, so d lx / d u = W (and d ly / d v = H)
      d_loc[2 * o] = a * (float)W * mine_x;
      d_loc[2 * o + 1] = a * (float)H * mine_y;
    }
  }
}

}  // namespace

// value (B, S, M, D), loc (B, Q, M, L, P, 2), attn (B, Q, M, L, P),
// grad_out (B, Q, M*D): contiguous f32 on the device. d_value has value's
// shape and must hold zeros; d_loc and d_attn have loc's and attn's shapes
// and are overwritten. shapes: host array of L (H, W) pairs. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ms_deform_attn_bwd(const float* value, const float* loc,
                                  const float* attn, const float* grad_out,
                                  float* d_value, float* d_loc, float* d_attn,
                                  const int* shapes, int B, int S, int M,
                                  int D, int Q, int L, int P, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv))
    return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * M;
  if (n_warps == 0) return 0;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ms_deform_attn_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      value, loc, attn, grad_out, d_value, d_loc, d_attn, lv, S, M, D, Q, P,
      L * P, n_warps);
  return (int)cudaGetLastError();
}
