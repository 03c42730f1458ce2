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
// What bounds it on the H100: bytes, in principle. At the train-path shapes
// (1024x1024, B=2: S = Q = 21504, M=8, D=32, L=3, P=4) each input read once
// and each gradient written once is ~231 MB, or ~0.069 ms at 3.35 TB/s; the
// arithmetic (~2.1 GFLOP) would take ~0.03 ms at 67 TFLOP/s f32. What holds
// it is the gather K1 does and the scatter into d_value: one atomic add per
// corner and channel, executed in L2.
//
// What the design does about it: it re-samples `value` exactly as K1 does
// (`msda::bilinear_corners`, 16-byte rows, each sample worked out once by
// one lane), in blocks of one head's neighbouring queries (encoder cells:
// every query whose reference point falls in one 8x8 cell of the finest
// level, on every level, when Q == S; runs of queries otherwise), and
// adds a corner's share of d_value with one 16-byte vector atomic a lane
// (sm_90's `atomicAdd` on float4): a quarter of the first design's atomic
// instructions (one 4-byte `atomicAdd` a lane). The dot products with the
// output gradient reduce inside each lane group with __shfl_xor_sync, and
// the lane that worked a sample out writes its d_loc and d_attn, once, with
// no atomics: they are the same bits on every run. d_value's sums run in
// another order on every run (PERF.md states the tolerance). A tile of
// d_value in shared memory (shared-memory float atomics, flushed with a
// bulk reduce-add) was measured and lost: those atomics are slower than L2's
// vector ones. A deterministic d_value is ROADMAP queue 2.
//
// What it reached on an H100 (700 W power limit; chip_smoke.py, PERF.md):
// 0.70 ms at the train shapes, 0.10 of its byte bound; the first design
// took 1.37 ms.

#include "ms_deform_attn_common.cuh"

namespace {

using msda::kFull;
using msda::kMaxDChunks;
using msda::kThreads;
using msda::kWarpsPerBlock;

constexpr int kLanes = 8;              // lanes that cover 32 f32 channels
constexpr int kGroups = 32 / kLanes;   // lane groups a warp

// kL, kP, kNC: L, P and D / 32 fixed at compile time, or 0 for any; at most
// 128 registers a thread, so that two blocks share an SM
template <int kL, int kP, int kNC>
__global__ void __launch_bounds__(kThreads, 2)
ms_deform_attn_bwd_kernel(const float* __restrict__ value,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn,
                          const float* __restrict__ grad_out,
                          float* __restrict__ d_value,
                          float* __restrict__ d_loc,
                          float* __restrict__ d_attn,
                          const int* __restrict__ tile_ptr,
                          const int* __restrict__ tile_q, msda::Levels lv,
                          int S, int M, int D, int Q, int L_, int P_,
                          int n_tiles) {
  const int L = kL ? kL : L_, P = kP ? kP : P_, K = L * P;
  const int nc = kNC ? kNC : D >> 5;
  // samples a lane group loads before it computes: all of them when L and P
  // are fixed, one at a time otherwise
  constexpr int kBatch = kL ? (kL * kP + kGroups - 1) / kGroups : 1;
  static_assert(kBatch <= kLanes, "a lane group works out at most kLanes samples");
  __shared__ msda::Levels s_lv;
  msda::share_levels(&s_lv, lv, L);

  const int tile = blockIdx.x % n_tiles;
  const long long bm = blockIdx.x / n_tiles;  // b * M + m
  const long long b = bm / M;
  const int m = (int)(bm % M);
  const long long pix_stride = (long long)M * D;  // one pixel of value
  const long long bm_offset = b * S * pix_stride + (long long)m * D;
  const float* value_bm = value + bm_offset;
  float* d_value_bm = d_value + bm_offset;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int n_it = (K + kGroups - 1) / kGroups;
  const int q_end = __ldg(tile_ptr + tile + 1);
  for (int i = __ldg(tile_ptr + tile) + (threadIdx.x >> 5); i < q_end;
       i += kWarpsPerBlock) {
    // (b, q, m) addresses loc / d_loc (K float2), attn / d_attn (K) and
    // grad_out (D channels)
    const long long row = (b * Q + __ldg(tile_q + i)) * M + m;
    float4 g[kMaxDChunks];
#pragma unroll
    for (int t = 0; t < kMaxDChunks; ++t)
      g[t] = t < nc ? __ldg(reinterpret_cast<const float4*>(grad_out + row * D +
                                                            32 * t + 4 * sub))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int it0 = 0; it0 < n_it; it0 += kLanes) {
      // lane `sub` of group `grp` works out sample (it0 + sub) * kGroups +
      // grp once: its corners' rows (-1: outside the level), K1's weights
      // and what its d_loc and d_attn need ...
      msda::Corners cs = {};
      float a = 0.f;
      int H = 0, W = 0, pix[4] = {-1, -1, -1, -1};
      float wa[4] = {0.f, 0.f, 0.f, 0.f};
      const int k = (it0 + sub) * kGroups + grp;
      const bool mine = it0 + sub < n_it && k < K;
      if (mine) {
        const int l = k / P;
        H = s_lv.h[l];
        W = s_lv.w[l];
        const float2 uv = __ldg(reinterpret_cast<const float2*>(loc) + row * K + k);
        cs = msda::bilinear_corners(uv.x, uv.y, H, W, s_lv.start[l]);
        a = __ldg(attn + row * K + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pix[c] = cs.idx[c];
          wa[c] = cs.idx[c] < 0 ? 0.f : cs.w[c] * a;
        }
      }
      // ... then the group's lanes take those samples together, kBatch at a
      // time: first every row, all loads in flight ...
      const int nj = min(kLanes, n_it - it0);
      for (int j0 = 0; j0 < nj; j0 += kBatch) {
        int pj[kBatch][4];
        float wj[kBatch][4];
        float4 v[kBatch][4][kMaxDChunks];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int src_lane = grp * kLanes + min(j0 + u, nj - 1);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pj[u][c] = j0 + u < nj ? __shfl_sync(kFull, pix[c], src_lane) : -1;
            wj[u][c] = __shfl_sync(kFull, wa[c], src_lane);
            const float* src = value_bm + pj[u][c] * pix_stride + 4 * sub;
#pragma unroll
            for (int t = 0; t < kMaxDChunks; ++t)
              if (t < nc)
                v[u][c][t] = pj[u][c] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                          : __ldg(reinterpret_cast<const float4*>(src + 32 * t));
          }
        }
        // ... then the d_value adds and the dot products with grad_out
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u;
          if (j >= nj) break;  // uniform
          float dot[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dot[c] = 0.f;
#pragma unroll
            for (int t = 0; t < kMaxDChunks; ++t) {
              if (t >= nc) continue;
              dot[c] += v[u][c][t].x * g[t].x + v[u][c][t].y * g[t].y +
                        v[u][c][t].z * g[t].z + v[u][c][t].w * g[t].w;
              if (pj[u][c] < 0) continue;  // outside the level: no gradient
              const float w = wj[u][c];
              atomicAdd(reinterpret_cast<float4*>(d_value_bm + pj[u][c] * pix_stride +
                                                  32 * t + 4 * sub),
                        make_float4(w * g[t].x, w * g[t].y, w * g[t].z, w * g[t].w));
            }
          }
          // the group's dot products over all channels, into every lane
#pragma unroll
          for (int off = 1; off < kLanes; off <<= 1)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[c] += __shfl_xor_sync(kFull, dot[c], off);
          if (sub == j && mine) {
            // sa = sum_c w_c dot_c, sx = sum_c dw_c/dlx dot_c, sy likewise;
            // w_00 = hx hy, w_01 = lx hy, w_10 = hx ly, w_11 = lx ly
            const float hx = 1.f - cs.lx, hy = 1.f - cs.ly;
            float sa = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float dwx = (c & 1) ? ((c & 2) ? cs.ly : hy) : -((c & 2) ? cs.ly : hy);
              const float dwy = (c & 2) ? ((c & 1) ? cs.lx : hx) : -((c & 1) ? cs.lx : hx);
              sa += cs.w[c] * dot[c];
              sx += dwx * dot[c];
              sy += dwy * dot[c];
            }
            const long long o = row * K + k;
            d_attn[o] = sa;
            // x = u * W - 0.5, so d lx / d u = W (and d ly / d v = H)
            d_loc[2 * o] = a * (float)W * sx;
            d_loc[2 * o + 1] = a * (float)H * sy;
          }
        }
      }
    }
  }
}

template <int kL, int kP, int kNC>
int launch_one(const float* value, const float* loc, const float* attn,
               const float* grad_out, float* d_value, float* d_loc,
               float* d_attn, const int* tile_ptr, const int* tile_q,
               const msda::Levels& lv, int B, int S, int M, int D, int Q, int L,
               int P, int n_tiles, cudaStream_t stream) {
  const long long blocks = (long long)B * M * n_tiles;
  ms_deform_attn_bwd_kernel<kL, kP, kNC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      value, loc, attn, grad_out, d_value, d_loc, d_attn, tile_ptr, tile_q, lv, S,
      M, D, Q, L, P, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, S, M, D), loc (B, Q, M, L, P, 2), attn (B, Q, M, L, P),
// grad_out (B, Q, M*D): contiguous f32 on the device. d_value has value's
// shape and must hold zeros; d_loc and d_attn have loc's and
// attn's shapes and are overwritten. tile_ptr and tile_q as for
// ms_deform_attn_fwd. shapes: host array of L (H, W) pairs. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ms_deform_attn_bwd(const float* value, const float* loc,
                                  const float* attn, const float* grad_out,
                                  float* d_value, float* d_loc, float* d_attn,
                                  const int* tile_ptr, const int* tile_q,
                                  const int* shapes, int B, int S, int M, int D,
                                  int Q, int L, int P, int n_tiles,
                                  void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv) || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 3 && P == 4 && D == 32)  // the model
    return launch_one<3, 4, 1>(value, loc, attn, grad_out, d_value, d_loc,
                               d_attn, tile_ptr, tile_q, lv, B, S, M, D, Q, L, P,
                               n_tiles, s);
  return launch_one<0, 0, 0>(value, loc, attn, grad_out, d_value, d_loc, d_attn,
                             tile_ptr, tile_q, lv, B, S, M, D, Q, L, P, n_tiles, s);
}
