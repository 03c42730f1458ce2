// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_fwd_kernel`
// (bm2f_tpu/ops/deform_attn_pallas.py:102) together with its XLA prep
// `_build_patches_and_indices` (:236): this one kernel computes the whole of
// `ms_deform_attn` (bm2f_tpu_torch/ops/deform_attn.py), from `value`, the
// sampling locations and the softmaxed attention weights to the output.
//
// What bounds it on the H100: bytes, in principle. Each input read once and
// the output written once is ~42 MB per call at the main-path shapes
// (800x800, B=1), or ~12.5 us at 3.35 TB/s; the arithmetic (~0.32 GFLOP)
// would take ~4.8 us at 67 TFLOP/s f32. The gather itself reads 4 corner
// rows of D channels for each of the B*Q*M*L*P samples, ~645 MB a call
// from a 13.4 MB `value`, so caches serve it; what holds this kernel is
// the instructions and row requests a warp issues per output row.
//
// What the design does about it:
// - 16-byte rows. 8 lanes cover a 128-byte f32 row of 32 channels (4 lanes
//   a 64-byte bf16 row), so one warp-wide load fetches the rows of 4
//   corners (8 in bf16). The first design issued one 4-byte load per lane
//   per corner.
// - Each sample worked out once. A lane group takes whole samples; lane
//   `sub` of the group computes sample sub's corners and weights, and the
//   group's lanes read them with __shfl_sync as they gather. The groups
//   combine their sums with __shfl_xor_sync once per output row.
//   Instantiated on L=3, P=4, D=32 (the model), every loop unrolls and all
//   12 loads of a (b, q, m) are issued together; a generic instantiation
//   takes any L <= 16, P and D <= 128.
// - Blocks of neighbouring queries of one head. A block owns one (b, m)
//   and one run of 64 consecutive queries, whose samples fall near each
//   other's, so its rows are reused from L1. Measured and not kept
//   (PERF.md): a `value` transposed head-major for the kernel (the
//   transpose cost more than it gave), the encoder cells K2 takes (no
//   faster here), and staging each tile's window of `value` in shared
//   memory with `cp.async.bulk` (it cost occupancy and L1 and saved nothing
//   L1 did not).
//
// A bf16 `value` (the bf16 serving path) takes the same kernel instantiated
// on 16-bit rows: it reads bf16 and does all arithmetic in f32, on the f32
// locations and attention weights, into an f32 output, as the Pallas path
// does (its patch table is cast to f32, deform_attn_pallas.py:272).
//
// What it reached on an H100 (700 W power limit; chip_smoke.py, PERF.md):
// 0.079 ms at 800x800 B=1, 0.16 of its byte bound, and 0.23 ms at the
// train shapes (1024x1024, B=2); 0.088 ms on a bf16 `value`. The first
// design took 0.31, 1.02 and 0.32 ms.

#include "ms_deform_attn_common.cuh"

namespace {

using msda::kFull;
using msda::kMaxDChunks;
using msda::kThreads;
using msda::kWarpsPerBlock;

// kL, kP, kNC: L, P and D / 32 fixed at compile time, or 0 for any
template <typename T, int kL, int kP, int kNC>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_fwd_kernel(const T* __restrict__ value,
                          const float* __restrict__ loc,
                          const float* __restrict__ attn,
                          float* __restrict__ out,
                          const int* __restrict__ tile_ptr,
                          const int* __restrict__ tile_q, msda::Levels lv,
                          int S, int M, int D, int Q, int L_, int P_,
                          int n_tiles) {
  constexpr int E = Row16<T>::kElems;  // channels a lane loads at once
  constexpr int kLanes = 32 / E;       // lanes that cover 32 channels
  constexpr int kGroups = 32 / kLanes;  // lane groups a warp
  const int L = kL ? kL : L_, P = kP ? kP : P_, K = L * P;
  const int nc = kNC ? kNC : D >> 5;
  __shared__ msda::Levels s_lv;
  msda::share_levels(&s_lv, lv, L);

  const int tile = blockIdx.x % n_tiles;
  const long long bm = blockIdx.x / n_tiles;  // b * M + m
  const long long b = bm / M;
  const int m = (int)(bm % M);
  const long long pix_stride = (long long)M * D;  // one pixel of value
  const T* value_bm = value + b * S * pix_stride + (long long)m * D;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int n_it = (K + kGroups - 1) / kGroups;  // samples a lane group takes
  const int q_end = __ldg(tile_ptr + tile + 1);
  for (int i = __ldg(tile_ptr + tile) + (threadIdx.x >> 5); i < q_end;
       i += kWarpsPerBlock) {
    // (b, q, m) addresses loc (K float2), attn (K) and out (D channels)
    const long long row = (b * Q + __ldg(tile_q + i)) * M + m;
    float acc[kMaxDChunks][E] = {};
    for (int it0 = 0; it0 < n_it; it0 += kLanes) {
      // lane `sub` of group `grp` works out sample (it0 + sub) * kGroups +
      // grp once: its corners' rows (-1: outside the level) and weights ...
      int pix[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      const int k = (it0 + sub) * kGroups + grp;
      if (it0 + sub < n_it && k < K) {
        const int l = k / P;
        const float2 uv = __ldg(reinterpret_cast<const float2*>(loc) + row * K + k);
        const msda::Corners cs = msda::bilinear_corners(uv.x, uv.y, s_lv.h[l],
                                                        s_lv.w[l], s_lv.start[l]);
        const float a = __ldg(attn + row * K + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pix[c] = cs.idx[c];
          wt[c] = cs.idx[c] < 0 ? 0.f : cs.w[c] * a;
        }
      }
      // ... and the group's lanes gather each of those samples together
      const int nj = min(kLanes, n_it - it0);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (j >= nj) break;  // uniform
        const int src_lane = grp * kLanes + j;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = __shfl_sync(kFull, pix[c], src_lane);
          const float w = __shfl_sync(kFull, wt[c], src_lane);
#pragma unroll
          for (int t = 0; t < kMaxDChunks; ++t) {
            if (t < nc) {
              float v[E] = {};
              if (p >= 0)
                Row16<T>::load(value_bm + p * pix_stride + 32 * t + E * sub, v);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[t][e] += w * v[e];
            }
          }
        }
      }
    }
    // the lane groups' sums of each channel, into every group
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
      for (int t = 0; t < kMaxDChunks; ++t)
        if (t < nc)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[t][e] += __shfl_xor_sync(kFull, acc[t][e], off);
    if (grp == 0) {
      float* o = out + row * D;
#pragma unroll
      for (int t = 0; t < kMaxDChunks; ++t)
        if (t < nc)
#pragma unroll
          for (int e = 0; e < E; e += 4)
            *reinterpret_cast<float4*>(o + 32 * t + E * sub + e) =
                make_float4(acc[t][e], acc[t][e + 1], acc[t][e + 2], acc[t][e + 3]);
    }
  }
}

template <typename T, int kL, int kP, int kNC>
int launch_one(const T* value, const float* loc, const float* attn, float* out,
               const int* tile_ptr, const int* tile_q, const msda::Levels& lv,
               int B, int S, int M, int D, int Q, int L, int P, int n_tiles,
               cudaStream_t stream) {
  const long long blocks = (long long)B * M * n_tiles;
  ms_deform_attn_fwd_kernel<T, kL, kP, kNC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      value, loc, attn, out, tile_ptr, tile_q, lv, S, M, D, Q, L, P, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* value, const float* loc, const float* attn, float* out,
           const int* tile_ptr, const int* tile_q, const int* shapes, int B,
           int S, int M, int D, int Q, int L, int P, int n_tiles, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv) || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 3 && P == 4 && D == 32)  // the model
    return launch_one<T, 3, 4, 1>(value, loc, attn, out, tile_ptr, tile_q, lv, B,
                                  S, M, D, Q, L, P, n_tiles, s);
  return launch_one<T, 0, 0, 0>(value, loc, attn, out, tile_ptr, tile_q, lv, B, S,
                                M, D, Q, L, P, n_tiles, s);
}

}  // namespace

// value (B, S, M, D), loc (B, Q, M, L, P, 2), attn (B, Q, M, L, P), out
// (B, Q, M*D): contiguous on the device; value f32 (ms_deform_attn_fwd)
// or bf16 (ms_deform_attn_fwd_bf16), everything else f32. tile_ptr
// (n_tiles + 1) and tile_q (Q): int32 on the device, the tiles of
// ops/deform_attn.py `tile_plan`. shapes: host array of L (H, W) pairs.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ms_deform_attn_fwd(const void* value, const float* loc,
                                  const float* attn, float* out,
                                  const int* tile_ptr, const int* tile_q,
                                  const int* shapes, int B, int S, int M, int D,
                                  int Q, int L, int P, int n_tiles,
                                  void* stream) {
  return launch(static_cast<const float*>(value), loc, attn, out, tile_ptr,
                tile_q, shapes, B, S, M, D, Q, L, P, n_tiles, stream);
}

extern "C" int ms_deform_attn_fwd_bf16(const void* value, const float* loc,
                                       const float* attn, float* out,
                                       const int* tile_ptr, const int* tile_q,
                                       const int* shapes, int B, int S, int M,
                                       int D, int Q, int L, int P, int n_tiles,
                                       void* stream) {
  return launch(static_cast<const Bf16Bits*>(value), loc, attn, out, tile_ptr,
                tile_q, shapes, B, S, M, D, Q, L, P, n_tiles, stream);
}
