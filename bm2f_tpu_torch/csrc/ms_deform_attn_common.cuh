// Shared by the deformable-attention forward (ms_deform_attn_fwd.cu, K1) and
// backward (ms_deform_attn_bwd.cu, K2): the level table, the bilinear corners
// of one sample, and the tiles a block takes. The backward re-samples `value`
// with exactly the forward's arithmetic because both call `bilinear_corners`.
//
// A block of either kernel owns one (b, m) and one tile of queries, tile t
// holding the queries tile_q[tile_ptr[t] : tile_ptr[t + 1]]
// (ops/deform_attn.py `tile_plan` builds the tables).

#pragma once

#include <cuda_runtime.h>

namespace msda {

constexpr int kMaxLevels = 16;
constexpr int kMaxDChunks = 4;  // D <= 128, in chunks of 32 channels
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// The level table from a host array of L (H, W) pairs. False when L, P or D
// is outside what the kernels take, or the levels do not sum to S.
inline bool make_levels(const int* shapes, int L, int P, int D, int S,
                        Levels* lv) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 32 || D % 32 != 0 ||
      D > 32 * kMaxDChunks)
    return false;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S;
}

// The level table in shared memory, where a level chosen at run time is one
// load. Every thread calls it (it syncs).
__device__ __forceinline__ void share_levels(Levels* s_lv, const Levels& lv,
                                             int L) {
  if (threadIdx.x < L) {
    s_lv->h[threadIdx.x] = lv.h[threadIdx.x];
    s_lv->w[threadIdx.x] = lv.w[threadIdx.x];
    s_lv->start[threadIdx.x] = lv.start[threadIdx.x];
  }
  __syncthreads();
}

// Corner c is (dy, dx) = (c >> 1, c & 1) from the top-left one. A corner
// outside the level has idx = -1 and w = 0 (zero padding). lx, ly are the
// fractional position inside the 2x2 neighbourhood.
struct Corners {
  int idx[4];
  float w[4];
  float lx, ly;
};

// The sample at normalized (u, v) of a level of H x W pixels whose first
// pixel is row `start` of value.
__device__ __forceinline__ Corners bilinear_corners(float u, float v, int H,
                                                    int W, int start) {
  Corners c;
  // loc * size - 0.5 with no fused multiply-add, as the plain version
  const float x = __fsub_rn(__fmul_rn(u, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)H), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  c.lx = __fsub_rn(x, x0);
  c.ly = __fsub_rn(y, y0);
  // validity in float, so that huge or NaN locations never reach an int
  // conversion: NaN compares false and leaves every corner out
  const bool vx0 = x0 >= 0.f && x0 <= (float)(W - 1);
  const bool vx1 = x0 >= -1.f && x0 <= (float)(W - 2);
  const bool vy0 = y0 >= 0.f && y0 <= (float)(H - 1);
  const bool vy1 = y0 >= -1.f && y0 <= (float)(H - 2);
  const int ix = (int)fminf(fmaxf(x0, -1.f), (float)W);
  const int iy = (int)fminf(fmaxf(y0, -1.f), (float)H);
  const float hx = 1.f - c.lx, hy = 1.f - c.ly;
  const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
  const float wt[4] = {hx * hy, c.lx * hy, hx * c.ly, c.lx * c.ly};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.idx[k] = ok[k] ? start + (iy + (k >> 1)) * W + ix + (k & 1) : -1;
    c.w[k] = ok[k] ? wt[k] : 0.f;
  }
  return c;
}

}  // namespace msda
