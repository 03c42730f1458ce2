// Shared by the deformable-attention forward (ms_deform_attn_fwd.cu, K1) and
// backward (ms_deform_attn_bwd.cu, K2): the level table, the bilinear corners
// of one sample, the 16-byte row slices of an f32 or bf16 `value`, and the
// tiles a block takes. The backward re-samples `value` with exactly the
// forward's arithmetic because both call `bilinear_corners`.
//
// A block of either kernel owns one (b, m) and one tile of queries, tile t
// holding the queries tile_q[tile_ptr[t] : tile_ptr[t + 1]]
// (ops/deform_attn.py `tile_plan` builds the tables).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_bits.cuh"

// 16 bytes of a `value` row as f32: 4 f32 or 8 bf16 channels. `load` reads
// and upcasts at once; `load_raw` keeps the 16 bytes in 4 registers and
// `unpack` upcasts them where they are used (K2 holds many rows in flight).
template <typename T>
struct Row16;

template <>
struct Row16<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static uint4 load_raw(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Row16<Bf16Bits> {
  static constexpr int kElems = 8;
  __device__ static void load(const Bf16Bits* p, float* v) { load_bf16x8(p, v); }
  __device__ static uint4 load_raw(const Bf16Bits* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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
