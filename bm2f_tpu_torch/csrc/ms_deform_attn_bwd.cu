// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_bwd_kernel`
// (bm2f_tpu/ops/deform_attn_pallas.py:118, reached through `_gather_core_bwd`
// :190) together with the autodiff of its XLA prep
// `_build_patches_and_indices` (:236): from `value`, the sampling locations,
// the attention weights and the gradient of the output, these kernels
// compute the gradients of all three inputs of `ms_deform_attn`
// (bm2f_tpu_torch/ops/deform_attn.py), the function K1 computes.
//
// d_value is the same bits on every run. The Pallas kernel scatters
// sequentially (deform_attn_pallas.py:144-150); blocks on the card run in
// no order, so d_value is summed destination-major instead, with no float
// atomics, in three steps (ops/deform_attn.py `ms_deform_attn_bwd_cuda`
// launches them; `destination_plan` and `d_value_by_destination` are their
// plain mirror):
//  1. The sample pass (`ms_deform_attn_bwd_sample`) re-samples `value`
//     exactly as K1 does (`msda::bilinear_corners`, 16-byte rows, each
//     sample worked out once by one lane, blocks of one head's neighbouring
//     queries: encoder cells when Q == S, runs otherwise). The lane that
//     works a sample out writes its d_loc and d_attn once, and, at the
//     sample's own index n = ((b M + m) Q + q) K + k (so nothing depends on
//     the tiles or their order), its key and its four corner weights times
//     its attention weight. The key is the sample's top-left corner pixel
//     on its level padded by one pixel above and to the left: pad_start[l]
//     + (y0 + 1)(W + 1) + (x0 + 1), in [0, S_pad), or S_pad when no corner
//     is inside the level.
//  2. A stable LSD radix sort of the samples by key within each (b, m)
//     (8-bit digits, 2 passes for S_pad < 2^16; per pass a count kernel, an
//     exclusive scan of the per-block counts by the caller and a scatter
//     kernel that ranks within a warp with __match_any_sync and writes
//     through shared memory, a block's items of one digit together). Each
//     key's samples come out in ascending n: ascending (q, k).
//  3. The bounds of each key's samples in the sorted keys (`msda_key_bounds`,
//     no atomics: a thread an item), then the reduce pass
//     (`ms_deform_attn_bwd_reduce`): a group of 8 lanes per destination row
//     (b, s, m), a block a tile of 4 x 8 pixels of one (b, m), whose rows
//     share many samples. Pixel (y, x) is corner c = 2 dy + dx of the
//     samples whose top-left corner is (y - dy, x - dx): for c = 0..3, and
//     within each key in ascending n, the group adds (w_c a) *
//     grad_out[b, q, m, :] in f32, a multiply and an add each rounded (no
//     fused multiply-add), 8 rows in flight, and writes the row once: zeros
//     where nothing landed, and a bf16 `value`'s d_value rounded to bf16
//     once.
//  That order (c, then q, then k) is fixed by the data alone.
//
// What bounds it on the H100: bytes, in principle. At the train-path shapes
// (1024x1024, B=2: S = Q = 21504, M=8, D=32, L=3, P=4) each input read once
// and each gradient written once is ~231 MB (187 MB on a bf16 `value`), or
// ~0.069 ms at 3.35 TB/s; the arithmetic (~2.1 GFLOP) would take ~0.03 ms
// at 67 TFLOP/s f32. What the design adds: the sample pass's gather of
// `value` rows (as K1's), 20 bytes a sample of keys and weights and the
// sort's passes over 8 bytes a sample (4.1M samples), and in the reduce
// one 128-byte grad_out row a valid corner (15.5M, 2.0 GB), served by L2:
// the bytes the earlier designs' float4 atomics read and wrote back in L2.
//
// A bf16 `value` (bf16 training) takes the sample pass instantiated on
// 16-bit rows, as K1 does: 4 lanes cover a 64-byte row of 32 channels, each
// lane 8 channels in one 16-byte load, all arithmetic in f32 on the f32
// locations, attention weights and output gradient. The reduce reads only
// f32 and differs in its store. The JAX package rounds its f32 patch
// gradient to bf16 and sums the four corner blocks in bf16 (the autodiff of
// deform_attn_pallas.py:267-272), one rounding per corner more.
//
// The two designs before this one added each corner's
// share into d_value with float atomics, in another order on every run.
// What this design reached on an H100 (700 W power limit; tools/
// deform_attn_bench.py, PERF.md): 0.96 ms at the train shapes in f32 (sample
// pass 0.46, sort 0.16, bounds 0.02, reduce 0.32), where the atomics took
// 0.70; 0.81 ms on a bf16 `value`, where they took 1.35.

#include "ms_deform_attn_common.cuh"

namespace {

using msda::kFull;
using msda::kMaxDChunks;
using msda::kMaxLevels;
using msda::kThreads;
using msda::kWarpsPerBlock;

// The first padded key of each level, in shared memory after
// msda::share_levels: level l holds (H_l + 1)(W_l + 1) top-left corners,
// from (-1, -1) to (H_l - 1, W_l - 1); s_pad[L] = S_pad. Every thread calls
// it (it syncs).
__device__ __forceinline__ void share_pad_starts(int* s_pad, const msda::Levels* s_lv,
                                                 int L) {
  if (threadIdx.x == 0) {
    int start = 0;
    for (int l = 0; l < L; ++l) {
      s_pad[l] = start;
      start += (s_lv->h[l] + 1) * (s_lv->w[l] + 1);
    }
    s_pad[L] = start;
  }
  __syncthreads();
}

// Step 1. kL, kP, kNC: L, P and D / 32 fixed at compile time, or 0 for any.
// On f32 rows at most 128 registers a thread, so that two blocks share an
// SM; bf16 rows were 4 % faster with no bound (PERF.md)
template <typename T, int kL, int kP, int kNC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 1 : 2)
ms_deform_attn_bwd_sample_kernel(const T* __restrict__ value,
                                 const float* __restrict__ loc,
                                 const float* __restrict__ attn,
                                 const float* __restrict__ grad_out,
                                 float* __restrict__ d_loc,
                                 float* __restrict__ d_attn,
                                 float4* __restrict__ wa_out,
                                 int* __restrict__ keys,
                                 const int* __restrict__ tile_ptr,
                                 const int* __restrict__ tile_q, msda::Levels lv,
                                 int S, int M, int D, int Q, int L_, int P_,
                                 int n_tiles) {
  constexpr int E = Row16<T>::kElems;   // channels a lane loads at once
  constexpr int kLanes = 32 / E;        // lanes that cover 32 channels
  constexpr int kGroups = 32 / kLanes;  // lane groups a warp
  const int L = kL ? kL : L_, P = kP ? kP : P_, K = L * P;
  const int nc = kNC ? kNC : D >> 5;
  // samples a lane group loads before it computes: all of them when L and P
  // are fixed, one at a time otherwise
  constexpr int kBatch = kL ? (kL * kP + kGroups - 1) / kGroups : 1;
  static_assert(kBatch <= kLanes, "a lane group works out at most kLanes samples");
  __shared__ msda::Levels s_lv;
  __shared__ int s_pad[kMaxLevels + 1];
  msda::share_levels(&s_lv, lv, L);
  share_pad_starts(s_pad, &s_lv, L);

  const int tile = blockIdx.x % n_tiles;
  const long long bm = blockIdx.x / n_tiles;  // b * M + m
  const long long b = bm / M;
  const int m = (int)(bm % M);
  const long long pix_stride = (long long)M * D;  // one pixel of value
  const T* value_bm = value + b * S * pix_stride + (long long)m * D;
  const int S_pad = s_pad[L];
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int n_it = (K + kGroups - 1) / kGroups;
  const int q_end = __ldg(tile_ptr + tile + 1);
  for (int i = __ldg(tile_ptr + tile) + (threadIdx.x >> 5); i < q_end;
       i += kWarpsPerBlock) {
    // (b, q, m) addresses loc / d_loc (K float2), attn / d_attn (K) and
    // grad_out (D channels)
    const long long row = (b * Q + __ldg(tile_q + i)) * M + m;
    float g[kMaxDChunks][E];
#pragma unroll
    for (int t = 0; t < kMaxDChunks; ++t)
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 x = t < nc ? __ldg(reinterpret_cast<const float4*>(
                                      grad_out + row * D + 32 * t + E * sub + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        g[t][e] = x.x;
        g[t][e + 1] = x.y;
        g[t][e + 2] = x.z;
        g[t][e + 3] = x.w;
      }
    for (int it0 = 0; it0 < n_it; it0 += kLanes) {
      // lane `sub` of group `grp` works out sample (it0 + sub) * kGroups +
      // grp once: its corners' rows (-1: outside the level), K1's weights,
      // and the sample's key and corner weights for the reduce ...
      msda::Corners cs = {};
      float a = 0.f;
      int H = 0, W = 0, pix[4] = {-1, -1, -1, -1};
      const int k = (it0 + sub) * kGroups + grp;
      const bool mine = it0 + sub < n_it && k < K;
      if (mine) {
        const int l = k / P;
        H = s_lv.h[l];
        W = s_lv.w[l];
        const float2 uv = __ldg(reinterpret_cast<const float2*>(loc) + row * K + k);
        cs = msda::bilinear_corners(uv.x, uv.y, H, W, s_lv.start[l]);
        a = __ldg(attn + row * K + k);
        float wa[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pix[c] = cs.idx[c];
          wa[c] = cs.idx[c] < 0 ? 0.f : __fmul_rn(cs.w[c], a);
        }
        const bool any = pix[0] >= 0 || pix[1] >= 0 || pix[2] >= 0 || pix[3] >= 0;
        const int key = any ? s_pad[l] + (cs.iy + 1) * (W + 1) + cs.ix + 1 : S_pad;
        const long long n = (bm * Q + __ldg(tile_q + i)) * K + k;
        keys[n] = key;
        wa_out[n] = make_float4(wa[0], wa[1], wa[2], wa[3]);
      }
      // ... then the group's lanes take those samples together, kBatch at a
      // time: first every row, all loads in flight (16 raw bytes each) ...
      const int nj = min(kLanes, n_it - it0);
      for (int j0 = 0; j0 < nj; j0 += kBatch) {
        uint4 v[kBatch][4][kMaxDChunks];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int src_lane = grp * kLanes + min(j0 + u, nj - 1);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int pj = j0 + u < nj ? __shfl_sync(kFull, pix[c], src_lane) : -1;
            const T* src = value_bm + pj * pix_stride + E * sub;
#pragma unroll
            for (int t = 0; t < kMaxDChunks; ++t)
              if (t < nc)
                v[u][c][t] = pj < 0 ? make_uint4(0u, 0u, 0u, 0u)
                                    : Row16<T>::load_raw(src + 32 * t);
          }
        }
        // ... then the dot products with grad_out
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
              float x[E];
              Row16<T>::unpack(v[u][c][t], x);
              float s = x[0] * g[t][0];
#pragma unroll
              for (int e = 1; e < E; ++e) s += x[e] * g[t][e];
              dot[c] += s;
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

// Step 2, the radix sort: 8-bit digits; the items form n_seg segments of
// seg_len (one per (b, m)), sorted each on its own; a block takes kSortTile
// consecutive items of one segment, a warp kSortItems rounds of 32
// consecutive items of them. hist and scan hold [segment][digit][block].
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortItems = 16;
constexpr int kSortTile = kWarpsPerBlock * 32 * kSortItems;
static_assert(kThreads == kRadix, "a thread a digit");

// hist[(segment * kRadix + d) * gridDim.x + block]: the block's keys of
// digit d
__global__ void __launch_bounds__(kThreads)
radix_count_kernel(const int* __restrict__ keys, int seg_len, int shift,
                   int* __restrict__ hist) {
  __shared__ int h[kRadix];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int tile_base = blockIdx.x * kSortTile;
  const int* seg = keys + (long long)blockIdx.y * seg_len;
  const int n = min(kSortTile, seg_len - tile_base);
  for (int i = threadIdx.x; i < n; i += kThreads)
    atomicAdd(&h[(__ldg(seg + tile_base + i) >> shift) & (kRadix - 1)], 1);
  __syncthreads();
  hist[((long long)blockIdx.y * kRadix + threadIdx.x) * gridDim.x + blockIdx.x] =
      h[threadIdx.x];
}

// The exclusive sum of v over the block's threads, in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  return before + x - v;
}

// One stable pass. An item of digit d goes to the exclusive scan of hist at
// (segment, d, block) (scan - hist), plus the block's items of digit d in
// earlier warps, earlier rounds of its warp and lower lanes of its round.
// The block first orders its items by digit in shared memory, then writes
// each digit's items to consecutive addresses. vals_in == nullptr stands for
// vals_in[i] = i.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                     int* __restrict__ keys_out, int* __restrict__ vals_out, int seg_len,
                     int shift, const int* __restrict__ hist,
                     const int* __restrict__ scan) {
  __shared__ int offset[kWarpsPerBlock][kRadix];  // per warp and digit
  __shared__ int digit_start[kRadix];             // in the block's order
  __shared__ int out_start[kRadix];               // in the output
  __shared__ int s_warp[kWarpsPerBlock];
  __shared__ int s_key[kSortTile], s_val[kSortTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = 0; w < kWarpsPerBlock; ++w) offset[w][threadIdx.x] = 0;
  __syncthreads();
  const long long seg_base = (long long)blockIdx.y * seg_len;
  const int tile_base = blockIdx.x * kSortTile;
  const int first = tile_base + warp * 32 * kSortItems + lane;
  int key[kSortItems], val[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int i = first + 32 * r;
    key[r] = i < seg_len ? __ldg(keys_in + seg_base + i) : -1;
    val[r] = i < seg_len ? (vals_in ? __ldg(vals_in + seg_base + i) : (int)(seg_base + i))
                         : 0;
    if (key[r] >= 0) atomicAdd(&offset[warp][(key[r] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  {  // thread d: the digit's warps in order, then the digits in order
    const int d = threadIdx.x;
    int run = 0;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int c = offset[w][d];
      offset[w][d] = run;
      run += c;
    }
    const int start = block_exclusive_scan(run, s_warp);
    digit_start[d] = start;
    const long long at = ((long long)blockIdx.y * kRadix + d) * gridDim.x + blockIdx.x;
    out_start[d] = __ldg(scan + at) - __ldg(hist + at);
    for (int w = 0; w < kWarpsPerBlock; ++w) offset[w][d] += start;
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool ok = key[r] >= 0;  // keys are >= 0; -1 past the end
    const int d = ok ? (key[r] >> shift) & (kRadix - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (ok) {
      const int at = offset[warp][d] + __popc(peers & lower);
      s_key[at] = key[r];
      s_val[at] = val[r];
    }
    __syncwarp();
    if (ok && lane == 31 - __clz(peers)) offset[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int n = min(kSortTile, seg_len - tile_base);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = s_key[i], d = (k >> shift) & (kRadix - 1);
    const int at = out_start[d] + i - digit_start[d];
    keys_out[at] = k;
    vals_out[at] = s_val[i];
  }
}

// f32 to bf16, rounded to nearest even (as PyTorch's .to(torch.bfloat16))
__device__ __forceinline__ uint16_t bf16_rne(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

// 4 channels (16-byte aligned f32, 8-byte aligned bf16), stored at once
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(Bf16Bits* p, const float* x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2((uint32_t)bf16_rne(x[0]) | (uint32_t)bf16_rne(x[1]) << 16,
                 (uint32_t)bf16_rne(x[2]) | (uint32_t)bf16_rne(x[3]) << 16);
}

// Step 3a. The bounds of every key's samples in the sorted keys: row_ptr[
// seg (S_pad + 1) + j] is the position of segment seg's first sample of key
// j, where key j + 1's begin its last ends; the last entry is n. A thread an
// item, writing the entries of the keys from its left neighbour's (or -1)
// up to its own.
__global__ void __launch_bounds__(kThreads)
key_bounds_kernel(const int* __restrict__ sorted, int seg_len, long long n, int S_pad,
                  int* __restrict__ row_ptr) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int at = (int)(i % seg_len);
  const int k = __ldg(sorted + i);
  const int prev = at == 0 ? -1 : __ldg(sorted + i - 1);
  int* rp = row_ptr + (i / seg_len) * (S_pad + 1);
  for (int j = prev + 1; j <= k; ++j) rp[j] = (int)i;
  if (at == seg_len - 1) {  // the segment's empty keys after its last
    for (int j = k + 1; j <= S_pad; ++j) rp[j] = (int)(i + 1);
    if (i == n - 1) rp[S_pad + 1] = (int)n;
  }
}

// The first tile of each level, in shared memory after msda::share_levels:
// level l holds ceil(H_l / kTileH) x ceil(W_l / kTileW) tiles, row by row;
// s_tile[L] is their number. Every thread calls it (it syncs).
constexpr int kTileH = 4, kTileW = 8;  // a block's pixels: 2 x 4 warps of 2 x 2
__device__ __forceinline__ void share_tile_starts(int* s_tile, const msda::Levels* s_lv,
                                                  int L) {
  if (threadIdx.x == 0) {
    int start = 0;
    for (int l = 0; l < L; ++l) {
      s_tile[l] = start;
      start += (s_lv->h[l] + kTileH - 1) / kTileH * ((s_lv->w[l] + kTileW - 1) / kTileW);
    }
    s_tile[L] = start;
  }
  __syncthreads();
}

// Step 3. A group of 8 lanes per destination row (b, s, m), lane `sub` of a
// group channels 4 sub .. 4 sub + 3 of each 32 (one 16-byte load). A block
// takes one (b, m) and a tile of kTileH x kTileW pixels of one level, a warp
// 2 x 2 of them: a sample is a corner of 4 neighbouring pixels, so the
// tile's warps read many of the same grad_out rows, from L1. A row's
// entries, corner 0's samples then corner 1's ..., are taken
// 8 at a time: lane sub fetches entry sub's sample (its grad_out row and
// weight; the next 8 entries' are fetched while this chunk's rows load),
// then the group loads the 8 rows at once and adds them in order. kNC: D /
// 32 fixed at compile time, or 0 for any.
template <typename TOut, int kNC>
__global__ void __launch_bounds__(kThreads, 4)
ms_deform_attn_bwd_reduce_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ order,
                                 const float* __restrict__ wa,
                                 const float* __restrict__ grad_out,
                                 TOut* __restrict__ d_value, msda::Levels lv, int B,
                                 int S, int M, int D, int Q, int L, int K) {
  constexpr int kLanes = 8, kRows = 32 / kLanes;
  constexpr int kInFlight = kNC == 1 ? kLanes : 2;
  static_assert(kRows == 4 && kWarpsPerBlock == kTileH * kTileW / 4, "2 x 2 pixels a warp");
  __shared__ msda::Levels s_lv;
  __shared__ int s_pad[kMaxLevels + 1], s_tile[kMaxLevels + 1];
  msda::share_levels(&s_lv, lv, L);
  share_pad_starts(s_pad, &s_lv, L);
  share_tile_starts(s_tile, &s_lv, L);
  const int nc = kNC ? kNC : D >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, grp = lane / kLanes, sub = lane % kLanes;
  const int n_tiles = s_tile[L];
  const int bm = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int b = bm / M, m = bm % M;
  int l = 0;
  while (l + 1 < L && tile >= s_tile[l + 1]) ++l;
  const int H = s_lv.h[l], W = s_lv.w[l];
  const int n_tx = (W + kTileW - 1) / kTileW;
  // this group's pixel; one outside the level redoes the level's last pixel
  // and writes nothing
  const int y_raw = (tile - s_tile[l]) / n_tx * kTileH + (warp / (kTileW / 2)) * 2 + (grp >> 1);
  const int x_raw = (tile - s_tile[l]) % n_tx * kTileW + (warp % (kTileW / 2)) * 2 + (grp & 1);
  const bool inside = y_raw < H && x_raw < W;
  const int y = min(y_raw, H - 1), x = min(x_raw, W - 1);
  const int s = s_lv.start[l] + y * W + x;
  const long long r = ((long long)b * S + s) * M + m;
  // lanes sub < 4: corner sub's samples, those whose top-left corner is
  // (y - dy, x - dx) on the padded level
  int lo = 0, cnt = 0;
  if (sub < 4) {
    const int key = (b * M + m) * (s_pad[L] + 1) + s_pad[l] +
                    (y - (sub >> 1) + 1) * (W + 1) + (x - (sub & 1) + 1);
    lo = __ldg(row_ptr + key);
    cnt = __ldg(row_ptr + key + 1) - lo;
  }
  int lo_c[4], end_c[4];  // corner c's entries are [end_c[c] - cnt, end_c[c])
  int total = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo_c[c] = __shfl_sync(kFull, lo, c, kLanes);
    total += __shfl_sync(kFull, cnt, c, kLanes);
    end_c[c] = total;
  }
  int most = total;  // the warp's longest row
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) most = max(most, __shfl_xor_sync(kFull, most, off));
  // entry e's grad_out row ((b Q + q) M + m) and weight, into the lane that
  // fetches it
  int grow = 0;
  float w = 0.f;
  auto fetch = [&](int e) {
    grow = 0;
    w = 0.f;
    if (e < total) {
      const int c = (e >= end_c[0]) + (e >= end_c[1]) + (e >= end_c[2]);
      const int from = c == 0 ? 0 : c == 1 ? end_c[0] : c == 2 ? end_c[1] : end_c[2];
      const int lo_e = c == 0 ? lo_c[0] : c == 1 ? lo_c[1] : c == 2 ? lo_c[2] : lo_c[3];
      const int n = __ldg(order + lo_e + e - from);  // ((b M + m) Q + q) K + k
      grow = (b * Q + (n / K) % Q) * M + m;
      w = __ldg(wa + 4LL * n + c);
    }
  };
  float acc[kMaxDChunks][4] = {};
  fetch(sub);
  for (int e0 = 0; e0 < most; e0 += kLanes) {
    const int cur_grow = grow;
    const float cur_w = w;
    fetch(e0 + kLanes + sub);  // the next chunk's, in flight with this one's rows
#pragma unroll
    for (int u0 = 0; u0 < kLanes; u0 += kInFlight) {
      float4 gv[kInFlight][kMaxDChunks];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long gu = (long long)__shfl_sync(kFull, cur_grow, u0 + u, kLanes) * D;
#pragma unroll
        for (int t = 0; t < kMaxDChunks; ++t)
          gv[u][t] = t < nc && e0 + u0 + u < total
                         ? __ldg(reinterpret_cast<const float4*>(grad_out + gu + 32 * t) + sub)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const float wu = __shfl_sync(kFull, cur_w, u0 + u, kLanes);
        if (e0 + u0 + u >= total) continue;  // this group's row has ended
#pragma unroll
        for (int t = 0; t < kMaxDChunks; ++t) {
          if (t >= nc) continue;
          acc[t][0] = __fadd_rn(acc[t][0], __fmul_rn(wu, gv[u][t].x));
          acc[t][1] = __fadd_rn(acc[t][1], __fmul_rn(wu, gv[u][t].y));
          acc[t][2] = __fadd_rn(acc[t][2], __fmul_rn(wu, gv[u][t].z));
          acc[t][3] = __fadd_rn(acc[t][3], __fmul_rn(wu, gv[u][t].w));
        }
      }
    }
  }
  if (!inside) return;
  TOut* dst = d_value + r * D + 4 * sub;
#pragma unroll
  for (int t = 0; t < kMaxDChunks; ++t)
    if (t < nc) store4(dst + 32 * t, acc[t]);
}

template <typename T, int kL, int kP, int kNC>
int launch_sample(const T* value, const float* loc, const float* attn,
                  const float* grad_out, float* d_loc, float* d_attn, float* wa,
                  int* keys, const int* tile_ptr, const int* tile_q,
                  const msda::Levels& lv, int B, int S, int M, int D, int Q, int L, int P,
                  int n_tiles, cudaStream_t stream) {
  const long long blocks = (long long)B * M * n_tiles;
  ms_deform_attn_bwd_sample_kernel<T, kL, kP, kNC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      value, loc, attn, grad_out, d_loc, d_attn, reinterpret_cast<float4*>(wa), keys,
      tile_ptr, tile_q, lv, S, M, D, Q, L, P, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int sample(const T* value, const float* loc, const float* attn, const float* grad_out,
           float* d_loc, float* d_attn, float* wa, int* keys,
           const int* tile_ptr, const int* tile_q, const int* shapes, int B, int S,
           int M, int D, int Q, int L, int P, int n_tiles, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv) || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (L == 3 && P == 4 && D == 32)  // the model
    return launch_sample<T, 3, 4, 1>(value, loc, attn, grad_out, d_loc, d_attn, wa, keys,
                                     tile_ptr, tile_q, lv, B, S, M, D, Q, L, P, n_tiles,
                                     s);
  return launch_sample<T, 0, 0, 0>(value, loc, attn, grad_out, d_loc, d_attn, wa, keys,
                                   tile_ptr, tile_q, lv, B, S, M, D, Q, L, P, n_tiles, s);
}

template <typename TOut>
int reduce(const int* row_ptr, const int* order, const float* wa, const float* grad_out,
           TOut* d_value, const int* shapes, int B, int S, int M, int D, int Q, int L,
           int P, void* stream) {
  msda::Levels lv;
  if (!msda::make_levels(shapes, L, P, D, S, &lv)) return (int)cudaErrorInvalidValue;
  if ((long long)B * S * M == 0) return 0;
  long long tiles = 0;
  for (int l = 0; l < L; ++l)
    tiles += (long long)((lv.h[l] + kTileH - 1) / kTileH) * ((lv.w[l] + kTileW - 1) / kTileW);
  const unsigned blocks = (unsigned)(tiles * B * M);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)  // the model
    ms_deform_attn_bwd_reduce_kernel<TOut, 1><<<blocks, kThreads, 0, s>>>(
        row_ptr, order, wa, grad_out, d_value, lv, B, S, M, D, Q, L, L * P);
  else
    ms_deform_attn_bwd_reduce_kernel<TOut, 0><<<blocks, kThreads, 0, s>>>(
        row_ptr, order, wa, grad_out, d_value, lv, B, S, M, D, Q, L, L * P);
  return (int)cudaGetLastError();
}

}  // namespace

// Step 1. value (B, S, M, D), loc (B, Q, M, L, P, 2), attn (B, Q, M, L, P),
// grad_out (B, Q, M*D): contiguous on the device; value f32
// (ms_deform_attn_bwd_sample) or bf16 (ms_deform_attn_bwd_sample_bf16),
// everything else f32. d_loc and d_attn have loc's and attn's shapes and
// are overwritten; wa (B*M*Q*L*P, 4) f32 and keys (B*M*Q*L*P) int32, both
// indexed by n = ((b M + m) Q + q) K + k, are overwritten. tile_ptr and
// tile_q as for ms_deform_attn_fwd. shapes: host array of L (H, W)
// pairs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ms_deform_attn_bwd_sample(const void* value, const float* loc,
                                         const float* attn, const float* grad_out,
                                         float* d_loc, float* d_attn, float* wa,
                                         int* keys, const int* tile_ptr,
                                         const int* tile_q, const int* shapes, int B,
                                         int S, int M, int D, int Q, int L, int P,
                                         int n_tiles, void* stream) {
  return sample(static_cast<const float*>(value), loc, attn, grad_out, d_loc, d_attn, wa,
                keys, tile_ptr, tile_q, shapes, B, S, M, D, Q, L, P, n_tiles, stream);
}

extern "C" int ms_deform_attn_bwd_sample_bf16(const void* value, const float* loc,
                                              const float* attn, const float* grad_out,
                                              float* d_loc, float* d_attn, float* wa,
                                              int* keys, const int* tile_ptr,
                                              const int* tile_q,
                                              const int* shapes, int B, int S, int M,
                                              int D, int Q, int L, int P, int n_tiles,
                                              void* stream) {
  return sample(static_cast<const Bf16Bits*>(value), loc, attn, grad_out, d_loc, d_attn,
                wa, keys, tile_ptr, tile_q, shapes, B, S, M, D, Q, L, P, n_tiles, stream);
}

// Step 2. n_seg segments of seg_len keys, each sorted on its own, a pass a
// digit of msda_radix_bits() bits from the lowest. hist and scan hold n_seg x
// 2^msda_radix_bits() x ceil(seg_len / msda_sort_tile()) int32, in that
// order; the caller fills scan with the inclusive sum of hist.
extern "C" int msda_sort_tile() { return kSortTile; }
extern "C" int msda_radix_bits() { return kRadixBits; }

extern "C" int msda_radix_count(const int* keys, int seg_len, int n_seg, int shift,
                                int* hist, void* stream) {
  if (seg_len <= 0 || n_seg <= 0) return 0;
  const dim3 grid((seg_len + kSortTile - 1) / kSortTile, n_seg);
  radix_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(keys, seg_len, shift,
                                                                  hist);
  return (int)cudaGetLastError();
}

extern "C" int msda_radix_scatter(const int* keys_in, const int* vals_in, int* keys_out,
                                  int* vals_out, int seg_len, int n_seg, int shift,
                                  const int* hist, const int* scan, void* stream) {
  if (seg_len <= 0 || n_seg <= 0) return 0;
  const dim3 grid((seg_len + kSortTile - 1) / kSortTile, n_seg);
  radix_scatter_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys_in, vals_in, keys_out, vals_out, seg_len, shift, hist, scan);
  return (int)cudaGetLastError();
}

// Step 3a. sorted: the keys as the sort left them, n_seg segments of
// seg_len; row_ptr (n_seg (S_pad + 1) + 1) int32 is overwritten.
extern "C" int msda_key_bounds(const int* sorted, int seg_len, int n_seg, int S_pad,
                               int* row_ptr, void* stream) {
  const long long n = (long long)seg_len * n_seg;
  if (n <= 0) return 0;
  key_bounds_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(sorted, seg_len, n, S_pad, row_ptr);
  return (int)cudaGetLastError();
}

// Step 3. row_ptr as step 3a wrote it; order: the sample indices sorted by
// key within each (b, m); wa as step 1 wrote it. d_value (B, S, M, D), f32 (ms_deform_attn_bwd_reduce)
// or bf16 (ms_deform_attn_bwd_reduce_bf16), is overwritten.
extern "C" int ms_deform_attn_bwd_reduce(const int* row_ptr, const int* order,
                                         const float* wa, const float* grad_out,
                                         void* d_value, const int* shapes, int B, int S,
                                         int M, int D, int Q, int L, int P,
                                         void* stream) {
  return reduce(row_ptr, order, wa, grad_out, static_cast<float*>(d_value), shapes, B, S,
                M, D, Q, L, P, stream);
}

extern "C" int ms_deform_attn_bwd_reduce_bf16(const int* row_ptr, const int* order,
                                              const float* wa, const float* grad_out,
                                              void* d_value, const int* shapes, int B,
                                              int S, int M, int D, int Q, int L, int P,
                                              void* stream) {
  return reduce(row_ptr, order, wa, grad_out, static_cast<Bf16Bits*>(d_value), shapes, B,
                S, M, D, Q, L, P, stream);
}
