// The box matcher's pairwise-affinity sums, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes the weak matcher's
// pairwise cost (bm2f_tpu/losses/weaksup.py `pairwise_cost_matrix`) as
// XLA's einsum of a (Q, h, w, K) log-probability tensor against a (G, h, w,
// K) weight tensor. The weights factor, w[g, p, k] = 1[cs[p, k] >= t] *
// box[g, p], so the cost needs only
//
//   S[q, p] = sum_k 1[cs[p, k] >= t] * lsp(q, p, k)
//
// which this kernel computes; the caller contracts it with the boxes in one
// (Q, h w) x (h w, G) product (bm2f_tpu_torch/losses/weaksup.py
// `pairwise_cost_matrix`). lsp is the plain version's
// (`weaksup.log_same_prob`): with fg = logsigmoid(x), bg = logsigmoid(-x)
// of each pixel's logit, 0 for a neighbour outside the image (the zero
// padding of `unfold_wo_center`),
//
//   a = fg_p + fg_n, b = bg_p + bg_n, mx = max(a, b)
//   lsp = log(exp(a - mx) + exp(b - mx) + 1e-12) + mx
//       = log((1 + exp(-|a - b|)) + 1e-12) + mx
//
// (one of the two exps is exp(0) = 1, so both lines give the same f32
// value), summed over the edges k in `neighbor_offsets` order. Both
// log-sigmoids share log1p(exp(-|x|)). Accurate expf / logf / log1pf: the
// configuration computes in f32 (no --use_fast_math).
//
// What bounds it on the H100. At the box cell's shape (Q 100, 216 x 352
// pixels, K 8) a call reads 30.4 MB of logits and 2.4 MB of similarity and
// writes the 30.4 MB S: 19 us at 3.35 TB/s. Its arithmetic is one exp and
// one log an edge, 8 edges a (q, p), 7.6 M (q, p) a call: the float
// pipes, not the bytes, set its pace (about 0.1 ms of least time).
//
// What the design does about it. A block takes a 16 x 32 tile of output
// pixels and kQueries queries:
// - it turns the tile's similarity into one threshold bit an edge, once,
//   held by each thread for its own two pixels over all its queries;
// - for each query it stages (fg, bg) of the tile and a halo of
//   (kernel_size / 2) * dilation in shared memory, so that each logit is
//   read from device memory once a block and each log-sigmoid computed once
//   a block (two buffers, one barrier a query);
// - each thread then sums its pixels' edges from shared memory (a warp
//   reads 32 neighbouring float2s, no bank conflict) and writes its own S
//   elements, a warp a 128-byte row segment. No atomics: S is the same bits
//   in every launch.
// The (3, 2) case of every configuration is unrolled with the offsets as
// constants; any other kernel_size (up to 7: 48 edges, one 64-bit mask a
// pixel) and dilation takes the loop of the generic instance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;     // 8
constexpr int kRows = kTileH / kRowStep;        // pixels a thread: rows ty, ty + 8
constexpr int kQueries = 4;                     // queries a block walks
constexpr int kMaxRadius = 3;                   // kernel_size 7: 48 edges

__device__ __forceinline__ float log_same(float2 c, float2 n) {
  const float a = c.x + n.x, b = c.y + n.y;
  const float mx = fmaxf(a, b);
  return logf((1.0f + expf(-fabsf(a - b))) + 1e-12f) + mx;
}

// kR > 0: radius kR and dilation kDil fixed at compile time; kR == 0: the
// runtime r, dil
template <int kR, int kDil>
__global__ void __launch_bounds__(kThreads)
pairwise_lsp_sum_kernel(const float* __restrict__ logits, const float* __restrict__ sim,
                        float* __restrict__ out, int Q, int H, int W, int r_rt,
                        int dil_rt, float thresh) {
  extern __shared__ float2 halo[];  // two buffers of (fg, bg), HH x HW each
  const int r = kR ? kR : r_rt;
  const int dil = kR ? kDil : dil_rt;
  const int pad = r * dil;
  const int side = 2 * r + 1;
  const int K = side * side - 1;
  const int HW = kTileW + 2 * pad;  // haloed row length
  const int n_halo = (kTileH + 2 * pad) * HW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int q0 = blockIdx.z * kQueries;
  const int q1 = min(q0 + kQueries, Q);
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x = x0 + tx;
  const size_t plane = (size_t)H * W;

  // each own pixel's edge bits: bit k = cs[p, k] >= thresh
  uint64_t bits[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + ty + i * kRowStep;
    uint64_t m = 0;
    if (y < H && x < W) {
      const float* s = sim + ((size_t)y * W + x) * K;
      for (int k = 0; k < K; ++k) m |= (uint64_t)(__ldg(s + k) >= thresh) << k;
    }
    bits[i] = m;
  }

  for (int q = q0; q < q1; ++q) {
    float2* buf = halo + ((q - q0) & 1) * n_halo;
    const float* lq = logits + (size_t)q * plane;
    for (int j = threadIdx.x; j < n_halo; j += kThreads) {
      const int hy = j / HW, hx = j - hy * HW;
      const int y = y0 - pad + hy, xx = x0 - pad + hx;
      float2 v = make_float2(0.0f, 0.0f);
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const float l = __ldg(lq + (size_t)y * W + xx);
        const float t = log1pf(expf(-fabsf(l)));
        v = make_float2(fminf(l, 0.0f) - t, fminf(-l, 0.0f) - t);
      }
      buf[j] = v;
    }
    __syncthreads();  // the other buffer is free: every thread passed the last barrier
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + ty + i * kRowStep;
      if (y >= H || x >= W) continue;
      const float2* c = buf + (ty + i * kRowStep + pad) * HW + tx + pad;
      const float2 cv = *c;
      const uint64_t m = bits[i];
      float s = 0.0f;
      int k = 0;
#pragma unroll
      for (int dy = -r; dy <= r; ++dy) {
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if ((m >> k) & 1) s += log_same(cv, c[dy * dil * HW + dx * dil]);
          ++k;
        }
      }
      out[(size_t)q * plane + (size_t)y * W + x] = s;
    }
  }
}

template <int kR, int kDil>
int launch(const float* logits, const float* sim, float* out, int Q, int H, int W, int r,
           int dil, float thresh, cudaStream_t stream) {
  const int pad = r * dil;
  const size_t smem = 2 * sizeof(float2) * (size_t)(kTileH + 2 * pad) * (kTileW + 2 * pad);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pairwise_lsp_sum_kernel<kR, kDil>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
            (Q + kQueries - 1) / kQueries);
  pairwise_lsp_sum_kernel<kR, kDil><<<grid, kThreads, smem, stream>>>(
      logits, sim, out, Q, H, W, r, dil, thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// S (Q, H*W) f32 from logits (Q, H, W) f32 and the image's similarity (H, W,
// K) f32, K = (2 (kernel_size / 2) + 1)^2 - 1, all contiguous. Returns 0 or
// the CUDA error of the launch; -1 for a kernel_size or a grid it does not
// take (the wrapper raises on these first).
extern "C" int pairwise_lsp_sum(const float* logits, const float* sim, float* out, int Q,
                                int H, int W, int kernel_size, int dilation, float thresh,
                                void* stream) {
  const int r = kernel_size / 2;
  if (r < 1 || r > kMaxRadius || dilation < 1 || (Q + kQueries - 1) / kQueries > 65535 ||
      (H + kTileH - 1) / kTileH > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r == 1 && dilation == 2)
    return launch<1, 2>(logits, sim, out, Q, H, W, r, dilation, thresh, s);
  return launch<0, 0>(logits, sim, out, Q, H, W, r, dilation, thresh, s);
}
