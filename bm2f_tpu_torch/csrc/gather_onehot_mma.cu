// Row-gather sum as one-hot matrix products on the tensor cores (the gather
// probe's one-hot formulation), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas probe kernels `onehot_kernel_v` and
// `onehot_kernel_bf16` (tools/roofline_microbench.py:80, :97, both through
// `_make_onehot_any`, pl.pallas_call at :155). It computes the function of
// gather_rows.cu (K3),
//
//   out[bm, q, :] = ((t_0 + t_1) + t_2) + ...,  t_k = table[bm, idx[bm, k, q], :]
//
// as K products A_k @ table[bm] with the one-hot selector
// A_k[q, s] = (idx[bm, k, q] == s), each product kept in its own f32
// accumulator and the K accumulators added in k order with ordinary f32 adds,
// as the Pallas kernel does (:86-90). Each accumulator element sums exactly one
// product 1 * table[s, n] and zeros, so it holds table[s, n] exactly whatever
// rounding the tensor core's own accumulation uses, and the result is
// bitwise equal to the plain version -- for bf16 tables, and for f32 tables
// whose values TF32 holds exactly (the probe's table is bf16-representable;
// the f32 path feeds the raw f32 bits to TF32, which uses their top 19).
// An index outside [0, S) selects nothing and adds a zero row.
//
// bf16 tables use mma.sync m16n8k16 (bf16 in, f32 accumulate); f32 tables use
// TF32 mma.sync m16n8k8.
//
// What bounds it on the H100: the function it computes needs only bytes,
// 0.079 ms at the production shapes (BM 32, QP 13312, K 4, S 2500), as K3's.
// The one-hot formulation adds work the function does not need: 2 * QP * S
// * 128 * K operations per bm, 1.09e12 at those shapes, 1.10 ms at 989
// TFLOP/s bf16 and 2.20 ms at 495 TFLOP/s TF32, so this kernel cannot come
// within 14x (bf16) or 28x (TF32) of the function's bound. The formulation
// only pays where a gather's descriptors are dearer than S * 128
// multiply-adds each, which is the question the probe asks of the card.
//
// What the design does about it: a block of 16 warps takes `qt` queries of one
// bm in passes of 64 (4 row blocks of 16 queries x 4 column blocks of 32
// channels, one warp each: 16 x 32 outputs x K accumulators = 16 f32
// registers per k per thread). The (S, 128) table streams through shared
// memory in chunks of 4 MMA k-steps (64 rows bf16, 32 rows f32), each loaded
// into registers one chunk ahead so that the global loads of chunk c+1 fly
// while the warps multiply chunk c. bf16 rows are staged as row pairs of one
// column packed in a 32-bit word, so that every B fragment is one 32-bit
// shared load; rows are padded by 8 words, which makes those loads free of
// bank conflicts. The selector never touches memory: each thread builds its
// A fragments in registers by comparing its rows' indices with the chunk's
// row numbers. Rows past S are staged as zeros and k-steps wholly past S are
// skipped, so S need not be a multiple of the MMA's k (625, or 40 in the
// smoke run). The product is dense, as the TPU kernel's is: no k-step is
// skipped because its selector happens to be all zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;          // table row width (channels)
constexpr int kWarps = 16;         // 4 row blocks x 4 column blocks
constexpr int kThreads = kWarps * 32;
constexpr int kPassRows = 64;      // queries per pass
constexpr int kStageRows = 32;     // 32-bit word rows staged per chunk
constexpr int kLd = kRow + 8;      // words per staged row, padded
constexpr int kStepsPerChunk = 4;  // MMA k-steps per chunk
constexpr int kMaxK = 4;
constexpr uint32_t kOneF32 = 0x3f800000u;  // 1.0f, also 1.0 in TF32
constexpr uint32_t kOneBf16 = 0x3f80u;     // 1.0 in bf16

// bf16 pair (cols c, c + 1) of a one-hot row whose hot column is c + rel
__device__ __forceinline__ uint32_t onehot_pair(int rel) {
  return rel == 0 ? kOneBf16 : (rel == 1 ? (kOneBf16 << 16) : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One chunk of the table, as each thread holds it between its global loads
// and its shared stores: 2 items of 16 bytes.
//   f32:  item f = (row r = f / 32, float4 column group f % 32)
//   bf16: item f = (row pair p = f / 32, 4-column group f % 32): 8 bytes of
//         row 2p in .x/.y and 8 bytes of row 2p + 1 in .z/.w
template <bool kBf16>
__device__ __forceinline__ void load_chunk(const char* __restrict__ table,
                                           int S, int chunk, int tid,
                                           uint4 (&pf)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = tid + j * kThreads;
    const int r = f >> 5, cg = f & 31;
    if (kBf16) {
      const int s0 = chunk * 2 * kStageRows + 2 * r;
      const uint2* row = reinterpret_cast<const uint2*>(table) + (long long)s0 * 32 + cg;
      const uint2 a = s0 < S ? __ldg(row) : make_uint2(0u, 0u);
      const uint2 b = s0 + 1 < S ? __ldg(row + 32) : make_uint2(0u, 0u);
      pf[j] = make_uint4(a.x, a.y, b.x, b.y);
    } else {
      const int s = chunk * kStageRows + r;
      pf[j] = s < S ? __ldg(reinterpret_cast<const uint4*>(table) + (long long)s * 32 + cg)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Word (r, n) of the stage: f32 row r, column n; or, for bf16, the pair
// (row 2r, row 2r + 1) of column n, the lower row in the low half.
template <bool kBf16>
__device__ __forceinline__ void store_chunk(uint32_t* stage, int tid,
                                            const uint4 (&pf)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = tid + j * kThreads;
    const int r = f >> 5, cg = f & 31;
    uint4 w = pf[j];
    if (kBf16) {
      const uint4 v = pf[j];  // .x = (c0, c1) and .y = (c2, c3) of row 2r; .z/.w of 2r + 1
      w = make_uint4((v.x & 0xffffu) | (v.z << 16), (v.x >> 16) | (v.z & 0xffff0000u),
                     (v.y & 0xffffu) | (v.w << 16), (v.y >> 16) | (v.w & 0xffff0000u));
    }
    *reinterpret_cast<uint4*>(stage + r * kLd + cg * 4) = w;
  }
}

template <bool kBf16, int K>
__global__ void __launch_bounds__(kThreads, 1)
gather_onehot_kernel(const void* __restrict__ table_v,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int S, int QP, int qt) {
  constexpr int kStep = kBf16 ? 16 : 8;  // MMA k
  constexpr int kChunkRows = kStep * kStepsPerChunk;
  __shared__ __align__(16) uint32_t stage[kStageRows * kLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int rb = warp >> 2, cb = warp & 3;
  const int bm = blockIdx.y;
  const char* table = static_cast<const char*>(table_v) +
                      (long long)bm * S * kRow * (kBf16 ? 2 : 4);
  const int* ix = idx + (long long)bm * K * QP;
  float* o = out + (long long)bm * QP * kRow;
  const int q_block = blockIdx.x * qt;
  const int n_pass = (min(qt, QP - q_block) + kPassRows - 1) / kPassRows;
  const int n_chunks = (S + kChunkRows - 1) / kChunkRows;
  const int n_steps = n_pass * n_chunks;

  float acc[K][4][4];
  int i0[K], i1[K];  // indices of this thread's rows g and g + 8
  uint4 pf[2];
  load_chunk<kBf16>(table, S, 0, tid, pf);

  for (int step = 0; step < n_steps; ++step) {
    const int pass = step / n_chunks, chunk = step - pass * n_chunks;
    const int r0 = q_block + pass * kPassRows + rb * 16 + g, r1 = r0 + 8;
    if (chunk == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        i0[k] = r0 < QP ? __ldg(ix + (long long)k * QP + r0) : -1;
        i1[k] = r1 < QP ? __ldg(ix + (long long)k * QP + r1) : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][j][e] = 0.f;
      }
    }
    __syncthreads();  // every warp is done with the previous chunk
    store_chunk<kBf16>(stage, tid, pf);
    __syncthreads();
    if (step + 1 < n_steps)  // the next chunk's loads fly during the MMAs
      load_chunk<kBf16>(table, S, (step + 1) % n_chunks, tid, pf);

    const int rows_left = S - chunk * kChunkRows;
#pragma unroll
    for (int ks = 0; ks < kStepsPerChunk; ++ks) {
      if (ks * kStep >= rows_left) break;  // uniform: only zeros beyond S
      // B fragments of the 4 column tiles: k rows t and t + 4 (f32), or
      // k row pairs t and t + 4 (bf16), column n
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = cb * 32 + j * 8 + g;
        b[j][0] = stage[(ks * 8 + t) * kLd + n];
        b[j][1] = stage[(ks * 8 + t + 4) * kLd + n];
      }
      const int s_base = chunk * kChunkRows + ks * kStep;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t a[4];
        if (kBf16) {
          // a0: (g, 2t..2t+1), a1: (g+8, 2t..), a2: (g, 2t+8..), a3: (g+8, 2t+8..)
          const int rel0 = i0[k] - s_base - 2 * t, rel1 = i1[k] - s_base - 2 * t;
          a[0] = onehot_pair(rel0);
          a[1] = onehot_pair(rel1);
          a[2] = onehot_pair(rel0 - 8);
          a[3] = onehot_pair(rel1 - 8);
        } else {
          // a0: (g, t), a1: (g+8, t), a2: (g, t+4), a3: (g+8, t+4)
          const int rel0 = i0[k] - s_base - t, rel1 = i1[k] - s_base - t;
          a[0] = rel0 == 0 ? kOneF32 : 0u;
          a[1] = rel1 == 0 ? kOneF32 : 0u;
          a[2] = rel0 == 4 ? kOneF32 : 0u;
          a[3] = rel1 == 4 ? kOneF32 : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kBf16)
            mma_bf16(acc[k][j], a, b[j]);
          else
            mma_tf32(acc[k][j], a, b[j]);
        }
      }
    }

    if (chunk == n_chunks - 1) {
      // accumulator (c0, c1) is row g, columns 2t, 2t + 1; (c2, c3) row g + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[4] = {acc[0][j][0], acc[0][j][1], acc[0][j][2], acc[0][j][3]};
#pragma unroll
        for (int k = 1; k < K; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += acc[k][j][e];
        const int n = cb * 32 + j * 8 + 2 * t;
        if (r0 < QP)
          *reinterpret_cast<float2*>(o + (long long)r0 * kRow + n) = make_float2(v[0], v[1]);
        if (r1 < QP)
          *reinterpret_cast<float2*>(o + (long long)r1 * kRow + n) = make_float2(v[2], v[3]);
      }
    }
  }
}

template <bool kBf16>
int launch(const void* table, const int* idx, float* out, int BM, int S,
           int K, int QP, int qt, void* stream) {
  if (BM < 0 || BM > 65535 || S < 1 || K < 1 || K > kMaxK || QP < 0 ||
      qt < kPassRows || qt % kPassRows != 0)
    return (int)cudaErrorInvalidValue;
  if (BM == 0 || QP == 0) return 0;
  const dim3 grid((unsigned)((QP + qt - 1) / qt), (unsigned)BM);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1:
      gather_onehot_kernel<kBf16, 1><<<grid, kThreads, 0, st>>>(table, idx, out, S, QP, qt);
      break;
    case 2:
      gather_onehot_kernel<kBf16, 2><<<grid, kThreads, 0, st>>>(table, idx, out, S, QP, qt);
      break;
    case 3:
      gather_onehot_kernel<kBf16, 3><<<grid, kThreads, 0, st>>>(table, idx, out, S, QP, qt);
      break;
    default:
      gather_onehot_kernel<kBf16, 4><<<grid, kThreads, 0, st>>>(table, idx, out, S, QP, qt);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table (BM, S, 128) f32 or bf16, idx (BM, K, QP) int32, out (BM, QP, 128)
// f32: contiguous, on the device. 1 <= K <= 4; qt, the queries of one block,
// a multiple of 64. Launches on `stream` and returns cudaGetLastError().
extern "C" int gather_onehot_f32(const void* table, const int* idx, float* out,
                                 int BM, int S, int K, int QP, int qt,
                                 void* stream) {
  return launch<false>(table, idx, out, BM, S, K, QP, qt, stream);
}

extern "C" int gather_onehot_bf16(const void* table, const int* idx,
                                  float* out, int BM, int S, int K, int QP,
                                  int qt, void* stream) {
  return launch<true>(table, idx, out, BM, S, K, QP, qt, stream);
}
