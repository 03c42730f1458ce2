// Row-gather sum (the gather probe's scalar formulation), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas probe kernels `scalar_kernel` and
// `scalar_kernel_bf16` (tools/roofline_microbench.py:59, :110, both through
// `_make_scalar_any`, pl.pallas_call at :129):
//
//   out[bm, q, :] = ((t_0 + t_1) + t_2) + ...,  t_k = table[bm, idx[bm, k, q], :]
//
// with table (BM, S, 128) in f32 or bf16, idx (BM, K, QP) int32 and out
// (BM, QP, 128) f32; each row is upcast to f32 and the rows are added in k
// order, t_0 taken as it is, so the result is bitwise equal to the plain
// version (bm2f_tpu_torch/ops/gather_probe.py `row_gather_sum_plain`). An
// index outside [0, S) adds a zero row, as the one-hot product (K4) gives.
// K is any number, 0 included (zero rows).
//
// What bounds it on the H100: bytes. At the probe's production shapes (BM 32,
// QP 13312, K 4, S 2500, f32) it must read idx (6.8 MB) and the table (41.0
// MB) once and write out (218.1 MB) once: 0.079 ms at 3.35 TB/s. The rows it
// gathers cross L2 once per descriptor, 872 MB (f32) or 436 MB (bf16) a call
// at every S, which is the floor a random-address gather cannot avoid: each
// table row is read about 21 times at S 2500.
//
// What the design does about it. The first port gave each query a warp that
// waited on two dependent round trips (its indices, then its rows), so
// latency and not bytes set the pace (bf16 was no faster than f32). Now:
// - a warp takes a run of 32 queries of one bm. Lane j loads the run's
//   indices idx[bm, k, q0 + j], one coalesced 128-byte load per k, and each
//   query takes its indices from lane j with `__shfl_sync`;
// - an f32 row is one warp instruction (32 lanes x 16 bytes); a bf16 row is
//   half of one (16 lanes x 16 bytes), so each half-warp takes its own query
//   and an instruction moves two rows;
// - the rows of kFlight queries (f32) or kFlight pairs of queries (bf16) are
//   all loaded before the first add: 16 loads of 16 bytes a lane in flight
//   at K 4 (8 in bf16);
// - the output, 82 % of the bytes, is written with streaming stores
//   (`__stcs`, evict-first), so that it does not push the table out of L2;
// - where the tables outgrow L2 (S 10000: 164 MB f32, 82 MB bf16, against
//   50 MB), the table is read with an L2 evict-last policy (`createpolicy`,
//   `ld.global.L2::cache_hint`): 3-8 % faster there, no faster where the
//   tables fit, so the host chooses it from their size against the card's
//   L2; else the loads are ordinary read-only ones (`__ldg`).
// Nothing is staged in shared memory. At the production shapes and S 2500
// this reaches about 0.14 ms in f32 and 0.10 ms in bf16 on an H100 (0.58
// and 0.71 of the byte bound; the first design took 0.20 and 0.21): the L2
// row traffic, not the DRAM bound, is the floor it approaches (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;  // table row width (channels)
constexpr int kRun = 32;   // queries a warp takes: one per lane for the indices
constexpr int kWarpsPerBlock = 8;
constexpr int kKc = 4;     // indices a lane holds at once (K > 4 walks chunks)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// 16 bytes of a table row (16-byte aligned), read-only, with the L2 policy
// `policy` when kEvictLast
template <bool kEvictLast>
__device__ __forceinline__ uint4 load16(const void* p, uint64_t policy) {
  if (!kEvictLast) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// ik[j] = idx[bm, k0 + j, q0 + lane] for j < kKc (-1 past K or past the run)
__device__ __forceinline__ void load_indices(const int* ix, int QP, int K,
                                             int k0, bool lane_in_run,
                                             int (&ik)[kKc]) {
#pragma unroll
  for (int j = 0; j < kKc; ++j)
    ik[j] = lane_in_run && k0 + j < K ? __ldg(ix + (long long)(k0 + j) * QP) : -1;
}

// acc (t_0 as it is, then + t_k in k order) over f32 lanes of float4 or bf16
// lanes of 8 values
template <int N>
__device__ __forceinline__ void add_row(float (&acc)[N], const float (&v)[N],
                                        bool first) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = first ? v[e] : acc[e] + v[e];
}

__device__ __forceinline__ void unpack(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// KC: K when K <= 4 (the indices are loaded once per run), 0 for any K (they
// are reloaded, from L1, for each group of queries and chunk of 4 k).
// Bf16: a lane covers 8 channels of one half-warp's query, else 4 channels.
// kEvictLast: the table loads take the L2 evict-last policy.
template <bool kBf16, int KC, bool kEvictLast>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const void* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int S, int K, int QP, int runs_per_bm,
                   long long n_runs) {
  constexpr int kVals = kBf16 ? 8 : 4;            // channels a lane covers
  constexpr int kRowBytes = kRow * (kBf16 ? 2 : 4);
  constexpr int kPerInstr = kBf16 ? 2 : 1;        // queries one instruction covers
  constexpr int kFlight = kBf16 ? 2 : 4;          // instructions' queries in flight
  constexpr int kGroup = kPerInstr * kFlight;     // queries a group loop takes
  constexpr int kKLoop = KC > 0 ? KC : kKc;

  const int lane = threadIdx.x & 31;
  const long long run = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_runs) return;  // uniform across the warp
  const long long bm = run / runs_per_bm;
  const int q0 = (int)(run - bm * runs_per_bm) * kRun;
  const int n = min(kRun, QP - q0);
  const int half = kBf16 ? lane >> 4 : 0;
  const int sub = kBf16 ? lane & 15 : lane;  // 16-byte slot of the row
  const char* tab = static_cast<const char*>(table) + bm * S * (long long)kRowBytes + sub * 16;
  const int* ix = idx + bm * K * (long long)QP + q0 + lane;
  float* o = out + (bm * QP + q0) * (long long)kRow + sub * kVals;
  const uint64_t policy = kEvictLast ? evict_last_policy() : 0;

  int ik[kKc];
  if (KC > 0) load_indices(ix, QP, K, 0, lane < n, ik);

  for (int g0 = 0; g0 < n; g0 += kGroup) {
    float acc[kFlight][kVals] = {};  // K == 0 writes zero rows
    for (int k0 = 0; k0 < (KC > 0 ? KC : K); k0 += kKc) {
      if (KC == 0) load_indices(ix, QP, K, k0, lane < n, ik);
      uint4 raw[kFlight][kKLoop];
#pragma unroll
      for (int f = 0; f < kFlight; ++f) {
        const int q = g0 + f * kPerInstr + half;  // this lane's query in the run
#pragma unroll
        for (int j = 0; j < kKLoop; ++j) {
          // every lane takes part in the shuffle; a query past the run loads nothing
          const int s = __shfl_sync(kFull, ik[j], q & 31);
          raw[f][j] = make_uint4(0u, 0u, 0u, 0u);
          if (q < n && k0 + j < K && (unsigned)s < (unsigned)S)
            raw[f][j] = load16<kEvictLast>(tab + (long long)s * kRowBytes, policy);
        }
      }
#pragma unroll
      for (int f = 0; f < kFlight; ++f)
#pragma unroll
        for (int j = 0; j < kKLoop; ++j) {
          if (k0 + j >= K) break;
          float v[kVals];
          unpack(raw[f][j], v);
          add_row(acc[f], v, k0 + j == 0);  // t_0 itself, not 0 + t_0
        }
    }
#pragma unroll
    for (int f = 0; f < kFlight; ++f) {
      const int q = g0 + f * kPerInstr + half;
      if (q >= n) continue;
      float* dst = o + (long long)q * kRow;
#pragma unroll
      for (int e = 0; e < kVals; e += 4)
        __stcs(reinterpret_cast<float4*>(dst + e),
               make_float4(acc[f][e], acc[f][e + 1], acc[f][e + 2], acc[f][e + 3]));
    }
  }
}

template <bool kBf16>
int launch(const void* table, const int* idx, float* out, int BM, int S, int K,
           int QP, void* stream) {
  if (BM < 0 || S < 1 || K < 0 || QP < 0) return (int)cudaErrorInvalidValue;
  const int runs_per_bm = (QP + kRun - 1) / kRun;
  const long long n_runs = (long long)BM * runs_per_bm;
  if (n_runs == 0) return 0;
  // evict-last table loads only where the tables outgrow L2
  int dev = 0, l2_bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return (int)e;
  const bool evict_last = (long long)BM * S * kRow * (kBf16 ? 2 : 4) > l2_bytes;
  const unsigned blocks = (unsigned)((n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kWarpsPerBlock * 32);
#define GATHER_ROWS_LAUNCH(KC)                                                       \
  {                                                                                 \
    auto kernel = evict_last ? gather_rows_kernel<kBf16, KC, true>                  \
                             : gather_rows_kernel<kBf16, KC, false>;                \
    kernel<<<blocks, block, 0, st>>>(table, idx, out, S, K, QP, runs_per_bm, n_runs); \
  }
  switch (K) {
    case 1: GATHER_ROWS_LAUNCH(1); break;
    case 2: GATHER_ROWS_LAUNCH(2); break;
    case 3: GATHER_ROWS_LAUNCH(3); break;
    case 4: GATHER_ROWS_LAUNCH(4); break;
    default: GATHER_ROWS_LAUNCH(0); break;
  }
#undef GATHER_ROWS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// table (BM, S, 128), idx (BM, K, QP) int32, out (BM, QP, 128) f32:
// contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gather_rows_f32(const void* table, const int* idx, float* out,
                               int BM, int S, int K, int QP, void* stream) {
  return launch<false>(table, idx, out, BM, S, K, QP, stream);
}

extern "C" int gather_rows_bf16(const void* table, const int* idx, float* out,
                                int BM, int S, int K, int QP, void* stream) {
  return launch<true>(table, idx, out, BM, S, K, QP, stream);
}
