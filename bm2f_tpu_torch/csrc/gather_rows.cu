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
// order, so the result is bitwise equal to the plain version
// (bm2f_tpu_torch/ops/gather_probe.py `row_gather_sum_plain`). An index
// outside [0, S) adds a zero row, as the one-hot product (K4) gives.
//
// What bounds it on the H100: bytes. At the probe's production shapes (BM 32,
// QP 13312, K 4, S 2500, f32) it must read idx (6.8 MB) and the table
// (41.0 MB) once and write out (218.1 MB) once: ~0.079 ms at 3.35 TB/s. It
// does no arithmetic to speak of (3 adds per output element).
//
// What the design does about it: the TPU kernel makes one scalar-addressed
// VMEM row copy per descriptor, which is what a TPU is slow at; on Hopper a
// row is one coalesced 512-byte (f32) or 256-byte (bf16) load by one warp.
// One warp owns one (bm, q); lane l holds channels 4l..4l+3 (a float4, or 8
// bytes of bf16); every lane reads the same K indices (a broadcast), starts
// up to 4 row loads before the first add, adds in k order in f32, and writes
// its float4 of the output row. The output write, 82 % of the bytes, is one
// coalesced 512-byte store per warp. Nothing is staged in shared memory.

#include "bf16_bits.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;  // table row width (channels)
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float4 load_row4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_row4(const Bf16Bits* p) {
  return load_bf16x4(p);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int S, int K, int QP,
                   long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= n_warps) return;  // uniform across the warp
  // warp = bm * QP + q: also the output row
  const long long bm = warp / QP;
  const int q = (int)(warp - bm * QP);
  const T* tab = table + bm * S * kRow + 4 * lane;
  const int* ix = idx + bm * K * QP + q;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < K) {
        const int s = __ldg(ix + (long long)(k0 + j) * QP);
        if ((unsigned)s < (unsigned)S) v[j] = load_row4(tab + (long long)s * kRow);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + j >= K) break;
      if (k0 + j == 0) {  // t_0 itself, not 0 + t_0 (which turns -0 into +0)
        acc = v[j];
      } else {
        acc.x += v[j].x;
        acc.y += v[j].y;
        acc.z += v[j].z;
        acc.w += v[j].w;
      }
    }
  }
  *reinterpret_cast<float4*>(out + warp * kRow + 4 * lane) = acc;
}

template <typename T>
int launch(const T* table, const int* idx, float* out, int BM, int S, int K,
           int QP, void* stream) {
  if (BM < 0 || S < 1 || K < 0 || QP < 0) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)BM * QP;
  if (n_warps == 0) return 0;
  const long long blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          (cudaStream_t)stream>>>(table, idx, out, S, K, QP,
                                                  n_warps);
  return (int)cudaGetLastError();
}

}  // namespace

// table (BM, S, 128), idx (BM, K, QP) int32, out (BM, QP, 128) f32:
// contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gather_rows_f32(const void* table, const int* idx, float* out,
                               int BM, int S, int K, int QP, void* stream) {
  return launch(static_cast<const float*>(table), idx, out, BM, S, K, QP,
                stream);
}

extern "C" int gather_rows_bf16(const void* table, const int* idx, float* out,
                                int BM, int S, int K, int QP, void* stream) {
  return launch(static_cast<const Bf16Bits*>(table), idx, out, BM, S, K, QP,
                stream);
}
