// A bf16 value as its 16 bits, and its upcast to f32, shared by the kernels
// that read bf16 rows (ms_deform_attn_fwd.cu, K1; ms_deform_attn_bwd.cu, K2;
// gather_rows.cu, K3). A bf16
// is the top half of an f32, so the upcast is exact: a shift, no rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct Bf16Bits {  // a bf16 value as its 16 bits
  uint16_t bits;
};

// One bf16 value, upcast to f32.
__device__ __forceinline__ float load_bf16(const Bf16Bits* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 4 bf16 values (8 bytes, 8-byte aligned), upcast to f32. Little-endian: the
// value at the lower address is the low half of a word.
__device__ __forceinline__ float4 load_bf16x4(const Bf16Bits* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// 8 bf16 values (16 bytes, 16-byte aligned), upcast to f32 in v[0:8],
// lowest address first.
__device__ __forceinline__ void load_bf16x8(const Bf16Bits* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
