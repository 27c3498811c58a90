// Word helpers shared by the port's row kernels (ell_agg.cu,
// rel_agg.cu): bf16 halves of a 32-bit word as f32, f32 rounded to bf16
// bits, and Word<V, kBf16>, one word of a row as a lane moves it.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace etpu {

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// One word of a row: V the word a lane moves, kBf16 the element type.
// add() accumulates w times the word's elements into acc; pack() rounds
// acc to the element type.
template <typename V, bool kBf16> struct Word;

template <> struct Word<uint4, false> {  // 4 f32
  static constexpr int kElts = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 v, float w) {
    acc[0] = fmaf(__uint_as_float(v.x), w, acc[0]);
    acc[1] = fmaf(__uint_as_float(v.y), w, acc[1]);
    acc[2] = fmaf(__uint_as_float(v.z), w, acc[2]);
    acc[3] = fmaf(__uint_as_float(v.w), w, acc[3]);
  }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <> struct Word<uint4, true> {   // 8 bf16
  static constexpr int kElts = 8;
  static __device__ __forceinline__ void add(float* acc, uint4 v, float w) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(lo_bf16(u[i]), w, acc[2 * i]);
      acc[2 * i + 1] = fmaf(hi_bf16(u[i]), w, acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* acc) {
    return make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                      pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
  }
};

template <> struct Word<uint32_t, false> {  // 1 f32
  static constexpr int kElts = 1;
  static __device__ __forceinline__ void add(float* acc, uint32_t v,
                                             float w) {
    acc[0] = fmaf(__uint_as_float(v), w, acc[0]);
  }
  static __device__ __forceinline__ uint32_t pack(const float* acc) {
    return __float_as_uint(acc[0]);
  }
};

template <> struct Word<uint16_t, true> {   // 1 bf16
  static constexpr int kElts = 1;
  static __device__ __forceinline__ void add(float* acc, uint16_t v,
                                             float w) {
    acc[0] = fmaf(lo_bf16(v), w, acc[0]);
  }
  static __device__ __forceinline__ uint16_t pack(const float* acc) {
    return static_cast<uint16_t>(bf16_bits(acc[0]));
  }
};

// A weight as x's type would hold it.
template <bool kBf16>
__device__ __forceinline__ float rounded(float w) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

}  // namespace etpu
