// Shared by the kernels: 16-byte vectors of fp32 / bf16 and their
// conversion to and from fp32 registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Read-only path, for data that no thread of the running kernel writes.
__device__ __forceinline__ uint4 load16_ro(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  // round to nearest even, as a cast to bf16 does, in one instruction
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Vec16<T>: N values of T fill one 16-byte vector; unpack widens them to
// fp32 registers, pack narrows them back, one() narrows a single value.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // A bf16 is the upper half of an fp32: widening is a shift.
  static __device__ __forceinline__ void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
    f[4] = __uint_as_float(r.z << 16);
    f[5] = __uint_as_float(r.z & 0xffff0000u);
    f[6] = __uint_as_float(r.w << 16);
    f[7] = __uint_as_float(r.w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float x) {
    return __float2bfloat16_rn(x);
  }
};

// The attention kernels' d_head: 32, 64 and 128 run exact instances; any
// other multiple of the 16-byte vector up to 128 runs the instance padded
// to 128 (rows read at their own stride D, lanes past D masked).  bf16 flash
// attention instead runs its 64 instance up to 64 and its 128 instance
// above, through TMA boxes whose columns past D read as zeros.  The
// wrappers hold the same rule (kernels/_build.py, check_head_dim).
constexpr int kMaxHeadDim = 128;

template <typename T>
inline bool padded_head_dim(int D) {
  return D > 0 && D < kMaxHeadDim && D % Vec16<T>::N == 0;
}

}  // namespace repro
