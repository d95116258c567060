// Element types that the solver kernels store, and the type each computes
// in.  bf16 and f16 are storage only: they widen exactly to f32 on load,
// every operation runs in f32, and a result is rounded once, to nearest
// even, where it is stored.  That is what the plain versions do
// (`.to(torch.float32)`, f32 arithmetic, `.to(dtype)`), and what the TPU
// kernels did with their f32 scratch.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {  // each library is one translation unit

template <typename S>
struct ComputeOf {
  using type = S;  // f32 and f64 compute in themselves
};
template <>
struct ComputeOf<__nv_bfloat16> {
  using type = float;
};
template <>
struct ComputeOf<__half> {
  using type = float;
};
template <typename S>
using compute_t = typename ComputeOf<S>::type;

// Storage to compute type: exact.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Compute to storage type: one rounding to nearest even (f16 overflows to
// inf, as torch's conversion does).
template <typename S>
struct Narrow {
  __device__ __forceinline__ static S from(S x) { return x; }
};
template <>
struct Narrow<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Narrow<__half> {
  __device__ __forceinline__ static __half from(float x) { return __float2half_rn(x); }
};

template <typename S>
__device__ __forceinline__ S narrow(compute_t<S> x) {
  return Narrow<S>::from(x);
}

// Two adjacent 2-byte values of a row, as one 32-bit word (the lower column
// in the low half): widened exactly, narrowed once to nearest even.
template <typename St>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  __device__ __forceinline__ static float2 widen(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  __device__ __forceinline__ static uint32_t narrow(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Pair<__half> {
  __device__ __forceinline__ static float2 widen(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  __device__ __forceinline__ static uint32_t narrow(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

}  // namespace
