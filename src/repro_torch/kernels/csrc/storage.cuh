// Element types that the solver kernels store, and the type each computes
// in.  bf16 and f16 are storage only: they widen exactly to f32 on load,
// every operation runs in f32, and a result is rounded once, to nearest
// even, where it is stored.  That is what the plain versions do
// (`.to(torch.float32)`, f32 arithmetic, `.to(dtype)`), and what the TPU
// kernels did with their f32 scratch.

#pragma once

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

}  // namespace
