// Cholesky panel: the lower Cholesky factor L of each of B SPD diagonal
// blocks A [v, v] (A = L L^T), upper triangle zeroed.  A single block is the
// batch of one.
//
// Replaces: src/repro/kernels/chol_panel.py::chol_panel (body `_kernel`) and
// ::chol_panel_batched (body `_batched_kernel`), both the v rounds of
// `_chol_rounds`.
//
// What bounds it on an H100: neither bytes nor operations.  On the single
// path the block is [32, 32] (4 KiB in f32, a ~2.4 ns floor at 3.35 TB/s);
// batched it is [256, 32, 32] (2 MiB, ~0.6 us).  The v rounds are strictly
// sequential, each a square root, a division and a block-wide update with
// two barriers, so the kernel is bound by the latency of those rounds.
//
// Design: the TPU runs one grid program per block with the block in VMEM,
// and so does this kernel, one CUDA block per system (blockIdx.x) with the
// [v, v] block in dynamic shared memory (v <= 128: up to 64 KiB in f32 and
// 128 KiB in f64, so the launcher raises the block's shared-memory limit).
// Round k: every thread reads d = sqrt(S[k][k]) and the column
// l_i = S[i][k] / d (i > k, else 0) is formed in shared memory; after a
// barrier, each element (i, j) of the whole block sets column k to
// l + d e_k and takes S[i][j] - l_i l_j; a barrier ends the round.  The
// update runs over the full block, as the reference's does, so a NaN pivot
// (a block that is not SPD) spreads the same way and nothing raises.
//
// Bit-exactness: every product, difference, sum, quotient and root uses the
// round-to-nearest intrinsics, which nvcc never contracts into an FMA.  The
// plain PyTorch version (repro_torch/kernels/ref.py::chol_panel_batched)
// rounds the same operations in the same order, so the kernel agrees with
// it bit for bit, and a batched lane with the single call.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxV = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_panel_kernel(const T* __restrict__ A, int64_t lda, int64_t bsa, T* __restrict__ L,
                  int v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = v + 1;  // padded row stride: column reads hit distinct banks
  T* S = reinterpret_cast<T*>(smem_raw);  // [v][ld]: the working block
  T* l = S + v * ld;                      // [v]: this round's column

  const int64_t b = blockIdx.x;
  const T* src = A + b * bsa;
  T* dst = L + b * static_cast<int64_t>(v) * v;
  const int n = v * v;

  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int i = idx / v;
    const int j = idx - i * v;
    S[i * ld + j] = src[static_cast<int64_t>(i) * lda + j];
  }

  for (int k = 0; k < v; ++k) {
    __syncthreads();
    const T d = sqrt_rn(S[k * ld + k]);
    for (int i = threadIdx.x; i < v; i += kThreads)
      l[i] = i > k ? div_rn(S[i * ld + k], d) : T(0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int i = idx / v;
      const int j = idx - i * v;
      const T li = l[i];
      T a = S[i * ld + j];
      if (j == k) a = add_rn(li, mul_rn(d, i == k ? T(1) : T(0)));
      S[i * ld + j] = sub_rn(a, mul_rn(li, l[j]));
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int i = idx / v;
    const int j = idx - i * v;
    dst[idx] = i >= j ? S[i * ld + j] : T(0);
  }
}

template <typename T>
int launch(const void* A, long long lda, long long bsa, void* L, int B, int v, void* stream) {
  // The limit is set for the widest block, always to the same value, so
  // launches from several host threads never race on the attribute.
  const size_t smem_max = static_cast<size_t>(kMaxV) * (kMaxV + 2) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(chol_panel_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(v) * (v + 2) * sizeof(T);
  chol_panel_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, bsa, static_cast<T*>(L), v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B blocks A [v, v] with row stride lda, batch stride bsa and unit column
// stride; L: [B, v, v] contiguous output.  1 <= v <= 128, 1 <= B < 2^31.
// Returns the cudaError_t of the launch.
extern "C" int chol_panel_f32(const void* A, long long lda, long long bsa, void* L, int B,
                              int v, void* stream) {
  return launch<float>(A, lda, bsa, L, B, v, stream);
}

extern "C" int chol_panel_f64(const void* A, long long lda, long long bsa, void* L, int B,
                              int v, void* stream) {
  return launch<double>(A, lda, bsa, L, B, v, stream);
}

extern "C" const char* chol_panel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
