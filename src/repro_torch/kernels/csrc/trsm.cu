// Right upper triangular solve:  X = B U^-1  (X U = B), U [v, v] upper with
// a non-unit diagonal, B [R, v], for one system or a batch of Bb.
//
// Replaces: src/repro/kernels/trsm.py::trsm_right_upper (body
// `_right_upper_kernel`) and ::trsm_right_upper_batched (body
// `_right_upper_batched_kernel`), both the column sweep of
// `_right_upper_solve`.  One kernel serves both: the system index is
// blockIdx.z with an int64 batch stride per operand, and a single system is
// Bb = 1.  A row's arithmetic does not depend on the batch or the tile, so a
// batched lane equals the single call bit for bit.
//
// What bounds it on an H100: bytes.  On the Cholesky path B is [16384, 32]
// (single) or [256, 512, 32] (batched): each element of B is read once and
// of X written once, with v^2 operations per row, so about v / 4 = 8 flop
// per byte in f32, below the card's ratio.  The floor is ~1.3 us single and
// ~10 us batched at 3.35 TB/s.
//
// Design: the TPU kernel tiles the long axis over the grid and keeps U and a
// [br, v] tile in VMEM.  Here each block owns kRows rows of one system, one
// thread per row.  U is staged in shared memory once per block, read with
// any row and column strides (the Cholesky path passes L00^T, a transposed
// view), and every thread reads the same U element at the same time, a
// broadcast.  The block's B tile is copied into shared memory with
// coalesced loads and a padded row stride (v + 1) so that the threads'
// row-wise reads hit distinct banks; each thread then sweeps its row column
// by column,
//   X[r, j] = (B[r, j] - sum_{i<j} X[r, i] U[i, j]) / U[j, j],
// in place, and the tile goes back out with coalesced stores.  Rows that are
// zero in B (the path masks every row above the trailing block) stay zero.
// The sum runs in another order than a library solve's, so results agree
// with the plain version within a stated tolerance, not bitwise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;  // rows (threads) per block
constexpr int kMaxV = 128;

template <typename T>
__global__ void __launch_bounds__(kRows)
trsm_right_upper_kernel(const T* __restrict__ B, int64_t ldb, int64_t bsb,
                        const T* __restrict__ U, int64_t ldu_r, int64_t ldu_c, int64_t bsu,
                        T* __restrict__ X, int R, int v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Us = reinterpret_cast<T*>(smem_raw);  // [v][v]
  const int ld = v + 1;
  T* Xs = Us + v * v;                      // [kRows][ld]: this block's rows

  const int64_t z = blockIdx.z;
  B += z * bsb;
  U += z * bsu;
  X += z * static_cast<int64_t>(R) * v;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);

  for (int idx = threadIdx.x; idx < v * v; idx += kRows) {
    const int i = idx / v;
    const int j = idx - i * v;
    Us[idx] = U[i * ldu_r + j * ldu_c];
  }
  for (int idx = threadIdx.x; idx < rows * v; idx += kRows) {
    const int r = idx / v;
    const int c = idx - r * v;
    Xs[r * ld + c] = B[static_cast<int64_t>(row0 + r) * ldb + c];
  }
  __syncthreads();

  if (threadIdx.x < rows) {
    T* x = Xs + threadIdx.x * ld;
    for (int j = 0; j < v; ++j) {
      T partial = T(0);
      for (int i = 0; i < j; ++i) partial += x[i] * Us[i * v + j];
      x[j] = (x[j] - partial) / Us[j * v + j];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * v; idx += kRows) {
    const int r = idx / v;
    const int c = idx - r * v;
    X[static_cast<int64_t>(row0 + r) * v + c] = Xs[r * ld + c];
  }
}

template <typename T>
int launch(const void* B, long long ldb, long long bsb, const void* U, long long ldu_r,
           long long ldu_c, long long bsu, void* X, int Bb, int R, int v, void* stream) {
  // The limit is set for the widest panel, always to the same value, so
  // launches from several host threads never race on the attribute.
  const size_t smem_max = static_cast<size_t>(kMaxV) * (kMaxV + kRows) * sizeof(T) +
                          static_cast<size_t>(kRows) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(trsm_right_upper_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (static_cast<size_t>(v) * v + static_cast<size_t>(kRows) * (v + 1)) *
                      sizeof(T);
  const dim3 grid((R + kRows - 1) / kRows, 1, Bb);
  trsm_right_upper_kernel<T><<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), ldb, bsb, static_cast<const T*>(U), ldu_r, ldu_c, bsu,
      static_cast<T*>(X), R, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bb systems: B [R, v] with row stride ldb and batch stride bsb (unit column
// stride); U [v, v] with row stride ldu_r, column stride ldu_c and batch
// stride bsu; X: [Bb, R, v] contiguous output.  1 <= v <= 128, R >= 1,
// 1 <= Bb <= 65535.  Returns the cudaError_t of the launch.
extern "C" int trsm_right_upper_f32(const void* B, long long ldb, long long bsb, const void* U,
                                    long long ldu_r, long long ldu_c, long long bsu, void* X,
                                    int Bb, int R, int v, void* stream) {
  return launch<float>(B, ldb, bsb, U, ldu_r, ldu_c, bsu, X, Bb, R, v, stream);
}

extern "C" int trsm_right_upper_f64(const void* B, long long ldb, long long bsb, const void* U,
                                    long long ldu_r, long long ldu_c, long long bsu, void* X,
                                    int Bb, int R, int v, void* stream) {
  return launch<double>(B, ldb, bsb, U, ldu_r, ldu_c, bsu, X, Bb, R, v, stream);
}

extern "C" const char* trsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
