// Triangular solves of the factorizations, for one system or a batch of Bb:
//
//   trsm_right_upper:  X = B U^-1  (X U = B), U [v, v] upper with a non-unit
//                      diagonal, B [R, v]  (L10 of the Cholesky step);
//   trsm_left_lower:   X = L^-1 B  (L X = B), L [v, v] lower, unit or not,
//                      B [v, C]  (U01 of the flat 2.5D step bodies).
//
// Replaces: src/repro/kernels/trsm.py::trsm_right_upper (body
// `_right_upper_kernel`) and ::trsm_right_upper_batched (body
// `_right_upper_batched_kernel`), both the column sweep of
// `_right_upper_solve`; and ::trsm_left_lower (body `_left_lower_kernel`)
// and ::trsm_left_lower_batched (body `_left_lower_batched_kernel`), both
// the row sweep of `_left_lower_solve`.  Each solve is one kernel that serves
// its single and batched entry points: the system index is blockIdx.z with an
// int64 batch stride per operand, and a single system is Bb = 1.  A row's (or
// column's) arithmetic does not depend on the batch or the tile, so a batched
// lane equals the single call bit for bit.
//
// What bounds them on an H100: bytes.  trsm_right_upper: on the Cholesky
// path B is [16384, 32] (single) or [256, 512, 32] (batched): each element of
// B is read once and of X written once, with v^2 operations per row, so about
// v / 4 = 8 flop per byte in f32, below the card's ratio.  The floor is
// ~1.3 us single and ~10 us batched at 3.35 TB/s.  trsm_left_lower: on the
// flat bodies B is [32, C] with C up to 16384 (one rank's columns), the same
// v / 4 flop per byte; the floor is ~1.3 us at C = 16384.
//
// Design of trsm_right_upper: the TPU kernel tiles the long axis over the
// grid and keeps U and a [br, v] tile in VMEM.  Here each block owns kRows
// rows of one system, one thread per row.  U is staged in shared memory once
// per block, read with any row and column strides (the Cholesky path passes
// L00^T, a transposed view), and every thread reads the same U element at
// the same time, a broadcast.  The block's B tile is copied into shared
// memory with coalesced loads and a padded row stride (v + 1) so that the
// threads' row-wise reads hit distinct banks; each thread then sweeps its row
// column by column,
//   X[r, j] = (B[r, j] - sum_{i<j} X[r, i] U[i, j]) / U[j, j],
// in place, and the tile goes back out with coalesced stores.  Rows that are
// zero in B (the path masks every row above the trailing block) stay zero.
//
// Design of trsm_left_lower: columns of B are independent, so each thread
// owns one column of one system (blockIdx.z); the TPU kernel's column tiles
// of bc = 256 become the grid's x axis.  For v <= 32 (every path's v),
// `trsm_left_lower_reg_kernel`, kRegCols = 128 threads (columns) a block,
// the fastest of 32, 64, 128 and 256 at [32, 16384] (PERF.md):
//   - a thread loads all v values of its column into registers before the
//     first sum, so it waits out one memory latency, where a load placed
//     behind each row's dependent sum would wait out v of them in turn;
//   - L is staged once per block, transposed, in shared memory (strictly
//     lower part, and the diagonal unless unit), every staging load issued
//     before the first store;
//   - the solve runs column by column: once x[q] is final, every later row
//     takes its term L[r][q] x[q], so a step's FMAs are independent of each
//     other, and the whole warp reads each 16-byte run of L's column q at
//     once (a broadcast);
//   - X goes out row by row after the solve, neighbouring threads on
//     neighbouring columns, so the stores coalesce.
// For 32 < v <= 128 (off every path), `trsm_left_lower_smem_kernel` keeps
// the column's solved values in a [v][kCols] shared-memory tile beside L (at
// v = 128 in f64, 128 KB and 64 KB of dynamic shared memory).  In both
// bodies each row's sum grows in ascending q as `partial += L * x`, then
// X[r, c] = B[r, c] - partial, then / L[r, r] unless unit: the order and form
// that `fused_schur.cu` repeats per block, which nvcc contracts into the same
// chain of FMAs in both kernels, so the flat step bodies (this kernel) and
// the windowed ones (the fused kernel) solve U01 alike.  The ragged column
// edge is masked; C need not be a multiple of the tile.
//
// Both sums run in another order than a library solve's, so results agree
// with the plain versions within a stated tolerance, not bitwise.

#include <cstdint>

#include <cuda_runtime.h>

#include "once_per_device.cuh"

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

constexpr int kCols = 64;         // columns (threads) per block of the shared-memory body
constexpr int kRegV = 32;         // v up to which a thread keeps its column in registers
constexpr int kRegCols = 128;     // columns (threads) per block of the register body

// One 16-byte run of a row of staged L: four f32 or two f64 values.
template <typename T>
struct alignas(16) Run {
  T x[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kRegCols)
trsm_left_lower_reg_kernel(const T* __restrict__ L, int64_t ldl_r, int64_t ldl_c, int64_t bsl,
                           const T* __restrict__ B, int64_t ldb, int64_t bsb,
                           T* __restrict__ X, int C, int v, int unit) {
  __shared__ __align__(16) T Lt[kRegV * kRegV];  // Lt[q][r] = L[r][q]; zero where not read
  constexpr int kRun = 16 / sizeof(T);

  const int64_t z = blockIdx.z;
  L += z * bsl;
  B += z * bsb;
  X += z * static_cast<int64_t>(v) * C;
  const int col = blockIdx.x * kRegCols + threadIdx.x;
  const bool has_col = col < C;

  // This thread's column, every row requested before anything waits on one.
  T x[kRegV];
#pragma unroll
  for (int r = 0; r < kRegV; ++r) x[r] = has_col && r < v ? B[r * ldb + col] : T(0);

  // L, transposed into shared memory: this thread's elements idx =
  // threadIdx.x + i * kRegCols, all loads issued before the first store.
  constexpr int kStage = kRegV * kRegV / kRegCols;
  T staged[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int idx = threadIdx.x + i * kRegCols;
    const int q = idx / kRegV;
    const int r = idx % kRegV;
    const bool read = r < v && (q < r || (q == r && !unit));
    staged[i] = read ? L[r * ldl_r + q * ldl_c] : T(0);
  }
#pragma unroll
  for (int i = 0; i < kStage; ++i) Lt[threadIdx.x + i * kRegCols] = staged[i];
  __syncthreads();
  if (!has_col) return;

  // Column by column: once x[q] is final, every later row takes its term
  // L[r][q] x[q].  Each row's partial sum still grows in ascending q, one
  // FMA at a time, so it is rounded exactly as a row-by-row sweep would
  // round it; the rows' FMAs of one step are independent of each other.
  T partial[kRegV];
#pragma unroll
  for (int r = 0; r < kRegV; ++r) partial[r] = T(0);
#pragma unroll
  for (int q = 0; q < kRegV; ++q) {
    T xq = x[q] - partial[q];
    if (!unit) xq = xq / Lt[q * kRegV + q];
    x[q] = xq;
#pragma unroll
    for (int r0 = (q + 1) / kRun * kRun; r0 < kRegV; r0 += kRun) {
      const Run<T> run = *reinterpret_cast<const Run<T>*>(Lt + q * kRegV + r0);
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        if (r0 + e > q) partial[r0 + e] += run.x[e] * xq;
    }
  }

#pragma unroll
  for (int r = 0; r < kRegV; ++r)
    if (r < v) X[static_cast<int64_t>(r) * C + col] = x[r];
}

template <typename T>
__global__ void __launch_bounds__(kCols)
trsm_left_lower_smem_kernel(const T* __restrict__ L, int64_t ldl_r, int64_t ldl_c, int64_t bsl,
                            const T* __restrict__ B, int64_t ldb, int64_t bsb,
                            T* __restrict__ X, int C, int v, int unit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);  // [v][v]
  T* Xs = Ls + v * v;                      // [v][kCols]: this block's columns

  const int64_t z = blockIdx.z;
  L += z * bsl;
  B += z * bsb;
  X += z * static_cast<int64_t>(v) * C;
  const int tx = threadIdx.x;
  const int col = blockIdx.x * kCols + tx;

  for (int r = 0; r < v; ++r)
    for (int q = tx; q < v; q += kCols) Ls[r * v + q] = L[r * ldl_r + q * ldl_c];
  __syncthreads();

  if (col < C) {
    for (int r = 0; r < v; ++r) {
      T partial = T(0);
      for (int q = 0; q < r; ++q) partial += Ls[r * v + q] * Xs[q * kCols + tx];
      T x = B[r * ldb + col] - partial;
      if (!unit) x = x / Ls[r * v + r];
      Xs[r * kCols + tx] = x;
      X[static_cast<int64_t>(r) * C + col] = x;
    }
  }
}

template <typename T>
int launch(const void* B, long long ldb, long long bsb, const void* U, long long ldu_r,
           long long ldu_c, long long bsu, void* X, int Bb, int R, int v, void* stream) {
  // The limit is raised once per device, for the widest panel.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(
        trsm_right_upper_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (static_cast<size_t>(v) * v + static_cast<size_t>(kRows) * (v + 1)) *
                      sizeof(T);
  const dim3 grid((R + kRows - 1) / kRows, 1, Bb);
  trsm_right_upper_kernel<T><<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), ldb, bsb, static_cast<const T*>(U), ldu_r, ldu_c, bsu,
      static_cast<T*>(X), R, v);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_left_lower(const void* L, long long ldl_r, long long ldl_c, long long bsl,
                      const void* B, long long ldb, long long bsb, void* X, int Bb, int v, int C,
                      int unit, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= kRegV) {
    const dim3 grid(
        static_cast<unsigned>((static_cast<int64_t>(C) + kRegCols - 1) / kRegCols), 1, Bb);
    trsm_left_lower_reg_kernel<T><<<grid, kRegCols, 0, s>>>(
        static_cast<const T*>(L), ldl_r, ldl_c, bsl, static_cast<const T*>(B), ldb, bsb,
        static_cast<T*>(X), C, v, unit);
    return static_cast<int>(cudaGetLastError());
  }
  // As above: the limit is raised once per device, for the widest panel.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(trsm_left_lower_smem_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxV * (kMaxV + kCols) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(v) * (v + kCols) * sizeof(T);
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(C) + kCols - 1) / kCols), 1, Bb);
  trsm_left_lower_smem_kernel<T><<<grid, kCols, smem, s>>>(
      static_cast<const T*>(L), ldl_r, ldl_c, bsl, static_cast<const T*>(B), ldb, bsb,
      static_cast<T*>(X), C, v, unit);
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

// Bb systems: L [v, v] with row stride ldl_r, column stride ldl_c and batch
// stride bsl (only its lower triangle is read, and its diagonal only when
// unit == 0); B [v, C] with row stride ldb and batch stride bsb (unit column
// stride); X: [Bb, v, C] contiguous output.  1 <= v <= 128, C >= 1,
// 1 <= Bb <= 65535.  Returns the cudaError_t of the launch.
extern "C" int trsm_left_lower_f32(const void* L, long long ldl_r, long long ldl_c,
                                   long long bsl, const void* B, long long ldb, long long bsb,
                                   void* X, int Bb, int v, int C, int unit, void* stream) {
  return launch_left_lower<float>(L, ldl_r, ldl_c, bsl, B, ldb, bsb, X, Bb, v, C, unit, stream);
}

extern "C" int trsm_left_lower_f64(const void* L, long long ldl_r, long long ldl_c,
                                   long long bsl, const void* B, long long ldb, long long bsb,
                                   void* X, int Bb, int v, int C, int unit, void* stream) {
  return launch_left_lower<double>(L, ldl_r, ldl_c, bsl, B, ldb, bsb, X, Bb, v, C, unit, stream);
}

extern "C" const char* trsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
