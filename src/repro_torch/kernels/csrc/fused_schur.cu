// Fused TRSM -> Schur update:  U01 = L00^-1 R01,  out = A - L10 @ U01, for
// one system or a batch of B independent ones.
//
// Replaces: src/repro/kernels/fused_schur.py::fused_trsm_schur (bodies
// `_forward_solve` and `_kernel`) and ::fused_trsm_schur_batched (body
// `_batched_kernel`).  One kernel serves both: the batch index is blockIdx.z
// and every operand has an int64 batch stride, and a single system is the
// B = 1 case.  The contraction order of each output element does not depend
// on the batch or the tiles, so a batched lane equals the single call bit for
// bit.
//
// What bounds it on an H100: bytes.  On the main path A is [16384, 16384]
// and v = 32, so one call does 2*N*N*v = 17.2 GFLOP while it must read A and
// write the result once, 2.1 GB in f32: about 8 flop per byte, far below the
// card's ratio of peak flops to bandwidth.  The floor is ~0.64 ms per call at
// 3.35 TB/s.
//
// Design: the TPU grid runs column tiles outer and row tiles inner, solves
// each U01 tile once on the first row step and keeps it in VMEM for the
// others.  Hopper blocks run in no order and share nothing, so here the grid
// is 2-D, (C / bc) x (M / bm), and every block solves its own [v, bc] U01
// tile into shared memory before it walks its bm rows.  One block per column
// tile would give only C / bc = 128 blocks of 8 warps at the main path's
// shape, too few warps in flight to cover device-memory latency; redoing the
// v x v solve costs an extra v / bm of the update's work (32 / 1024 = 3% at
// the default bm) and needs no second pass.  Only the blocks of grid row 0
// write U01, so each U01 tile is written exactly once.  Batched, the grid is
// (C / bc) x (M / bm) x B: at the serving tier's (B, M, C, v) =
// (256, 512, 512, 32) with bm = 512 that is 4 x 1 x 256 = 1024 blocks, and
// the redone solve costs v / bm = 6% extra.
//
// Each block has 256 threads: 128 column threads (one per column of the
// tile; bc <= 128) times 2 row groups.  The update walks the block's rows in
// chunks of 32: the chunk's L10 rows are staged in shared memory, transposed
// and padded against bank conflicts, and each thread keeps 16 row
// accumulators for its column, so one shared-memory read of U01 feeds 16
// multiply-adds.  A and the output are read and written once, one row of the
// tile per warp transaction.  Accumulation is in T (f32 for f32 inputs) and
// sums the whole v-contraction before subtracting it from A, as the
// reference does; the order of that sum differs from a library GEMM's, so
// results agree with the plain version within a stated tolerance, not
// bitwise.
//
// R01 arrives pre-masked (zero before column c0 + v) and the arithmetic keeps
// the reference's full shape; skipping the zero columns is later work, as are
// wgmma, TMA and clusters.

#include <cstdint>

#include <cuda_runtime.h>

#include "once_per_device.cuh"
namespace {

constexpr int kColThreads = 128;              // columns per tile, at most
constexpr int kRowGroups = 2;
constexpr int kRowsPerThread = 16;
constexpr int kChunk = kRowGroups * kRowsPerThread;  // rows per pass
constexpr int kLStride = kChunk + 1;          // padded stride of staged L10
constexpr int kThreads = kColThreads * kRowGroups;
constexpr int kMaxV = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_trsm_schur_kernel(const T* __restrict__ A, int64_t lda, int64_t bsa,
                        const T* __restrict__ L00, int64_t ldl, int64_t bsl,
                        const T* __restrict__ R01, int64_t ldr, int64_t bsr,
                        const T* __restrict__ L10, int64_t ld10, int64_t bs10,
                        T* __restrict__ out, int64_t ldo, int64_t bso,
                        T* __restrict__ U01, int64_t ldu, int64_t bsu,
                        int M, int v, int bm, int bc, int unit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Us = reinterpret_cast<T*>(smem_raw);  // [v][kColThreads]: this tile's U01
  T* Ls = Us + v * kColThreads;            // [v][kLStride]: staged L10 chunk

  // This block's system.
  const int64_t z = blockIdx.z;
  A += z * bsa;
  L00 += z * bsl;
  R01 += z * bsr;
  L10 += z * bs10;
  out += z * bso;
  U01 += z * bsu;

  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int col = blockIdx.x * bc + tx;
  const bool has_col = tx < bc;

  // 1. Forward substitution L00 @ U = R01 for this column tile.
  if (ty == 0 && has_col) {
    for (int r = 0; r < v; ++r) {
      T partial = T(0);
      for (int q = 0; q < r; ++q) partial += L00[r * ldl + q] * Us[q * kColThreads + tx];
      T x = R01[r * ldr + col] - partial;
      if (!unit) x = x / L00[r * ldl + r];
      Us[r * kColThreads + tx] = x;
      if (blockIdx.y == 0) U01[r * ldu + col] = x;
    }
  }
  __syncthreads();

  // 2. out = A - L10 @ U over this block's rows, kChunk rows per pass.
  const int row0 = blockIdx.y * bm;
  const int row_end = min(row0 + bm, M);
  for (int r0 = row0; r0 < row_end; r0 += kChunk) {
    for (int idx = threadIdx.x; idx < v * kChunk; idx += kThreads) {
      const int rr = idx / v;
      const int q = idx - rr * v;
      const int row = r0 + rr;
      Ls[q * kLStride + rr] = row < row_end ? L10[static_cast<int64_t>(row) * ld10 + q] : T(0);
    }
    __syncthreads();
    if (has_col) {
      // Issue the A loads first so their latency overlaps the contraction.
      T a[kRowsPerThread];
      T acc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = r0 + ty * kRowsPerThread + i;
        a[i] = row < row_end ? A[static_cast<int64_t>(row) * lda + col] : T(0);
        acc[i] = T(0);
      }
      const T* lrow = Ls + ty * kRowsPerThread;
      for (int q = 0; q < v; ++q) {
        const T u = Us[q * kColThreads + tx];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i] += lrow[q * kLStride + i] * u;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = r0 + ty * kRowsPerThread + i;
        if (row < row_end) out[static_cast<int64_t>(row) * ldo + col] = a[i] - acc[i];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* A, long long lda, long long bsa, const void* L00, long long ldl,
           long long bsl, const void* R01, long long ldr, long long bsr, const void* L10,
           long long ld10, long long bs10, void* out, long long ldo, long long bso, void* U01,
           long long ldu, long long bsu, int B, int M, int C, int v, int bm, int bc, int unit,
           void* stream) {
  // The limit is raised once per device, for the widest panel.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(fused_trsm_schur_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxV * (kColThreads + kLStride) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(v) * (kColThreads + kLStride) * sizeof(T);
  const dim3 grid(C / bc, M / bm, B);
  fused_trsm_schur_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, bsa, static_cast<const T*>(L00), ldl, bsl,
      static_cast<const T*>(R01), ldr, bsr, static_cast<const T*>(L10), ld10, bs10,
      static_cast<T*>(out), ldo, bso, static_cast<T*>(U01), ldu, bsu, M, v, bm, bc, unit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B systems: A [M, C], L00 [v, v], R01 [v, C], L10 [M, v], out [M, C],
// U01 [v, C], each with the given row stride, batch stride and unit column
// stride (a single system is B = 1).  Needs bc <= 128, C % bc == 0,
// M % bm == 0, v <= 128, M / bm <= 65535 and B <= 65535.  Returns the
// cudaError_t.
extern "C" int fused_trsm_schur_f32(const void* A, long long lda, long long bsa,
                                    const void* L00, long long ldl, long long bsl,
                                    const void* R01, long long ldr, long long bsr,
                                    const void* L10, long long ld10, long long bs10, void* out,
                                    long long ldo, long long bso, void* U01, long long ldu,
                                    long long bsu, int B, int M, int C, int v, int bm, int bc,
                                    int unit, void* stream) {
  return launch<float>(A, lda, bsa, L00, ldl, bsl, R01, ldr, bsr, L10, ld10, bs10, out, ldo,
                       bso, U01, ldu, bsu, B, M, C, v, bm, bc, unit, stream);
}

extern "C" int fused_trsm_schur_f64(const void* A, long long lda, long long bsa,
                                    const void* L00, long long ldl, long long bsl,
                                    const void* R01, long long ldr, long long bsr,
                                    const void* L10, long long ld10, long long bs10, void* out,
                                    long long ldo, long long bso, void* U01, long long ldu,
                                    long long bsu, int B, int M, int C, int v, int bm, int bc,
                                    int unit, void* stream) {
  return launch<double>(A, lda, bsa, L00, ldl, bsl, R01, ldr, bsr, L10, ld10, bs10, out, ldo,
                        bso, U01, ldu, bsu, B, M, C, v, bm, bc, unit, stream);
}

extern "C" const char* fused_schur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
