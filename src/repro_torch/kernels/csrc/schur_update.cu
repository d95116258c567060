// Schur-complement update:  out = A - L @ U, A [M, N], L [M, K], U [K, N],
// for one system or a batch of B independent ones.
//
// Replaces: src/repro/kernels/schur_update.py::schur_update (body `_kernel`)
// and ::schur_update_batched (body `_batched_kernel`).  One kernel serves
// both: the system index is blockIdx.z with an int64 batch stride per
// operand, and a single system is B = 1.  An output element's arithmetic
// does not depend on the batch or its tile's place, so a batched lane equals
// the single call bit for bit.
//
// What bounds it on an H100: bytes.  On the Cholesky path A is
// [16384, 16384] with K = 32, so one call does 2 M N K = 17.2 GFLOP while it
// must read A and write the result once, 2.1 GB in f32: about 8 flop per
// byte, below the card's ratio of f32 peak to bandwidth (20).  The floor is
// ~0.64 ms per call at 3.35 TB/s; batched at (256, 512, 512, 32), ~0.17 ms.
//
// Design: a plain tiled SIMT product.  The TPU kernel walks (bm, bn) output
// tiles with the contraction as the fastest grid axis and carries an f32
// accumulator in VMEM across it.  Hopper blocks share nothing, so here each
// block owns a kBM x kBN = 64 x 128 output tile and loops over K itself, in
// chunks of kChunk (32 in f32, 16 in f64): the chunk's L rows are staged in
// shared memory transposed (padded against bank conflicts) and its U rows as
// they are, both with coalesced loads.  256 threads = 32 column lanes x 8
// row groups; each thread owns 8 consecutive rows and 4 columns 32 apart, so
// a warp's loads and stores of A and the output are 128-byte rows, a
// shared-memory read of L is a broadcast, and one of U is conflict-free.
// The accumulator starts from A, as the Pallas kernel's does; each chunk's
// dot product is summed in registers and then subtracted from it (at
// K = 32 in f32: out = A - sum of 32 products).  The A loads are issued
// first so that their latency overlaps the chunk's products.  Ragged edges
// (M, N, K not multiples of the tiles) are masked, so any shape runs.
// The order of the sum differs from a library GEMM's, so results agree with
// the plain version within a stated tolerance, not bitwise.
//
// It does not use the tensor cores: at K = 32 the update is bound by bytes,
// and wgmma, TMA and a persistent schedule are later work, as is skipping
// the zero rows and columns of the path's full-shape update.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kColLanes = 32;
constexpr int kRowGroups = 8;
constexpr int kThreads = kColLanes * kRowGroups;
constexpr int kRowsPerThread = kBM / kRowGroups;  // 8
constexpr int kColsPerThread = kBN / kColLanes;   // 4

template <typename T>
struct Chunk {
  static constexpr int value = sizeof(T) == 4 ? 32 : 16;  // keeps shared memory < 48 KiB
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_update_kernel(const T* __restrict__ A, int64_t lda, int64_t bsa,
                    const T* __restrict__ L, int64_t ldl, int64_t bsl,
                    const T* __restrict__ U, int64_t ldu, int64_t bsu,
                    T* __restrict__ out, int64_t ldo, int64_t bso, int M, int N, int K) {
  constexpr int kChunk = Chunk<T>::value;
  __shared__ T Ls[kChunk][kBM + 1];  // L chunk, transposed: Ls[k][row]
  __shared__ T Us[kChunk][kBN];      // U chunk: Us[k][col]

  const int64_t z = blockIdx.z;
  A += z * bsa;
  L += z * bsl;
  U += z * bsu;
  out += z * bso;

  const int tx = threadIdx.x % kColLanes;
  const int ty = threadIdx.x / kColLanes;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int rbase = row0 + ty * kRowsPerThread;

  T acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int row = rbase + r;
      const int col = col0 + tx + c * kColLanes;
      acc[r][c] = (row < M && col < N) ? A[static_cast<int64_t>(row) * lda + col] : T(0);
    }
  }

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int idx = threadIdx.x; idx < kBM * kChunk; idx += kThreads) {
      const int m = idx / kChunk;
      const int k = idx - m * kChunk;
      const int row = row0 + m;
      Ls[k][m] = (row < M && k0 + k < K) ? L[static_cast<int64_t>(row) * ldl + k0 + k] : T(0);
    }
    for (int idx = threadIdx.x; idx < kChunk * kBN; idx += kThreads) {
      const int k = idx / kBN;
      const int n = idx - k * kBN;
      const int col = col0 + n;
      Us[k][n] = (col < N && k0 + k < K) ? U[static_cast<int64_t>(k0 + k) * ldu + col] : T(0);
    }
    __syncthreads();

    T dot[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) dot[r][c] = T(0);
    }
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      T l[kRowsPerThread];
      T u[kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) l[r] = Ls[k][ty * kRowsPerThread + r];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) u[c] = Us[k][tx + c * kColLanes];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) dot[r][c] += l[r] * u[c];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[r][c] -= dot[r][c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int row = rbase + r;
      const int col = col0 + tx + c * kColLanes;
      if (row < M && col < N) out[static_cast<int64_t>(row) * ldo + col] = acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* A, long long lda, long long bsa, const void* L, long long ldl,
           long long bsl, const void* U, long long ldu, long long bsu, void* out, long long ldo,
           long long bso, int B, int M, int N, int K, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, B);
  schur_update_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), lda, bsa, static_cast<const T*>(L), ldl, bsl,
      static_cast<const T*>(U), ldu, bsu, static_cast<T*>(out), ldo, bso, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B systems: A [M, N], L [M, K], U [K, N], out [M, N], each with the given
// row stride, batch stride and unit column stride (a single system is
// B = 1).  Needs ceil(M / 64) <= 65535 and B <= 65535.  Returns the
// cudaError_t of the launch.
extern "C" int schur_update_f32(const void* A, long long lda, long long bsa, const void* L,
                                long long ldl, long long bsl, const void* U, long long ldu,
                                long long bsu, void* out, long long ldo, long long bso, int B,
                                int M, int N, int K, void* stream) {
  return launch<float>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M, N, K,
                       stream);
}

extern "C" int schur_update_f64(const void* A, long long lda, long long bsa, const void* L,
                                long long ldl, long long bsl, const void* U, long long ldu,
                                long long bsu, void* out, long long ldo, long long bso, int B,
                                int M, int N, int K, void* stream) {
  return launch<double>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M, N, K,
                        stream);
}

extern "C" const char* schur_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
