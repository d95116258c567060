// Schur-complement update:  out = A - L @ U, A [M, N], L [M, K], U [K, N],
// for one system or a batch of B independent ones.
//
// Replaces: src/repro/kernels/schur_update.py::schur_update (body `_kernel`)
// and ::schur_update_batched (body `_batched_kernel`).  The TPU kernel walks
// (bm, bn) output tiles with the contraction as the fastest grid axis and
// carries an f32 accumulator in VMEM across it.  One kernel here serves both
// entry points, a single system being B = 1.  An output element's arithmetic
// does not depend on the batch, its tile's place or the block that runs it,
// so a batched lane equals the single call bit for bit.
//
// What bounds it on an H100: bytes.  On the Cholesky path A is
// [16384, 16384] with K = 32, so one call does 2 M N K = 17.2 GFLOP while it
// must read A and write the result once, 2.1 GB in f32: about 8 flop per
// byte, below the card's ratio of f32 peak to bandwidth (20).  The floor is
// ~0.64 ms per call at 3.35 TB/s; batched at (256, 512, 512, 32), ~0.17 ms.
//
// The first body gave each block one 64 x 128 output tile and ran
// its phases strictly in turn: A into registers with 4-byte loads, the L and
// U chunks through shared memory behind barriers, the products, the stores.
// It took 0.370 ms at the batched shape (46% of its floor) and 1.088 ms at
// the single one (59%), held back by:
//   - no overlap: no block overlapped its stores or its products with the
//     next tile's loads, and a 32-value accumulator beside a 32-value dot
//     product left room for about two blocks an SM;
//   - traffic its floor does not count: L was read again by every column
//     tile and U by every row tile, 24 KB of L2 reads per 64 KB of A;
//   - waves: the batched shape's 8,192 blocks ran in 31 waves, each ending
//     with SMs idle.
// This body is a persistent, pipelined stream:
//   - a grid of one block an SM; block b walks a contiguous range of
//     32 x 256 output tiles, ordered (system, 256-column stripe, row tile)
//     with the row tile fastest, so one system's tiles run close together.
//     A run of tiles of one (system, stripe) is an item: the stripe's U
//     chunk [32, 256] is staged once per item (two buffers, so the next
//     item's U arrives while the last tiles of this one run), a row tile's
//     L [32, 32] once per tile.  At the batched shape that is 4 KB of L and
//     2 KB of U per tile against 64 KB of A in and out (9%, from 37%);
//   - A and L arrive by TMA (`cp.async.bulk.tensor`, tensor maps built per
//     call through cudaGetDriverEntryPoint, no -lcuda) into a ring of four
//     stages on mbarriers: thread 0 keeps three tiles' loads in flight
//     while the block runs the products of the fourth;
//   - the result is written over the A tile in shared memory and leaves by
//     a TMA store, which holds no registers; a stage is loaded again only
//     once its store has been read out (`cp.async.bulk.wait_group.read`);
//   - the A loads and the stores carry an L2 evict-first policy, since each
//     byte passes once, so that L and U stay in L2 (slightly faster in
//     exploratory calls on the card);
//   - the products stay on the CUDA cores in f32 (f64 for f64): TF32
//     `wgmma` would round L and U to 10-bit mantissas, another function, and
//     the 2.15 G FMAs of a batched call (~64 us at 67 TFLOP/s) fit under its
//     ~170 us of bytes.  Each warp owns a 32 x 32 block, each thread 8 rows
//     4 apart by 4 adjacent columns; per k a thread reads its 8 values of L
//     from 128-byte rows swizzled as TMA's 128B mode lays them (conflict
//     free, 4 values of k a load) and 4 values of U (a broadcast across row
//     groups): three shared-memory reads per 32 FMAs.
// In exploratory calls on the card, 64 x 128 tiles ran as fast as 32 x 256
// ones, which read L half as often, and issuing tile n + 3's loads before
// tile n's products rather than after them was no faster.  The same pipeline
// with the products left out ran faster, a little at the batched shape and
// more at the single one: part of the products is not hidden under the
// copies, and a producer warp of its own is the next thing to try.
// Arithmetic, the same in every mode and as the first body's: the
// accumulator starts from A; each chunk of K (32 in f32, 16 in f64, zero
// padded) is summed in ascending k in its own FMA chain from 0, then
// subtracted once, so out = A - sum of the products at K = 32 in f32.
//
// Edges: TMA needs 16-byte aligned bases and row and batch strides.  Where
// an operand misses that (an odd row stride, K < 4), where K is over one
// chunk, and in f64, the same body takes plain loads: per tile, the block
// loads A, then each chunk of L and U, into the same shared-memory layout
// and stores the result itself, without the pipeline, with the same
// arithmetic.  Ragged M, N and K are zero-filled and clipped (by TMA, or by
// the plain loads' masks), so any shape runs; the conflux step's windows of
// a wider matrix (row stride > N, bases 32 columns apart) take the TMA path.
// The order of the sum differs from a library GEMM's, so results agree with
// the plain version within a stated tolerance, not bitwise.
//
// bf16 and f16 (`storage.cuh`): every value of A, L and U is widened exactly
// to f32, the products are exact and summed in f32, and each result is
// rounded once, to nearest even, where it is stored: the Pallas kernel's
// A.astype(f32) - dot(l, u, preferred_element_type=f32), cast back.  Two
// bodies compute that:
//   - `schur_update_wgmma_kernel`, a stream of its own (below), for every
//     operand that TMA takes in 2 bytes and K <= 64;
//   - the plain loads of `schur_update_kernel`, a template on the storage
//     type St computing in T = compute_t<St>, for the rest: they widen each
//     value as they load it into the f32 layout in shared memory and run the
//     f32 arithmetic.  (`Smem::kRing` is 1 for 2-byte storage, so that body
//     never builds f32 tensor maps over 2-byte data.)
// The launcher reports which way a call went (`*mode`).
//
// The 2-byte stream.  On the Cholesky path's [16384, 16384] at K = 32, one
// call must read A and write the result once, 1.07 GB in bf16, a floor of
// 0.32 ms at 3.35 TB/s, while it does 17.2 GFLOP: 0.26 ms on the CUDA cores'
// f32 FMAs, 80% of the floor, but 0.017 ms on the tensor cores.  So the
// products run on `wgmma` (m64n256k16, f32 accumulators in registers), which
// computes the same function: the products of two bf16 or two f16 values
// are exact in f32 and summed in f32.  The stream keeps the f32 design's
// order and reuse: one block an SM, 64 x 256 output tiles ordered (system,
// stripe, row tile) with the row tile fastest, U staged once per (system,
// stripe) item in two buffers, A and L in a ring of four stages, a stage
// reloaded only once its store has been read out.  A block is one consumer
// warpgroup and a producer warp:
//   - the producer issues every TMA copy and store: A in four 128-byte-
//     swizzled boxes of 64 columns (TMA's limit for that swizzle in 2
//     bytes), L as one box [64 rows, 64 columns] (zero-filled past K, the
//     `wgmma` A operand, K-major), U as four boxes [16 ceil(K / 16), 64]
//     (the B operand, MN-major through the transpose bit, as
//     `flash_attention.cu` reads V), evict-first on A and the results;
//   - the consumer waits for a stage, issues ceil(K / 16) products from a
//     zero accumulator, then widens the A tile, subtracts, narrows and writes
//     the result over the A tile in place.  Its accumulator layout reads a
//     row pair of 4 bytes a thread, and the 128-byte swizzle puts the eight
//     rows a warp reads at once on eight distinct 16-byte runs: no bank
//     conflicts, and no staging through another layout.  It then tells the
//     producer (a "done" mbarrier), which stores the tile.
// An output element's sum depends on nothing but its L row and U column, so
// a batched lane equals the single call bit for bit.  The order of the sum
// is the tensor cores', not the plain loads' FMA chain, so the two bodies
// agree within a 2-byte rounding, not bitwise.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the driver call is looked up at run time
#include <cuda_runtime.h>

#include "attributes.cuh"
#include "once_per_device.cuh"
#include "storage.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 32;          // rows of an output tile
constexpr int kBN = 256;         // columns of an output tile: a stripe
constexpr int kThreads = kBM * kBN / 32;  // 8 warps, each a 32 x 32 block of the tile
constexpr int kStages = 4;       // A + L tiles in the ring
constexpr int kRowBytes = 128;   // a row of an L chunk: 32 f32 or 16 f64

template <typename T>
struct Chunk {
  static constexpr int value = kRowBytes / sizeof(T);  // 32 in f32, 16 in f64
};

// One 16-byte run: four f32 or two f64 values (of the compute type).
template <typename T>
struct alignas(16) Run {
  T x[16 / sizeof(T)];
};

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle repeats
// every 8 rows), in the compute type T of storage type S: A [kBM][kBN] and
// L [kBM][128 B] per stage, then U [chunk][kBN] twice, then a "full"
// mbarrier per stage.  The plain mode uses stage 0 and U buffer 0.
template <typename S>
struct Smem {
  using T = compute_t<S>;
  static constexpr uint32_t kA = kBM * kBN * sizeof(T);
  static constexpr uint32_t kL = kBM * kRowBytes;
  static constexpr uint32_t kU = Chunk<T>::value * kBN * sizeof(T);
  static constexpr uint32_t kStage = kA + kL;
  // Only f32 storage takes this body's TMA stream: f64 runs the plain mode only, and
  // bf16 and f16 run it for the operands that their own stream does not take.
  static constexpr int kRing = sizeof(S) == 4 ? kStages : 1;
  static constexpr uint32_t kBars = kRing * kStage + 2 * kU;
  static constexpr size_t kBytes = 1024 + kBars + kRing * 8;
  static_assert(kBytes <= 232448, "a block may use at most 227 KB of shared memory");
};

// The byte offset of 16-byte run c of row m of an L chunk: TMA's 128B
// swizzle, which moves the runs of 8 consecutive rows onto distinct banks.
__device__ __forceinline__ int l_offset(int m, int c) {
  return m * kRowBytes + ((c ^ (m & 7)) << 4);
}

// The products of one chunk for this thread's 8 x 4 outputs: rows row + 4 r
// (r < 8), columns col + c (c < 4); dot[r][c] = sum over ascending k of
// L[row + 4 r][k] U[k][col + c], one FMA at a time from 0.
template <typename T>
__device__ __forceinline__ void chunk_products(const unsigned char* Ls, const T* Us, int row,
                                               int col, T (&dot)[8][4]) {
  constexpr int kRun = 16 / sizeof(T);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[r][c] = T(0);
  }
#pragma unroll 2
  for (int kk = 0; kk < Chunk<T>::value; kk += kRun) {
    Run<T> l[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      l[r] = *reinterpret_cast<const Run<T>*>(Ls + l_offset(row + 4 * r, kk / kRun));
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      T u[4];
#pragma unroll
      for (int c0 = 0; c0 < 4; c0 += kRun) {
        const Run<T> run = *reinterpret_cast<const Run<T>*>(Us + (kk + e) * kBN + col + c0);
#pragma unroll
        for (int c = 0; c < kRun; ++c) u[c0 + c] = run.x[c];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[r][c] += l[r].x[e] * u[c];
      }
    }
  }
}

// acc -= dot on this thread's outputs of the A tile in shared memory.
template <typename T>
__device__ __forceinline__ void subtract(T* As, int row, int col, const T (&dot)[8][4]) {
  constexpr int kRun = 16 / sizeof(T);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    T* a = As + (row + 4 * r) * kBN + col;
#pragma unroll
    for (int c0 = 0; c0 < 4; c0 += kRun) {
      Run<T> run = *reinterpret_cast<const Run<T>*>(a + c0);
#pragma unroll
      for (int c = 0; c < kRun; ++c) run.x[c] -= dot[r][c0 + c];
      *reinterpret_cast<Run<T>*>(a + c0) = run;
    }
  }
}

struct Operand {
  const void* ptr;
  int64_t ld;  // row stride, elements
  int64_t bs;  // batch stride, elements
};

template <typename St>
__global__ void __launch_bounds__(kThreads, 1)
schur_update_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_l,
                    const __grid_constant__ CUtensorMap tm_u,
                    const __grid_constant__ CUtensorMap tm_out, Operand a_op, Operand l_op,
                    Operand u_op, St* __restrict__ out, int64_t ldo, int64_t bso, int nsys,
                    int M, int N, int K, int bulk) {
  using T = compute_t<St>;
  using S = Smem<St>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  // Warp w owns the 32 x 32 block (w / (kBN / 32), w % (kBN / 32)) of the
  // tile; lane l in it the rows l / 8 + 4 r (r < 8) and the 4 columns from
  // (l % 8) * 4.
  const int row = tid / 32 / (kBN / 32) * 32 + lane / 8;
  const int col = tid / 32 % (kBN / 32) * 32 + (lane % 8) * 4;

  const int nrt = (M + kBM - 1) / kBM;
  const int nst = (N + kBN - 1) / kBN;
  const int64_t tiles = static_cast<int64_t>(nsys) * nst * nrt;
  const int64_t t_begin = tiles * blockIdx.x / gridDim.x;
  const int64_t count = tiles * (blockIdx.x + 1) / gridDim.x - t_begin;
  const int64_t key0 = t_begin / nrt;  // (system, stripe) of the first tile
  T dot[8][4];

  if constexpr (sizeof(St) == 4) {
    if (bulk) {
      const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(base));
      const uint32_t u0 = smem0 + kStages * S::kStage;
      const uint32_t full0 = u0 + 2 * S::kU;
      const uint64_t stream_policy = evict_first_policy();
      if (tid == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();

      // Thread 0's loads: tile n into stage n % kStages once the store of
      // tile n - kStages has been read out, and with the U of a new item q
      // into buffer q % 2 once every tile of item q - 2 is done.  `done` is
      // the last tile whose products every thread has finished.
      int64_t next = 0;
      auto issue = [&](int64_t done) {
        for (; next < count && next <= done + kStages - 1; ++next) {
          const int64_t tau = t_begin + next;
          const int64_t key = tau / nrt;
          const bool starts = next == 0 || tau % nrt == 0;
          if (starts && key - key0 >= 2 && key * nrt - nrt - t_begin > done + 1) break;
          const uint32_t stage = smem0 + (next % kStages) * S::kStage;
          const uint32_t bar = full0 + 8 * (next % kStages);
          const int row0 = static_cast<int>(tau % nrt) * kBM;
          const int col0 = static_cast<int>(key % nst) * kBN;
          const int z = static_cast<int>(key / nst);
          mbar_expect_tx(bar, S::kA + S::kL + (starts ? S::kU : 0));
          tma_load_3d(stage, &tm_a, bar, col0, row0, z, stream_policy);
          tma_load_3d(stage + S::kA, &tm_l, bar, 0, row0, z);
          if (starts) tma_load_3d(u0 + ((key - key0) & 1) * S::kU, &tm_u, bar, col0, 0, z);
        }
      };
      if (tid == 0) issue(-1);

      for (int64_t n = 0; n < count; ++n) {
        const int64_t tau = t_begin + n;
        const int64_t key = tau / nrt;
        unsigned char* stage = base + (n % kStages) * S::kStage;
        mbar_wait(full0 + 8 * (n % kStages), static_cast<uint32_t>((n / kStages) & 1));
        chunk_products<T>(stage + S::kA,
                          reinterpret_cast<const T*>(base + kStages * S::kStage +
                                                     ((key - key0) & 1) * S::kU),
                          row, col, dot);
        subtract<T>(reinterpret_cast<T*>(stage), row, col, dot);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) {
          const int c0 = static_cast<int>(key % nst) * kBN;
          const int c1 = static_cast<int>(tau % nrt) * kBM;
          const uint32_t src = smem0 + (n % kStages) * S::kStage;
          tma_store_3d(&tm_out, src, c0, c1, static_cast<int>(key / nst), stream_policy);
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          issue(n);
        }
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      return;
    }
  }

  // Plain loads: one tile at a time through stage 0 and U buffer 0.
  constexpr int kChunk = Chunk<T>::value;
  constexpr int kRun = 16 / sizeof(T);
  T* As = reinterpret_cast<T*>(base);
  unsigned char* Ls = base + S::kA;
  T* Us = reinterpret_cast<T*>(base + S::kRing * S::kStage);
  for (int64_t n = 0; n < count; ++n) {
    const int64_t tau = t_begin + n;
    const int64_t key = tau / nrt;
    const int row0 = static_cast<int>(tau % nrt) * kBM;
    const int col0 = static_cast<int>(key % nst) * kBN;
    const int64_t z = key / nst;
    const St* A = static_cast<const St*>(a_op.ptr) + z * a_op.bs;
    const St* L = static_cast<const St*>(l_op.ptr) + z * l_op.bs;
    const St* U = static_cast<const St*>(u_op.ptr) + z * u_op.bs;
    for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
      const int m = idx / kBN;
      const int c = idx % kBN;
      const bool in = row0 + m < M && col0 + c < N;
      As[idx] = in ? widen(A[static_cast<int64_t>(row0 + m) * a_op.ld + col0 + c]) : T(0);
    }
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      for (int idx = tid; idx < kBM * kChunk; idx += kThreads) {
        const int m = idx / kChunk;
        const int k = idx % kChunk;
        const bool in = row0 + m < M && k0 + k < K;
        *reinterpret_cast<T*>(Ls + l_offset(m, k / kRun) + (k % kRun) * sizeof(T)) =
            in ? widen(L[static_cast<int64_t>(row0 + m) * l_op.ld + k0 + k]) : T(0);
      }
      for (int idx = tid; idx < kChunk * kBN; idx += kThreads) {
        const int k = idx / kBN;
        const int c = idx % kBN;
        const bool in = k0 + k < K && col0 + c < N;
        Us[idx] = in ? widen(U[static_cast<int64_t>(k0 + k) * u_op.ld + col0 + c]) : T(0);
      }
      __syncthreads();
      chunk_products<T>(Ls, Us, row, col, dot);
      subtract<T>(As, row, col, dot);
      __syncthreads();
    }
    __syncthreads();  // K = 0: A's loads before the stores below
    St* o = out + z * bso;
    for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
      const int m = idx / kBN;
      const int c = idx % kBN;
      if (row0 + m < M && col0 + c < N)
        o[static_cast<int64_t>(row0 + m) * ldo + col0 + c] = narrow<St>(As[idx]);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// bf16 and f16: a TMA + wgmma stream
// --------------------------------------------------------------------------

constexpr int kWRows = 64;                 // rows of a 2-byte output tile: one m64 product
constexpr int kWBox = 64;                  // columns of a box: one 128-byte swizzled row
constexpr int kWBoxes = kBN / kWBox;       // boxes of a 256-column stripe
constexpr int kWMaxK = 64;                 // K of one chunk: L rows of 128 bytes
constexpr int kWStages = 4;                // A + L tiles in the ring
constexpr int kWMath = 128;                // the consumer warpgroup
constexpr int kWThreads = kWMath + 32;     // and the producer warp

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle repeats
// every 8 rows): per stage A [4 boxes][64 rows][128 B] and L [64 rows][128 B],
// then U [4 boxes][64 rows][128 B] twice, then a "full" and a "done"
// mbarrier per stage.
struct WSmem {
  static constexpr uint32_t kABox = kWRows * 128;
  static constexpr uint32_t kA = kWBoxes * kABox;
  static constexpr uint32_t kL = kWRows * 128;
  static constexpr uint32_t kStage = kA + kL;
  static constexpr uint32_t kUBox = kWMaxK * 128;
  static constexpr uint32_t kU = kWBoxes * kUBox;
  static constexpr uint32_t kUOff = kWStages * kStage;
  static constexpr uint32_t kBars = kUOff + 2 * kU;
  static constexpr size_t kBytes = 1024 + kBars + 2 * kWStages * 8;
  static_assert(kBytes <= 232448, "a block may use at most 227 KB of shared memory");
};

// KS = ceil(K / 16) products of k16 a tile.
template <typename St, int KS>
__global__ void __launch_bounds__(kWThreads, 1)
schur_update_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_l,
                          const __grid_constant__ CUtensorMap tm_u,
                          const __grid_constant__ CUtensorMap tm_out, int nsys, int M, int N) {
  using W = WSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t smem0 = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (smem0 - raw);
  const uint32_t full0 = smem0 + W::kBars;
  const uint32_t done0 = full0 + 8 * kWStages;
  const int tid = threadIdx.x;

  const int nrt = (M + kWRows - 1) / kWRows;
  const int nst = (N + kBN - 1) / kBN;
  const int64_t tiles = static_cast<int64_t>(nsys) * nst * nrt;
  const int64_t t_begin = tiles * blockIdx.x / gridDim.x;
  const int64_t count = tiles * (blockIdx.x + 1) / gridDim.x - t_begin;
  const int64_t key0 = t_begin / nrt;  // (system, stripe) of the first tile

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(done0 + 8 * s, kWMath / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role, broadcast from lane 0 so that the compiler sees it uniform
  // across each warp and keeps the products off any divergent path.
  if (__shfl_sync(0xffffffffu, tid / kWMath, 0) != 0) {
    if (tid > kWMath) return;
    // The producer: tile n into stage n % kWStages once the store of tile
    // n - kWStages has been read out, and with the U of a new item q into
    // buffer q % 2 once every tile of item q - 2 is done.  `done` is the
    // last tile whose result the consumer has written.  Boxes wholly past
    // N are neither loaded nor stored.
    const uint64_t stream_policy = evict_first_policy();
    int64_t next = 0;
    auto issue = [&](int64_t done) {
      for (; next < count && next <= done + kWStages; ++next) {
        const int64_t tau = t_begin + next;
        const int64_t key = tau / nrt;
        const bool starts = next == 0 || tau % nrt == 0;
        if (starts && key - key0 >= 2 && key * nrt - nrt - t_begin > done + 1) break;
        const uint32_t stage = smem0 + (next % kWStages) * W::kStage;
        const uint32_t bar = full0 + 8 * (next % kWStages);
        const int row0 = static_cast<int>(tau % nrt) * kWRows;
        const int col0 = static_cast<int>(key % nst) * kBN;
        const int z = static_cast<int>(key / nst);
        const int boxes = min(kWBoxes, (N - col0 + kWBox - 1) / kWBox);
        mbar_expect_tx(bar, boxes * W::kABox + W::kL + (starts ? boxes * KS * 16 * 128 : 0));
        for (int b = 0; b < boxes; ++b)
          tma_load_3d(stage + b * W::kABox, &tm_a, bar, col0 + b * kWBox, row0, z, stream_policy);
        tma_load_3d(stage + W::kA, &tm_l, bar, 0, row0, z);
        if (starts) {
          const uint32_t u = smem0 + W::kUOff + static_cast<uint32_t>((key - key0) & 1) * W::kU;
          for (int b = 0; b < boxes; ++b)
            tma_load_3d(u + b * W::kUBox, &tm_u, bar, col0 + b * kWBox, 0, z);
        }
      }
    };
    issue(-1);
    for (int64_t n = 0; n < count; ++n) {
      const int64_t tau = t_begin + n;
      const int64_t key = tau / nrt;
      const int row0 = static_cast<int>(tau % nrt) * kWRows;
      const int col0 = static_cast<int>(key % nst) * kBN;
      const int boxes = min(kWBoxes, (N - col0 + kWBox - 1) / kWBox);
      const uint32_t stage = smem0 + (n % kWStages) * W::kStage;
      mbar_wait(done0 + 8 * (n % kWStages), static_cast<uint32_t>((n / kWStages) & 1));
      for (int b = 0; b < boxes; ++b)
        tma_store_3d(&tm_out, stage + b * W::kABox, col0 + b * kWBox, row0,
                     static_cast<int>(key / nst), stream_policy);
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      issue(n);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // The consumer warpgroup.  Thread t holds accumulator pairs 2j, 2j + 1 at
  // row 16 (t / 32) + (t % 32) / 4 + 8 (j % 2), columns 8 (j / 2) + 2 (t % 4)
  // and one more; in the swizzled A tile that pair lies in box j / 16, at
  // byte 4 (t % 4) of 16-byte run ((j / 2) % 8) ^ ((t % 32) / 4) of its row.
  const int lane = tid % 32;
  const uint32_t row_off = (16 * (tid / 32) + lane / 4) * 128 + 4 * (lane % 4);
  const int swz = lane / 4;
  float acc[kBN / 2];
  for (int64_t n = 0; n < count; ++n) {
    const int64_t key = (t_begin + n) / nrt;
    const int s = static_cast<int>(n % kWStages);
    const uint32_t stage = smem0 + s * W::kStage;
    const uint32_t u = smem0 + W::kUOff + static_cast<uint32_t>((key - key0) & 1) * W::kU;
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>((n / kWStages) & 1));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // k16 step kk: 32 bytes into L's 128-byte rows; 16 rows of U's boxes.
      mma_ss_t<kBN, St>(acc, sw128_desc(stage + W::kA + kk * 32, 16, 1024),
                        sw128_desc(u + kk * 2048, W::kUBox, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    unsigned char* const a = base + s * W::kStage;
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) {
      const int cb = j / 2;  // the pair's 8-column block
      uint32_t* p = reinterpret_cast<uint32_t*>(
          a + (cb / 8) * W::kABox + row_off + (j % 2) * 8 * 128 + (((cb % 8) ^ swz) << 4));
      const float2 x = Pair<St>::widen(*p);
      *p = Pair<St>::narrow(x.x - acc[2 * j], x.y - acc[2 * j + 1]);
    }
    // This warp's results before the TMA store that reads them.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(done0 + 8 * s);
  }
}

// The 2-byte stream for operands that `launch` found TMA takes; an error if
// the driver refuses a map all the same (never the plain loads).
template <typename S, int KS>
int launch_wgmma(const void* A, long long lda, long long bsa, const void* L, long long ldl,
                 long long bsl, const void* U, long long ldu, long long bsu, void* out,
                 long long ldo, long long bso, int B, int M, int N, int K, int64_t tiles,
                 cudaStream_t stream) {
  static OncePerDevice<> limit;
  int sms = 0;
  const cudaError_t err = limit.get(
      [](int dev, int* n) {
        const cudaError_t e = cudaFuncSetAttribute(schur_update_wgmma_kernel<S, KS>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(WSmem::kBytes));
        return e != cudaSuccess ? e
                                : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
      },
      &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_a{}, tm_l{}, tm_u{}, tm_out{};
  if (!(tensor_map<S>(&tm_a, A, lda, bsa, B, M, N, kWRows, kWBox, kSw) &&
        tensor_map<S>(&tm_l, L, ldl, bsl, B, M, K, kWRows, kWBox, kSw) &&
        tensor_map<S>(&tm_u, U, ldu, bsu, B, K, N, 16 * KS, kWBox, kSw) &&
        tensor_map<S>(&tm_out, out, ldo, bso, B, M, N, kWRows, kWBox, kSw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  schur_update_wgmma_kernel<S, KS><<<grid, kWThreads, WSmem::kBytes, stream>>>(
      tm_a, tm_l, tm_u, tm_out, B, M, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const void* A, long long lda, long long bsa, const void* L, long long ldl,
           long long bsl, const void* U, long long ldu, long long bsu, void* out, long long ldo,
           long long bso, int B, int M, int N, int K, int* mode, void* stream) {
  using T = compute_t<S>;
  *mode = 0;
  const int64_t tiles =
      static_cast<int64_t>(B) * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles == 0) return static_cast<int>(cudaSuccess);

  // 2-byte storage: the wgmma stream wherever TMA takes every operand and
  // K <= 64, decided by that rule alone; else the plain loads.
  if constexpr (sizeof(S) == 2) {
    if (K <= kWMaxK && tma_fits<S>(A, lda, bsa, B, M, N) && tma_fits<S>(L, ldl, bsl, B, M, K) &&
        tma_fits<S>(U, ldu, bsu, B, K, N) && tma_fits<S>(out, ldo, bso, B, M, N)) {
      *mode = 2;
      if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
      const int64_t wtiles =
          static_cast<int64_t>(B) * ((M + kWRows - 1) / kWRows) * ((N + kBN - 1) / kBN);
      const auto st = static_cast<cudaStream_t>(stream);
      switch ((K + 15) / 16) {
        case 1:
          return launch_wgmma<S, 1>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M,
                                    N, K, wtiles, st);
        case 2:
          return launch_wgmma<S, 2>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M,
                                    N, K, wtiles, st);
        case 3:
          return launch_wgmma<S, 3>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M,
                                    N, K, wtiles, st);
        default:
          return launch_wgmma<S, 4>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M,
                                    N, K, wtiles, st);
      }
    }
  }

  // The limit is raised, and the SMs counted, once per device.
  static OncePerDevice<> limit;
  int sms = 0;
  const cudaError_t err = limit.get(
      [](int dev, int* n) {
        const cudaError_t e = cudaFuncSetAttribute(schur_update_kernel<S>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(Smem<S>::kBytes));
        return e != cudaSuccess ? e
                                : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
      },
      &sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  // TMA for f32 storage with one chunk of K (every f32 path's shape), else
  // plain loads: f64 always, bf16 and f16 where the stream above does not
  // take the operands.
  CUtensorMap tm_a{}, tm_l{}, tm_u{}, tm_out{};
  const int bulk =
      sizeof(S) == 4 && K <= Chunk<T>::value &&
      tensor_map<float>(&tm_a, A, lda, bsa, B, M, N, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map<float>(&tm_l, L, ldl, bsl, B, M, K, kBM, Chunk<T>::value,
                        CU_TENSOR_MAP_SWIZZLE_128B) &&
      tensor_map<float>(&tm_u, U, ldu, bsu, B, K, N, Chunk<T>::value, kBN,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map<float>(&tm_out, out, ldo, bso, B, M, N, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  *mode = bulk;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  schur_update_kernel<S><<<grid, kThreads, Smem<S>::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_l, tm_u, tm_out, Operand{A, lda, bsa}, Operand{L, ldl, bsl}, Operand{U, ldu, bsu},
      static_cast<S*>(out), ldo, bso, B, M, N, K, bulk);
  return static_cast<int>(cudaGetLastError());
}

// Every instance the launchers above can take (`attributes.cuh`).
const KernelInstance kInstances[] = {
    {"schur_update_kernel<f32>", "f32", KI(schur_update_kernel<float>), kThreads, static_cast<long long>(Smem<float>::kBytes)},
    {"schur_update_kernel<f64>", "f64", KI(schur_update_kernel<double>), kThreads, static_cast<long long>(Smem<double>::kBytes)},
    {"schur_update_kernel<bf16>", "bf16", KI(schur_update_kernel<__nv_bfloat16>), kThreads, static_cast<long long>(Smem<__nv_bfloat16>::kBytes)},
    {"schur_update_kernel<f16>", "f16", KI(schur_update_kernel<__half>), kThreads, static_cast<long long>(Smem<__half>::kBytes)},
    {"schur_update_wgmma_kernel<bf16,1>", "bf16", KI((schur_update_wgmma_kernel<__nv_bfloat16, 1>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<bf16,2>", "bf16", KI((schur_update_wgmma_kernel<__nv_bfloat16, 2>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<bf16,3>", "bf16", KI((schur_update_wgmma_kernel<__nv_bfloat16, 3>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<bf16,4>", "bf16", KI((schur_update_wgmma_kernel<__nv_bfloat16, 4>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<f16,1>", "f16", KI((schur_update_wgmma_kernel<__half, 1>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<f16,2>", "f16", KI((schur_update_wgmma_kernel<__half, 2>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<f16,3>", "f16", KI((schur_update_wgmma_kernel<__half, 3>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
    {"schur_update_wgmma_kernel<f16,4>", "f16", KI((schur_update_wgmma_kernel<__half, 4>)), kWThreads, static_cast<long long>(WSmem::kBytes)},
};

}  // namespace

KERNEL_INSTANCE_ENTRIES(schur_update)

// B systems: A [M, N], L [M, K], U [K, N], out [M, N], all of one element
// type (the entry's suffix), each with the given row stride, batch stride
// and unit column stride (a single system is B = 1).  Sets *mode to 1 where
// f32 operands took the TMA stream, 2 where bf16 or f16 ones took the wgmma
// stream, 0 where they took plain loads (always for f64).  Returns the
// cudaError_t of the launch.
#define SCHUR_ENTRY(suffix, S)                                                                 \
  extern "C" int schur_update_##suffix(const void* A, long long lda, long long bsa,           \
                                       const void* L, long long ldl, long long bsl,           \
                                       const void* U, long long ldu, long long bsu, void* out, \
                                       long long ldo, long long bso, int B, int M, int N,     \
                                       int K, int* mode, void* stream) {                      \
    return launch<S>(A, lda, bsa, L, ldl, bsl, U, ldu, bsu, out, ldo, bso, B, M, N, K, mode,  \
                     stream);                                                                  \
  }
SCHUR_ENTRY(f32, float)
SCHUR_ENTRY(f64, double)
SCHUR_ENTRY(bf16, __nv_bfloat16)
SCHUR_ENTRY(f16, __half)

extern "C" const char* schur_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
