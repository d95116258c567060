// Fused TRSM -> Schur update:  U01 = L00^-1 R01,  out = A - L10 @ U01, for
// one system or a batch of B independent ones.
//
// Replaces: src/repro/kernels/fused_schur.py::fused_trsm_schur (bodies
// `_forward_solve` and `_kernel`) and ::fused_trsm_schur_batched (body
// `_batched_kernel`).  The TPU kernel walks column tiles outer and row tiles
// inner, solves each U01 tile once on the first row step and keeps it in
// VMEM for the others.  One kernel here serves both entry points, a single
// system being B = 1.  An output element's arithmetic does not depend on the
// batch, its tile's place or the block that runs it, so a batched lane
// equals the single call bit for bit.
//
// What bounds it on an H100: bytes.  On the main path A is [16384, 16384]
// and v = 32, so one call does 2 N N v = 17.2 GFLOP while it must read A and
// write the result once, 2.1 GB in f32: about 8 flop per byte, below the
// card's ratio of f32 peak to bandwidth (20).  The floor is ~0.64 ms per
// call at 3.35 TB/s; batched at (256, 512, 512, 32), ~0.18 ms.
//
// The first body gave each block a fixed [bm, bc] tile and ran its phases
// strictly in turn: the forward solve on one of its two row groups while
// the other waited, the L10 chunk staged with 4-byte loads, then A into
// registers, the products and the stores.  It took 0.3534 ms batched (50%
// of its floor) and 1.187 ms single (54%), held back by:
//   - no overlap: no block overlapped its stores or its products with the
//     next chunk's loads;
//   - waves: 1,024 blocks batched and 2,048 single, each grid ending in a
//     partial wave;
//   - redone solves: every block solved its own [v, bc] U01 tile, half its
//     threads idle at a barrier meanwhile.
// This body is a persistent, pipelined stream, the design of
// `schur_update.cu` with the solve folded in:
//   - a grid of one block an SM; block b walks a contiguous range of
//     32 x 256 output tiles, ordered (system, 256-column stripe, row tile)
//     with the row tile fastest.  A run of tiles of one (system, stripe) is
//     an item.  Per item the stripe's R01 [32, 256] and L00 [32, 32] arrive
//     by TMA into one of two pairs of buffers (the next item's land while
//     this one's last tiles run), and the block solves L00 U = R01 there in
//     place, one column a thread in registers; every row tile of the item
//     then reads U from shared memory.  A block whose range starts inside an
//     item solves that item too (the same operations, so the same bits);
//     only the block that holds the item's row tile 0 writes U01[:, stripe];
//   - a producer warp of its own issues every TMA copy beside 8 math warps:
//     A and L10 tiles into a ring of four stages on "full" mbarriers, each
//     result out of its stage by a TMA store once the math warps have
//     signalled the stage's "empty" mbarrier, a stage reloaded only after
//     its store has been read out (`cp.async.bulk.wait_group.read`), a U
//     buffer only after every tile of the item two back is done.  The math
//     warps never wait for one another within an item, only on the
//     barriers, and none of them stalls on a copy;
//   - the A loads and the stores carry an L2 evict-first policy, since each
//     byte passes once, so that L10, L00 and R01 stay in L2;
//   - the products stay on the CUDA cores in f32 (f64 for f64): TF32
//     `wgmma` would round L10 and U01 to 10-bit mantissas, another function,
//     and they fit under the bytes.  Each math warp owns a 32 x 32 block of
//     the tile, each thread 8 rows 4 apart by 4 adjacent columns; per k a
//     thread reads its 8 values of L10 from 128-byte rows swizzled as TMA's
//     128B mode lays them (conflict free, 4 values of k a load) and 4 values
//     of U (a broadcast across row groups).
// On an "NVIDIA H100 80GB HBM3" at 700 W this body takes 0.2350 ms batched
// (75% of its floor) and 0.7737 ms single (83%); with thread 0 of the math
// warps issuing the copies instead of a producer warp, 0.2414 and 0.8697 ms.
// Arithmetic, the same in every mode and as the first body's at every v:
// the solve's partial sum of row r starts from 0 and runs over ascending
// q < r, then x = R01 - partial, then an IEEE division when !unit; the
// update's accumulator starts from 0 and runs in ascending k over the whole
// v (one FMA chain, also over several chunks, and no zero-padding terms:
// a chunk of v < 32 stops at v), then out = A - acc in one subtraction.
//
// Edges: TMA needs 16-byte aligned bases and row and batch strides, and
// here v of at least 4 and at most one 128-byte chunk (32 in f32).  Where
// an operand misses that (an odd row stride, v = 31 or 33), and in f64, the
// same body takes plain loads: per item each thread solves its column into
// a local array (v up to 128) from L00 and R01 in device memory, and per
// tile the block loads A, then each chunk of L10 and of its U, into the same
// shared-memory layout and stores the result itself, without the pipeline,
// with the same arithmetic.  Ragged M, C and v are zero-filled and clipped
// (by TMA, or by the plain loads' masks), so any shape runs; the conflux
// step's windows of a wider matrix (row stride > C, bases a multiple of v
// columns in) take the TMA path.  R01 arrives pre-masked on the LU paths
// (zero before column c0 + v) and every column is still updated, so that a
// non-finite row of L10 reaches every column (NaN * 0 = NaN), as in the
// reference.  The order of the sum differs from a library GEMM's, so
// results agree with the plain version within a stated tolerance, not
// bitwise.
//
// bf16 and f16 (`storage.cuh`): the function is the Pallas kernel's: U01
// is solved in f32 and used in f32 for A - L10 @ U01, with exact products
// summed in f32, and each result is rounded once, to nearest even, where it
// is stored (`out`, and U01 itself).  Two bodies compute it:
//   - `fused_trsm_schur_wgmma_kernel`, a stream of its own (below), for
//     8 <= v <= 32 (one chunk; TMA's rows of at least 16 bytes), M > 0 and
//     operands that TMA takes in 2 bytes (16-byte aligned bases, row and
//     batch strides of whole 16-byte runs): every path's shape, the conflux
//     step's windows included;
//   - the plain loads of `fused_trsm_schur_kernel`, a template on the
//     storage type computing in compute_t<S>, for the rest (v = 1 or 33, an
//     odd row stride, v = 128): they widen every value as they load it into
//     the f32 layout in shared memory.  (`Smem::kRing` is 1 for 2-byte
//     storage, so that body never builds f32 tensor maps over 2-byte data.)
// The launcher reports which way a call went (`*mode`).
//
// The 2-byte stream.  On the LU path's [16384, 16384] at v = 32, one call
// must read A and write the result once, 1.07 GB in bf16, a floor of
// 0.32 ms at 3.35 TB/s, while it does 17.2 GFLOP: 0.26 ms on the CUDA
// cores' f32 FMAs, 80% of the floor, so the products and the copies would
// pace each other there.  The tensor cores take bf16 only: bf16 L10 times
// U01 rounded to bf16 is another function (the JAX "ref" backend's), and
// TF32 another again.  So U is split exactly into three bf16 parts, U = hi
// + mid + lo (`split3`: 8 + 8 + 8 significant bits cover f32's 24), and
// the tile takes one product of each part into one f32 accumulator; a
// product of two bf16 values is exact in f32, so only the order of the f32
// sum differs from the plain version's.  f16 L10 is split the same way into
// two bf16 parts (`split2`: f16 has 11 significant bits), hi in k 0-31 and
// lo in k 32-63 of the stage's L row, and a K = 64 product per part forms
// (L_hi + L_lo) U_part: 6 products a tile at v = 32 in bf16, 12 in f16,
// about 768 and 1,536 tensor-core clocks against ~4,500 for the tile's 64
// KB of copies.  The stream is the 2-byte `schur_update`'s
// (`schur_update.cu`) with the f32 stream's per-item solve folded in: one
// block an SM, 64 x 256 output tiles ordered (system, stripe, row tile)
// with the row tile fastest, a producer warp issuing every TMA copy and
// store, A in four 128-byte-swizzled boxes of 64 columns, evict-first on A
// and the results, a stage reloaded only once its store has been read out.
// Two consumer warpgroups run `wgmma` m64n128k16, each on half the tile's
// columns, so that one's epilogue runs beside the other's products.  Per
// item the stripe's R01 [v, 256] and L00 [v, v] arrive by TMA with its
// first tile (R01 into the lo part of one of two U buffers); the consumers
// widen them, solve L00 U = R01 in f32 in registers, one column a thread,
// with `solve_column`'s arithmetic, and write the parts over R01.  A block
// whose range starts inside an item solves it too; only the block that
// holds its row tile 0 writes U01.  Shared memory bounds the ring at three
// stages of 40 KB beside two 48 KB U buffers.  Non-finite values: a part
// that is 0 times an infinite value (of L10, or of U against f16 L10's lo)
// gives NaN where the whole values' product is infinite, so a tile whose
// L10 or U holds a non-finite value forms each NaN of its accumulator
// again from the whole values (`whole_dot`), and NaN and inf land where the
// plain version puts them.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums only: the driver call is looked up at run time
#include <cuda_runtime.h>

#include "once_per_device.cuh"
#include "storage.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 32;                   // rows of an output tile
constexpr int kBN = 256;                  // columns of an output tile: a stripe
constexpr int kMathThreads = kBM * kBN / 32;  // 8 warps, each a 32 x 32 block of the tile
constexpr int kThreads = kMathThreads + 32;   // and the producer warp
constexpr int kStages = 4;                // A + L10 tiles in the ring
constexpr int kRowBytes = 128;            // a row of an L10 chunk or of L00
constexpr int kMaxV = 128;                // the plain mode's solve keeps v values a thread

template <typename T>
struct Chunk {
  static constexpr int value = kRowBytes / sizeof(T);  // 32 in f32, 16 in f64
};

// One 16-byte run: four f32 or two f64 values.
template <typename T>
struct alignas(16) Run {
  T x[16 / sizeof(T)];
};

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle repeats
// every 8 rows), in the compute type T of storage type S: A [kBM][kBN] and
// L10 [kBM][128 B] per stage, then U [chunk][kBN] twice, then L00 [chunk]
// [128 B] twice, then a "full" and an "empty" mbarrier per stage.  The plain
// mode uses stage 0 and U buffer 0.
template <typename S>
struct Smem {
  using T = compute_t<S>;
  static constexpr uint32_t kA = kBM * kBN * sizeof(T);
  static constexpr uint32_t kL = kBM * kRowBytes;
  static constexpr uint32_t kU = Chunk<T>::value * kBN * sizeof(T);
  static constexpr uint32_t kL00 = Chunk<T>::value * kRowBytes;
  static constexpr uint32_t kStage = kA + kL;
  // Only f32 storage takes the TMA stream: f64, bf16 and f16 run the plain mode only.
  static constexpr int kRing = sizeof(S) == 4 ? kStages : 1;
  static constexpr uint32_t kUOff = kRing * kStage;
  static constexpr uint32_t kL00Off = kUOff + 2 * kU;
  static constexpr uint32_t kBars = kL00Off + 2 * kL00;
  static constexpr size_t kBytes = 1024 + kBars + 2 * kRing * 8;
  static_assert(kBytes <= 232448, "a block may use at most 227 KB of shared memory");
};

// A barrier of the math warps only (named barrier 1; the producer warp
// never takes part).
__device__ __forceinline__ void math_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMathThreads) : "memory");
}

// The byte offset of 16-byte run c of row m of an L10 chunk: TMA's 128B
// swizzle, which moves the runs of 8 consecutive rows onto distinct banks.
__device__ __forceinline__ int l_offset(int m, int c) {
  return m * kRowBytes + ((c ^ (m & 7)) << 4);
}

// Forward substitution for this thread's column x of U, in place, v <= one
// chunk: x[r] = x[r] - (sum over ascending q < r of L00[r][q] x[q], from 0),
// divided by L00[r][r] when !unit.  L00 is [chunk][128 B] in shared memory.
template <typename T>
__device__ __forceinline__ void solve_column(T (&x)[Chunk<T>::value], const T* L00, int v,
                                             int unit) {
  constexpr int kC = Chunk<T>::value;
  constexpr int kRun = 16 / sizeof(T);
#pragma unroll
  for (int r = 0; r < kC; ++r) {
    if (r >= v) break;
    T partial = T(0);
#pragma unroll
    for (int q0 = 0; q0 < r; q0 += kRun) {
      const Run<T> l = *reinterpret_cast<const Run<T>*>(L00 + r * kC + q0);
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (q0 + e < r) partial += l.x[e] * x[q0 + e];
      }
    }
    T xr = x[r] - partial;
    if (!unit) xr = xr / L00[r * kC + r];
    x[r] = xr;
  }
}

// The products of one chunk for this thread's 8 x 4 outputs, added to dot:
// rows row + 4 r (r < 8), columns col + c (c < 4); dot[r][c] += L10[row +
// 4 r][k] U[k][col + c] over ascending k < nk, one FMA at a time.  kFull
// says nk is the whole chunk.
template <typename T, bool kFull>
__device__ __forceinline__ void chunk_products(const unsigned char* Ls, const T* Us, int row,
                                               int col, int nk, T (&dot)[8][4]) {
  constexpr int kRun = 16 / sizeof(T);
#pragma unroll 2
  for (int kk = 0; kk < Chunk<T>::value; kk += kRun) {
    if (!kFull && kk >= nk) break;
    Run<T> l[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      l[r] = *reinterpret_cast<const Run<T>*>(Ls + l_offset(row + 4 * r, kk / kRun));
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (!kFull && kk + e >= nk) break;
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

template <typename T>
__device__ __forceinline__ void zero(T (&dot)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[r][c] = T(0);
  }
}

// a -= dot on this thread's outputs of the A tile in shared memory.
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
fused_trsm_schur_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_l00,
                        const __grid_constant__ CUtensorMap tm_r01,
                        const __grid_constant__ CUtensorMap tm_l10,
                        const __grid_constant__ CUtensorMap tm_out, Operand a_op, Operand l00_op,
                        Operand r01_op, Operand l10_op, St* __restrict__ out, int64_t ldo,
                        int64_t bso, St* __restrict__ U01, int64_t ldu, int64_t bsu, int nsys,
                        int M, int C, int v, int unit, int bulk) {
  using T = compute_t<St>;
  using S = Smem<St>;
  constexpr int kC = Chunk<T>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  // Math warp w owns the 32 x 32 block (w / (kBN / 32), w % (kBN / 32)) of
  // the tile; lane l in it the rows l / 8 + 4 r (r < 8) and the 4 columns
  // from (l % 8) * 4.  For the solve, math thread t owns column t of the
  // stripe.
  const int row = tid / 32 / (kBN / 32) * 32 + lane / 8;
  const int col = tid / 32 % (kBN / 32) * 32 + (lane % 8) * 4;

  // An item has at least one row tile, so that M = 0 still solves U01.
  const int nrt = M > 0 ? (M + kBM - 1) / kBM : 1;
  const int nst = (C + kBN - 1) / kBN;
  const int64_t tiles = static_cast<int64_t>(nsys) * nst * nrt;
  const int64_t t_begin = tiles * blockIdx.x / gridDim.x;
  const int64_t count = tiles * (blockIdx.x + 1) / gridDim.x - t_begin;
  const int64_t key0 = t_begin / nrt;  // (system, stripe) of the first tile
  T dot[8][4];

  if constexpr (sizeof(St) == 4) {
    if (bulk) {
      const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(base));
      const uint32_t full0 = smem0 + S::kBars;
      const uint32_t empty0 = full0 + 8 * kStages;
      if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
          mbar_init(full0 + 8 * s, 1);
          mbar_init(empty0 + 8 * s, kMathThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();

      if (tid >= kMathThreads) {
        if (tid > kMathThreads) return;
        // The producer: tile n into stage n % kStages once the store of
        // tile n - kStages has been read out, and with the R01 and L00 of a
        // new item q into buffer q % 2 once every tile of item q - 2 is
        // done.  `done` is the last tile whose products every math warp has
        // finished.
        const uint64_t stream_policy = evict_first_policy();
        int64_t next = 0;
        auto issue = [&](int64_t done) {
          for (; next < count && next <= done + kStages; ++next) {
            const int64_t tau = t_begin + next;
            const int64_t key = tau / nrt;
            const bool starts = next == 0 || tau % nrt == 0;
            if (starts && key - key0 >= 2 && key * nrt - nrt - t_begin > done + 1) break;
            const uint32_t stage = smem0 + (next % kStages) * S::kStage;
            const uint32_t bar = full0 + 8 * (next % kStages);
            const int row0 = static_cast<int>(tau % nrt) * kBM;
            const int col0 = static_cast<int>(key % nst) * kBN;
            const int z = static_cast<int>(key / nst);
            mbar_expect_tx(bar, S::kA + S::kL + (starts ? S::kU + S::kL00 : 0));
            tma_load_3d(stage, &tm_a, bar, col0, row0, z, stream_policy);
            tma_load_3d(stage + S::kA, &tm_l10, bar, 0, row0, z);
            if (starts) {
              const uint32_t b = static_cast<uint32_t>((key - key0) & 1);
              tma_load_3d(smem0 + S::kUOff + b * S::kU, &tm_r01, bar, col0, 0, z);
              tma_load_3d(smem0 + S::kL00Off + b * S::kL00, &tm_l00, bar, 0, 0, z);
            }
          }
        };
        issue(-1);
        for (int64_t n = 0; n < count; ++n) {
          const int64_t tau = t_begin + n;
          const int64_t key = tau / nrt;
          mbar_wait(empty0 + 8 * (n % kStages), static_cast<uint32_t>((n / kStages) & 1));
          tma_store_3d(&tm_out, smem0 + (n % kStages) * S::kStage,
                       static_cast<int>(key % nst) * kBN, static_cast<int>(tau % nrt) * kBM,
                       static_cast<int>(key / nst), stream_policy);
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          issue(n);
        }
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        return;
      }

      for (int64_t n = 0; n < count; ++n) {
        const int64_t tau = t_begin + n;
        const int64_t key = tau / nrt;
        unsigned char* stage = base + (n % kStages) * S::kStage;
        const int b = static_cast<int>((key - key0) & 1);
        T* Us = reinterpret_cast<T*>(base + S::kUOff + b * S::kU);
        mbar_wait(full0 + 8 * (n % kStages), static_cast<uint32_t>((n / kStages) & 1));
        if (n == 0 || tau % nrt == 0) {
          // A new item: R01 and L00 have landed with this tile.  Solve this
          // thread's column in place (rows from v on stay zero).
          T x[kC];
#pragma unroll
          for (int k = 0; k < kC; ++k) x[k] = Us[k * kBN + tid];
          solve_column<T>(x, reinterpret_cast<const T*>(base + S::kL00Off + b * S::kL00), v,
                          unit);
#pragma unroll
          for (int k = 0; k < kC; ++k) Us[k * kBN + tid] = x[k];
          const int c = static_cast<int>(key % nst) * kBN + tid;
          if (tau % nrt == 0 && c < C) {
            St* u = U01 + key / nst * bsu + c;
#pragma unroll
            for (int r = 0; r < kC; ++r) {
              if (r < v) u[r * ldu] = narrow<St>(x[r]);
            }
          }
          math_sync();
        }
        zero(dot);
        if (v == kC) {
          chunk_products<T, true>(stage + S::kA, Us, row, col, kC, dot);
        } else {
          chunk_products<T, false>(stage + S::kA, Us, row, col, v, dot);
        }
        subtract<T>(reinterpret_cast<T*>(stage), row, col, dot);
        // This warp's writes (and the solve's) before the TMA store and the
        // stage's next load.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * (n % kStages));
      }
      return;
    }
  }

  // Plain loads: one tile at a time through stage 0 and U buffer 0, by the
  // math warps.
  if (tid >= kMathThreads) return;
  constexpr int kRun = 16 / sizeof(T);
  T* As = reinterpret_cast<T*>(base);
  unsigned char* Ls = base + S::kA;
  T* Us = reinterpret_cast<T*>(base + S::kUOff);
  T x[kMaxV];  // this thread's column of the item's U
  for (int64_t n = 0; n < count; ++n) {
    const int64_t tau = t_begin + n;
    const int64_t key = tau / nrt;
    const int row0 = static_cast<int>(tau % nrt) * kBM;
    const int col0 = static_cast<int>(key % nst) * kBN;
    const int64_t z = key / nst;
    const int c = col0 + tid;
    if ((n == 0 || tau % nrt == 0) && c < C) {
      const St* L00 = static_cast<const St*>(l00_op.ptr) + z * l00_op.bs;
      const St* R01 = static_cast<const St*>(r01_op.ptr) + z * r01_op.bs;
      for (int r = 0; r < v; ++r) {
        T partial = T(0);
        for (int q = 0; q < r; ++q) partial += widen(L00[r * l00_op.ld + q]) * x[q];
        T xr = widen(R01[r * r01_op.ld + c]) - partial;
        if (!unit) xr = xr / widen(L00[r * l00_op.ld + r]);
        x[r] = xr;
      }
      if (tau % nrt == 0) {
        for (int r = 0; r < v; ++r) U01[z * bsu + r * ldu + c] = narrow<St>(x[r]);
      }
    }
    const St* A = static_cast<const St*>(a_op.ptr) + z * a_op.bs;
    const St* L10 = static_cast<const St*>(l10_op.ptr) + z * l10_op.bs;
    for (int idx = tid; idx < kBM * kBN; idx += kMathThreads) {
      const int m = idx / kBN;
      const int cc = idx % kBN;
      const bool in = row0 + m < M && col0 + cc < C;
      As[idx] = in ? widen(A[static_cast<int64_t>(row0 + m) * a_op.ld + col0 + cc]) : T(0);
    }
    zero(dot);
    for (int k0 = 0; k0 < v; k0 += kC) {
      for (int idx = tid; idx < kBM * kC; idx += kMathThreads) {
        const int m = idx / kC;
        const int k = idx % kC;
        const bool in = row0 + m < M && k0 + k < v;
        *reinterpret_cast<T*>(Ls + l_offset(m, k / kRun) + (k % kRun) * sizeof(T)) =
            in ? widen(L10[static_cast<int64_t>(row0 + m) * l10_op.ld + k0 + k]) : T(0);
      }
      for (int k = 0; k < kC; ++k) Us[k * kBN + tid] = k0 + k < v && c < C ? x[k0 + k] : T(0);
      math_sync();
      const int nk = v - k0 < kC ? v - k0 : kC;
      if (nk == kC) {
        chunk_products<T, true>(Ls, Us, row, col, nk, dot);
      } else {
        chunk_products<T, false>(Ls, Us, row, col, nk, dot);
      }
      math_sync();
    }
    subtract<T>(As, row, col, dot);
    math_sync();
    St* o = out + z * bso;
    for (int idx = tid; idx < kBM * kBN; idx += kMathThreads) {
      const int m = idx / kBN;
      const int cc = idx % kBN;
      if (row0 + m < M && col0 + cc < C)
        o[static_cast<int64_t>(row0 + m) * ldo + col0 + cc] = narrow<St>(As[idx]);
    }
    math_sync();
  }
}

// --------------------------------------------------------------------------
// bf16 and f16: a TMA + wgmma stream
// --------------------------------------------------------------------------

constexpr int kWRows = 64;              // rows of a 2-byte output tile: one m64 product
constexpr int kWBox = 64;               // columns of a box: one 128-byte swizzled row
constexpr int kWBoxes = kBN / kWBox;    // boxes of a 256-column stripe
constexpr int kWMinV = 8;               // v of at least 16 bytes, TMA's least row
constexpr int kWV = 32;                 // v of at most one chunk: U's rows in a buffer
constexpr int kWStages = 3;             // A + L10 tiles in the ring
constexpr int kWUBufs = 2;              // items whose U (and L00) are in shared memory
constexpr int kWGroups = 2;             // consumer warpgroups, each a 64 x kWN half tile
constexpr int kWN = kBN / kWGroups;     // columns of a warpgroup's products
constexpr int kWMath = 128 * kWGroups;  // the consumer threads
constexpr int kWCols = kBN / kWMath;    // columns of U that a consumer thread solves
constexpr int kWThreads = kWMath + 32;  // and the producer warp

// Shared memory, from a 1024-byte boundary (the 128-byte swizzle repeats
// every 8 rows): per stage A [4 boxes][64 rows][128 B] and L10 [64 rows]
// [128 B]; per item buffer U's three parts hi, mid and lo, each [4 boxes]
// [32 rows][128 B] (R01 lands in lo), then L00 [32][32] per item buffer;
// then a "full" and a "done" mbarrier per stage.
struct WSmem {
  static constexpr uint32_t kABox = kWRows * 128;
  static constexpr uint32_t kA = kWBoxes * kABox;
  static constexpr uint32_t kL = kWRows * 128;
  static constexpr uint32_t kStage = kA + kL;
  static constexpr uint32_t kPartBox = kWV * 128;
  static constexpr uint32_t kPart = kWBoxes * kPartBox;
  static constexpr uint32_t kU = 3 * kPart;
  static constexpr uint32_t kL00 = kWV * kWV * 2;
  static constexpr uint32_t kUOff = kWStages * kStage;
  static constexpr uint32_t kL00Off = kUOff + kWUBufs * kU;
  static constexpr uint32_t kBars = kL00Off + kWUBufs * kL00;
  static constexpr size_t kBytes = 1024 + kBars + 2 * kWStages * 8;
  static_assert(kBytes <= 232448, "a block may use at most 227 KB of shared memory");
};

// The byte offset of byte b of row m of a 128-byte-swizzled box.
__device__ __forceinline__ int sw128(int m, int b) {
  return m * 128 + ((((b >> 4) ^ m) & 7) << 4) + (b & 15);
}

// The bits of the bf16 value nearest to x (NaN stays NaN).
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The exact split of an f32 value u into three bf16 parts (their bits, in
// the low half of each word): hi is u with its low 16 bits cleared, r =
// u - hi, mid is r with its low 16 bits cleared, lo = r - mid.  Both
// subtractions are exact; every part that is not zero has u's sign
// (clearing bits truncates toward zero), and a part that is zero takes it
// too.  So hi + mid + lo rebuilds u bit for bit wherever |u| >= 2^-110 or
// u = +-0 (8 + 8 + 8 significant bits cover f32's 24; hi, a truncation,
// never rounds up past f32's largest value); below 2^-110, lo drops what
// lies under bf16's smallest subnormal, 2^-133.  Non-finite u goes whole
// into hi (inf stays inf, NaN stays NaN), with mid = lo = 0.
__device__ __forceinline__ void split3(float u, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(u);
  const uint32_t sign = b & 0x80000000u;
  const float r = u - __uint_as_float(b & 0xffff0000u);
  const uint32_t rb = __float_as_uint(r) & 0xffff0000u;
  const float l = r - __uint_as_float(rb);
  const bool fin = isfinite(u);
  hi = fin ? b >> 16 : bf16_bits(u);
  mid = fin ? (rb | sign) >> 16 : 0u;
  lo = fin ? (__float_as_uint(l) | sign) >> 16 : 0u;
}

// The same in two parts for an f16 value widened to f32 (11 significant
// bits): hi, its low 16 bits cleared, and lo = x - hi, exact and of at most
// 3 bits, so hi + lo rebuilds every finite f16 value, subnormals included.
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t b = __float_as_uint(x);
  const float l = x - __uint_as_float(b & 0xffff0000u);
  const bool fin = isfinite(x);
  hi = fin ? b >> 16 : bf16_bits(x);
  lo = fin ? (__float_as_uint(l) | (b & 0x80000000u)) >> 16 : 0u;
}

// This thread's share of a stage's L10 tile [64 rows][32 k]: its 16-byte
// runs t + i kWMath (row run / 4, k 8 (run % 4) on).  bf16 storage: whether
// any of its values is not finite.  f16 storage: the same, and each value
// split into bf16 parts (`split2`), hi over the value (k 0-31) and lo at
// k + 32, so that one product of K = 64 forms (L_hi + L_lo) U_part.
template <typename St>
__device__ __forceinline__ bool prepare_l10(unsigned char* Ls, int tid) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kWRows * 4 / kWMath; ++i) {
    const int run = tid + i * kWMath;
    const int m = run / 4;
    uint4* p = reinterpret_cast<uint4*>(Ls + sw128(m, 16 * (run % 4)));
    uint4 w = *p;
    uint32_t* x = reinterpret_cast<uint32_t*>(&w);
    if constexpr (std::is_same<St, __half>::value) {
      uint4 lo;
      uint32_t* y = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = Pair<__half>::widen(x[e]);
        uint32_t h0, l0, h1, l1;
        split2(f.x, h0, l0);
        split2(f.y, h1, l1);
        bad |= !isfinite(f.x) || !isfinite(f.y);
        x[e] = h0 | (h1 << 16);
        y[e] = l0 | (l1 << 16);
      }
      *p = w;
      *reinterpret_cast<uint4*>(Ls + sw128(m, 64 + 16 * (run % 4))) = lo;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bad |= (x[e] & 0x7f80u) == 0x7f80u || (x[e] & 0x7f800000u) == 0x7f800000u;
      }
    }
  }
  return bad;
}

// The per-item solve, in the consumer threads: thread t owns the kWCols
// columns from kWCols t of the stripe, 2 kWCols bytes of row k of U's box
// kWCols t / 64.  It widens its columns of R01 (from the lo part, where they
// landed; zero past C, `in`) and solves L00 U = R01 in f32 in registers
// with `solve_column`'s arithmetic, splits U into the three parts
// (`split3`) over R01, and, where `u01` is given, writes U01 rounded once.
// Returns whether any of its values of U is not finite.
template <typename St>
__device__ __forceinline__ bool solve_item(unsigned char* ub, const St* L00, int tid,
                                           const bool (&in)[kWCols], int v, int unit, St* u01,
                                           int64_t ldu) {
  const int box = kWCols * tid / kWBox;
  const int byte = 2 * (kWCols * tid % kWBox);
  unsigned char* lo = ub + 2 * WSmem::kPart;
  float x[kWCols][kWV];
#pragma unroll
  for (int k = 0; k < kWV; ++k) {
    const int o = box * WSmem::kPartBox + sw128(k, byte);
#pragma unroll
    for (int j = 0; j < kWCols; ++j)
      x[j][k] = in[j] ? widen(reinterpret_cast<const St*>(lo + o)[j]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kWV; ++r) {
    if (r >= v) break;
    float p[kWCols] = {};
#pragma unroll
    for (int q0 = 0; q0 < r; q0 += 8) {
      const uint4 run = *reinterpret_cast<const uint4*>(L00 + r * kWV + q0);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&run);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (q0 + e < r) {
          const float2 f = Pair<St>::widen(w[e / 2]);
          const float l = e % 2 ? f.y : f.x;
#pragma unroll
          for (int j = 0; j < kWCols; ++j) p[j] += l * x[j][q0 + e];
        }
      }
    }
    const float d = unit ? 1.f : widen(L00[r * kWV + r]);
#pragma unroll
    for (int j = 0; j < kWCols; ++j) {
      const float y = x[j][r] - p[j];
      x[j][r] = unit ? y : y / d;
    }
  }
  bool bad = false;
#pragma unroll
  for (int k = 0; k < kWV; ++k) {
    const int o = box * WSmem::kPartBox + sw128(k, byte);
#pragma unroll
    for (int j = 0; j < kWCols; ++j) {
      uint32_t h, m, l;
      split3(x[j][k], h, m, l);
      reinterpret_cast<uint16_t*>(ub + o)[j] = static_cast<uint16_t>(h);
      reinterpret_cast<uint16_t*>(ub + WSmem::kPart + o)[j] = static_cast<uint16_t>(m);
      reinterpret_cast<uint16_t*>(lo + o)[j] = static_cast<uint16_t>(l);
      bad |= !isfinite(x[j][k]);
    }
  }
  if (u01 != nullptr) {
#pragma unroll
    for (int r = 0; r < kWV; ++r) {
      if (r >= v) break;
#pragma unroll
      for (int j = 0; j < kWCols; ++j) {
        if (in[j]) u01[r * ldu + j] = narrow<St>(x[j][r]);
      }
    }
  }
  return bad;
}

// Row m, column c of the product L10 U with the whole values, rebuilt
// exactly from the parts in shared memory (L10 = hi + lo in f16, U = hi +
// mid + lo), summed in an FMA chain over ascending k < v from 0.
template <typename St>
__device__ __forceinline__ float whole_dot(const unsigned char* Ls, const unsigned char* ub, int m,
                                           int c, int v) {
  const unsigned char* u = ub + (c / kWBox) * WSmem::kPartBox;
  const int cb = 2 * (c % kWBox);
  float s = 0.f;
#pragma unroll 1
  for (int k = 0; k < v; ++k) {
    float l = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m, 2 * k)));
    if constexpr (std::is_same<St, __half>::value) {
      l += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m, 64 + 2 * k)));
    } else {
      static_assert(std::is_same<St, __nv_bfloat16>::value, "2-byte storage only");
    }
    const int o = sw128(k, cb);
    const float hi = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(u + o));
    const float mid =
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(u + WSmem::kPart + o));
    const float lo =
        __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(u + 2 * WSmem::kPart + o));
    s += l * ((hi + mid) + lo);
  }
  return s;
}

// Whether x is set in any consumer thread: a barrier of the kWMath of them
// (named barrier 1; the producer warp never takes part).
__device__ __forceinline__ bool math_any(bool x) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, 1, %2, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(x)), "n"(kWMath)
      : "memory");
  return r != 0;
}

// KS = ceil(v / 16) k16 steps a part.
template <typename St, int KS>
__global__ void __launch_bounds__(kWThreads, 1)
fused_trsm_schur_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_l00,
                              const __grid_constant__ CUtensorMap tm_r01,
                              const __grid_constant__ CUtensorMap tm_l10,
                              const __grid_constant__ CUtensorMap tm_out, St* __restrict__ U01,
                              int64_t ldu, int64_t bsu, int nsys, int M, int C, int v, int unit) {
  using W = WSmem;
  // f16 L10 takes two K = 32 halves (hi, lo) of the stage's L row a part.
  constexpr int kHalves = std::is_same<St, __half>::value ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t smem0 = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (smem0 - raw);
  const uint32_t full0 = smem0 + W::kBars;
  const uint32_t done0 = full0 + 8 * kWStages;
  const int tid = threadIdx.x;

  const int nrt = (M + kWRows - 1) / kWRows;
  const int nst = (C + kBN - 1) / kBN;
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
    // n - kWStages has been read out, and with the R01 and L00 of a new
    // item q into buffer q % kWUBufs once every tile of item q - kWUBufs is
    // done.  `done` is the last tile whose result the consumer has written.
    // Boxes wholly past C are neither loaded nor stored.
    const uint64_t stream_policy = evict_first_policy();
    int64_t next = 0;
    auto issue = [&](int64_t done) {
      for (; next < count && next <= done + kWStages; ++next) {
        const int64_t tau = t_begin + next;
        const int64_t key = tau / nrt;
        const bool starts = next == 0 || tau % nrt == 0;
        if (starts && key - key0 >= kWUBufs && (key - kWUBufs + 1) * nrt - 1 - t_begin > done)
          break;
        const uint32_t stage = smem0 + (next % kWStages) * W::kStage;
        const uint32_t bar = full0 + 8 * (next % kWStages);
        const int row0 = static_cast<int>(tau % nrt) * kWRows;
        const int col0 = static_cast<int>(key % nst) * kBN;
        const int z = static_cast<int>(key / nst);
        const int boxes = min(kWBoxes, (C - col0 + kWBox - 1) / kWBox);
        mbar_expect_tx(bar, boxes * W::kABox + W::kL +
                                (starts ? boxes * W::kPartBox + W::kL00 : 0));
        for (int b = 0; b < boxes; ++b)
          tma_load_3d(stage + b * W::kABox, &tm_a, bar, col0 + b * kWBox, row0, z, stream_policy);
        tma_load_3d(stage + W::kA, &tm_l10, bar, 0, row0, z);
        if (starts) {
          const uint32_t q = static_cast<uint32_t>((key - key0) % kWUBufs);
          const uint32_t lo = smem0 + W::kUOff + q * W::kU + 2 * W::kPart;
          for (int b = 0; b < boxes; ++b)
            tma_load_3d(lo + b * W::kPartBox, &tm_r01, bar, col0 + b * kWBox, 0, z);
          tma_load_3d(smem0 + W::kL00Off + q * W::kL00, &tm_l00, bar, 0, 0, z);
        }
      }
    };
    issue(-1);
    for (int64_t n = 0; n < count; ++n) {
      const int64_t tau = t_begin + n;
      const int64_t key = tau / nrt;
      const int row0 = static_cast<int>(tau % nrt) * kWRows;
      const int col0 = static_cast<int>(key % nst) * kBN;
      const int boxes = min(kWBoxes, (C - col0 + kWBox - 1) / kWBox);
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

  // The consumers: warpgroup g takes the tile's columns from g kWN on.
  // Thread t of it holds accumulator pairs 2j, 2j + 1 at row 16 (t / 32) +
  // (t % 32) / 4 + 8 (j % 2), columns g kWN + 8 (j / 2) + 2 (t % 4) and one
  // more; in the swizzled A tile that pair lies in box g kWN / 64 + j / 16,
  // at byte 4 (t % 4) of 16-byte run ((j / 2) % 8) ^ ((t % 32) / 4) of its
  // row.
  const int lane = tid % 32;
  const int group = tid / 128;
  const int gcol = group * kWN;  // the group's first column
  const uint32_t row_off = (16 * (tid % 128 / 32) + lane / 4) * 128 + 4 * (lane % 4);
  const int swz = lane / 4;
  float acc[kWN / 2];
  bool item_bad = false;  // a value of the item's U is not finite
  for (int64_t n = 0; n < count; ++n) {
    const int64_t tau = t_begin + n;
    const int64_t key = tau / nrt;
    const int s = static_cast<int>(n % kWStages);
    const int q = static_cast<int>((key - key0) % kWUBufs);
    const uint32_t stage = smem0 + s * W::kStage;
    const uint32_t u = smem0 + W::kUOff + q * W::kU;
    unsigned char* const ub = base + W::kUOff + q * W::kU;
    unsigned char* const Ls = base + s * W::kStage + W::kA;
    const int row0 = static_cast<int>(tau % nrt) * kWRows;
    const int col0 = static_cast<int>(key % nst) * kBN;
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>((n / kWStages) & 1));
    const bool starts = n == 0 || tau % nrt == 0;
    if (starts) {
      // A new item: R01 and L00 have landed with this tile.
      const int c = col0 + kWCols * tid;
      St* const u01 = tau % nrt == 0 ? U01 + key / nst * bsu + c : nullptr;
      bool in[kWCols];
#pragma unroll
      for (int j = 0; j < kWCols; ++j) in[j] = c + j < C;
      item_bad = solve_item<St>(ub, reinterpret_cast<const St*>(base + W::kL00Off + q * W::kL00),
                                tid, in, v, unit, u01, ldu);
    }
    bool bad = prepare_l10<St>(Ls, tid) || item_bad;
    // The solve's and the split's writes before the products read them.
    if (starts || kHalves == 2) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bad = math_any(bad);
    fresh(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          // k16 step kk of half h: 32 bytes into L10's 128-byte rows; 16
          // rows of part p's boxes from the group's.
          mma_ss_t<kWN, __nv_bfloat16>(
              acc, sw128_desc(stage + W::kA + h * 64 + kk * 32, 16, 1024),
              sw128_desc(u + p * W::kPart + gcol / kWBox * W::kPartBox + kk * 2048, W::kPartBox,
                         1024),
              p + h + kk > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    if (bad) {
      // A part that is 0 times an infinite value of L10 or U gives NaN where
      // the whole values' product is infinite: form each NaN of the
      // accumulator again from the whole values (a NaN there is NaN in the
      // plain version too).  The accumulators pass through a local array,
      // so that this rare path is a loop and holds no registers elsewhere.
      float sums[kWN / 2];
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) sums[i] = acc[i];
#pragma unroll 1
      for (int i = 0; i < kWN / 2; ++i) {
        const int m = 16 * (tid % 128 / 32) + lane / 4 + 8 * ((i / 2) % 2);
        const int c = gcol + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (isnan(sums[i]) && row0 + m < M && col0 + c < C)
          sums[i] = whole_dot<St>(Ls, ub, m, c, v);
      }
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) acc[i] = sums[i];
    }
    unsigned char* const a = base + s * W::kStage + gcol / kWBox * W::kABox;
#pragma unroll
    for (int j = 0; j < kWN / 4; ++j) {
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
int launch_wgmma(const void* A, long long lda, long long bsa, const void* L00, long long ldl,
                 long long bsl, const void* R01, long long ldr, long long bsr, const void* L10,
                 long long ld10, long long bs10, void* out, long long ldo, long long bso,
                 void* U01, long long ldu, long long bsu, int B, int M, int C, int v, int unit,
                 cudaStream_t stream) {
  static OncePerDevice<> limit;
  int sms = 0;
  const cudaError_t err = limit.get(
      [](int dev, int* n) {
        const cudaError_t e = cudaFuncSetAttribute(fused_trsm_schur_wgmma_kernel<S, KS>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(WSmem::kBytes));
        return e != cudaSuccess ? e
                                : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
      },
      &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_a{}, tm_l00{}, tm_r01{}, tm_l10{}, tm_out{};
  if (!(tensor_map<S>(&tm_a, A, lda, bsa, B, M, C, kWRows, kWBox, kSw) &&
        tensor_map<S>(&tm_l00, L00, ldl, bsl, B, v, v, kWV, kWV, CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tensor_map<S>(&tm_r01, R01, ldr, bsr, B, v, C, kWV, kWBox, kSw) &&
        tensor_map<S>(&tm_l10, L10, ld10, bs10, B, M, v, kWRows, kWBox, kSw) &&
        tensor_map<S>(&tm_out, out, ldo, bso, B, M, C, kWRows, kWBox, kSw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles =
      static_cast<int64_t>(B) * ((M + kWRows - 1) / kWRows) * ((C + kBN - 1) / kBN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_trsm_schur_wgmma_kernel<S, KS><<<grid, kWThreads, WSmem::kBytes, stream>>>(
      tm_a, tm_l00, tm_r01, tm_l10, tm_out, static_cast<S*>(U01), ldu, bsu, B, M, C, v, unit);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const void* A, long long lda, long long bsa, const void* L00, long long ldl,
           long long bsl, const void* R01, long long ldr, long long bsr, const void* L10,
           long long ld10, long long bs10, void* out, long long ldo, long long bso, void* U01,
           long long ldu, long long bsu, int B, int M, int C, int v, int unit, int* mode,
           void* stream) {
  constexpr int kC = Chunk<compute_t<S>>::value;
  *mode = 0;
  const int64_t tiles =
      static_cast<int64_t>(B) * (M > 0 ? (M + kBM - 1) / kBM : 1) * ((C + kBN - 1) / kBN);
  if (tiles == 0) return static_cast<int>(cudaSuccess);

  // 2-byte storage: the wgmma stream wherever 8 <= v <= 32, M > 0 and TMA
  // takes every operand, decided by that rule alone; else the plain loads.
  if constexpr (sizeof(S) == 2) {
    if (v >= kWMinV && v <= kWV && M > 0 && tma_fits<S>(A, lda, bsa, B, M, C) &&
        tma_fits<S>(L00, ldl, bsl, B, v, v) && tma_fits<S>(R01, ldr, bsr, B, v, C) &&
        tma_fits<S>(L10, ld10, bs10, B, M, v) && tma_fits<S>(out, ldo, bso, B, M, C)) {
      *mode = 2;
      if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
      const auto st = static_cast<cudaStream_t>(stream);
      return v <= 16 ? launch_wgmma<S, 1>(A, lda, bsa, L00, ldl, bsl, R01, ldr, bsr, L10, ld10,
                                          bs10, out, ldo, bso, U01, ldu, bsu, B, M, C, v, unit, st)
                     : launch_wgmma<S, 2>(A, lda, bsa, L00, ldl, bsl, R01, ldr, bsr, L10, ld10,
                                          bs10, out, ldo, bso, U01, ldu, bsu, B, M, C, v, unit, st);
    }
  }

  // The limit is raised, and the SMs counted, once per device.
  static OncePerDevice<> limit;
  int sms = 0;
  const cudaError_t err = limit.get(
      [](int dev, int* n) {
        const cudaError_t e = cudaFuncSetAttribute(fused_trsm_schur_kernel<S>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(Smem<S>::kBytes));
        return e != cudaSuccess ? e
                                : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
      },
      &sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  // TMA for f32 storage with v within one chunk (every f32 path's shape),
  // else plain loads: f64 always, bf16 and f16 where the stream above does
  // not take the operands.
  CUtensorMap tm_a{}, tm_l00{}, tm_r01{}, tm_l10{}, tm_out{};
  const int bulk =
      sizeof(S) == 4 && v <= kC && M > 0 &&
      tensor_map<float>(&tm_a, A, lda, bsa, B, M, C, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map<float>(&tm_l00, L00, ldl, bsl, B, v, v, kC, kC, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map<float>(&tm_r01, R01, ldr, bsr, B, v, C, kC, kBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map<float>(&tm_l10, L10, ld10, bs10, B, M, v, kBM, kC, CU_TENSOR_MAP_SWIZZLE_128B) &&
      tensor_map<float>(&tm_out, out, ldo, bso, B, M, C, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  *mode = bulk;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_trsm_schur_kernel<S><<<grid, kThreads, Smem<S>::kBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_l00, tm_r01, tm_l10, tm_out, Operand{A, lda, bsa},
      Operand{L00, ldl, bsl}, Operand{R01, ldr, bsr}, Operand{L10, ld10, bs10},
      static_cast<S*>(out), ldo, bso, static_cast<S*>(U01), ldu, bsu, B, M, C, v, unit, bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B systems: A [M, C], L00 [v, v], R01 [v, C], L10 [M, v], out [M, C],
// U01 [v, C], all of one element type (the entry's suffix), each with the
// given row stride, batch stride and unit column stride (a single system is
// B = 1), 1 <= v <= 128.  Sets *mode to 1 where f32 operands took the TMA
// stream, 2 where bf16 or f16 ones took the wgmma stream, 0 where they took
// plain loads (always for f64).  Returns the cudaError_t of the launch.
#define FUSED_ENTRY(suffix, S)                                                                  \
  extern "C" int fused_trsm_schur_##suffix(                                                    \
      const void* A, long long lda, long long bsa, const void* L00, long long ldl,              \
      long long bsl, const void* R01, long long ldr, long long bsr, const void* L10,           \
      long long ld10, long long bs10, void* out, long long ldo, long long bso, void* U01,      \
      long long ldu, long long bsu, int B, int M, int C, int v, int unit, int* mode,           \
      void* stream) {                                                                          \
    return launch<S>(A, lda, bsa, L00, ldl, bsl, R01, ldr, bsr, L10, ld10, bs10, out, ldo, bso, \
                     U01, ldu, bsu, B, M, C, v, unit, mode, stream);                           \
  }
FUSED_ENTRY(f32, float)
FUSED_ENTRY(f64, double)
FUSED_ENTRY(bf16, __nv_bfloat16)
FUSED_ENTRY(f16, __half)

extern "C" const char* fused_schur_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
