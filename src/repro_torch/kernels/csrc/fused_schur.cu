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
// bf16 and f16 (`storage.cuh`): the kernel is a template on the storage type
// S of every operand and computes in compute_t<S> (f32 for both), as the
// Pallas kernel does: U01 is solved in f32 and used in f32 for
// A - L10 @ U01, and each result is rounded once, to nearest even, where it
// is stored (`out`, and U01 itself).  The TMA stream is chosen by the
// storage size (`Smem::kRing`, `bulk`), so 2-byte storage takes the plain
// loads, which widen every value as they load it into the f32 layout in
// shared memory; f32 tensor maps are never built over 2-byte data.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the driver call is looked up at run time
#include <cuda_runtime.h>

#include "once_per_device.cuh"
#include "storage.cuh"
#include "tma.cuh"

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

// An L2 policy that evicts first what it tags: the streamed A tiles and the
// results, which are read or written once, so that L10, L00 and R01 stay in
// L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// One box of a 3-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The same, tagged with an L2 policy.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "l"(policy)
      : "memory");
}

// One box from shared memory into a 3-D tensor map (clipped at its edges),
// as a bulk group of its own, tagged with an L2 policy.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3, %4}], [%1], %5;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

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

// A 3-D f32 map over [nsys, rows, cols] (innermost first) with row stride ld
// and batch stride bs (elements), read or written in boxes of box_rows x
// box_cols of one system.  False where TMA cannot take the operand: a base
// or stride off a 16-byte boundary, or a map the driver refuses.
bool f32_map(CUtensorMap* map, const void* ptr, int64_t ld, int64_t bs, int nsys, int rows,
             int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (nsys == 1) bs = ld * rows;  // any stride will do for a single system
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 || ld % 4 || bs % 4 || bs <= 0 ||
      cols < 4) {
    return false;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(nsys)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4, static_cast<cuuint64_t>(bs) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  // else plain loads: f64, bf16 and f16 storage always.
  CUtensorMap tm_a{}, tm_l00{}, tm_r01{}, tm_l10{}, tm_out{};
  const int bulk =
      sizeof(S) == 4 && v <= kC && M > 0 &&
      f32_map(&tm_a, A, lda, bsa, B, M, C, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      f32_map(&tm_l00, L00, ldl, bsl, B, v, v, kC, kC, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      f32_map(&tm_r01, R01, ldr, bsr, B, v, C, kC, kBN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      f32_map(&tm_l10, L10, ld10, bs10, B, M, v, kBM, kC, CU_TENSOR_MAP_SWIZZLE_128B) &&
      f32_map(&tm_out, out, ldo, bso, B, M, C, kBM, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
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
// B = 1), 1 <= v <= 128.  Sets *mode to 1 where the operands took the TMA
// stream, 0 where they took plain loads (always for f64, bf16 and f16).
// Returns the cudaError_t of the launch.
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
