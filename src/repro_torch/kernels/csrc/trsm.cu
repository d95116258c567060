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
// grid and keeps U and a [br, v] tile in VMEM.  Here each thread owns one
// row of one system (blockIdx.z).  The first body (kept below as
// `trsm_right_upper_smem_kernel`) took 19.7 us at [16384, 32], 16x its
// floor, for three reasons:
//   - too little parallel work: 64 threads a block, so about four warps an
//     SM at [16384, 32], and nothing hid a memory latency;
//   - a serial chain per row: each column's sum was a dependent FMA chain
//     fed from shared memory, then a division, about 530 dependent steps;
//   - a round trip through shared memory: B in and X out through a tile,
//     with 4-byte accesses, index divisions and two barriers.
// For v <= 32 (every path's v), `trsm_right_upper_reg_kernel`, the
// transposed form of trsm_left_lower's register body:
//   - a thread holds its row in registers for the whole solve.  Where the
//     row stride and base allow 16-byte loads (the paths' [N, v] panels), a
//     warp loads its 32 rows together, each load instruction covering whole
//     rows (128-byte rows of v = 32 in f32, 64-byte ones in bf16 and f16),
//     all loads issued before anything waits on one, and the rows pass to
//     their threads through a swizzled tile in shared memory; else each
//     thread loads its own row, one value a load;
//   - U's upper triangle and diagonal go to shared memory once per block,
//     read with any strides in the order of U's unit stride so that the
//     loads coalesce (the Cholesky path passes L00^T, the LU conflux path
//     U00 as it is), every staging load issued before the first store;
//   - column by column: once x[j] is final, every later column m takes its
//     term x[j] U[j][m], so a step's FMAs are independent of each other and
//     the warp reads each 16-byte run of U's row j at once (a broadcast).
//     Each partial[m] still grows in ascending j, one FMA at a time from 0,
//     then x[m] = (x[m] - partial[m]) / U[m][m] with IEEE division: the
//     terms, order and rounding of the first body's row sweep, so X has the
//     same bits as before (checked on the card against that body);
//   - X leaves from registers back through a swizzled tile, a warp's
//     16-byte stores covering whole rows (one value a store where v is not
//     a multiple of the run).  In exploratory calls on the card this was
//     faster than each thread storing its own row in 16-byte runs, most at
//     the batched shape, and the warp's loads were faster than per-thread
//     ones for the same reason: a per-thread run of a 128-byte row puts 32
//     rows, 32 cache lines, into every load and store instruction.
// Rows that are zero in B are solved like any other, so a zero or NaN on
// U's diagonal gives NaN in them as in the plain version.  Their zero
// dividends would send every division of their warp down the IEEE
// division's slow path (the paths' panels are zero above the trailing
// block, so from none to nearly all of the rows, and the first body paid
// for that on every call); where the quotient of a zero is exact without
// the division it is taken by a multiplication, same bits.  kRightRows = 128
// threads (rows) a block: at [16384, 32] that is 128 blocks, one an SM; it
// was faster than 64-thread blocks there in exploratory calls on the card
// and as fast at [256, 512, 32], and in bf16 and f16 faster than 64- and
// 32-row blocks at both shapes (`tools/trsm_variants.py`).  About two
// thirds of a call at [16384, 32] is the solve's dependent chain, one warp
// to a scheduler (the same tool's `no_solve`).  f64 at v = 32 runs the
// same body without spills (ptxas: about 200 registers).  v > 32, off
// every path, keeps the shared-memory body.
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
//
// bf16 and f16 (`storage.cuh`): every body is a template on the storage type
// St of B, the triangle and X, and computes in T = compute_t<St> (f32 for
// both), as the Pallas kernels do: each value widens exactly as it is
// loaded, the rows (columns), the staged triangle, the partial sums and the
// zero-dividend test are in T, so a solve runs the f32 body's operations in
// its order, and each result is rounded once, to nearest even, as it is
// stored.  The right solve's register body moves 2-byte rows as it moves
// f32 ones: a warp's 16-byte loads take runs of 8 values, 4 to a row of
// v = 32, so one load instruction covers 8 whole rows (512 contiguous bytes
// of the paths' panels), and each run widens exactly into two f32 runs of
// the swizzled f32 tile Ws, from which each thread reads its row as in f32.
// On the way out each thread narrows its row once, into runs of 8 values
// that it writes to its own row of Ws at the slots `slot2` gives (two rows'
// runs of one instruction meet all eight 16-byte bank groups), and the
// warp's 16-byte stores cover 8 whole rows of X each.  Only the route of the
// values through memory differs from one value a load and a store; the
// conversions and the solve are the same, and so are the bits.  The left
// solve's bodies load and store one 2-byte value a thread and access, as
// in f32 (neighbouring threads on neighbouring columns).

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "once_per_device.cuh"
#include "storage.cuh"

namespace {

constexpr int kRows = 64;  // rows (threads) per block of the shared-memory body
constexpr int kMaxV = 128;
constexpr int kRegV = 32;         // v up to which a thread keeps its row (column) in registers
constexpr int kRightRows = 128;   // rows (threads) per block of the right solve's register body

// One 16-byte run: four f32 or two f64 values (of the compute type).
template <typename T>
struct alignas(16) Run {
  T x[16 / sizeof(T)];
};

// v itself, hidden from the optimizer.
__device__ __forceinline__ float opaque(float v) {
  asm("" : "+f"(v));
  return v;
}
__device__ __forceinline__ double opaque(double v) {
  asm("" : "+d"(v));
  return v;
}

// The 16-byte slot, of the 8 in a 128-byte row of Ws, where the 2-byte
// body's stores put run c (values 8c..8c+7) of row r: within the row, so a
// thread writes only where it read; the 8 rows that 8 lanes write of one run
// take 8 slots, and rows 2k and 2k + 1, which a quarter of the warp's
// global stores read together, take slots 0-3 and 4-7.
__device__ __forceinline__ int slot2(int c, int r) { return (c ^ (r >> 1 & 3)) + 4 * (r & 1); }

// The 2-byte value in the low (hi = false) or high half of a 32-bit word.
template <typename St>
__device__ __forceinline__ St half_of(uint32_t w, bool hi) {
  const uint16_t b = static_cast<uint16_t>(hi ? w >> 16 : w);
  return *reinterpret_cast<const St*>(&b);
}

// Two 2-byte values as one word, the first in the low half.
template <typename St>
__device__ __forceinline__ uint32_t word_of(St lo, St hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16;
}

// St: the storage type.  vec_in: B's base, row and batch strides and v are
// whole 16-byte runs of St (the launcher's rule), and a warp loads its rows
// together.  The 2-byte paths are compiled for 2-byte storage only.
template <typename St>
__global__ void __launch_bounds__(kRightRows)
trsm_right_upper_reg_kernel(const St* __restrict__ B, int64_t ldb, int64_t bsb,
                            const St* __restrict__ U, int64_t ldu_r, int64_t ldu_c, int64_t bsu,
                            St* __restrict__ X, int R, int v, int vec_in) {
  using T = compute_t<St>;
  constexpr bool kTwo = sizeof(St) == 2;       // bf16 and f16 rows; else f32 and f64 ones
  constexpr int kRun = 16 / sizeof(T);
  constexpr int kRowRuns = kRegV / kRun;       // 16-byte runs of a row: 8 in f32, 16 in f64
  constexpr int kRowsAtOnce = 32 / kRowRuns;   // rows a warp's 16-byte access covers
  constexpr int kRun2 = 8;                     // 2-byte values in a 16-byte run
  constexpr int kRowRuns2 = kRegV / kRun2;     // 16-byte runs of a 2-byte row: 4
  constexpr int kRowsAtOnce2 = 32 / kRowRuns2; // 2-byte rows a warp's 16-byte access covers: 8
  // Us[j][m] = U[j][m] for j <= m < v; 1 on the diagonal past v (the padded
  // columns then solve to 0); 0 elsewhere.  Each warp's 32 rows pass
  // through Ws.  Both hold rows of kRegV values whose 16-byte runs are
  // swizzled (run c of row r at run c ^ (r & 7)), so that 8 lanes reading or
  // writing one run of 8 rows, or one value of 8 rows, meet distinct banks.
  __shared__ __align__(16) T Us[kRegV * kRegV];
  __shared__ __align__(16) T Ws[kRightRows * kRegV];
  const auto at = [](int r, int m) {
    return r * kRegV + ((m / kRun) ^ (r & 7)) * kRun + m % kRun;
  };

  const int64_t z = blockIdx.z;
  B += z * bsb;
  U += z * bsu;
  X += z * static_cast<int64_t>(R) * v;
  const int lane = threadIdx.x % 32;
  const int warp_row0 = blockIdx.x * kRightRows + threadIdx.x / 32 * 32;
  const int row = blockIdx.x * kRightRows + threadIdx.x;
  T* ws = Ws + threadIdx.x / 32 * 32 * kRegV;

  // The warp's 32 rows, every load issued before anything waits on one:
  // with 16-byte loads, lane l takes run l % kRowRuns of rows
  // l / kRowRuns + i kRowsAtOnce, so one load instruction covers whole
  // 128-byte rows (in 2 bytes, run l % 4 of rows l / 4 + 8 i, 8 whole rows
  // an instruction, the raw bits held in runs[i] until they widen); else
  // one value a load of the thread's own row.
  Run<T> runs[kRowRuns];
  T x[kRegV];
  if (vec_in) {
    if constexpr (kTwo) {
#pragma unroll
      for (int i = 0; i < kRowRuns2; ++i) {
        const int r = lane / kRowRuns2 + i * kRowsAtOnce2;
        const int c = lane % kRowRuns2;
#pragma unroll
        for (int e = 0; e < kRun; ++e) runs[i].x[e] = T(0);
        if (warp_row0 + r < R && c * kRun2 < v)
          runs[i] = *reinterpret_cast<const Run<T>*>(
              B + static_cast<int64_t>(warp_row0 + r) * ldb + c * kRun2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRowRuns; ++i) {
        const int r = lane / kRowRuns + i * kRowsAtOnce;
        const int c = lane % kRowRuns;
#pragma unroll
        for (int e = 0; e < kRun; ++e) runs[i].x[e] = T(0);
        if (warp_row0 + r < R && c * kRun < v)
          runs[i] = *reinterpret_cast<const Run<T>*>(
              reinterpret_cast<const T*>(B) + static_cast<int64_t>(warp_row0 + r) * ldb +
              c * kRun);
      }
    }
  } else {
    const St* b = B + static_cast<int64_t>(row) * ldb;
#pragma unroll
    for (int m = 0; m < kRegV; ++m) x[m] = row < R && m < v ? widen(b[m]) : T(0);
  }

  // U's upper triangle: this thread's elements idx = threadIdx.x + i *
  // kRightRows, taken in the order of U's unit stride so that a warp's loads
  // coalesce (the Cholesky path's L00^T has unit row stride), all loads
  // issued before the first store.
  constexpr int kStage = kRegV * kRegV / kRightRows;
  const bool by_rows = ldu_c == 1;
  T staged[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int idx = threadIdx.x + i * kRightRows;
    const int j = by_rows ? idx / kRegV : idx % kRegV;
    const int m = by_rows ? idx % kRegV : idx / kRegV;
    staged[i] = j <= m && m < v ? widen(U[j * ldu_r + m * ldu_c]) : T(j == m ? 1 : 0);
  }
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int idx = threadIdx.x + i * kRightRows;
    const int j = by_rows ? idx / kRegV : idx % kRegV;
    const int m = by_rows ? idx % kRegV : idx / kRegV;
    Us[at(j, m)] = staged[i];
  }
  if (vec_in) {
    if constexpr (kTwo) {
      // Each 2-byte run widens exactly (`widen`, as one value a load does)
      // into the two f32 runs of its values.
#pragma unroll
      for (int i = 0; i < kRowRuns2; ++i) {
        const int r = lane / kRowRuns2 + i * kRowsAtOnce2;
        const int m = lane % kRowRuns2 * kRun2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Run<T> run;
#pragma unroll
          for (int e = 0; e < kRun; ++e)
            run.x[e] = widen(half_of<St>(__float_as_uint(runs[i].x[2 * h + e / 2]), e % 2));
          *reinterpret_cast<Run<T>*>(ws + at(r, m + h * kRun)) = run;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRowRuns; ++i) {
        const int r = lane / kRowRuns + i * kRowsAtOnce;
        *reinterpret_cast<Run<T>*>(ws + at(r, lane % kRowRuns * kRun)) = runs[i];
      }
    }
  }
  __syncthreads();
  if (vec_in) {
#pragma unroll
    for (int c = 0; c < kRowRuns; ++c) {
      const Run<T> run = *reinterpret_cast<const Run<T>*>(ws + at(lane, c * kRun));
#pragma unroll
      for (int e = 0; e < kRun; ++e) x[c * kRun + e] = run.x[e];
    }
  }

  T partial[kRegV];
#pragma unroll
  for (int m = 0; m < kRegV; ++m) partial[m] = T(0);
#pragma unroll
  for (int j = 0; j < kRegV; ++j) {
    // The IEEE division takes a slow path for a zero dividend, which every
    // zero row of B meets at every column.  There the quotient needs no
    // division: +-0 over a finite nonzero divisor is +-0 with the sign of
    // their product, which is what num * den gives.  So a zero dividend over
    // such a divisor is multiplied and 1 is divided in its place (`opaque`,
    // or the compiler, seeing the quotient unused there, divides num after
    // all); any other divisor (0, inf or NaN) still divides the zero.  Same
    // bits either way.
    const T num = x[j] - partial[j];
    const T den = Us[at(j, j)];
    const bool zero = num == T(0) && fabs(den) > T(0) && fabs(den) < T(INFINITY);
    const T quotient = opaque(zero ? T(1) : num) / den;
    const T xj = zero ? num * den : quotient;
    x[j] = xj;
#pragma unroll
    for (int m0 = (j + 1) / kRun * kRun; m0 < kRegV; m0 += kRun) {
      const Run<T> run = *reinterpret_cast<const Run<T>*>(Us + at(j, m0));
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        if (m0 + e > j) partial[m0 + e] += xj * run.x[e];
    }
  }

  // X out: where v is a whole number of runs (X is contiguous from a
  // 256-byte boundary), the rows go back through Ws and leave in 16-byte
  // runs as they came in, a warp's store covering whole rows; else one
  // value a store.  In 2 bytes each value is narrowed once, as one value a
  // store narrows it, and a thread writes its row's runs to its own row of
  // Ws (`slot2`), where it read, so only the reads of other rows wait on the
  // warp.
  if (v % (kTwo ? kRun2 : kRun) == 0) {
    if constexpr (kTwo) {
#pragma unroll
      for (int c = 0; c < kRowRuns2; ++c) {
        uint4 run;
        run.x = word_of(narrow<St>(x[c * kRun2]), narrow<St>(x[c * kRun2 + 1]));
        run.y = word_of(narrow<St>(x[c * kRun2 + 2]), narrow<St>(x[c * kRun2 + 3]));
        run.z = word_of(narrow<St>(x[c * kRun2 + 4]), narrow<St>(x[c * kRun2 + 5]));
        run.w = word_of(narrow<St>(x[c * kRun2 + 6]), narrow<St>(x[c * kRun2 + 7]));
        *reinterpret_cast<uint4*>(ws + lane * kRegV + slot2(c, lane) * kRun) = run;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRowRuns2; ++i) {
        const int r = lane / kRowRuns2 + i * kRowsAtOnce2;
        const int c = lane % kRowRuns2;
        if (warp_row0 + r < R && c * kRun2 < v)
          *reinterpret_cast<uint4*>(X + static_cast<int64_t>(warp_row0 + r) * v + c * kRun2) =
              *reinterpret_cast<const uint4*>(ws + r * kRegV + slot2(c, r) * kRun);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kRowRuns; ++c) {
        Run<T> run;
#pragma unroll
        for (int e = 0; e < kRun; ++e) run.x[e] = x[c * kRun + e];
        *reinterpret_cast<Run<T>*>(ws + at(lane, c * kRun)) = run;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRowRuns; ++i) {
        const int r = lane / kRowRuns + i * kRowsAtOnce;
        const int c = lane % kRowRuns;
        if (warp_row0 + r < R && c * kRun < v)
          *reinterpret_cast<Run<T>*>(reinterpret_cast<T*>(X) +
                                     static_cast<int64_t>(warp_row0 + r) * v + c * kRun) =
              *reinterpret_cast<const Run<T>*>(ws + at(r, c * kRun));
      }
    }
  } else if (row < R) {
#pragma unroll
    for (int m = 0; m < kRegV; ++m)
      if (m < v) X[static_cast<int64_t>(row) * v + m] = narrow<St>(x[m]);
  }
}

template <typename St>
__global__ void __launch_bounds__(kRows)
trsm_right_upper_smem_kernel(const St* __restrict__ B, int64_t ldb, int64_t bsb,
                             const St* __restrict__ U, int64_t ldu_r, int64_t ldu_c,
                             int64_t bsu, St* __restrict__ X, int R, int v) {
  using T = compute_t<St>;
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
    Us[idx] = widen(U[i * ldu_r + j * ldu_c]);
  }
  for (int idx = threadIdx.x; idx < rows * v; idx += kRows) {
    const int r = idx / v;
    const int c = idx - r * v;
    Xs[r * ld + c] = widen(B[static_cast<int64_t>(row0 + r) * ldb + c]);
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
    X[static_cast<int64_t>(row0 + r) * v + c] = narrow<St>(Xs[r * ld + c]);
  }
}

constexpr int kCols = 64;         // columns (threads) per block of the shared-memory body
constexpr int kRegCols = 128;     // columns (threads) per block of the register body

template <typename St>
__global__ void __launch_bounds__(kRegCols)
trsm_left_lower_reg_kernel(const St* __restrict__ L, int64_t ldl_r, int64_t ldl_c, int64_t bsl,
                           const St* __restrict__ B, int64_t ldb, int64_t bsb,
                           St* __restrict__ X, int C, int v, int unit) {
  using T = compute_t<St>;
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
  for (int r = 0; r < kRegV; ++r) x[r] = has_col && r < v ? widen(B[r * ldb + col]) : T(0);

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
    staged[i] = read ? widen(L[r * ldl_r + q * ldl_c]) : T(0);
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
    if (r < v) X[static_cast<int64_t>(r) * C + col] = narrow<St>(x[r]);
}

template <typename St>
__global__ void __launch_bounds__(kCols)
trsm_left_lower_smem_kernel(const St* __restrict__ L, int64_t ldl_r, int64_t ldl_c, int64_t bsl,
                            const St* __restrict__ B, int64_t ldb, int64_t bsb,
                            St* __restrict__ X, int C, int v, int unit) {
  using T = compute_t<St>;
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
    for (int q = tx; q < v; q += kCols) Ls[r * v + q] = widen(L[r * ldl_r + q * ldl_c]);
  __syncthreads();

  if (col < C) {
    for (int r = 0; r < v; ++r) {
      T partial = T(0);
      for (int q = 0; q < r; ++q) partial += Ls[r * v + q] * Xs[q * kCols + tx];
      T x = widen(B[r * ldb + col]) - partial;
      if (!unit) x = x / Ls[r * v + r];
      Xs[r * kCols + tx] = x;
      X[static_cast<int64_t>(r) * C + col] = narrow<St>(x);
    }
  }
}

// The body a launch takes (`*mode`, and `kernels/trsm.py::right_mode`):
// the register body with the warp's 16-byte loads, or with one value a
// load, or the shared-memory body.
enum RightMode { kPlain = 0, kWideLoads = 1, kSmem = 2 };

// S: the storage type; shared memory holds its compute type T.
template <typename S>
int launch(const void* B, long long ldb, long long bsb, const void* U, long long ldu_r,
           long long ldu_c, long long bsu, void* X, int Bb, int R, int v, int* mode,
           void* stream) {
  using T = compute_t<S>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= kRegV) {
    constexpr int kRun = 16 / sizeof(S);  // values of a 16-byte run of B
    const int vec_in = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % kRun == 0 &&
                       bsb % kRun == 0 && v % kRun == 0;
    *mode = vec_in ? kWideLoads : kPlain;
    const dim3 grid(
        static_cast<unsigned>((static_cast<int64_t>(R) + kRightRows - 1) / kRightRows), 1, Bb);
    trsm_right_upper_reg_kernel<S><<<grid, kRightRows, 0, s>>>(
        static_cast<const S*>(B), ldb, bsb, static_cast<const S*>(U), ldu_r, ldu_c, bsu,
        static_cast<S*>(X), R, v, vec_in);
    return static_cast<int>(cudaGetLastError());
  }
  // The limit is raised once per device, for the widest panel.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(
        trsm_right_upper_smem_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  *mode = kSmem;
  const size_t smem = (static_cast<size_t>(v) * v + static_cast<size_t>(kRows) * (v + 1)) *
                      sizeof(T);
  const dim3 grid((R + kRows - 1) / kRows, 1, Bb);
  trsm_right_upper_smem_kernel<S><<<grid, kRows, smem, s>>>(
      static_cast<const S*>(B), ldb, bsb, static_cast<const S*>(U), ldu_r, ldu_c, bsu,
      static_cast<S*>(X), R, v);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_left_lower(const void* L, long long ldl_r, long long ldl_c, long long bsl,
                      const void* B, long long ldb, long long bsb, void* X, int Bb, int v, int C,
                      int unit, void* stream) {
  using T = compute_t<S>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= kRegV) {
    const dim3 grid(
        static_cast<unsigned>((static_cast<int64_t>(C) + kRegCols - 1) / kRegCols), 1, Bb);
    trsm_left_lower_reg_kernel<S><<<grid, kRegCols, 0, s>>>(
        static_cast<const S*>(L), ldl_r, ldl_c, bsl, static_cast<const S*>(B), ldb, bsb,
        static_cast<S*>(X), C, v, unit);
    return static_cast<int>(cudaGetLastError());
  }
  // As above: the limit is raised once per device, for the widest panel.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(trsm_left_lower_smem_kernel<S>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxV * (kMaxV + kCols) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(v) * (v + kCols) * sizeof(T);
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(C) + kCols - 1) / kCols), 1, Bb);
  trsm_left_lower_smem_kernel<S><<<grid, kCols, smem, s>>>(
      static_cast<const S*>(L), ldl_r, ldl_c, bsl, static_cast<const S*>(B), ldb, bsb,
      static_cast<S*>(X), C, v, unit);
  return static_cast<int>(cudaGetLastError());
}

// Every instance the launchers above can take (`attributes.cuh`).
const KernelInstance kInstances[] = {
    {"trsm_right_upper_reg_kernel<f32>", "f32", KI(trsm_right_upper_reg_kernel<float>), kRightRows, 0},
    {"trsm_right_upper_smem_kernel<f32>", "f32", KI(trsm_right_upper_smem_kernel<float>), kRows, static_cast<long long>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(float))},
    {"trsm_left_lower_reg_kernel<f32>", "f32", KI(trsm_left_lower_reg_kernel<float>), kRegCols, 0},
    {"trsm_left_lower_smem_kernel<f32>", "f32", KI(trsm_left_lower_smem_kernel<float>), kCols, static_cast<long long>(kMaxV * (kMaxV + kCols) * sizeof(float))},
    {"trsm_right_upper_reg_kernel<f64>", "f64", KI(trsm_right_upper_reg_kernel<double>), kRightRows, 0},
    {"trsm_right_upper_smem_kernel<f64>", "f64", KI(trsm_right_upper_smem_kernel<double>), kRows, static_cast<long long>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(double))},
    {"trsm_left_lower_reg_kernel<f64>", "f64", KI(trsm_left_lower_reg_kernel<double>), kRegCols, 0},
    {"trsm_left_lower_smem_kernel<f64>", "f64", KI(trsm_left_lower_smem_kernel<double>), kCols, static_cast<long long>(kMaxV * (kMaxV + kCols) * sizeof(double))},
    {"trsm_right_upper_reg_kernel<bf16>", "bf16", KI(trsm_right_upper_reg_kernel<__nv_bfloat16>), kRightRows, 0},
    {"trsm_right_upper_smem_kernel<bf16>", "bf16", KI(trsm_right_upper_smem_kernel<__nv_bfloat16>), kRows, static_cast<long long>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(float))},
    {"trsm_left_lower_reg_kernel<bf16>", "bf16", KI(trsm_left_lower_reg_kernel<__nv_bfloat16>), kRegCols, 0},
    {"trsm_left_lower_smem_kernel<bf16>", "bf16", KI(trsm_left_lower_smem_kernel<__nv_bfloat16>), kCols, static_cast<long long>(kMaxV * (kMaxV + kCols) * sizeof(float))},
    {"trsm_right_upper_reg_kernel<f16>", "f16", KI(trsm_right_upper_reg_kernel<__half>), kRightRows, 0},
    {"trsm_right_upper_smem_kernel<f16>", "f16", KI(trsm_right_upper_smem_kernel<__half>), kRows, static_cast<long long>((kMaxV * (kMaxV + kRows) + kRows) * sizeof(float))},
    {"trsm_left_lower_reg_kernel<f16>", "f16", KI(trsm_left_lower_reg_kernel<__half>), kRegCols, 0},
    {"trsm_left_lower_smem_kernel<f16>", "f16", KI(trsm_left_lower_smem_kernel<__half>), kCols, static_cast<long long>(kMaxV * (kMaxV + kCols) * sizeof(float))},
};

}  // namespace

KERNEL_INSTANCE_ENTRIES(trsm)

// Bb systems: B [R, v] with row stride ldb and batch stride bsb (unit column
// stride); U [v, v] with row stride ldu_r, column stride ldu_c and batch
// stride bsu; X: [Bb, R, v] contiguous output.  1 <= v <= 128, R >= 1,
// 1 <= Bb <= 65535.  Every operand has the element type of the entry's
// suffix.  Sets *mode to the body taken (`RightMode`) and returns the
// cudaError_t of the launch.
#define RIGHT_ENTRY(suffix, S)                                                                 \
  extern "C" int trsm_right_upper_##suffix(const void* B, long long ldb, long long bsb,       \
                                           const void* U, long long ldu_r, long long ldu_c,   \
                                           long long bsu, void* X, int Bb, int R, int v,      \
                                           int* mode, void* stream) {                         \
    return launch<S>(B, ldb, bsb, U, ldu_r, ldu_c, bsu, X, Bb, R, v, mode, stream);           \
  }
RIGHT_ENTRY(f32, float)
RIGHT_ENTRY(f64, double)
RIGHT_ENTRY(bf16, __nv_bfloat16)
RIGHT_ENTRY(f16, __half)

// Bb systems: L [v, v] with row stride ldl_r, column stride ldl_c and batch
// stride bsl (only its lower triangle is read, and its diagonal only when
// unit == 0); B [v, C] with row stride ldb and batch stride bsb (unit column
// stride); X: [Bb, v, C] contiguous output.  1 <= v <= 128, C >= 1,
// 1 <= Bb <= 65535.  Every operand has the element type of the entry's
// suffix.  Returns the cudaError_t of the launch.
#define LEFT_ENTRY(suffix, S)                                                                  \
  extern "C" int trsm_left_lower_##suffix(const void* L, long long ldl_r, long long ldl_c,    \
                                          long long bsl, const void* B, long long ldb,        \
                                          long long bsb, void* X, int Bb, int v, int C,       \
                                          int unit, void* stream) {                           \
    return launch_left_lower<S>(L, ldl_r, ldl_c, bsl, B, ldb, bsb, X, Bb, v, C, unit,         \
                                stream);                                                      \
  }
LEFT_ENTRY(f32, float)
LEFT_ENTRY(f64, double)
LEFT_ENTRY(bf16, __nv_bfloat16)
LEFT_ENTRY(f16, __half)

extern "C" const char* trsm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
