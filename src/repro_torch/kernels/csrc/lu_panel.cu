// Masked panel LUP: the v pivot / scale / rank-1 update rounds of COnfLUX's
// panel factorization, with rows masked instead of swapped (paper §7.3).
//
// Replaces: src/repro/kernels/lu_panel.py::lu_panel (body `_panel_rounds`)
// and ::lu_panel_batched (body `_batched_kernel`, the same rounds).  The TPU
// kernel is one grid program that holds the whole [R, v] panel in VMEM and
// runs the v rounds on it: the weighted argmax of column k picks the pivot
// row p (NaN first, then the largest, lowest index on ties, as jnp.argmax),
// p's weight drops to 0, the active rows (weight > 0) divide column k by the
// pivot (a zero or NaN pivot divides by 1), and EVERY row takes
// F[i, :] -= m_i * (F[p, :] * (j > k)) with m_i = 0 for rows not active.
//
// What bounds it on an H100: latency, not bytes.  On the main path the
// panel is [16384, 32] (2 MiB in f32), read and written once, a ~1.3 us
// floor at 3.35 TB/s.  The v rounds are strictly sequential and each needs
// a panel-wide argmax before the next can start, so the time is v dependent
// panel-wide reductions and the row updates between them.
//
// Register bodies (v <= 32; every path's v).  Each row lives in one
// thread's registers for all v rounds, is read once from the strided input
// and written once to F.  The round loop is rolled, four rounds a body, and
// the columns rotate through the registers between bodies, so every
// register index is a constant: a fully unrolled 32-round body is larger
// than the instruction cache, and its rounds then wait on instruction
// fetch (it was slower, and much slower again when other work had evicted
// it from L2, as on the paths).  Two and eight rounds a body ran as fast.  Weights are read once and
// the pivot mask is kept in registers, so a call is one launch.  A warp's
// argmax is two (f32) or three (f64) max reductions (redux.sync) of an
// integer key that orders candidates as torch.argmax does (`Key`), and the
// row update is every thread's own, in parallel.
//   - `lu_panel_block_kernel`: one block per system, one row a thread up to
//     256 rows in f32 (128 in f64), two up to 1024 (512): lu_panel_batched,
//     and lu_panel on small panels.  Per round: each warp's argmax, the
//     winning lane writes its row to shared memory, one __syncthreads, then
//     every warp reduces the warps' candidates itself (no second barrier),
//     forms the update's terms from the pivot row, one per lane, and each
//     thread updates its rows.  The conflux tournament's [32, 32] panel is
//     one warp: no block barrier and no second reduction.
//   - `lu_panel_grid_kernel`: one panel over a cooperative grid of 256-thread
//     blocks, one row a thread while one block per SM holds the panel
//     (two, then four, rows a thread above that, so R up to 132 * 1024
//     rows stays on this body; 256 threads and one row a thread were the
//     fastest of 128-512 threads and 1-4 rows at [16384, 32]).
//     The old body paid, each round, a barrier on one global counter, a
//     second dependent L2 read of the pivot row once p was known, and one
//     warp per row with rows in turn (a chain of dependent L2 loads,
//     divisions and stores).  Here, each round:
//       1. each block publishes its best candidate (key, index), that
//          row's pivot entry and the update's terms formed from the row
//          into a slot of its own, as 16-byte
//          chunks of two 64-bit words {payload, tag}; the tag is the
//          launch's epoch, and each round has its own slots;
//       2. every block reads all slots of the round in one parallel pass of
//          16-byte loads, retrying a chunk until both its tags match, so a
//          word is current exactly when its own tag says so (no fence, no
//          flag to wait on first: one L2 round trip), and copies them into
//          shared memory;
//       3. every warp reduces the slots' candidates the same way, so all
//          agree on p, and p's terms are already in shared memory;
//       4. every thread divides and updates its own rows.
//     No counter barrier is left.  The slots live in a scratch buffer that
//     the wrapper allocates once per (device, stream), zero-filled, and
//     reuses: launches on one stream run one after the other, and launches
//     on two streams get two buffers, so two launches that could run at
//     once never share one (PyTorch's streams are pooled and never freed,
//     so a stream's handle names one stream for the life of the process).
//     The epoch is a word of the scratch that the kernel advances itself:
//     every block reads it at the start, and block 0 writes the next value
//     at the end, when every block has read it; tag 0 is never used, so the
//     zero-filled buffer matches nothing, and a word from an earlier launch
//     matches only after 2^32 - 1 more launches of this body on the stream
//     (the wrapper zero-fills the buffer long before that).  A replayed
//     CUDA graph advances the epoch the same way.
//
// Every row takes the plain version's terms literally, all 32 columns each
// round: x_j -= m' * u_j with u_j = F[p, j] * (j > k) and m' = 0 for rows not
// active.  The terms with u_j = F[p, j] * 0 or m' = 0 are +-0 or NaN: they
// change a value only to spread a NaN (0 * inf) or to turn -0 into +0, and
// applying them is what makes a NaN or an infinite value spread exactly as
// in the plain version (a later round may then pick a row of weight 0
// whose column became NaN).  It costs 32 products and differences a row and
// round, about twice the trailing columns alone.
//
// Generic bodies (v > 32, or more rows than the register bodies hold):
// `lu_panel_kernel` (cooperative grid, panel in device memory) and
// `lu_panel_batched_kernel` (one block per system, panel in shared memory
// when it fits the block's budget, else in F).  They apply every term of
// every row literally, one warp per row and lanes over columns, and keep
// the pivot list in shared memory as the mask.  The grid body publishes
// each block's candidate row with its candidate, so no block reads a row
// that its owner is updating.
//
// Pivot choice, in every body through one integer key (`Key`): a NaN
// candidate beats any number and the lowest index wins among NaNs, as
// torch.argmax does; otherwise the larger value, lowest index on ties.
// ok[k] = candidate > 0 (False for NaN).  R >= 1 rows always give a
// candidate, so p is always a row of the panel.
//
// Bit-exactness: every product, difference, sum and quotient uses the
// round-to-nearest intrinsics (__fmul_rn, __fsub_rn, __fdiv_rn and their
// double forms), which nvcc never contracts into an FMA.  The
// plain PyTorch versions (repro_torch/kernels/ref.py::lu_panel and
// ::lu_panel_batched) round the same operations in the same order, so every
// body agrees with them, and a batched lane with the single call, bit for
// bit on the card (NaN at the same places).
//
// Storage and compute types (`storage.cuh`): every body is a template on
// the panel's storage type S and computes in compute_t<S>, which is f32 for
// bf16 and f16.  A 2-byte entry widens each value exactly as it loads it
// (16-byte row loads then carry 8 values), keeps rows, keys, slots and
// shared memory in f32, and rounds once, to nearest even, as it stores F,
// which is what the plain version does around its f32 rounds.  So its bits
// are the f32 body's on the widened panel, rounded.  The weights are read
// in the compute type.  The generic bodies update their rows in device
// memory; with 2-byte storage they do so in an f32 work buffer that the
// wrapper passes, and convert into F at the end.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "attributes.cuh"
#include "once_per_device.cuh"
#include "storage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr long long kSpinLimit = 1ll << 26;  // seconds of waiting: trap, do not hang

// Register bodies.
constexpr int kRegV = 32;            // v <= 32: a row's columns in 32 registers
constexpr int kGridThreads = 256;
constexpr int kGridWarps = kGridThreads / kWarp;
constexpr int kGridMaxBlocks = 144;  // slots per round, >= the SMs of an H100 (132)
constexpr int kReadBatch = 8;        // 16-byte chunks a thread has in flight per pass
constexpr int kRoundsPerBody = 4;    // rounds in the register bodies' unrolled loop body
constexpr int kBlockWarpsMax = 16;
// The one-block body's largest block: 512 threads in f32, 256 in f64.
template <typename T>
constexpr int kBlockThreads = sizeof(T) == 4 ? 512 : 256;
// Rows a thread holds in the grid body: up to 4 in f32, 2 in f64.
template <typename T>
constexpr int kGridRowsMax = sizeof(T) == 4 ? 4 : 2;

// Generic bodies.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxV = 128;
constexpr int kMaxBlocks = 256;
constexpr int kMinRowsPerBlock = 32;

// A slot: the pivot row's terms u (kRegV values), the pivot, the
// candidate's key (`Key`: one word in f32, two in f64) and its index, as
// 32-bit payload words, two to a 16-byte chunk, each with a 32-bit tag.
// Slots fill whole 32-byte sectors (an even number of chunks, from a
// 128-byte aligned base), so that a slot read does not wait for L2 to fetch
// the rest of a half-written sector from device memory.
template <typename T>
struct Slot {
  static constexpr int kValueWords = sizeof(T) / 4;
  static constexpr int kKeyWords = sizeof(T) / 4;
  static constexpr int kRowWords = kRegV * kValueWords;
  static constexpr int kWords = kRowWords + kValueWords + kKeyWords + 1;
  static constexpr int kChunks = (kWords + 3) / 4 * 2;
  static constexpr int kSmemWords = (2 * kChunks + 3) / 4 * 4;  // 16-byte aligned rows
};

// Scratch layout: the epoch word; the slots [kRegV rounds][kGridMaxBlocks]
// [chunks] (sized for f64); the generic grid body's partials (keys and
// rows, [2] buffers by round parity) and barrier.
constexpr size_t kEpochBytes = 128;
constexpr size_t kSlotBytes =
    static_cast<size_t>(kRegV) * kGridMaxBlocks * Slot<double>::kChunks * 16;
constexpr size_t kPartKeyBytes = 2 * kMaxBlocks * 3 * sizeof(uint32_t);
constexpr size_t kPartRowBytes = 2 * static_cast<size_t>(kMaxBlocks) * kMaxV * sizeof(double);
constexpr size_t kSlotOffset = kEpochBytes;
constexpr size_t kPartKeyOffset = kSlotOffset + kSlotBytes;
constexpr size_t kPartRowOffset = kPartKeyOffset + kPartKeyBytes;
constexpr size_t kBarrierOffset = kPartRowOffset + kPartRowBytes;
constexpr size_t kScratchBytes = kBarrierOffset + 2 * sizeof(unsigned int);

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// ---------------------------------------------------------------------------
// Register bodies
// ---------------------------------------------------------------------------

// A candidate as an unsigned key (hi, lo) whose order is torch.argmax's: NaN
// above every number, -0 equal to +0, else the values' order; lo is the low
// half of an f64 key (0 in f32).  With the index, (hi, lo, ~idx) orders
// candidates as torch.argmax does (the lowest index wins a tie, and among
// NaNs), so a warp's argmax is two or three max reductions of 32-bit words
// (redux.sync).  No row (past R) has the key (0, 0), below every candidate.
struct Key {
  uint32_t hi, lo;
  int idx;  // INT_MAX: no row
};

__device__ __forceinline__ Key key_of(float c, int idx) {
  if (isnan(c)) return {0xffffffffu, 0u, idx};
  const uint32_t u = __float_as_uint(__fadd_rn(c, 0.0f));  // -0 + 0 = +0
  return {u & 0x80000000u ? ~u : u | 0x80000000u, 0u, idx};
}

__device__ __forceinline__ Key key_of(double c, int idx) {
  if (isnan(c)) return {0xffffffffu, 0xffffffffu, idx};
  unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(c, 0.0)));
  u = u >> 63 ? ~u : u | (1ull << 63);
  return {static_cast<uint32_t>(u >> 32), static_cast<uint32_t>(u), idx};
}

__device__ __forceinline__ Key no_key() { return {0u, 0u, INT_MAX}; }

__device__ __forceinline__ bool key_beats(const Key& a, const Key& b) {
  return a.hi > b.hi || (a.hi == b.hi && (a.lo > b.lo || (a.lo == b.lo && a.idx < b.idx)));
}

// Whether the candidate is > 0 (False for NaN and for +-0): ok[k].
__device__ __forceinline__ bool key_positive(const Key& k) {
  return k.hi != 0xffffffffu && (k.hi > 0x80000000u || (k.hi == 0x80000000u && k.lo != 0u));
}

// The warp's best key; every lane ends with it.
template <typename T>
__device__ __forceinline__ Key warp_best(Key k) {
  const uint32_t hi = __reduce_max_sync(kAllLanes, k.hi);
  bool top = k.hi == hi;
  uint32_t lo = 0u;
  if (sizeof(T) == 8) {
    lo = __reduce_max_sync(kAllLanes, top ? k.lo : 0u);
    top = top && k.lo == lo;
  }
  const uint32_t nidx = __reduce_max_sync(kAllLanes, top ? ~static_cast<uint32_t>(k.idx) : 0u);
  return {hi, lo, static_cast<int>(~nidx)};
}

// Eight bf16 or f16, four f32 or two f64 values: one 16-byte access.
template <typename T>
struct alignas(16) Run {
  static constexpr int kN = 16 / sizeof(T);
  T x[kN];
};

// The rows a thread holds, with their weights and candidates.  The round
// loop is not unrolled (an unrolled 32-round body is larger than the
// instruction cache, and each round then waits on instruction fetch), so
// the columns rotate through the registers instead: in the body that runs
// rounds k0 .. k0 + kRoundsPerBody - 1, register j holds column
// (k0 + j) mod 32, and every index into x is a constant.
template <typename T, int ROWS>
struct Rows {
  T x[ROWS][kRegV];
  T w[ROWS];
  Key key[ROWS];  // this round's candidate; idx INT_MAX: no row

  // Row i (if i < R): read once from the strided input of storage type S,
  // 16 bytes at a time when v == 32 and the rows are aligned, widened to T;
  // columns j >= v are 0.
  template <typename S>
  __device__ __forceinline__ void load(int q, const S* in, int64_t ld_in, const T* weights,
                                       int i, int R, int v, bool vec) {
    if (i >= R) {
      key[q] = no_key();
      w[q] = T(0);
#pragma unroll
      for (int j = 0; j < kRegV; ++j) x[q][j] = T(0);
      return;
    }
    w[q] = weights[i];
    const S* src = in + static_cast<int64_t>(i) * ld_in;
    if (vec) {
#pragma unroll
      for (int j0 = 0; j0 < kRegV; j0 += Run<S>::kN) {
        const Run<S> r = *reinterpret_cast<const Run<S>*>(src + j0);
#pragma unroll
        for (int e = 0; e < Run<S>::kN; ++e) x[q][j0 + e] = widen(r.x[e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRegV; ++j) x[q][j] = j < v ? widen(src[j]) : T(0);
    }
    key[q] = key_of(mul_rn(fabs(x[q][0]), w[q]), i);
  }

  // This thread's best candidate.
  __device__ __forceinline__ Key best() const {
    Key b = key[0];
#pragma unroll
    for (int q = 1; q < ROWS; ++q)
      if (key_beats(key[q], b)) b = key[q];
    return b;
  }

  // The owner of row i writes it, as it stands, to dst [kRegV] (16-byte
  // aligned, register order).
  __device__ __forceinline__ void publish(int i, T* dst) const {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      if (key[q].idx != i || i == INT_MAX) continue;
#pragma unroll
      for (int j0 = 0; j0 < kRegV; j0 += Run<T>::kN) {
        Run<T> run;
#pragma unroll
        for (int e = 0; e < Run<T>::kN; ++e) run.x[e] = x[q][j0 + e];
        *reinterpret_cast<Run<T>*>(dst + j0) = run;
      }
    }
  }

  // Round k = k0 + r with pivot row p, its value piv and the terms u
  // [kRegV] (shared memory, 16-byte aligned), as the plain version: p's
  // weight drops to 0; an active row (weight > 0) sets column k to
  // m = F[i, k] / safe; EVERY row takes x_j -= m' * u_j for all j, with m'
  // = m if active, else +0.  Then the candidate of round k + 1.
  __device__ __forceinline__ void round(int r, int k, int p, T piv, const T* u, int v) {
    const T safe = fabs(piv) > T(0) ? piv : T(1);
    T uj[kRegV];
#pragma unroll
    for (int j0 = 0; j0 < kRegV; j0 += Run<T>::kN) {
      const Run<T> run = *reinterpret_cast<const Run<T>*>(u + j0);
#pragma unroll
      for (int e = 0; e < Run<T>::kN; ++e) uj[j0 + e] = run.x[e];
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int i = key[q].idx;
      if (i == p) w[q] = T(0);
      const bool active = w[q] > T(0);
      const T m = div_rn(x[q][r], safe);
      const T me = active ? m : T(0);
      if (active) x[q][r] = m;
#pragma unroll
      for (int j = 0; j < kRegV; ++j) x[q][j] = sub_rn(x[q][j], mul_rn(me, uj[j]));
      if (k + 1 < v && i != INT_MAX)
        key[q] = key_of(mul_rn(fabs(x[q][(r + 1) % kRegV]), w[q]), i);
    }
  }

  // After a body: register j takes the column of register j + kRoundsPerBody.
  __device__ __forceinline__ void rotate() {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      T t[kRegV];
#pragma unroll
      for (int j = 0; j < kRegV; ++j) t[j] = x[q][(j + kRoundsPerBody) % kRegV];
#pragma unroll
      for (int j = 0; j < kRegV; ++j) x[q][j] = t[j];
    }
  }

  // Row q to F (storage type S, each value rounded once), after `shift`
  // register positions of rotation.
  template <typename S>
  __device__ __forceinline__ void store(int q, S* F, int v, int shift) const {
    if (key[q].idx == INT_MAX) return;
    S* dst = F + static_cast<int64_t>(key[q].idx) * v;
    if (v == kRegV && shift % kRegV == 0) {  // F is a fresh allocation: aligned rows
#pragma unroll
      for (int j0 = 0; j0 < kRegV; j0 += Run<S>::kN) {
        Run<S> run;
#pragma unroll
        for (int e = 0; e < Run<S>::kN; ++e) run.x[e] = narrow<S>(x[q][j0 + e]);
        *reinterpret_cast<Run<S>*>(dst + j0) = run;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRegV; ++j) {
        const int c = (shift + j) % kRegV;
        if (c < v) dst[c] = narrow<S>(x[q][j]);
      }
    }
  }
};

// Round k = k0 + r: the update's term for the pivot row's entry t at
// register j, u_j = F[p, j] * (column > k).  Registers r + 1 .. 31 - k0 hold
// the columns k + 1 .. 31 (F[p, j] * 1 is F[p, j]); the others hold
// columns <= k and keep the product with 0, whose sign, or NaN, the plain
// version subtracts too.
template <typename T>
__device__ __forceinline__ T term(T t, int j, int r, int k0) {
  return j > r && j <= kRegV - 1 - k0 ? t : mul_rn(t, T(0));
}

// The rotation a row has taken after v rounds.
__device__ __forceinline__ int final_shift(int v) {
  return (v + kRoundsPerBody - 1) / kRoundsPerBody * kRoundsPerBody;
}

// Whether rows of T starting at p with row stride ld can be read 16 bytes at a time.
template <typename T>
__device__ __forceinline__ bool aligned(const T* p, int64_t ld) {
  return (reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(ld * sizeof(T))) % 16 == 0;
}

// Each warp's best candidate of the round in shared memory, by turns.
struct WarpKeys {
  uint32_t hi[2][kBlockWarpsMax], lo[2][kBlockWarpsMax];
  int idx[2][kBlockWarpsMax];

  __device__ __forceinline__ void put(int buf, int warp, const Key& k) {
    hi[buf][warp] = k.hi;
    lo[buf][warp] = k.lo;
    idx[buf][warp] = k.idx;
  }
  __device__ __forceinline__ Key get(int buf, int lane, int nw) const {
    return lane < nw ? Key{hi[buf][lane], lo[buf][lane], idx[buf][lane]} : no_key();
  }
};

// One block per system; blockDim.x = nt (a multiple of 32, at most
// kBlockThreads<T>) and R <= nt * ROWS.  Thread t holds rows q * nt + t.
template <typename S, int ROWS>
__global__ void __launch_bounds__(kBlockThreads<compute_t<S>>)
lu_panel_block_kernel(const S* __restrict__ in, int64_t ld_in, int64_t bs_in,
                      const compute_t<S>* __restrict__ weights, S* __restrict__ F, int R,
                      int v, int* __restrict__ order, unsigned char* __restrict__ ok) {
  using T = compute_t<S>;
  __shared__ __align__(16) T wrow[2][kBlockWarpsMax][kRegV];  // each warp's winner, by turns
  __shared__ __align__(16) T wu[kBlockWarpsMax][kRegV];       // each warp's copy of the terms
  __shared__ WarpKeys wkeys;

  const int nt = blockDim.x;
  const int nw = nt / kWarp;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int64_t b = blockIdx.x;
  const S* src = in + b * bs_in;
  const bool vec = v == kRegV && aligned(src, ld_in);

  Rows<T, ROWS> rows;
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    rows.load(q, src, ld_in, weights + b * R, q * nt + tid, R, v, vec);

#pragma unroll 1
  for (int k0 = 0; k0 < v; k0 += kRoundsPerBody) {
#pragma unroll
    for (int r = 0; r < kRoundsPerBody; ++r) {
      const int k = k0 + r;
      if (k >= v) break;
      const int buf = k & 1;
      // The warp's candidate, and its row from the lane that holds it;
      // with more than one warp, every warp then reduces the warps'.
      Key best = warp_best<T>(rows.best());
      rows.publish(best.idx, wrow[buf][warp]);
      if (nw > 1) {
        if (lane == 0) wkeys.put(buf, warp, best);
        __syncthreads();
        best = warp_best<T>(wkeys.get(buf, lane, nw));
      } else {
        __syncwarp();
      }
      const int p = best.idx;
      const T* prow = wrow[buf][(p % nt) / kWarp];
      if (tid == 0) {
        order[b * v + k] = p;
        ok[b * v + k] = key_positive(best) ? 1 : 0;
      }
      // The terms, one per lane, into this warp's copy.
      wu[warp][lane] = term(prow[lane], lane, r, k0);
      __syncwarp();
      rows.round(r, k, p, prow[r], wu[warp], v);
      __syncwarp();
    }
    rows.rotate();
  }

  S* Fb = F + b * R * v;
  const int shift = final_shift(v);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) rows.store(q, Fb, v, shift);
}

// 16-byte chunk loads and stores that are morally strong per 8-byte word
// (a vector access is a set of word accesses, each single-copy atomic).
__device__ __forceinline__ void store_chunk(unsigned long long* p, unsigned long long a,
                                            unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

__device__ __forceinline__ void load_chunk(const unsigned long long* p, unsigned long long& a,
                                           unsigned long long& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p)
               : "memory");
}

__device__ __forceinline__ unsigned long long tagged(uint32_t payload, uint32_t tag) {
  return (static_cast<unsigned long long>(tag) << 32) | payload;
}

// Payload word n of round k0 + r's slot for the pivot row `row`: the words
// of the update's terms u, of the pivot F[p, k], of the key, the index.
template <typename T>
__device__ __forceinline__ uint32_t slot_word(const T* row, int r, int k0, const Key& k, int n) {
  using S = Slot<T>;
  uint32_t words[S::kValueWords];
  if (n < S::kRowWords + S::kValueWords) {
    const int j = n / S::kValueWords;
    const T t = j < kRegV ? term(row[j], j, r, k0) : row[r];
    memcpy(words, &t, sizeof(T));
    return words[n % S::kValueWords];
  }
  n -= S::kRowWords + S::kValueWords;
  if (n == 0) return k.hi;
  if (S::kKeyWords == 2 && n == 1) return k.lo;
  return n == S::kKeyWords ? static_cast<uint32_t>(k.idx) : 0u;
}

// One panel over a cooperative grid of nblocks <= kGridMaxBlocks blocks of
// kGridThreads; block b holds rows [b * RPB, (b + 1) * RPB) with RPB =
// kGridThreads * ROWS, thread t of it rows b * RPB + q * kGridThreads + t.
template <typename St, int ROWS>
__global__ void __launch_bounds__(kGridThreads, 1)
lu_panel_grid_kernel(const St* __restrict__ in, int64_t ld_in,
                     const compute_t<St>* __restrict__ weights, St* __restrict__ F, int R, int v,
                     int* __restrict__ order, unsigned char* __restrict__ ok,
                     unsigned char* scratch) {
  using T = compute_t<St>;
  using S = Slot<T>;
  constexpr int kRowsPerBlock = kGridThreads * ROWS;
  __shared__ __align__(16) T wrow[2][kGridWarps][kRegV];
  __shared__ WarpKeys wkeys;
  __shared__ __align__(16) uint32_t sbuf[kGridMaxBlocks * S::kSmemWords];  // the round's slots
  __shared__ uint32_t s_tag;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nblocks = gridDim.x;
  volatile uint32_t* epoch = reinterpret_cast<volatile uint32_t*>(scratch);
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(scratch + kSlotOffset);

  if (tid == 0) {
    const uint32_t e = *epoch + 1u;
    s_tag = e == 0u ? 1u : e;
  }
  Rows<T, ROWS> rows;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const bool vec = v == kRegV && aligned(in, ld_in);
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    rows.load(q, in, ld_in, weights, r0 + q * kGridThreads + tid, R, v, vec);
  __syncthreads();
  const uint32_t tag = s_tag;

#pragma unroll 1
  for (int k0 = 0; k0 < v; k0 += kRoundsPerBody) {
#pragma unroll
    for (int r = 0; r < kRoundsPerBody; ++r) {
      const int k = k0 + r;
      if (k >= v) break;
      const int buf = k & 1;
      unsigned long long* round_slots =
          slots + static_cast<size_t>(k) * kGridMaxBlocks * S::kChunks * 2;

      // 1. The block's candidate and its row: each warp's, then warp 0's
      //    reduction of those, published with the update's terms as this
      //    block's slot of the round.
      const Key wb = warp_best<T>(rows.best());
      rows.publish(wb.idx, wrow[buf][warp]);
      if (lane == 0) wkeys.put(buf, warp, wb);
      __syncthreads();
      if (warp == 0) {
        const Key bb = warp_best<T>(wkeys.get(buf, lane, kGridWarps));
        const T* row = wrow[buf][((bb.idx - r0) % kGridThreads) / kWarp];
        unsigned long long* mine =
            round_slots + static_cast<size_t>(blockIdx.x) * S::kChunks * 2;
        for (int c = lane; c < S::kChunks; c += kWarp)
          store_chunk(mine + 2 * c, tagged(slot_word(row, r, k0, bb, 2 * c), tag),
                      tagged(slot_word(row, r, k0, bb, 2 * c + 1), tag));
      }

      // 2. Every slot of the round, in one pass of 16-byte loads: a chunk
      //    is taken when both of its words carry this launch's tag.
      const int total = nblocks * S::kChunks;
      for (int base = 0; base < total; base += kGridThreads * kReadBatch) {
        unsigned long long a[kReadBatch], c2[kReadBatch];
        unsigned pending = 0;
#pragma unroll
        for (int n = 0; n < kReadBatch; ++n) {
          const int qc = base + n * kGridThreads + tid;
          if (qc < total) {
            load_chunk(round_slots + 2 * qc, a[n], c2[n]);
            pending |= 1u << n;
          }
        }
        long long spins = 0;
        while (true) {
          unsigned stale = 0;
#pragma unroll
          for (int n = 0; n < kReadBatch; ++n)
            if (((pending >> n) & 1u) &&
                (static_cast<uint32_t>(a[n] >> 32) != tag ||
                 static_cast<uint32_t>(c2[n] >> 32) != tag))
              stale |= 1u << n;
          if (!stale) break;
          if (++spins > kSpinLimit) __trap();
#pragma unroll
          for (int n = 0; n < kReadBatch; ++n)
            if ((stale >> n) & 1u)
              load_chunk(round_slots + 2 * (base + n * kGridThreads + tid), a[n], c2[n]);
        }
#pragma unroll
        for (int n = 0; n < kReadBatch; ++n) {
          if (!((pending >> n) & 1u)) continue;
          const int qc = base + n * kGridThreads + tid;
          const int s = qc / S::kChunks;
          const int c = qc - s * S::kChunks;
          *reinterpret_cast<uint2*>(sbuf + s * S::kSmemWords + 2 * c) =
              make_uint2(static_cast<uint32_t>(a[n]), static_cast<uint32_t>(c2[n]));
        }
      }
      __syncthreads();

      // 3. The pivot: every warp reduces the slots' candidates the same way.
      Key g = no_key();
      for (int s = lane; s < nblocks; s += kWarp) {
        const uint32_t* sw = sbuf + s * S::kSmemWords + S::kRowWords + S::kValueWords;
        const Key sk = {sw[0], S::kKeyWords == 2 ? sw[1] : 0u,
                        static_cast<int>(sw[S::kKeyWords])};
        if (key_beats(sk, g)) g = sk;
      }
      g = warp_best<T>(g);
      const int p = g.idx;
      const uint32_t* slot = sbuf + (p / kRowsPerBlock) * S::kSmemWords;
      if (blockIdx.x == 0 && tid == 0) {
        order[k] = p;
        ok[k] = key_positive(g) ? 1 : 0;
      }
      T piv;
      memcpy(&piv, slot + S::kRowWords, sizeof(T));

      // 4. Every thread's rows.
      rows.round(r, k, p, piv, reinterpret_cast<const T*>(slot), v);
    }
    rows.rotate();
  }

  // Every block has read the epoch: the next launch on this stream takes
  // the next one.
  if (blockIdx.x == 0 && tid == 0) *epoch = tag;
  const int shift = final_shift(v);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) rows.store(q, F, v, shift);
}

// ---------------------------------------------------------------------------
// Generic bodies: v > 32, or more rows than the register bodies hold
// ---------------------------------------------------------------------------

// The block's best key; every thread ends with it.  All threads must call,
// and calls alternate between the two buffers of `red`.
template <typename T>
__device__ __forceinline__ Key block_best(Key k, WarpKeys& red, int buf) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  k = warp_best<T>(k);
  if (lane == 0) red.put(buf, warp, k);
  __syncthreads();
  return warp_best<T>(red.get(buf, lane, kWarps));
}

// Whether row i is one of the pivots piv[0..npiv) (all lanes of a warp call).
__device__ __forceinline__ bool is_pivot(const int* piv, int npiv, int i, int lane) {
  bool hit = false;
  for (int t = lane; t < npiv; t += kWarp) hit |= piv[t] == i;
  return __any_sync(kAllLanes, hit);
}

// Round k on row i of weight w (0 if it was a pivot) in `row` (device or
// shared memory), one warp with lanes over columns: the plain version's
// terms, literally.  Returns the row's candidate for round k + 1 (every lane).
template <typename T>
__device__ __forceinline__ Key literal_round(T* row, int i, T w, const T* prow, T safe, int k,
                                             int v, int lane) {
  const bool active = w > T(0);
  const T m = active ? div_rn(row[k], safe) : T(0);
  __syncwarp();
  for (int j = lane; j < v; j += kWarp) {
    T x = j == k && active ? m : row[j];
    row[j] = sub_rn(x, mul_rn(m, mul_rn(prow[j], j > k ? T(1) : T(0))));
  }
  __syncwarp();
  return k + 1 < v ? key_of(mul_rn(fabs(row[k + 1]), w), i) : no_key();
}

// Grid barrier for a cooperative launch: every block's writes before it
// are visible to every block after it.  The arrival counter returns to 0
// and the generation only grows, so the pair needs zeroing only once.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      long long spins = 0;
      while (*gen == seen) {
        __nanosleep(64);
        if (++spins > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// W: the rows as they are updated, [R, v] of the compute type: F itself
// when S is the compute type, else a work buffer converted into F at the end.
template <typename S>
__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(const S* __restrict__ in, int64_t ld_in, const compute_t<S>* __restrict__ weights,
                compute_t<S>* W, S* F, int R, int v, int* order, unsigned char* ok,
                unsigned char* scratch) {
  using T = compute_t<S>;
  __shared__ WarpKeys red;
  __shared__ T prow[kMaxV];
  __shared__ int piv[kMaxV];

  uint32_t* part_key = reinterpret_cast<uint32_t*>(scratch + kPartKeyOffset);  // [2][blocks][3]
  T* part_row = reinterpret_cast<T*>(scratch + kPartRowOffset);  // [2][kMaxBlocks][kMaxV]
  unsigned int* bar = reinterpret_cast<unsigned int*>(scratch + kBarrierOffset);

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int nblocks = gridDim.x;
  const int rows_per_block = (R + nblocks - 1) / nblocks;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);

  // Publishes this block's best candidate and its row (one of the block's
  // own, current in F) into partials buffer nbuf.
  auto publish = [&](Key best, int nbuf) {
    best = block_best<T>(best, red, 1);
    uint32_t* key = part_key + (nbuf * kMaxBlocks + blockIdx.x) * 3;
    if (tid == 0) {
      key[0] = best.hi;
      key[1] = best.lo;
      key[2] = static_cast<uint32_t>(best.idx);
    }
    if (best.idx != INT_MAX && tid < v)
      part_row[(static_cast<size_t>(nbuf) * kMaxBlocks + blockIdx.x) * kMaxV + tid] =
          W[static_cast<int64_t>(best.idx) * v + tid];
  };

  // Copy this block's rows and form the candidates for column 0.  Row i is
  // always handled by warp (i - r0) % kWarps, each lane on its own columns.
  Key best = no_key();
  for (int i = r0 + warp; i < r1; i += kWarps) {
    const S* src = in + static_cast<int64_t>(i) * ld_in;
    T* row = W + static_cast<int64_t>(i) * v;
    for (int j = lane; j < v; j += kWarp) row[j] = widen(src[j]);
    const Key c = key_of(mul_rn(fabs(widen(src[0])), weights[i]), i);
    if (key_beats(c, best)) best = c;
  }
  publish(best, 0);

  for (int k = 0; k < v; ++k) {
    grid_barrier(bar, nblocks);

    // The pivot, from every block's candidate; its row from its partial.
    const int buf = k & 1;
    best = no_key();
    if (tid < nblocks) {
      const uint32_t* key = part_key + (buf * kMaxBlocks + tid) * 3;
      best = {__ldcg(key), __ldcg(key + 1), static_cast<int>(__ldcg(key + 2))};
    }
    best = block_best<T>(best, red, 0);
    const int p = best.idx;
    const int slot = p / rows_per_block;  // the block that holds row p
    if (tid == 0) {
      if (blockIdx.x == 0) {
        order[k] = p;
        ok[k] = key_positive(best) ? 1 : 0;
      }
      piv[k] = p;
    }
    if (tid < v)
      prow[tid] = __ldcg(part_row + (static_cast<size_t>(buf) * kMaxBlocks + slot) * kMaxV + tid);
    __syncthreads();

    // Every row of the block takes the round; candidates for round k + 1.
    const T piv_val = prow[k];
    const T safe = fabs(piv_val) > T(0) ? piv_val : T(1);
    best = no_key();
    for (int i = r0 + warp; i < r1; i += kWarps) {
      const T wi = is_pivot(piv, k + 1, i, lane) ? T(0) : weights[i];
      const Key c = literal_round(W + static_cast<int64_t>(i) * v, i, wi, prow, safe, k, v, lane);
      if (key_beats(c, best)) best = c;
    }
    if (k + 1 < v) publish(best, (k + 1) & 1);
  }
  if constexpr (sizeof(S) != sizeof(T)) {
    // The block's own rows, each rounded once into F.
    __syncthreads();
    const int64_t n0 = static_cast<int64_t>(r0) * v;
    const int64_t n1 = static_cast<int64_t>(r1) * v;
    for (int64_t idx = n0 + tid; idx < n1; idx += kThreads) F[idx] = narrow<S>(W[idx]);
  }
}

// W: the panels in device memory as they are updated, [B, R, v] of the
// compute type, when they are not kept in shared memory: F itself when S is
// the compute type, else a work buffer.
template <typename S>
__global__ void __launch_bounds__(kThreads)
lu_panel_batched_kernel(const S* __restrict__ in, int64_t ld_in, int64_t bs_in,
                        const compute_t<S>* __restrict__ weights, compute_t<S>* W, S* F, int R,
                        int v, int* order, unsigned char* ok, int in_shared) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ WarpKeys red;
  __shared__ T prow[kMaxV];
  __shared__ int piv[kMaxV];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int64_t b = blockIdx.x;
  const S* src_b = in + b * bs_in;
  const T* wg = weights + b * R;
  S* Fg = F + b * R * v;
  // The working panel: shared memory, or W.
  T* Fw = in_shared ? reinterpret_cast<T*>(smem_raw) : W + b * R * v;
  int* order_b = order + b * v;
  unsigned char* ok_b = ok + b * v;

  // Copy the rows and form the candidates for column 0.  Row i is always
  // handled by warp i % kWarps, each lane on its own columns.
  Key best = no_key();
  for (int i = warp; i < R; i += kWarps) {
    const S* src = src_b + static_cast<int64_t>(i) * ld_in;
    T* row = Fw + static_cast<int64_t>(i) * v;
    for (int j = lane; j < v; j += kWarp) row[j] = widen(src[j]);
    const Key c = key_of(mul_rn(fabs(widen(src[0])), wg[i]), i);
    if (key_beats(c, best)) best = c;
  }

  for (int k = 0; k < v; ++k) {
    // The pivot: a block-wide argmax of the candidates.
    best = block_best<T>(best, red, k & 1);
    const int p = best.idx;
    if (tid == 0) {
      order_b[k] = p;
      ok_b[k] = key_positive(best) ? 1 : 0;
      piv[k] = p;
    }
    if (tid < v) prow[tid] = Fw[static_cast<int64_t>(p) * v + tid];
    __syncthreads();

    // Every row takes the round; candidates for round k + 1.
    const T piv_val = prow[k];
    const T safe = fabs(piv_val) > T(0) ? piv_val : T(1);
    best = no_key();
    for (int i = warp; i < R; i += kWarps) {
      const T wi = is_pivot(piv, k + 1, i, lane) ? T(0) : wg[i];
      const Key c = literal_round(Fw + static_cast<int64_t>(i) * v, i, wi, prow, safe, k, v,
                                  lane);
      if (key_beats(c, best)) best = c;
    }
  }

  if (in_shared || sizeof(S) != sizeof(T)) {
    __syncthreads();
    const int64_t n = static_cast<int64_t>(R) * v;
    for (int64_t idx = tid; idx < n; idx += kThreads) Fg[idx] = narrow<S>(Fw[idx]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

int sm_count(int* sms) {
  static OncePerDevice<int> count;
  return static_cast<int>(count.get(
      [](int dev, int* out) {
        return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
      },
      sms));
}

// Rows a thread of the one-block body holds for R rows (0: over its
// budget): one up to half the largest block, else two, which keeps two
// blocks on an SM (faster on the [256, 512, 32] stack than one row a
// thread in blocks of 512).
template <typename T>
int block_rows(int R) {
  return R <= kBlockThreads<T> / 2 ? 1 : (R <= 2 * kBlockThreads<T> ? 2 : 0);
}

// The generic bodies update rows in device memory of the compute type: F
// itself, or, for 2-byte storage, the caller's work buffer (refused if
// missing).
template <typename S>
compute_t<S>* work_rows(void* F, void* work) {
  return sizeof(S) == sizeof(compute_t<S>) ? static_cast<compute_t<S>*>(F)
                                           : static_cast<compute_t<S>*>(work);
}

template <typename S>
int launch_block(const void* in, long long ld_in, long long bs_in, const void* weights,
                 void* F, int B, int R, int v, void* order, void* ok, cudaStream_t s) {
  using T = compute_t<S>;
  const int rpt = block_rows<T>(R);
  const int nt = ((R + rpt - 1) / rpt + kWarp - 1) / kWarp * kWarp;
  const auto kernel = rpt == 1 ? lu_panel_block_kernel<S, 1> : lu_panel_block_kernel<S, 2>;
  kernel<<<B, nt, 0, s>>>(static_cast<const S*>(in), ld_in, bs_in,
                          static_cast<const T*>(weights), static_cast<S*>(F), R, v,
                          static_cast<int*>(order), static_cast<unsigned char*>(ok));
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int ROWS>
int launch_grid(const void* in, long long ld_in, const void* weights, void* F, int R, int v,
                void* order, void* ok, void* scratch, cudaStream_t s) {
  const S* in_t = static_cast<const S*>(in);
  int64_t ld = ld_in;
  const compute_t<S>* w_t = static_cast<const compute_t<S>*>(weights);
  S* F_t = static_cast<S*>(F);
  int* order_t = static_cast<int*>(order);
  unsigned char* ok_t = static_cast<unsigned char*>(ok);
  unsigned char* scratch_t = static_cast<unsigned char*>(scratch);
  void* args[] = {&in_t, &ld, &w_t, &F_t, &R, &v, &order_t, &ok_t, &scratch_t};
  const int nblocks = (R + kGridThreads * ROWS - 1) / (kGridThreads * ROWS);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lu_panel_grid_kernel<S, ROWS>), dim3(nblocks),
      dim3(kGridThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_generic(const void* in, long long ld_in, const void* weights, void* work, void* F,
                   int R, int v, void* order, void* ok, void* scratch, int sms, cudaStream_t s) {
  int nblocks = (R + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  nblocks = nblocks < sms ? nblocks : sms;
  nblocks = nblocks < kMaxBlocks ? nblocks : kMaxBlocks;
  const S* in_t = static_cast<const S*>(in);
  int64_t ld = ld_in;
  const compute_t<S>* w_t = static_cast<const compute_t<S>*>(weights);
  compute_t<S>* W_t = work_rows<S>(F, work);
  if (W_t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  S* F_t = static_cast<S*>(F);
  int* order_t = static_cast<int*>(order);
  unsigned char* ok_t = static_cast<unsigned char*>(ok);
  unsigned char* scratch_t = static_cast<unsigned char*>(scratch);
  void* args[] = {&in_t, &ld, &w_t, &W_t, &F_t, &R, &v, &order_t, &ok_t, &scratch_t};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lu_panel_kernel<S>), dim3(nblocks), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The body a launch takes (`*mode`, and `kernels/lu_panel.py`'s `.mode`).
enum PanelMode { kGeneric = 0, kBlock = 1, kGrid = 2 };

// The single panel: the one-block body while the rows fit it, then the grid
// body with the fewest rows a thread that fit one block per SM, then the
// generic body.
template <typename S>
int launch(const void* in, long long ld_in, const void* weights, void* work, void* F, int R,
           int v, void* order, void* ok, void* scratch, int* mode, void* stream) {
  using T = compute_t<S>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *mode = kBlock;
  if (v <= kRegV && block_rows<T>(R) > 0)
    return launch_block<S>(in, ld_in, 0, weights, F, 1, R, v, order, ok, s);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const int64_t slots = sms < kGridMaxBlocks ? sms : kGridMaxBlocks;
  *mode = kGrid;
  if (v <= kRegV) {
    if (R <= slots * kGridThreads)
      return launch_grid<S, 1>(in, ld_in, weights, F, R, v, order, ok, scratch, s);
    if (R <= slots * kGridThreads * 2)
      return launch_grid<S, 2>(in, ld_in, weights, F, R, v, order, ok, scratch, s);
    if (kGridRowsMax<T> == 4 && R <= slots * kGridThreads * 4)
      return launch_grid<S, kGridRowsMax<T>>(in, ld_in, weights, F, R, v, order, ok, scratch, s);
  }
  *mode = kGeneric;
  return launch_generic<S>(in, ld_in, weights, work, F, R, v, order, ok, scratch, sms, s);
}

template <typename S>
int launch_batched(const void* in, long long ld_in, long long bs_in, const void* weights,
                   void* work, void* F, int B, int R, int v, void* order, void* ok, int* mode,
                   void* stream) {
  using T = compute_t<S>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *mode = kBlock;
  if (v <= kRegV && block_rows<T>(R) > 0)
    return launch_block<S>(in, ld_in, bs_in, weights, F, B, R, v, order, ok, s);
  *mode = kGeneric;
  // The device's whole opt-in budget, raised once per device.
  static OncePerDevice<size_t> limit;
  size_t budget = 0;
  const cudaError_t err = limit.get([](int dev, size_t* out) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, lu_panel_batched_kernel<S>);
    if (e != cudaSuccess) return e;
    *out = static_cast<size_t>(optin) - attr.sharedSizeBytes;
    return cudaFuncSetAttribute(lu_panel_batched_kernel<S>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*out));
  }, &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t need = static_cast<size_t>(R) * v * sizeof(T);
  const int in_shared = need <= budget ? 1 : 0;
  T* W = work_rows<S>(F, work);
  if (!in_shared && W == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  lu_panel_batched_kernel<S><<<B, kThreads, in_shared ? need : 0, s>>>(
      static_cast<const S*>(in), ld_in, bs_in, static_cast<const T*>(weights), W,
      static_cast<S*>(F), R, v, static_cast<int*>(order), static_cast<unsigned char*>(ok),
      in_shared);
  return static_cast<int>(cudaGetLastError());
}

// Every instance the launchers above can take (`attributes.cuh`).
const KernelInstance kInstances[] = {
    {"lu_panel_block_kernel<f32,1>", "f32", KI((lu_panel_block_kernel<float, 1>)), kBlockThreads<float> / 2, 0},
    {"lu_panel_block_kernel<f32,2>", "f32", KI((lu_panel_block_kernel<float, 2>)), kBlockThreads<float>, 0},
    {"lu_panel_grid_kernel<f32,1>", "f32", KI((lu_panel_grid_kernel<float, 1>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<f32,2>", "f32", KI((lu_panel_grid_kernel<float, 2>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<f32,4>", "f32", KI((lu_panel_grid_kernel<float, 4>)), kGridThreads, 0},
    {"lu_panel_kernel<f32>", "f32", KI(lu_panel_kernel<float>), kThreads, 0},
    {"lu_panel_batched_kernel<f32>", "f32", KI(lu_panel_batched_kernel<float>), kThreads, kOptinRest},
    {"lu_panel_block_kernel<f64,1>", "f64", KI((lu_panel_block_kernel<double, 1>)), kBlockThreads<double> / 2, 0},
    {"lu_panel_block_kernel<f64,2>", "f64", KI((lu_panel_block_kernel<double, 2>)), kBlockThreads<double>, 0},
    {"lu_panel_grid_kernel<f64,1>", "f64", KI((lu_panel_grid_kernel<double, 1>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<f64,2>", "f64", KI((lu_panel_grid_kernel<double, 2>)), kGridThreads, 0},
    {"lu_panel_kernel<f64>", "f64", KI(lu_panel_kernel<double>), kThreads, 0},
    {"lu_panel_batched_kernel<f64>", "f64", KI(lu_panel_batched_kernel<double>), kThreads, kOptinRest},
    {"lu_panel_block_kernel<bf16,1>", "bf16", KI((lu_panel_block_kernel<__nv_bfloat16, 1>)), kBlockThreads<float> / 2, 0},
    {"lu_panel_block_kernel<bf16,2>", "bf16", KI((lu_panel_block_kernel<__nv_bfloat16, 2>)), kBlockThreads<float>, 0},
    {"lu_panel_grid_kernel<bf16,1>", "bf16", KI((lu_panel_grid_kernel<__nv_bfloat16, 1>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<bf16,2>", "bf16", KI((lu_panel_grid_kernel<__nv_bfloat16, 2>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<bf16,4>", "bf16", KI((lu_panel_grid_kernel<__nv_bfloat16, 4>)), kGridThreads, 0},
    {"lu_panel_kernel<bf16>", "bf16", KI(lu_panel_kernel<__nv_bfloat16>), kThreads, 0},
    {"lu_panel_batched_kernel<bf16>", "bf16", KI(lu_panel_batched_kernel<__nv_bfloat16>), kThreads, kOptinRest},
    {"lu_panel_block_kernel<f16,1>", "f16", KI((lu_panel_block_kernel<__half, 1>)), kBlockThreads<float> / 2, 0},
    {"lu_panel_block_kernel<f16,2>", "f16", KI((lu_panel_block_kernel<__half, 2>)), kBlockThreads<float>, 0},
    {"lu_panel_grid_kernel<f16,1>", "f16", KI((lu_panel_grid_kernel<__half, 1>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<f16,2>", "f16", KI((lu_panel_grid_kernel<__half, 2>)), kGridThreads, 0},
    {"lu_panel_grid_kernel<f16,4>", "f16", KI((lu_panel_grid_kernel<__half, 4>)), kGridThreads, 0},
    {"lu_panel_kernel<f16>", "f16", KI(lu_panel_kernel<__half>), kThreads, 0},
    {"lu_panel_batched_kernel<f16>", "f16", KI(lu_panel_batched_kernel<__half>), kThreads, kOptinRest},
};

}  // namespace

KERNEL_INSTANCE_ENTRIES(lu_panel)

// Bytes of the scratch buffer a stream's launches share; zero-filled once.
extern "C" int lu_panel_scratch_bytes() { return static_cast<int>(kScratchBytes); }

// in: [R, v] panel with row stride ld_in (unit column stride); weights: [R]
// contiguous, of the compute type (f32 for a bf16 or f16 panel), read only;
// work: [R, v] of the compute type for the generic body with a bf16 or f16
// panel (v > 32 or more rows than the register bodies hold), else unused
// and may be null; F: [R, v] contiguous output of the panel's type; order:
// [v] int32; ok: [v] bool; scratch: lu_panel_scratch_bytes() bytes,
// zero-filled when allocated and used by one stream only.  1 <= v <= 128.
// Sets *mode to the body taken (`PanelMode`) and returns the cudaError_t of
// the launch.
#define LU_PANEL_ENTRY(suffix, S)                                                           \
  extern "C" int lu_panel_##suffix(const void* in, long long ld_in, const void* weights,    \
                                   void* work, void* F, int R, int v, void* order, void* ok, \
                                   void* scratch, int* mode, void* stream) {               \
    return launch<S>(in, ld_in, weights, work, F, R, v, order, ok, scratch, mode, stream); \
  }
LU_PANEL_ENTRY(f32, float)
LU_PANEL_ENTRY(f64, double)
LU_PANEL_ENTRY(bf16, __nv_bfloat16)
LU_PANEL_ENTRY(f16, __half)

// in: B panels [R, v], row stride ld_in and batch stride bs_in (unit column
// stride); weights: [B, R] contiguous, of the compute type, read only;
// work: [B, R, v] of the compute type for the generic body with a bf16 or
// f16 panel (v > 32 or R > 1024), else unused and may be null; F: [B, R, v]
// contiguous output; order: [B, v] int32; ok: [B, v] bool.  1 <= v <= 128,
// B >= 1.  Sets *mode to the body taken (`PanelMode`: the one-block body or
// the generic one) and returns the cudaError_t of the launch.
#define LU_PANEL_BATCHED_ENTRY(suffix, S)                                                  \
  extern "C" int lu_panel_batched_##suffix(const void* in, long long ld_in, long long bs_in, \
                                           const void* weights, void* work, void* F, int B,  \
                                           int R, int v, void* order, void* ok, int* mode,   \
                                           void* stream) {                                   \
    return launch_batched<S>(in, ld_in, bs_in, weights, work, F, B, R, v, order, ok, mode,  \
                             stream);                                                        \
  }
LU_PANEL_BATCHED_ENTRY(f32, float)
LU_PANEL_BATCHED_ENTRY(f64, double)
LU_PANEL_BATCHED_ENTRY(bf16, __nv_bfloat16)
LU_PANEL_BATCHED_ENTRY(f16, __half)

extern "C" const char* lu_panel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
