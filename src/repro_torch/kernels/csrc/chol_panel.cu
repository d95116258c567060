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
// sequential, each a square root, a division and a rank-1 update of the
// block, so the kernel is bound by the latency of those rounds.
//
// Design for v <= 32 (every path's v), `chol_panel_warp_kernel`: one warp
// per system and the block in registers, lane i holding row i (32 values,
// unrolled; v == 32 is an instantiation of its own, so no guard on v is
// left in the rounds).  Lane i reads and writes its own row, a full aligned
// row in 16-byte runs that use every byte of each sector they touch.  The
// code is straight-line and one warp issues it, so the kernel's time goes
// with the instructions of a round and with its dependent latencies:
//   - round k: every lane takes d = sqrt(S[k][k]) and l_i = S[i][k] / d
//     (i > k, else 0), sets column k to l_i + d e_k and takes
//     S[i][j] - l_i l_j for j > k;
//   - the critical path first: lane k + 1 forms the next pivot from its own
//     l and one shuffle hands it to every lane, while the l_j reach the
//     lanes through a row of l in shared memory that the whole warp reads
//     16 bytes at a time (a broadcast); two such rows by turns need one
//     __syncwarp a round and no barrier;
//   - the columns j <= k take l_i * 0 in round k (l_j = 0 there), which
//     changes a value only to spread a NaN or to turn -0 into +0, so those
//     subtractions are applied after the rounds as one addition that gives
//     the same bits in the lower triangle (see the kernel).
// One system per block: packing two or four systems' warps into a block was
// no faster on the [256, 32, 32] stack (PERF.md).
//
// Design for 32 < v <= 128, `chol_panel_smem_kernel` (off every path; the
// TPU kernel's one program per block with the block in VMEM): one CUDA block
// per system, the [v, v] block in dynamic shared memory (up to 128 KiB in
// f64, so the launcher raises the block's limit once per device), warps on
// rows and lanes on columns; per round a barrier after the column l is
// formed and one after the update.
//
// The shared-memory body runs the update over the full block, as the
// reference does; the register body does too, except that it folds the zero
// terms of finished columns as above, with the same bits.  So a NaN pivot or
// a non-finite entry (a block that is not SPD) spreads the same way and
// nothing raises.  Bit-exactness: every product, difference, sum, quotient
// and root uses the round-to-nearest intrinsics, which nvcc never contracts
// into an FMA.  The plain PyTorch version (repro_torch/kernels/ref.py::
// chol_panel_batched) rounds the same elementwise operations in the same
// order, so the kernel agrees with it bit for bit wherever the block lives,
// and a batched lane with the single call.
//
// bf16 and f16 (`storage.cuh`): both bodies are templates on the storage
// type St and compute in T = compute_t<St> (f32 for both), as the Pallas
// kernel does: every value widens exactly as it is loaded, the rows in
// registers, the round's l and the shared-memory block are in T, and each
// result is rounded once, to nearest even, as it is stored (the zeros above
// the diagonal too).  So the 2-byte kernel runs the f32 body's operations in
// its order and agrees bit for bit with the plain version, which widens,
// factors in f32 and rounds once.  The register body reads and writes a
// 2-byte row of v = 32 (64 bytes) in 16-byte runs of eight values as well.

#include <cstdint>

#include <cuda_runtime.h>

#include "once_per_device.cuh"
#include "storage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kThreads = 256;       // the shared-memory body
constexpr int kSmemWarps = kThreads / kWarp;
constexpr int kMaxV = 128;

// One 16-byte run: four f32, two f64 or eight bf16 / f16 values (l is read
// by the whole warp at once).
template <typename T>
struct alignas(16) Run {
  T x[16 / sizeof(T)];
};

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

// Whether rows of T starting at p with row stride ld can be read 16 bytes at a time.
template <typename T>
__device__ __forceinline__ bool aligned(const T* p, int64_t ld) {
  return (reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(ld * sizeof(T))) % 16 == 0;
}

// kV32: v == 32, every guard on v known at compile time.  St is the
// storage type, T the compute type.
template <typename St, bool kV32>
__global__ void __launch_bounds__(kWarp)
chol_panel_warp_kernel(const St* __restrict__ A, int64_t lda, int64_t bsa, St* __restrict__ L,
                       int v_arg) {
  using T = compute_t<St>;
  __shared__ __align__(16) T lrow[2 * kWarp];  // [2][32]: the rounds' l, by turns
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  constexpr int kRun = 16 / sizeof(T);
  constexpr int kIoRun = 16 / sizeof(St);  // values of a 16-byte run in storage
  const int v = kV32 ? kWarp : v_arg;
  const St* src = A + b * bsa;
  St* dst = L + b * static_cast<int64_t>(v) * v;

  // In: lane i reads row i, every load issued before the first is waited
  // on; a full aligned row in 16-byte runs.
  T s[kWarp];
  const St* row = src + lane * lda;
  if (kV32 && aligned(src, lda)) {
#pragma unroll
    for (int j0 = 0; j0 < kWarp; j0 += kIoRun) {
      const Run<St> run = *reinterpret_cast<const Run<St>*>(row + j0);
#pragma unroll
      for (int e = 0; e < kIoRun; ++e) s[j0 + e] = widen(run.x[e]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWarp; ++j) s[j] = lane < v && j < v ? widen(row[j]) : T(0);
  }

  // Round k subtracts z = l * 0 from every column j <= k (l_j = 0 there).
  // Those subtractions are applied after the rounds as one addition of w,
  // the sum of every round's -z (see below).
  T w = T(-0.0);
  T pivot = __shfl_sync(kAllLanes, s[0], 0);
  T d = sqrt_rn(pivot);
#pragma unroll
  for (int k = 0; k < kWarp; ++k) {
    if (k >= v) break;
    const T q = div_rn(s[k], d);
    const T l = lane > k ? q : T(0);
    s[k] = add_rn(l, mul_rn(d, lane == k ? T(1) : T(0)));
    w = add_rn(w, -mul_rn(l, T(0)));
    if (k + 1 == kWarp) break;
    // The critical path first: the next pivot from lane k + 1's own l (the
    // value the update gives S[k+1][k+1]), then column k + 1 of every row.
    pivot = __shfl_sync(kAllLanes, sub_rn(s[k + 1], mul_rn(l, l)), k + 1);
    T* lk = lrow + (k % 2) * kWarp;  // two rows by turns: one __syncwarp a round
    lk[lane] = l;
    __syncwarp();
    s[k + 1] = sub_rn(s[k + 1], mul_rn(l, lk[k + 1]));
    // The rest of the row while the pivot is in flight: l_j for j > k + 1,
    // four (f32) or two (f64) at a time from one broadcast read.
#pragma unroll
    for (int j0 = (k + 2) / kRun * kRun; j0 < kWarp; j0 += kRun) {
      const Run<T> lj = *reinterpret_cast<const Run<T>*>(lk + j0);
#pragma unroll
      for (int e = 0; e < kRun; ++e)
        if (j0 + e > k + 1) s[j0 + e] = sub_rn(s[j0 + e], mul_rn(l, lj.x[e]));
    }
    d = sqrt_rn(pivot);
  }
  // Column j took z_j, z_{j+1}, ... in turn after it was set in round j
  // (this lane's z is +0 from round k = lane on).  Subtracting a zero
  // changes x only if x is -0 or the zero is NaN, and sums of signed zeros
  // and NaN are exact in any order, so that sequence is one addition of the
  // sum of its -z.  The sum w over every round gives the same in each
  // column j <= lane, the lower triangle that is kept:
  //   - a set value l + d * 0 is never -0, so the sign of w cannot matter;
  //   - a NaN z_k with k < j means l_k was infinite or NaN, which made this
  //     lane's column j infinite or NaN in round k; then in round j either
  //     z_j is NaN (j < lane) or the pivot, hence d and the set value, is
  //     NaN (j = lane), so the sequence gives NaN as w does.
#pragma unroll
  for (int j = 0; j < kWarp; ++j) s[j] = add_rn(s[j], w);

  // Out: lane i writes row i, its upper part zeroed.
#pragma unroll
  for (int j = 0; j < kWarp; ++j) s[j] = j <= lane ? s[j] : T(0);
  St* out = dst + lane * v;
  if (kV32) {  // dst is a fresh allocation: aligned
#pragma unroll
    for (int j0 = 0; j0 < kWarp; j0 += kIoRun) {
      Run<St> run;
#pragma unroll
      for (int e = 0; e < kIoRun; ++e) run.x[e] = narrow<St>(s[j0 + e]);
      *reinterpret_cast<Run<St>*>(out + j0) = run;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWarp; ++j)
      if (lane < v && j < v) out[j] = narrow<St>(s[j]);
  }
}

template <typename St>
__global__ void __launch_bounds__(kThreads)
chol_panel_smem_kernel(const St* __restrict__ A, int64_t lda, int64_t bsa, St* __restrict__ L,
                       int v) {
  using T = compute_t<St>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = v + 1;  // padded row stride: column reads hit distinct banks
  T* S = reinterpret_cast<T*>(smem_raw);  // [v][ld]: the working block
  T* l = S + v * ld;                      // [v]: this round's column
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;

  const int64_t b = blockIdx.x;
  const St* src = A + b * bsa;
  St* dst = L + b * static_cast<int64_t>(v) * v;

  for (int i = warp; i < v; i += kSmemWarps)
    for (int j = lane; j < v; j += kWarp) S[i * ld + j] = widen(src[i * lda + j]);

  for (int k = 0; k < v; ++k) {
    __syncthreads();
    const T d = sqrt_rn(S[k * ld + k]);
    for (int i = threadIdx.x; i < v; i += kThreads)
      l[i] = i > k ? div_rn(S[i * ld + k], d) : T(0);
    __syncthreads();
    for (int i = warp; i < v; i += kSmemWarps) {
      const T li = l[i];
      for (int j = lane; j < v; j += kWarp) {
        T a = S[i * ld + j];
        if (j == k) a = add_rn(li, mul_rn(d, i == k ? T(1) : T(0)));
        S[i * ld + j] = sub_rn(a, mul_rn(li, l[j]));
      }
    }
  }
  __syncthreads();

  for (int i = warp; i < v; i += kSmemWarps)
    for (int j = lane; j < v; j += kWarp)
      dst[i * v + j] = narrow<St>(i >= j ? S[i * ld + j] : T(0));
}

// S: the storage type.  The shared-memory body's block is in its compute type.
template <typename S>
int launch(const void* A, long long lda, long long bsa, void* L, int B, int v, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= kWarp) {
    const auto kernel = v == kWarp ? chol_panel_warp_kernel<S, true>
                                   : chol_panel_warp_kernel<S, false>;
    kernel<<<B, kWarp, 0, s>>>(static_cast<const S*>(A), lda, bsa, static_cast<S*>(L), v);
    return static_cast<int>(cudaGetLastError());
  }
  // The limit is raised once per device, for the widest block.
  using T = compute_t<S>;
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(chol_panel_smem_kernel<S>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxV * (kMaxV + 2) * sizeof(T)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(v) * (v + 2) * sizeof(T);
  chol_panel_smem_kernel<S><<<B, kThreads, smem, s>>>(static_cast<const S*>(A), lda, bsa,
                                                      static_cast<S*>(L), v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B blocks A [v, v] with row stride lda, batch stride bsa and unit column
// stride; L: [B, v, v] contiguous output, of A's element type (the entry's
// suffix).  1 <= v <= 128, 1 <= B < 2^31.  Returns the cudaError_t of the
// launch.
#define CHOL_ENTRY(suffix, S)                                                                \
  extern "C" int chol_panel_##suffix(const void* A, long long lda, long long bsa, void* L,  \
                                     int B, int v, void* stream) {                           \
    return launch<S>(A, lda, bsa, L, B, v, stream);                                          \
  }
CHOL_ENTRY(f32, float)
CHOL_ENTRY(f64, double)
CHOL_ENTRY(bf16, __nv_bfloat16)
CHOL_ENTRY(f16, __half)

extern "C" const char* chol_panel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
