// Masked panel LUP: the v pivot / scale / rank-1 update rounds of COnfLUX's
// panel factorization, with rows masked instead of swapped (paper §7.3).
// Two kernels share the round arithmetic below: `lu_panel_kernel` spreads one
// panel over a cooperative grid, `lu_panel_batched_kernel` gives each of B
// panels a block of its own.
//
// Replaces: src/repro/kernels/lu_panel.py::lu_panel (body `_panel_rounds`)
// and ::lu_panel_batched (body `_batched_kernel`, the same rounds).
//
// What bounds it on an H100: not bytes.  On the main path the panel is
// [16384, 32] (2 MiB in f32), read and written once, a ~1.3 us floor at
// 3.35 TB/s.  The v rounds are strictly sequential and each needs a
// panel-wide argmax before the next can start, so the kernel is bound by the
// latency of v global reductions and of the row updates between them.
//
// Design of the single-panel kernel: the TPU kernel holds the whole panel in
// VMEM; a Hopper block has at most 227 KB of shared memory and one SM's share
// of the L2 bandwidth, so a single block would spend milliseconds per panel.
// Here the rows are split into contiguous slabs, one per block of a
// cooperative grid of up to one block per SM, and the panel stays in device
// memory (2 MiB stays resident in the 50 MB L2).  Each round k:
//   1. every block holds its best candidate for column k, the (value, index)
//      pair maximising |F[i, k]| * w[i] over its rows, in a double-buffered
//      partials array; a grid-wide barrier publishes them;
//   2. every block reduces all partials the same way, so all agree on the
//      pivot p without a second barrier.  Ties go to the lowest index, as
//      torch.argmax and jnp.argmax do; block 0 records order[k] and ok[k],
//      and p's owner masks w[p];
//   3. every block reads the pivot row (through L2, bypassing L1, since
//      another block wrote it) and, one warp per row with lanes over columns,
//      divides column k of its active rows by the pivot (a zero pivot divides
//      by 1) and applies F[i, k+1:] -= F[i, k] * F[p, k+1:].  The same pass
//      reads the updated column k + 1 and forms the next round's candidate.
// Rows with weight 0 are never written after the initial copy.  The grid
// barrier is an arrival counter and a generation word in device memory; a
// waiter that spins for seconds traps instead of hanging the card.
//
// Design of the batched kernel: the TPU runs one grid program per system
// with the panel in VMEM, and so does this one, one block per system.  Its
// panel and weights live in dynamic shared memory when R * (v + 1) elements
// fit a block's budget (R <= ~1700 rows in f32 at v = 32), and otherwise in
// the output buffer in device memory; the launcher picks by shape and the
// same code runs on either (generic pointers).  Each round is a block-wide
// argmax (warp shuffles, then per-warp partials), the pivot row read into
// shared memory, and the same one-warp-per-row update as above, with
// __syncthreads() in place of the grid barrier.  A small batch leaves most
// SMs idle; that is the price of needing no grid barrier.
//
// Bit-exactness: every product, difference and quotient uses the
// round-to-nearest intrinsics (__fmul_rn, __fsub_rn, __fdiv_rn and their
// double forms), which nvcc never contracts into an FMA.  The plain PyTorch
// versions (repro_torch/kernels/ref.py::lu_panel and ::lu_panel_batched)
// round the same operations in the same order, so both kernels agree with
// them, and a batched lane with the single kernel, bit for bit on the card.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "once_per_device.cuh"
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 128;
constexpr int kMaxBlocks = 256;     // partials slots; at most kThreads
constexpr int kMinRowsPerBlock = 32;
constexpr long long kSpinLimit = 1ll << 27;  // ~10 s of 64 ns sleeps

// Scratch layout (zero-filled by the caller before each launch):
// part_val [2][kMaxBlocks] doubles, part_idx [2][kMaxBlocks] ints, barrier
// [2] unsigned ints (arrivals, generation).
constexpr size_t kValBytes = 2 * kMaxBlocks * sizeof(double);
constexpr size_t kIdxBytes = 2 * kMaxBlocks * sizeof(int);
constexpr size_t kScratchBytes = kValBytes + kIdxBytes + 2 * sizeof(unsigned int);

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// (va, ia) beats (vb, ib): larger value, or equal value and lower index.
template <typename T>
__device__ __forceinline__ bool beats(T va, int ia, T vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T ov = __shfl_down_sync(0xffffffffu, best, off);
    int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (beats(ov, oi, best, idx)) {
      best = ov;
      idx = oi;
    }
  }
}

// Block-wide argmax; thread 0 ends with the result.  All threads must call.
template <typename T>
__device__ __forceinline__ void block_argmax(T& best, int& idx, T* red_val, int* red_idx) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  warp_argmax(best, idx);
  if (lane == 0) {
    red_val[warp] = best;
    red_idx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? red_val[lane] : T(-1);
    idx = lane < kWarps ? red_idx[lane] : INT_MAX;
    warp_argmax(best, idx);
  }
}

// Grid-wide barrier for a cooperative launch: every block's writes before it
// are visible to every block after it.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(const T* __restrict__ in, int64_t ld_in, T* F, T* w, int R, int v,
                int* order, unsigned char* ok, unsigned char* scratch) {
  __shared__ T red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ T prow[kMaxV];
  __shared__ T s_best;
  __shared__ int s_p;

  T* part_val = reinterpret_cast<T*>(scratch);  // [2][kMaxBlocks]
  int* part_idx = reinterpret_cast<int*>(scratch + kValBytes);
  unsigned int* bar = reinterpret_cast<unsigned int*>(scratch + kValBytes + kIdxBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nblocks = gridDim.x;
  const int rows_per_block = (R + nblocks - 1) / nblocks;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);

  // Copy this block's rows and form the candidates for column 0.  Row i is
  // always handled by warp (i - r0) % kWarps, each lane on its own columns.
  T best = T(-1);
  int bi = INT_MAX;
  for (int i = r0 + warp; i < r1; i += kWarps) {
    const T* src = in + static_cast<int64_t>(i) * ld_in;
    T* row = F + static_cast<int64_t>(i) * v;
    for (int j = lane; j < v; j += 32) row[j] = src[j];
    const T c = mul_rn(fabs(src[0]), w[i]);
    if (c > best) {  // rows ascend, so strict > keeps the lowest index
      best = c;
      bi = i;
    }
  }
  block_argmax(best, bi, red_val, red_idx);
  if (tid == 0) {
    part_val[blockIdx.x] = best;
    part_idx[blockIdx.x] = bi;
  }

  for (int k = 0; k < v; ++k) {
    grid_barrier(bar, nblocks);

    // 2. The pivot, from every block's candidate.
    const int buf = (k & 1) * kMaxBlocks;
    best = T(-1);
    bi = INT_MAX;
    if (tid < nblocks) {
      best = __ldcg(part_val + buf + tid);
      bi = __ldcg(part_idx + buf + tid);
    }
    block_argmax(best, bi, red_val, red_idx);
    if (tid == 0) {
      s_best = best;
      s_p = bi;
    }
    __syncthreads();
    const int p = s_p;
    if (tid == 0) {
      if (blockIdx.x == 0) {
        order[k] = p;
        ok[k] = s_best > T(0) ? 1 : 0;
      }
      if (p >= r0 && p < r1) w[p] = T(0);
    }
    if (tid < v) prow[tid] = __ldcg(F + static_cast<int64_t>(p) * v + tid);
    __syncthreads();

    // 3. Scale and update the active rows; form the next round's candidates.
    const T piv = prow[k];
    const T safe = fabs(piv) > T(0) ? piv : T(1);
    best = T(-1);
    bi = INT_MAX;
    for (int i = r0 + warp; i < r1; i += kWarps) {
      T* row = F + static_cast<int64_t>(i) * v;
      const T wi = w[i];
      if (wi > T(0)) {
        const T m = div_rn(row[k], safe);
        __syncwarp();
        for (int j = lane; j < v; j += 32) {
          if (j == k) {
            row[j] = m;
          } else if (j > k) {
            row[j] = sub_rn(row[j], mul_rn(m, prow[j]));
          }
        }
        __syncwarp();
      }
      if (k + 1 < v) {
        const T c = mul_rn(fabs(row[k + 1]), wi);
        if (c > best) {
          best = c;
          bi = i;
        }
      }
    }
    if (k + 1 < v) {
      block_argmax(best, bi, red_val, red_idx);
      if (tid == 0) {
        const int nbuf = ((k + 1) & 1) * kMaxBlocks;
        part_val[nbuf + blockIdx.x] = best;
        part_idx[nbuf + blockIdx.x] = bi;
      }
    }
  }
}

template <typename T>
int launch(const void* in, long long ld_in, void* F, void* w, int R, int v, void* order,
           void* ok, void* scratch, void* stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nblocks = (R + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  nblocks = nblocks < sms ? nblocks : sms;
  nblocks = nblocks < kMaxBlocks ? nblocks : kMaxBlocks;
  const T* in_t = static_cast<const T*>(in);
  int64_t ld = ld_in;
  T* F_t = static_cast<T*>(F);
  T* w_t = static_cast<T*>(w);
  int* order_t = static_cast<int*>(order);
  unsigned char* ok_t = static_cast<unsigned char*>(ok);
  unsigned char* scratch_t = static_cast<unsigned char*>(scratch);
  void* args[] = {&in_t, &ld, &F_t, &w_t, &R, &v, &order_t, &ok_t, &scratch_t};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lu_panel_kernel<T>),
                                    dim3(nblocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_panel_batched_kernel(const T* __restrict__ in, int64_t ld_in, int64_t bs_in, T* F, T* w,
                        int R, int v, int* order, unsigned char* ok, int in_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ T prow[kMaxV];
  __shared__ int s_p;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t b = blockIdx.x;
  const T* src_b = in + b * bs_in;
  T* Fg = F + b * R * v;
  T* wg = w + b * R;
  // The working panel and weights: shared memory, or the outputs themselves.
  T* Fw = in_shared ? reinterpret_cast<T*>(smem_raw) : Fg;
  T* ww = in_shared ? reinterpret_cast<T*>(smem_raw) + static_cast<int64_t>(R) * v : wg;
  int* order_b = order + b * v;
  unsigned char* ok_b = ok + b * v;

  if (in_shared) {
    for (int i = tid; i < R; i += kThreads) ww[i] = wg[i];
    __syncthreads();
  }
  // Copy the rows and form the candidates for column 0.  Row i is always
  // handled by warp i % kWarps, each lane on its own columns.
  T best = T(-1);
  int bi = INT_MAX;
  for (int i = warp; i < R; i += kWarps) {
    const T* src = src_b + static_cast<int64_t>(i) * ld_in;
    T* row = Fw + static_cast<int64_t>(i) * v;
    for (int j = lane; j < v; j += 32) row[j] = src[j];
    const T c = mul_rn(fabs(src[0]), ww[i]);
    if (c > best) {  // rows ascend, so strict > keeps the lowest index
      best = c;
      bi = i;
    }
  }

  for (int k = 0; k < v; ++k) {
    // The pivot: a block-wide argmax of the candidates.
    block_argmax(best, bi, red_val, red_idx);
    if (tid == 0) {
      const int pk = bi < R ? bi : 0;  // only a NaN panel leaves no candidate
      s_p = pk;
      order_b[k] = pk;
      ok_b[k] = best > T(0) ? 1 : 0;
      ww[pk] = T(0);
    }
    __syncthreads();
    const int p = s_p;
    if (tid < v) prow[tid] = Fw[static_cast<int64_t>(p) * v + tid];
    __syncthreads();

    // Scale and update the active rows; form the next round's candidates.
    const T piv = prow[k];
    const T safe = fabs(piv) > T(0) ? piv : T(1);
    best = T(-1);
    bi = INT_MAX;
    for (int i = warp; i < R; i += kWarps) {
      T* row = Fw + static_cast<int64_t>(i) * v;
      const T wi = ww[i];
      if (wi > T(0)) {
        const T m = div_rn(row[k], safe);
        __syncwarp();
        for (int j = lane; j < v; j += 32) {
          if (j == k) {
            row[j] = m;
          } else if (j > k) {
            row[j] = sub_rn(row[j], mul_rn(m, prow[j]));
          }
        }
        __syncwarp();
      }
      if (k + 1 < v) {
        const T c = mul_rn(fabs(row[k + 1]), wi);
        if (c > best) {
          best = c;
          bi = i;
        }
      }
    }
  }

  if (in_shared) {
    __syncthreads();
    const int64_t n = static_cast<int64_t>(R) * v;
    for (int64_t idx = tid; idx < n; idx += kThreads) Fg[idx] = Fw[idx];
  }
}

template <typename T>
int launch_batched(const void* in, long long ld_in, long long bs_in, void* F, void* w, int B,
                   int R, int v, void* order, void* ok, void* stream) {
  // The device's whole opt-in budget, raised once per device.
  static OncePerDevice<size_t> limit;
  size_t budget = 0;
  const cudaError_t err = limit.get([](int dev, size_t* out) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, lu_panel_batched_kernel<T>);
    if (e != cudaSuccess) return e;
    *out = static_cast<size_t>(optin) - attr.sharedSizeBytes;
    return cudaFuncSetAttribute(lu_panel_batched_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*out));
  }, &budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t need = (static_cast<size_t>(R) * v + R) * sizeof(T);
  const int in_shared = need <= budget ? 1 : 0;
  lu_panel_batched_kernel<T><<<B, kThreads, in_shared ? need : 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), ld_in, bs_in, static_cast<T*>(F), static_cast<T*>(w), R, v,
      static_cast<int*>(order), static_cast<unsigned char*>(ok), in_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of zero-filled scratch each launch needs.
extern "C" int lu_panel_scratch_bytes() { return static_cast<int>(kScratchBytes); }

// in: [R, v] panel with row stride ld_in (unit column stride); F: [R, v]
// contiguous output; w: [R] weights, overwritten; order: [v] int32; ok: [v]
// bool; scratch: lu_panel_scratch_bytes() zeroed bytes.  v <= 128.
// Returns the cudaError_t of the launch.
extern "C" int lu_panel_f32(const void* in, long long ld_in, void* F, void* w, int R, int v,
                            void* order, void* ok, void* scratch, void* stream) {
  return launch<float>(in, ld_in, F, w, R, v, order, ok, scratch, stream);
}

extern "C" int lu_panel_f64(const void* in, long long ld_in, void* F, void* w, int R, int v,
                            void* order, void* ok, void* scratch, void* stream) {
  return launch<double>(in, ld_in, F, w, R, v, order, ok, scratch, stream);
}

// in: B panels [R, v], row stride ld_in and batch stride bs_in (unit column
// stride); F: [B, R, v] contiguous output; w: [B, R] contiguous weights,
// overwritten; order: [B, v] int32; ok: [B, v] bool.  v <= 128, B >= 1.
// Returns the cudaError_t of the launch.
extern "C" int lu_panel_batched_f32(const void* in, long long ld_in, long long bs_in, void* F,
                                    void* w, int B, int R, int v, void* order, void* ok,
                                    void* stream) {
  return launch_batched<float>(in, ld_in, bs_in, F, w, B, R, v, order, ok, stream);
}

extern "C" int lu_panel_batched_f64(const void* in, long long ld_in, long long bs_in, void* F,
                                    void* w, int B, int R, int v, void* order, void* ok,
                                    void* stream) {
  return launch_batched<double>(in, ld_in, bs_in, F, w, B, R, v, order, ok, stream);
}

extern "C" const char* lu_panel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
