// Selective scan of the Mamba-1 SSM, with its final state:
//
//   h_t = a_t * h_{t-1} + b_t,   y_t[i] = sum_n C_t[n] h_t[i, n],   h_0 = 0,
//
// for a and b [B, S, di, N] and C [B, S, N], all f32 and contiguous; writes
// y [B, S, di] and the last state h_S [B, di, N].
//
// Replaces: src/repro/kernels/mamba_scan.py::mamba_scan (body `_kernel`).
// Its grid is (B, d_inner tiles, seq chunks), with the chunk axis sequential
// so the [bd, N] state persists in VMEM from one chunk to the next, and a
// fori over the chunk's steps inside.  Here blocks run in parallel and in no
// order, so the sequential axis is a loop over all S steps inside the
// thread.  The TPU kernel leaves the state in scratch after its last chunk;
// this one writes it out, since the prefill -> decode handoff of
// `mamba_forward(return_state=True)` needs it (mamba.py:124-130).
//
// What bounds it on an H100: bytes.  At falcon-mamba-7b's prefill shape
// (B = 2, S = 2048, di = 8192, N = 16) a and b are 2.1 GB each, C, y and h_S
// another 0.14 GB: 4.43 GB at 3.35 TB/s is 1.32 ms, against 4 B S di N =
// 2.2e9 operations, 0.03 ms at 67 TFLOP/s.  The design streams a and b once
// with coalesced loads and never writes h: the [B, S, di, N] state history
// that the JAX model's chunked associative scan builds (mamba.py:116-118) is
// what the kernel saves.
//
// Design:
// - One thread per (batch, channel i, state n), N consecutive lanes per
//   channel, so for one step t the loads of a and b are contiguous over
//   (di, N) and coalesce into full 128-byte lines.  h is a register.
// - y_t[i] is the sum over the N lanes of a channel: warp shuffles inside
//   groups of N lanes (N a power of two <= 32), and lane n = 0 writes it.
//   C_t is the same N values for every channel: broadcast loads.
// - The loop over t is unrolled so the loads of later steps, which do not
//   depend on h, are in flight while the dependent chain runs.
// - h rounds the product and the sum separately (__fmul_rn, __fadd_rn), as
//   the plain version's two PyTorch operations do, so nvcc does not contract
//   them into an FMA and the final state equals the plain version's bit for
//   bit.  y sums its N products in another order than PyTorch's reduction,
//   so it agrees within a stated tolerance.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ C, float* __restrict__ y, float* __restrict__ hS,
                  int S, int di, int64_t total) {
  const int64_t t_id = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = t_id < total;
  const int64_t pair = valid ? t_id : 0;
  const int64_t per_batch = static_cast<int64_t>(di) * N;
  const int64_t bi = pair / per_batch;
  const int64_t rem = pair - bi * per_batch;  // i * N + n
  const int i = static_cast<int>(rem / N);
  const int n = static_cast<int>(rem - static_cast<int64_t>(i) * N);

  const float* ap = a + bi * S * per_batch + rem;
  const float* bp = b + bi * S * per_batch + rem;
  const float* cp = C + bi * S * N + n;
  float* yp = y + bi * S * di + i;

  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const int64_t off = static_cast<int64_t>(t) * per_batch;
    const float at = valid ? ap[off] : 0.f;
    const float bt = valid ? bp[off] : 0.f;
    const float ct = valid ? cp[static_cast<int64_t>(t) * N] : 0.f;
    h = __fadd_rn(__fmul_rn(at, h), bt);
    float yt = __fmul_rn(ct, h);
#pragma unroll
    for (int o = N / 2; o > 0; o >>= 1) {
      yt = __fadd_rn(yt, __shfl_xor_sync(0xffffffffu, yt, o, N));
    }
    if (valid && n == 0) yp[static_cast<int64_t>(t) * di] = yt;
  }
  if (valid) hS[pair] = h;
}

template <int N>
int launch_n(const float* a, const float* b, const float* C, float* y, float* hS, int B, int S,
             int di, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * di * N;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, b, C, y, hS, S, di, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b [B, S, di, N], C [B, S, N], y [B, S, di] and hS [B, di, N], all f32
// and contiguous.  N in {1, 2, 4, 8, 16, 32}, B, S, di >= 1.  Returns the
// cudaError_t of the launch.
extern "C" int mamba_scan_f32(const void* a, const void* b, const void* C, void* y, void* hS,
                              int B, int S, int di, int N, void* stream_ptr) {
  if (B < 1 || S < 1 || di < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pc = static_cast<const float*>(C);
  float* py = static_cast<float*>(y);
  float* ph = static_cast<float*>(hS);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (N) {
    case 1: return launch_n<1>(pa, pb, pc, py, ph, B, S, di, stream);
    case 2: return launch_n<2>(pa, pb, pc, py, ph, B, S, di, stream);
    case 4: return launch_n<4>(pa, pb, pc, py, ph, B, S, di, stream);
    case 8: return launch_n<8>(pa, pb, pc, py, ph, B, S, di, stream);
    case 16: return launch_n<16>(pa, pb, pc, py, ph, B, S, di, stream);
    case 32: return launch_n<32>(pa, pb, pc, py, ph, B, S, di, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
