// Forward attention with an online softmax: causal, sliding-window or
// bidirectional, softcapped or not, grouped-query (GQA, H % KV == 0):
//
//   out[b, s, h] = sum_j softmax_j(mask(cap(q[b, s, h] . k[b, j, h/gq] / sqrt(hd)))) v[b, j, h/gq]
//
// for q [B, S, H, hd] and k, v [B, S, KV, hd], all contiguous, bf16 or f32,
// out [B, S, H, hd] in the inputs' dtype.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
// `_kernel`).  Its grid is (batch * kv head, q tiles, kv tiles), with the kv
// axis sequential so that m, l and acc persist in VMEM from one kv tile to
// the next.  Here blocks run in parallel and in no order, so the kv axis is a
// loop inside the block: one block per (batch, kv head, q tile), and the
// block walks the kv tiles it needs.
//
// What bounds it on an H100: operations.  At qwen3-8b's prefill shape
// (B = 4, S = 2048, H = 32, KV = 8, hd = 128, bf16, causal) the two products
// take 4 B H hd S(S+1)/2 = 1.37e11 operations, 0.139 ms at the tensor cores'
// 989 TFLOP/s, against 168 MB of q, k, v and out, 0.05 ms at 3.35 TB/s.  This
// first kernel does not reach the tensor cores: both products are f32 FMAs on
// the SMs' CUDA cores (67 TFLOP/s at most), so it is some 15x above the
// bound at best.  `wgmma`, TMA and warp specialisation are for a later
// version; this one is right first.
//
// Design:
// - A q tile is kRows = 64 packed rows, row r = s * gq + g for query position
//   s and head g of the kv head's group, as the TPU kernel packs bq * gq rows
//   (flash_attention.py:77-79): each K/V tile staged in shared memory serves
//   all gq heads of the group, so it is read once per group.
// - 256 threads, 8 warps of 8 rows each.  In the QK product a lane owns two
//   keys of the 64-key tile (rows' q values are warp-wide broadcasts from
//   shared memory, the K tile has a padded row stride of hd + 1 floats so the
//   lanes' keys fall in distinct banks); the row max and sum are warp
//   shuffles, so every lane holds m, l and alpha of its warp's rows.  In the
//   PV product a lane owns the dims d = lane + 32 i of its warp's rows and
//   keeps acc in registers.  K and V take turns in one shared buffer.
// - Scores, m, l and acc are f32.  Softcap is cap * tanh(s / cap) in f32.  p
//   is rounded to the inputs' dtype before the PV product, as the reference
//   rounds it (flash_attention.py:53-55); l sums the unrounded p.
// - Masking is the reference's: a masked score is the finite -1e30, never
//   -inf (exp(-inf - -inf) is NaN).  A kv tile masked for every row of the
//   q tile is skipped: above the causal diagonal, left of the window.  A
//   tile masked for only some rows is processed, and for a row with no valid
//   key yet it adds exp(0) = 1 terms that the first tile with a valid key
//   resets through alpha = exp(-1e30 - m) = 0, exactly as the reference's
//   sequential kv grid does; so skipping gives the reference's answer and
//   halves a causal product's work.
// - Any S: the block computes its own offsets and masks the ragged q tile
//   (rows past S are not written) and kv tile (keys past S score -inf and
//   load as 0, so they add exactly nothing).  The TPU kernel asserted
//   S % bq == 0.
// - q tiles are issued in reverse order, so under a causal mask the blocks
//   with the most kv tiles start first.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;
constexpr int kKeys = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kMaxHd = 256;

// -inf, the score of a key past S only.
__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_floats(int hd) {
  // Q tile [kRows][hd], K or V tile [kKeys][hd + 1], P tile [kRows][kKeys]
  return static_cast<size_t>(kRows) * hd + static_cast<size_t>(kKeys) * (hd + 1) +
         static_cast<size_t>(kRows) * kKeys;
}

// DPL: dims per lane in the PV product, ceil(hd / 32).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, int H, int KV, int hd, int causal, int window,
                 float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [kRows][hd]
  float* KVs = Qs + kRows * hd;           // [kKeys][hd + 1]
  float* Ps = KVs + kKeys * (hd + 1);     // [kRows][kKeys]
  const int ldkv = hd + 1;

  const int gq = H / KV;
  const int64_t rows_total = static_cast<int64_t>(S) * gq;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(qt) * kRows;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y - b * KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage the q tile: packed row r -> position s = r / gq, head kvh * gq + r % gq.
  for (int idx = tid; idx < kRows * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int64_t gr = r0 + r;
    float x = 0.f;
    if (gr < rows_total) {
      const int64_t s = gr / gq;
      const int h = kvh * gq + static_cast<int>(gr - s * gq);
      x = to_f32(q[((static_cast<int64_t>(b) * S + s) * H + h) * hd + d]);
    }
    Qs[idx] = x;
  }

  // Positions of this warp's rows, and the block's range of positions.
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = static_cast<int>((r0 + warp * kRowsPerWarp + i) / gq);
  }
  const int q_lo = static_cast<int>(r0 / gq);
  const int64_t r_end = r0 + kRows < rows_total ? r0 + kRows : rows_total;
  const int q_hi = static_cast<int>((r_end - 1) / gq);
  // Keys some row of the tile may attend to: (q_lo - window, q_hi] under the
  // masks; every other kv tile is masked for every row and is skipped.
  const int kv_end = causal ? min(S, q_hi + 1) : S;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int j_first = (kv_begin / kKeys) * kKeys;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int64_t kv_row_stride = static_cast<int64_t>(KV) * hd;
  const T* kbase = k + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  const T* vbase = v + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  const float* qrows = Qs + warp * kRowsPerWarp * hd;
  float* prows = Ps + warp * kRowsPerWarp * kKeys;

  for (int j0 = j_first; j0 < kv_end; j0 += kKeys) {
    __syncthreads();  // the previous tile's V reads are done (and Qs is staged)
    for (int idx = tid; idx < kKeys * hd; idx += kThreads) {
      const int c = idx / hd;
      const int d = idx - c * hd;
      const int j = j0 + c;
      KVs[c * ldkv + d] = j < S ? to_f32(kbase[j * kv_row_stride + d]) : 0.f;
    }
    __syncthreads();

    // s = q . k for this warp's rows and this lane's keys j0 + lane, j0 + lane + 32.
    float s0[kRowsPerWarp], s1[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s0[i] = s1[i] = 0.f;
    const float* k0 = KVs + lane * ldkv;
    const float* k1 = KVs + (lane + 32) * ldkv;
    for (int d = 0; d < hd; d += 4) {
      const float ka[4] = {k0[d], k0[d + 1], k0[d + 2], k0[d + 3]};
      const float kb[4] = {k1[d], k1[d + 1], k1[d + 2], k1[d + 3]};
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qrows + i * hd + d);
        s0[i] += qv.x * ka[0];
        s0[i] += qv.y * ka[1];
        s0[i] += qv.z * ka[2];
        s0[i] += qv.w * ka[3];
        s1[i] += qv.x * kb[0];
        s1[i] += qv.y * kb[1];
        s1[i] += qv.z * kb[2];
        s1[i] += qv.w * kb[3];
      }
    }

    float alpha[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float sc[2] = {s0[i] * scale, s1[i] * scale};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + lane + 32 * u;
        if (softcap > 0.f) sc[u] = softcap * tanhf(sc[u] / softcap);
        bool ok = true;
        if (causal) ok = ok && j <= qpos[i];
        if (window > 0) ok = ok && j > qpos[i] - window;
        sc[u] = j >= S ? minus_inf() : (ok ? sc[u] : kNegInf);
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(sc[0], sc[1])));
      const float p0 = expf(sc[0] - m_new);
      const float p1 = expf(sc[1] - m_new);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      prows[i * kKeys + lane] = to_f32(from_f32<T>(p0));
      prows[i * kKeys + lane + 32] = to_f32(from_f32<T>(p1));
    }
    __syncthreads();  // all warps are done with K

    for (int idx = tid; idx < kKeys * hd; idx += kThreads) {
      const int c = idx / hd;
      const int d = idx - c * hd;
      const int j = j0 + c;
      KVs[c * ldkv + d] = j < S ? to_f32(vbase[j * kv_row_stride + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha[i];
    }
    for (int c = 0; c < kKeys; c += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          vv[u][e] = d < hd ? KVs[(c + u) * ldkv + d] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(prows + i * kKeys + c);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          acc[i][e] += pv.x * vv[0][e];
          acc[i][e] += pv.y * vv[1][e];
          acc[i][e] += pv.z * vv[2][e];
          acc[i][e] += pv.w * vv[3][e];
        }
      }
    }
  }

  // out = acc / l for this warp's rows that exist.
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t gr = r0 + warp * kRowsPerWarp + i;
    if (gr >= rows_total) continue;
    const int64_t s = gr / gq;
    const int h = kvh * gq + static_cast<int>(gr - s * gq);
    T* orow = out + ((static_cast<int64_t>(b) * S + s) * H + h) * hd;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) orow[d] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int DPL>
int launch_dpl(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int KV, int hd, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  // The limit is set for the widest head this instantiation takes, always to
  // the same value, so launches from several host threads never race on it.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_floats(32 * DPL) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_total = static_cast<int64_t>(S) * (H / KV);
  const dim3 grid(static_cast<unsigned>((rows_total + kRows - 1) / kRows), B * KV);
  flash_fwd_kernel<T, DPL><<<grid, kThreads, smem_floats(hd) * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int KV,
           int hd, int causal, int window, float softcap, float scale, void* stream_ptr) {
  if (hd < 16 || hd > kMaxHd || hd % 16 || KV < 1 || H % KV || S < 1 || B < 1 ||
      static_cast<int64_t>(B) * KV > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((hd + 31) / 32) {
    case 1: return launch_dpl<T, 1>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 2: return launch_dpl<T, 2>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 3: return launch_dpl<T, 3>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 4: return launch_dpl<T, 4>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 5: return launch_dpl<T, 5>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 6: return launch_dpl<T, 6>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    case 7: return launch_dpl<T, 7>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
    default: return launch_dpl<T, 8>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                                       stream);
  }
}

}  // namespace

// q [B, S, H, hd], k and v [B, S, KV, hd], out [B, S, H, hd], all contiguous
// and of one dtype.  16 <= hd <= 256 with hd % 16 == 0, H % KV == 0,
// B * KV <= 65535.  causal: 0 or 1; window: 0 for none, else the number of
// keys a query sees (itself included); softcap: 0 for none; scale: the
// scores' factor, hd^-1/2 rounded to f32 by the caller.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int H, int KV, int hd, int causal, int window,
                                    float softcap, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale,
                               stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int H, int KV, int hd, int causal, int window,
                                   float softcap, float scale, void* stream) {
  return launch<float>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap, scale, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
