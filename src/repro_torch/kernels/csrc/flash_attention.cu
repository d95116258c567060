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
// 989 TFLOP/s, against 168 MB of q, k, v and out, 0.05 ms at 3.35 TB/s.  So
// the bf16 kernel is built around the tensor cores, and around keeping them
// fed:
// - Both products are `wgmma` (warpgroup MMA, bf16 in, f32 accumulators in
//   registers), the only way to the tensor cores' full rate.  S = Q K^T reads
//   Q and the K tile from shared memory (both K-major); O += P V takes P from
//   registers, where the S accumulators turn into the A fragment without any
//   data movement (the bf16 rounding is the reference's p.astype(v.dtype)),
//   and the V tile from shared memory, MN-major (the transpose bit).  hd is
//   padded to HDP = 64 ceil(hd / 64), and the padded columns are zeros.
// - K and V arrive by TMA into a ring of three stages (two at hd > 192) in
//   128-byte-swizzled boxes of 64 columns that `wgmma` reads as they lie,
//   each stage with a "full" mbarrier.  There is no producer warp: thread 0
//   fills the ring, and each later refill is issued by the last of the eight
//   warps to release a stage (an atomic count per stage), kStages tiles
//   ahead, so the loads of the next tiles run under this tile's products.
// - A block is two warpgroups of 64 packed rows each (128 rows), 256
//   threads, so ptxas may give each thread up to 255 registers.  A producer
//   warpgroup would put three warps on each of the SM's four 16K-register
//   files and cap every thread at 168: measured, ptxas then spilled at
//   hd = 256 and had no room for a second P, and `setmaxnreg` did not raise
//   what it allocated.
// - The warpgroups take turns issuing products (ping-pong on two named
//   barriers), and within a warpgroup the softmax of tile t runs while the
//   PV of tile t - 1 does (two P buffers), so the exponentials overlap the
//   tensor cores.  The source keeps ptxas from serializing the products: the
//   warpgroup index is broadcast so descriptors stay in uniform registers,
//   no register a running product reads is written, and no product sits
//   under a branch ptxas sees as divergent.
// The f32 entry point keeps a SIMT body (f32 FMAs on the CUDA cores): a
// tensor-core product of f32 inputs is TF32, which keeps about three digits
// and would break the f32 parity of 2e-4 with the plain version.
//
// Semantics (both bodies):
// - Packed rows r = s * gq + g for query position s and head g of the kv
//   head's group, as the TPU kernel packs bq * gq rows (flash_attention.py:
//   77-79): each K/V tile in shared memory serves all gq heads of the group.
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
// - Any S: the block masks the ragged q tile (rows past S are not written)
//   and kv tile (keys past S score -inf and load as 0, so they add exactly
//   nothing; in the bf16 body TMA fills them with zeros, and the columns
//   past hd of a box too, so the padded QK steps add exactly 0).  The TPU
//   kernel asserted S % bq == 0.
// - q tiles are issued in reverse order, so under a causal mask the blocks
//   with the most kv tiles start first.
// - bf16 scores (the C entries' `bf16_scores`, the template argument BS of
//   both bodies): the scores are held as the reference's bf16 score buffers
//   hold them (ref.flash_attention(score_dtype=bf16), after the JAX
//   package's blocked_attention): the product rounded to bf16, times the
//   scale (rounded to bf16 by the caller), rounded; softcap's s / cap, tanh
//   and cap * tanh each rounded; a masked score is -1e30 rounded to bf16;
//   s - m (m taken to bf16) and p = exp(s - m) rounded; m, l and acc stay
//   f32, and l sums the rounded p.  The rounding is `__float2bfloat16_rn`
//   in registers.  The bf16 body folds no scale into exp2 there: the scale
//   must act before the rounding.  BS = false compiles to the f32-score
//   bodies as they were.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the driver call is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attributes.cuh"
#include "once_per_device.cuh"
#include "tma.cuh"
#include "wgmma.cuh"
namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kMaxHd = 256;

// -inf, the score of a key past S only.
__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

// x rounded to bf16 (to nearest, ties to even) and widened back: the bf16
// score buffers' rounding points.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The masked score where the scores are bf16: the reference adds the mask
// value taken to bf16, -1e30 rounded to -1.0002556e30 (BS: bf16 scores).
template <bool BS>
__device__ __forceinline__ float masked_score() {
  return BS ? -1.0002555517425873e30f : kNegInf;
}

// The score s = product * scale, softcapped, in f32 or held in bf16 as the
// reference's bf16 score buffers hold it: the product rounded, times the
// scale, rounded; then s / cap, tanh and cap * tanh each rounded (the caller
// passes the scale and the cap rounded to bf16, as the reference takes them).
__device__ __forceinline__ float bf16_score(float product, float scale, float softcap) {
  float x = bf16r(bf16r(product) * scale);
  if (softcap > 0.f) x = bf16r(softcap * bf16r(tanhf(bf16r(x / softcap))));
  return x;
}

// --------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// --------------------------------------------------------------------------

constexpr int kRows = 128;             // packed rows of a block: two warpgroups of 64
constexpr int kThreads = 256;          // the two warpgroups
constexpr int kBoxCols = 64;           // hd columns of a TMA box: one 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;

// The block's tiles for hd padded to HDP = 64 * ceil(hd / 64).  Shared
// memory, from a 1024-byte boundary (the 128-byte swizzle repeats every 8
// rows of 128 bytes): Q [HDP / 64 boxes][128 rows][128 B], then per stage
// of the K/V ring K and V [HDP / 64 boxes][kKeys rows][128 B], then a
// "full" mbarrier and a claim count per stage.  Three stages fit in the
// 227 KB a block may use except at HDP = 256.
template <int HDP>
struct Tiles {
  static constexpr int kKeys = HDP <= 128 ? 128 : 64;
  static constexpr int kStages = HDP <= 192 ? 3 : 2;
  static constexpr int kBoxes = HDP / kBoxCols;
  static constexpr uint32_t kQBox = kRows * 128;
  static constexpr uint32_t kKVBox = kKeys * 128;
  static constexpr uint32_t kQ = kBoxes * kQBox;
  static constexpr uint32_t kKV = kBoxes * kKVBox;  // one K or V tile
  static constexpr uint32_t kBarriers = kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem = 1024 + kBarriers + kStages * (8 + 4);
  static_assert(kSmem <= 232448, "a block may use at most 227 KB of shared memory");
};

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Named barriers 1..4 (0 is __syncthreads): bar.sync waits for `n` threads
// to arrive, counting its own; bar.arrive counts without waiting.
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Position r / gq of packed row r: a 32-bit division wherever r fits, as it
// does at any S a card holds (a 64-bit one is a call of ~100 instructions).
__device__ __forceinline__ int64_t position(int64_t r, int gq) {
  return r <= 0xffffffffll ? static_cast<int64_t>(static_cast<uint32_t>(r) /
                                                  static_cast<uint32_t>(gq))
                           : r / gq;
}

// The offset of packed row r's q / out row.
__device__ __forceinline__ int64_t row_offset(int64_t r, int b, int kvh, int gq, int S, int H,
                                              int hd) {
  const int64_t s = position(r, gq);
  const int h = kvh * gq + static_cast<int>(r - s * gq);
  return ((static_cast<int64_t>(b) * S + s) * H + h) * hd;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x, flushing results below 2^-126 to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HDP, bool BS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int S,
                      int H, int KV, int hd, int causal, int window, float softcap, float scale) {
  using T = Tiles<HDP>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base;                   // Q boxes
  const uint32_t skv = base + T::kQ;          // stage st: K at skv + 2 st kKV, V kKV after it
  const uint32_t sbar = base + T::kBarriers;  // full[st] at sbar + 8 st
  int* const claims = reinterpret_cast<int*>(base_ptr + T::kBarriers + 8 * kStages);

  const int gq = H / KV;
  const int64_t rows_total = static_cast<int64_t>(S) * gq;
  const int64_t r0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y - b * KV;
  // Keys some row of the tile may attend to: (q_lo - window, q_hi] under the
  // masks; every other kv tile is masked for every row and is skipped.
  const int q_lo = static_cast<int>(position(r0, gq));
  const int64_t r_end = r0 + kRows < rows_total ? r0 + kRows : rows_total;
  const int q_hi = static_cast<int>(position(r_end - 1, gq));
  const int kv_end = causal ? min(S, q_hi + 1) : S;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int j_first = (kv_begin / kKeys) * kKeys;
  const int n_tiles = (kv_end - j_first + kKeys - 1) / kKeys;

  // K and V of tile t into stage t % kStages, both counted on its "full"
  // barrier.
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    const uint32_t full = sbar + 8 * st;
    const uint32_t k_dst = skv + 2 * st * T::kKV;
    const int j0 = j_first + t * kKeys;
    mbar_expect_tx(full, 2 * T::kKV);
#pragma unroll
    for (int c = 0; c < T::kBoxes; ++c) {
      tma_load_4d(k_dst + c * T::kKVBox, &tm_k, full, c * kBoxCols, kvh, j0, b);
      tma_load_4d(k_dst + T::kKV + c * T::kKVBox, &tm_v, full, c * kBoxCols, kvh, j0, b);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sbar + 8 * st, 1);
      claims[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  // The warpgroup, broadcast from lane 0 so the compiler sees it uniform:
  // the products' descriptors are then built in uniform registers, not
  // moved there between products (which makes ptxas serialize them).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t w0 = r0 + wg * 64;  // this warpgroup's first packed row

  // Stage this warpgroup's 64 Q rows, 16 bytes a load, into the swizzled
  // boxes (16-byte chunk c of row r at chunk c ^ (r % 8)); zeros past hd and
  // past the last row.  A thread issues up to 8 loads before it stores any,
  // so the block waits for device memory once or twice, not once per chunk.
  constexpr int kChunks = HDP / 8;  // 16-byte chunks of a row
  constexpr int kPerThread = 64 * kChunks / 128;
  constexpr int kBatch = kPerThread <= 8 ? kPerThread : kPerThread / 2;
#pragma unroll
  for (int u0 = 0; u0 < kPerThread; u0 += kBatch) {
    uint4 qv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = (tid + 128 * (u0 + u)) / kChunks;
      const int c = (tid + 128 * (u0 + u)) % kChunks;
      qv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (w0 + r < rows_total && c * 8 < hd) {
        qv[u] = __ldg(reinterpret_cast<const uint4*>(
            q + row_offset(w0 + r, b, kvh, gq, S, H, hd) + c * 8));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = (tid + 128 * (u0 + u)) / kChunks;
      const int c = (tid + 128 * (u0 + u)) % kChunks;
      const int row = wg * 64 + r;
      const uint32_t off = (c >> 3) * T::kQBox + row * 128 + (((c & 7) ^ (row & 7)) << 4);
      *reinterpret_cast<uint4*>(base_ptr + off) = qv[u];
    }
  }
  // The products read Q through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg, 128);

  // This thread's two accumulator rows, w0 + ra and w0 + ra + 8.
  const int ra = warp * 16 + (lane >> 2);
  int pos_a = static_cast<int>(position(w0 + ra, gq));
  int pos_b = static_cast<int>(position(w0 + ra + 8, gq));
  // Kept as computed: recomputing them in the loop costs more than the two
  // registers.
  asm volatile("" : "+r"(pos_a), "+r"(pos_b));
  const int col0 = 2 * (lane & 3);
  // score units -> log2; bf16 scores are scaled where they are rounded.
  const float to_log2 = BS || softcap > 0.f ? kLog2e : scale * kLog2e;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t q_desc_base = sq + wg * 64 * 128;

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this thread's columns
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4], pb[kKeys / 16][4];  // P of the even and of the odd tiles

  // S = Q K^T of the tile in stage st, over hd in steps of 16 (32 bytes of
  // a 128-byte row); O += P V of the tile in stage st, over the keys in
  // steps of 16 (two 8-key swizzle atoms; the next 64 hd columns of V are
  // the next box, the leading byte offset).
  auto issue_qk = [&](int st) {
    const uint32_t sk = skv + 2 * st * T::kKV;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t in_box = (kk & 3) * 32;
      mma_ss<kKeys>(s, sw128_desc(q_desc_base + (kk >> 2) * T::kQBox + in_box, 16, 1024),
                    sw128_desc(sk + (kk >> 2) * T::kKVBox + in_box, 16, 1024), kk > 0);
    }
  };
  auto issue_pv = [&](int st, const uint32_t(&pt)[kKeys / 16][4]) {
    const uint32_t sv = skv + 2 * st * T::kKV + T::kKV;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      mma_rs<HDP>(o, pt[kk], sw128_desc(sv + kk * 2048, T::kKVBox, 1024));
    }
  };

  // Once a warp's products on tile t are done it claims the tile's stage;
  // the last of the eight warps to claim it refills it with tile t + kStages.
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) {
      const int st = t % kStages;
      __threadfence_block();
      if (atomicAdd(claims + st, 1) == kThreads / 32 - 1) {
        __threadfence_block();
        claims[st] = 0;
        if (t + kStages < n_tiles) load_tile(t + kStages);
      }
    }
  };

  // Scores stay in the exponent's units: raw q.k, whose factor
  // scale * log2(e) goes into exp2, or softcapped (factor log2(e)).  bf16
  // scores (BS) are the reference's bf16 values (`bf16_score`), scaled
  // before their rounding, so their factor is log2(e): `shape` makes them
  // in a shaped tile, `softmax` in any other.  A masked score is -1e30 in
  // either (in bf16, -1e30 rounded), as m starts, far below every real score:
  // exp2((s - m) to_log2) is 1 while a row has seen only masked keys and 0
  // once it has a real one, as in the reference.  Most tiles need neither a
  // softcap nor a mask and leave s as the product wrote it; the others
  // rewrite s in place, each step a straight run over the fragment.
  // The mask test uses the block's range of positions, not the warpgroup's:
  // ptxas must see the branch as uniform, or it serializes the products.
  auto shaped = [&](int t) {
    const int j0 = j_first + t * kKeys;
    return softcap > 0.f || (causal && j0 + kKeys - 1 > q_lo) ||
           (window > 0 && j0 <= q_hi - window) || j0 + kKeys > S;
  };
  auto shape = [&](int t) {
    const int j0 = j_first + t * kKeys;
    if constexpr (BS) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = bf16_score(s[i], scale, softcap);
    } else if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = softcap * tanhf(s[i] * scale * inv_cap);
    }
    if ((causal && j0 + kKeys - 1 > q_lo) || (window > 0 && j0 <= q_hi - window) ||
        j0 + kKeys > S) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int j = j0 + col0 + 8 * (i >> 2) + (i & 1);
        const int pos = (i & 2) ? pos_b : pos_a;
        const bool ok = (!causal || j <= pos) && (window <= 0 || j > pos - window);
        s[i] = j >= S ? minus_inf() : (ok ? s[i] : masked_score<BS>());
      }
    }
  };
  // The softmax of the scores in s: bf16 P fragments `pt`, m and l
  // updated, alpha = exp(m_old - m_new) per row.  With bf16 scores, the
  // scores of a tile that `shape` did not rewrite (`shaped` false) are made
  // here first; s - m and p are rounded to bf16, and l sums the rounded p.
  auto softmax = [&](uint32_t(&pt)[kKeys / 16][4], float& alpha_a, float& alpha_b,
                     bool shaped_tile) {
    if constexpr (BS) {
      if (!shaped_tile) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] = bf16r(bf16r(s[i]) * scale);
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < kKeys / 2; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    alpha_a = ex2((m_a - mx_a) * to_log2);
    alpha_b = ex2((m_b - mx_b) * to_log2);
    m_a = mx_a;
    m_b = mx_b;
    // p = exp(s - m) in f32 into l, rounded to bf16 into P's A fragments:
    // keys 16 kk .. 16 kk + 15 are accumulators 8 kk .. 8 kk + 7.
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if constexpr (BS) {
          e[u] = bf16r(ex2(bf16r(s[8 * kk + u] - bf16r((u & 2) ? m_b : m_a)) * kLog2e));
        } else {
          e[u] = ex2((s[8 * kk + u] - ((u & 2) ? m_b : m_a)) * to_log2);
        }
      }
      sum_a += (e[0] + e[1]) + (e[4] + e[5]);
      sum_b += (e[2] + e[3]) + (e[6] + e[7]);
      pt[kk][0] = pack_bf16(e[0], e[1]);
      pt[kk][1] = pack_bf16(e[2], e[3]);
      pt[kk][2] = pack_bf16(e[4], e[5]);
      pt[kk][3] = pack_bf16(e[6], e[7]);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  };

  // The two warpgroups take turns on the tensor cores: a warpgroup issues
  // its products in its slot (named barrier 3 + wg over both warpgroups) and
  // then opens the other's, so that one's softmax runs under the other's
  // products.  Slot t holds S of tile t and O += P V of tile t - 1; the
  // softmax of tile t then runs under that PV, so the P of tile t - 1 and of
  // tile t are both live, in pa and pb by turns (the loop is unrolled by two
  // so that no copy ties them to the same registers, which would make ptxas
  // serialize the products).  Warpgroup 1 opens warpgroup 0's first slot;
  // warpgroup 0 takes the last opening at the end, so both barriers finish
  // even.
  const uint32_t my_slot = 3 + wg, other_slot = 4 - wg;
  if (wg == 1) named_arrive(3, kThreads);
  {
    mbar_wait(sbar, 0);
    named_sync(my_slot, kThreads);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    named_arrive(other_slot, kThreads);
    wgmma_wait<0>();
    pin(s);
    const bool rewrite = shaped(0);
    if (rewrite) shape(0);
    float alpha_a, alpha_b;  // O is still 0
    softmax(pa, alpha_a, alpha_b, rewrite);
  }
  auto step = [&](int t, const uint32_t(&p_prev)[kKeys / 16][4],
                  uint32_t(&p_next)[kKeys / 16][4]) {
    const int st = t % kStages;
    mbar_wait(sbar + 8 * st, (t / kStages) & 1);
    named_sync(my_slot, kThreads);
    pin(o);
    wgmma_fence();
    issue_qk(st);
    wgmma_commit();
    issue_pv((t - 1) % kStages, p_prev);
    wgmma_commit();
    named_arrive(other_slot, kThreads);
    wgmma_wait<1>();  // S of tile t
    pin(s);
    // A tile that rewrites s waits for the PV first, for the same reason.
    const bool rewrite = shaped(t);
    if (rewrite) {
      wgmma_wait<0>();
      pin(o);
      shape(t);
    }
    float alpha_a, alpha_b;
    softmax(p_next, alpha_a, alpha_b, rewrite);
    if (!rewrite) {
      wgmma_wait<0>();  // PV of tile t - 1
      pin(o);
    }
    release(t - 1);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;
  };
  for (int t = 1; t < n_tiles; t += 2) {
    step(t, pa, pb);
    if (t + 1 < n_tiles) step(t + 1, pb, pa);
  }
  // The last P to pa while no product runs: products under a branch make
  // ptxas serialize them all.
  if ((n_tiles - 1) & 1) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[kk][u] = pb[kk][u];
    }
  }
  named_sync(my_slot, kThreads);
  pin(o);
  wgmma_fence();
  issue_pv((n_tiles - 1) % kStages, pa);
  wgmma_commit();
  named_arrive(other_slot, kThreads);
  wgmma_wait<0>();
  pin(o);
  if (wg == 0) named_sync(3, kThreads);

  // out = acc / max(l, 1e-30).  Each thread scales its two rows into the
  // warpgroup's own Q rows, which no product reads any more (swizzled as Q,
  // so a warp's 4-byte writes fall in distinct banks); then the warpgroup
  // writes whole 16-byte chunks of the rows that exist.
  const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int row = wg * 64 + ra + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + col0;
    const float inv = (i & 2) ? inv_b : inv_a;
    const uint32_t off = (col >> 6) * T::kQBox + row * 128 +
                         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
    *reinterpret_cast<__nv_bfloat162*>(base_ptr + off) =
        __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
  }
  named_sync(1 + wg, 128);
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (w0 + r < rows_total && c * 8 < hd) {
      const int row = wg * 64 + r;
      const uint32_t off = (c >> 3) * T::kQBox + row * 128 + (((c & 7) ^ (row & 7)) << 4);
      *reinterpret_cast<uint4*>(out + row_offset(w0 + r, b, kvh, gq, S, H, hd) + c * 8) =
          *reinterpret_cast<const uint4*>(base_ptr + off);
    }
  }
}

// A 4-D map over k or v [B, S, KV, hd] (innermost first: hd, KV, S, B) whose
// box is 64 columns of one head for `keys` positions, 128-byte swizzled.  S
// stays a dimension of its own, so a box past S reads zeros, not the next
// batch's rows; columns past hd read zeros too.
bool kv_map(CUtensorMap* map, const void* ptr, int B, int S, int KV, int hd, int keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(KV) * hd * 2,
                                 static_cast<cuuint64_t>(S) * KV * hd * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, bool BS>
int launch_bf16_hdp(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                    int KV, int hd, int causal, int window, float softcap, float scale,
                    cudaStream_t stream) {
  using T = Tiles<HDP>;
  CUtensorMap tm_k, tm_v;
  if (!kv_map(&tm_k, k, B, S, KV, hd, T::kKeys) || !kv_map(&tm_v, v, B, S, KV, hd, T::kKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(flash_fwd_bf16_kernel<HDP, BS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(T::kSmem));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_total = static_cast<int64_t>(S) * (H / KV);
  const dim3 grid(static_cast<unsigned>((rows_total + kRows - 1) / kRows), B * KV);
  flash_fwd_bf16_kernel<HDP, BS><<<grid, kThreads, T::kSmem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), S, H,
      KV, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BS>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                int KV, int hd, int causal, int window, float softcap, float scale,
                cudaStream_t stream) {
  // TMA reads k and v from 16-byte boundaries; q is read 16 bytes a load.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch ((hd + kBoxCols - 1) / kBoxCols) {
    case 1: return launch_bf16_hdp<64, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                           softcap, scale, stream);
    case 2: return launch_bf16_hdp<128, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                            softcap, scale, stream);
    case 3: return launch_bf16_hdp<192, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                            softcap, scale, stream);
    default: return launch_bf16_hdp<256, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                             softcap, scale, stream);
  }
}

// --------------------------------------------------------------------------
// f32: f32 FMAs on the CUDA cores
// --------------------------------------------------------------------------
//
// A q tile is kF32Rows = 64 packed rows, 256 threads, 8 warps of 8 rows.  In
// the QK product a lane owns two keys of the 64-key tile (rows' q values are
// warp-wide broadcasts from shared memory, the K tile has a padded row stride
// of hd + 1 floats so the lanes' keys fall in distinct banks); the row max
// and sum are warp shuffles, so every lane holds m, l and alpha of its warp's
// rows.  In the PV product a lane owns the dims d = lane + 32 i of its warp's
// rows and keeps acc in registers.  K and V take turns in one shared buffer.

constexpr int kF32Rows = 64;
constexpr int kF32Keys = 64;
constexpr int kF32Threads = 256;
constexpr int kWarps = kF32Threads / 32;
constexpr int kRowsPerWarp = kF32Rows / kWarps;  // 8

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
  // Q tile [kF32Rows][hd], K or V tile [kF32Keys][hd + 1], P tile [kF32Rows][kF32Keys]
  return static_cast<size_t>(kF32Rows) * hd + static_cast<size_t>(kF32Keys) * (hd + 1) +
         static_cast<size_t>(kF32Rows) * kF32Keys;
}

// DPL: dims per lane in the PV product, ceil(hd / 32); BS: bf16 scores.
template <int DPL, bool BS>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int S, int H, int KV,
                     int hd, int causal, int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [kF32Rows][hd]
  float* KVs = Qs + kF32Rows * hd;        // [kF32Keys][hd + 1]
  float* Ps = KVs + kF32Keys * (hd + 1);  // [kF32Rows][kF32Keys]
  const int ldkv = hd + 1;

  const int gq = H / KV;
  const int64_t rows_total = static_cast<int64_t>(S) * gq;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(qt) * kF32Rows;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y - b * KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage the q tile: packed row r -> position s = r / gq, head kvh * gq + r % gq.
  for (int idx = tid; idx < kF32Rows * hd; idx += kF32Threads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int64_t gr = r0 + r;
    Qs[idx] = gr < rows_total ? q[row_offset(gr, b, kvh, gq, S, H, hd) + d] : 0.f;
  }

  // Positions of this warp's rows, and the block's range of positions.
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = static_cast<int>((r0 + warp * kRowsPerWarp + i) / gq);
  }
  const int q_lo = static_cast<int>(r0 / gq);
  const int64_t r_end = r0 + kF32Rows < rows_total ? r0 + kF32Rows : rows_total;
  const int q_hi = static_cast<int>((r_end - 1) / gq);
  // Keys some row of the tile may attend to: (q_lo - window, q_hi] under the
  // masks; every other kv tile is masked for every row and is skipped.
  const int kv_end = causal ? min(S, q_hi + 1) : S;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int j_first = (kv_begin / kF32Keys) * kF32Keys;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int64_t kv_row_stride = static_cast<int64_t>(KV) * hd;
  const float* kbase = k + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  const float* vbase = v + (static_cast<int64_t>(b) * S * KV + kvh) * hd;
  const float* qrows = Qs + warp * kRowsPerWarp * hd;
  float* prows = Ps + warp * kRowsPerWarp * kF32Keys;

  for (int j0 = j_first; j0 < kv_end; j0 += kF32Keys) {
    __syncthreads();  // the previous tile's V reads are done (and Qs is staged)
    for (int idx = tid; idx < kF32Keys * hd; idx += kF32Threads) {
      const int c = idx / hd;
      const int d = idx - c * hd;
      const int j = j0 + c;
      KVs[c * ldkv + d] = j < S ? kbase[j * kv_row_stride + d] : 0.f;
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
      if constexpr (BS) {
        sc[0] = bf16_score(s0[i], scale, softcap);
        sc[1] = bf16_score(s1[i], scale, softcap);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + lane + 32 * u;
        if (!BS && softcap > 0.f) sc[u] = softcap * tanhf(sc[u] / softcap);
        bool ok = true;
        if (causal) ok = ok && j <= qpos[i];
        if (window > 0) ok = ok && j > qpos[i] - window;
        sc[u] = j >= S ? minus_inf() : (ok ? sc[u] : masked_score<BS>());
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(sc[0], sc[1])));
      // With bf16 scores, s - m and p are rounded to bf16 (m taken to bf16
      // first), and l sums the rounded p.
      const float mb = BS ? bf16r(m_new) : m_new;
      const float p0 = BS ? bf16r(expf(bf16r(sc[0] - mb))) : expf(sc[0] - m_new);
      const float p1 = BS ? bf16r(expf(bf16r(sc[1] - mb))) : expf(sc[1] - m_new);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + warp_sum(p0 + p1);
      m[i] = m_new;
      prows[i * kF32Keys + lane] = p0;
      prows[i * kF32Keys + lane + 32] = p1;
    }
    __syncthreads();  // all warps are done with K

    for (int idx = tid; idx < kF32Keys * hd; idx += kF32Threads) {
      const int c = idx / hd;
      const int d = idx - c * hd;
      const int j = j0 + c;
      KVs[c * ldkv + d] = j < S ? vbase[j * kv_row_stride + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha[i];
    }
    for (int c = 0; c < kF32Keys; c += 4) {
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
        const float4 pv = *reinterpret_cast<const float4*>(prows + i * kF32Keys + c);
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
    float* orow = out + row_offset(gr, b, kvh, gq, S, H, hd);
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) orow[d] = acc[i][e] / denom;
    }
  }
}

template <int DPL, bool BS>
int launch_f32_dpl(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int KV, int hd, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  // The limit is raised once per device, for the widest head this
  // instantiation takes.
  static OncePerDevice<> limit;
  const cudaError_t err = limit.get([](int, int*) {
    return cudaFuncSetAttribute(flash_fwd_f32_kernel<DPL, BS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_floats(32 * DPL) * sizeof(float)));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_total = static_cast<int64_t>(S) * (H / KV);
  const dim3 grid(static_cast<unsigned>((rows_total + kF32Rows - 1) / kF32Rows), B * KV);
  flash_fwd_f32_kernel<DPL, BS><<<grid, kF32Threads, smem_floats(hd) * sizeof(float), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, KV, hd, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BS>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
               int KV, int hd, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch_f32_dpl<1, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 2: return launch_f32_dpl<2, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 3: return launch_f32_dpl<3, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 4: return launch_f32_dpl<4, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 5: return launch_f32_dpl<5, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 6: return launch_f32_dpl<6, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    case 7: return launch_f32_dpl<7, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                         softcap, scale, stream);
    default: return launch_f32_dpl<8, BS>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                          softcap, scale, stream);
  }
}

bool shape_ok(int B, int S, int H, int KV, int hd) {
  return hd >= 16 && hd <= kMaxHd && hd % 16 == 0 && KV >= 1 && H % KV == 0 && S >= 1 &&
         B >= 1 && static_cast<int64_t>(B) * KV <= 65535;
}

// Every instance the launchers above can take (`attributes.cuh`).
const KernelInstance kInstances[] = {
    {"flash_fwd_bf16_kernel<64>", "bf16", KI((flash_fwd_bf16_kernel<64, false>)), kThreads, static_cast<long long>(Tiles<64>::kSmem)},
    {"flash_fwd_bf16_kernel<128>", "bf16", KI((flash_fwd_bf16_kernel<128, false>)), kThreads, static_cast<long long>(Tiles<128>::kSmem)},
    {"flash_fwd_bf16_kernel<192>", "bf16", KI((flash_fwd_bf16_kernel<192, false>)), kThreads, static_cast<long long>(Tiles<192>::kSmem)},
    {"flash_fwd_bf16_kernel<256>", "bf16", KI((flash_fwd_bf16_kernel<256, false>)), kThreads, static_cast<long long>(Tiles<256>::kSmem)},
    {"flash_fwd_bf16_kernel<64, bf16 scores>", "bf16", KI((flash_fwd_bf16_kernel<64, true>)), kThreads, static_cast<long long>(Tiles<64>::kSmem)},
    {"flash_fwd_bf16_kernel<128, bf16 scores>", "bf16", KI((flash_fwd_bf16_kernel<128, true>)), kThreads, static_cast<long long>(Tiles<128>::kSmem)},
    {"flash_fwd_bf16_kernel<192, bf16 scores>", "bf16", KI((flash_fwd_bf16_kernel<192, true>)), kThreads, static_cast<long long>(Tiles<192>::kSmem)},
    {"flash_fwd_bf16_kernel<256, bf16 scores>", "bf16", KI((flash_fwd_bf16_kernel<256, true>)), kThreads, static_cast<long long>(Tiles<256>::kSmem)},
    {"flash_fwd_f32_kernel<1>", "f32", KI((flash_fwd_f32_kernel<1, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 1) * sizeof(float))},
    {"flash_fwd_f32_kernel<2>", "f32", KI((flash_fwd_f32_kernel<2, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 2) * sizeof(float))},
    {"flash_fwd_f32_kernel<3>", "f32", KI((flash_fwd_f32_kernel<3, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 3) * sizeof(float))},
    {"flash_fwd_f32_kernel<4>", "f32", KI((flash_fwd_f32_kernel<4, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 4) * sizeof(float))},
    {"flash_fwd_f32_kernel<5>", "f32", KI((flash_fwd_f32_kernel<5, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 5) * sizeof(float))},
    {"flash_fwd_f32_kernel<6>", "f32", KI((flash_fwd_f32_kernel<6, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 6) * sizeof(float))},
    {"flash_fwd_f32_kernel<7>", "f32", KI((flash_fwd_f32_kernel<7, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 7) * sizeof(float))},
    {"flash_fwd_f32_kernel<8>", "f32", KI((flash_fwd_f32_kernel<8, false>)), kF32Threads, static_cast<long long>(smem_floats(32 * 8) * sizeof(float))},
    {"flash_fwd_f32_kernel<1, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<1, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 1) * sizeof(float))},
    {"flash_fwd_f32_kernel<2, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<2, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 2) * sizeof(float))},
    {"flash_fwd_f32_kernel<3, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<3, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 3) * sizeof(float))},
    {"flash_fwd_f32_kernel<4, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<4, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 4) * sizeof(float))},
    {"flash_fwd_f32_kernel<5, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<5, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 5) * sizeof(float))},
    {"flash_fwd_f32_kernel<6, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<6, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 6) * sizeof(float))},
    {"flash_fwd_f32_kernel<7, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<7, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 7) * sizeof(float))},
    {"flash_fwd_f32_kernel<8, bf16 scores>", "f32", KI((flash_fwd_f32_kernel<8, true>)), kF32Threads, static_cast<long long>(smem_floats(32 * 8) * sizeof(float))},
};

}  // namespace

KERNEL_INSTANCE_ENTRIES(flash_attention)

// q [B, S, H, hd], k and v [B, S, KV, hd], out [B, S, H, hd], all contiguous
// and of one dtype.  16 <= hd <= 256 with hd % 16 == 0, H % KV == 0,
// B * KV <= 65535; bf16 pointers on 16-byte boundaries.  causal: 0 or 1;
// window: 0 for none, else the number of keys a query sees (itself
// included); softcap: 0 for none; scale: the scores' factor, hd^-1/2
// rounded to f32 by the caller; bf16_scores: 0 for f32 scores, 1 for the
// reference's bf16 score buffers (then the caller rounds scale and softcap
// to bf16, as the reference takes them).  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int H, int KV, int hd, int causal, int window,
                                    float softcap, float scale, int bf16_scores, void* stream) {
  if (!shape_ok(B, S, H, KV, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_scores ? launch_bf16<true>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap,
                                         scale, st)
                     : launch_bf16<false>(q, k, v, out, B, S, H, KV, hd, causal, window,
                                          softcap, scale, st);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int H, int KV, int hd, int causal, int window,
                                   float softcap, float scale, int bf16_scores, void* stream) {
  if (!shape_ok(B, S, H, KV, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_scores ? launch_f32<true>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap,
                                        scale, st)
                     : launch_f32<false>(q, k, v, out, B, S, H, KV, hd, causal, window, softcap,
                                         scale, st);
}

// The dynamic shared memory the bf16 kernel asks for at head width hd.
extern "C" int flash_attention_bf16_smem(int hd) {
  switch ((hd + kBoxCols - 1) / kBoxCols) {
    case 1: return static_cast<int>(Tiles<64>::kSmem);
    case 2: return static_cast<int>(Tiles<128>::kSmem);
    case 3: return static_cast<int>(Tiles<192>::kSmem);
    default: return static_cast<int>(Tiles<256>::kSmem);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
