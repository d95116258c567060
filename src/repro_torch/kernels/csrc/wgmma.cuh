// Hopper's warpgroup matrix products (`wgmma`, sm_90a) on 2-byte operands,
// bf16 or f16, with f32 accumulators in registers, and what a kernel needs
// around them: shared-memory descriptors of 128-byte-swizzled tiles, the
// fence, commit and wait of the asynchronous products, and a pin that keeps
// the compiler's hands off the accumulators while a product runs.
//
// A product is m64nNk16: D [64 x N] (+)= A [64 x 16] B [16 x N], issued by
// the four warps of a warpgroup together.  Accumulator i of thread t of the
// warpgroup is row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2.  Each product of two bf16 (or two f16)
// values is exact in f32, and the products are summed in f32.
//
// Every wrapper takes the element type E (default bf16) as a template
// argument; both types are stamped out by the same macros below, so the two
// differ only in the instruction's type suffix.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {  // each library is one translation unit

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products' fence and wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Starts the accumulators' live range here without an instruction: their
// values are undefined until a product with acc = 0 overwrites them, so the
// registers hold other values before this point (the asm of a product reads
// them, which would keep them live across a loop).
template <int N>
__device__ __forceinline__ void fresh(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i]));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]: A and B in shared memory, both
// K-major; acc = 0 overwrites D.
template <int N, typename E = __nv_bfloat16>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// The same with B MN-major (the transpose bit): B's rows of N values lie
// contiguous, as a row-major [K, N] matrix does.
template <int N, typename E = __nv_bfloat16>
__device__ void mma_ss_t(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// D[64 x N] += A[64 x 16] B[16 x N]: A in registers (pairs of E, the
// accumulator layout's rows and columns), B in shared memory MN-major.
template <int N, typename E = __nv_bfloat16>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

// The accumulators' operand numbers ("%0, ..., %<N/2 - 1>") and operands.
#define WGMMA_R32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R64                                                                         \
  WGMMA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
            "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
            "%62, %63"
#define WGMMA_R96                                                                         \
  WGMMA_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, " \
            "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "   \
            "%94, %95"
#define WGMMA_R128                                                                     \
  WGMMA_R96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, " \
            "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "     \
            "%121, %122, %123, %124, %125, %126, %127"
#define WGMMA_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D32(i) WGMMA_D8(i), WGMMA_D8(i + 8), WGMMA_D8(i + 16), WGMMA_D8(i + 24)
#define WGMMA_D64 WGMMA_D32(0), WGMMA_D32(32)
#define WGMMA_D96 WGMMA_D64, WGMMA_D32(64)
#define WGMMA_D128 WGMMA_D96, WGMMA_D32(96)

// Both operands from shared memory: "%<a>" and "%<b>" are the descriptors,
// "%<p>" the accumulate flag; TB is the transpose bit of B.
#define WGMMA_SS(NAME, N, E, TY, TB, REGS, DOPS, A, B, P)                                 \
  template <>                                                                            \
  __device__ __forceinline__ void NAME<N, E>(float(&d)[N / 2], uint64_t a, uint64_t b,    \
                                             int acc) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS   \
                 "}, " A ", " B ", p, 1, 1, 0, " TB ";\n}\n"                              \
                 : DOPS                                                                  \
                 : "l"(a), "l"(b), "r"(acc));                                            \
  }
// A from registers: "{%<a>, ...}" its four registers, "%<b>" B's descriptor,
// "%<p>" the accumulate flag (always set).
#define WGMMA_RS(N, E, TY, REGS, DOPS, A4, B, P)                                          \
  template <>                                                                            \
  __device__ __forceinline__ void mma_rs<N, E>(float(&d)[N / 2], const uint32_t(&a)[4],   \
                                               uint64_t b) {                             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS   \
                 "}, " A4 ", " B ", p, 1, 1, 1;\n}\n"                                     \
                 : DOPS                                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));          \
  }

#define WGMMA_ALL(E, TY)                                                                  \
  WGMMA_SS(mma_ss, 64, E, TY, "0", WGMMA_R32, WGMMA_D32(0), "%32", "%33", "%34")          \
  WGMMA_SS(mma_ss, 128, E, TY, "0", WGMMA_R64, WGMMA_D64, "%64", "%65", "%66")            \
  WGMMA_SS(mma_ss_t, 128, E, TY, "1", WGMMA_R64, WGMMA_D64, "%64", "%65", "%66")          \
  WGMMA_SS(mma_ss_t, 256, E, TY, "1", WGMMA_R128, WGMMA_D128, "%128", "%129", "%130")     \
  WGMMA_RS(64, E, TY, WGMMA_R32, WGMMA_D32(0), "{%32, %33, %34, %35}", "%36", "%37")      \
  WGMMA_RS(128, E, TY, WGMMA_R64, WGMMA_D64, "{%64, %65, %66, %67}", "%68", "%69")        \
  WGMMA_RS(192, E, TY, WGMMA_R96, WGMMA_D96, "{%96, %97, %98, %99}", "%100", "%101")      \
  WGMMA_RS(256, E, TY, WGMMA_R128, WGMMA_D128, "{%128, %129, %130, %131}", "%132", "%133")

WGMMA_ALL(__nv_bfloat16, "bf16")
WGMMA_ALL(__half, "f16")

#undef WGMMA_ALL
#undef WGMMA_RS
#undef WGMMA_SS
#undef WGMMA_D128
#undef WGMMA_D96
#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_D8
#undef WGMMA_R128
#undef WGMMA_R96
#undef WGMMA_R64
#undef WGMMA_R32

}  // namespace
