"""Hold `fused_trsm_schur`'s CUDA bodies against variants of their source,
and against an earlier tree's build, on one CUDA card: bits and device time.

    python3 tools/fused_schur_variants.py [--parent DIR]

Each variant is `src/repro_torch/kernels/csrc/fused_schur.cu` with one named
edit (`VARIANTS`; the results of all but `stages4` are wrong on purpose),
built with nvcc and the port's flags into `build/repro_torch/variants/` and
called through ctypes as the wrappers call the kept build.  Each is timed
on the storage types whose body it edits:

- `thread0_issues` (f32): no producer warp; thread 0 of the math warps
  issues the copies after a barrier of all of them on every tile, as
  `csrc/schur_update.cu`'s f32 stream does;
- `no_solve` (f32, bf16, f16): the per-item forward substitution left out
  (its time less the kept body's is the solve's cost);
- `no_products` (bf16, f16): the `wgmma` products left out (a zero
  accumulator): the copies, the solve, the split and the epilogue;
- `cuda_core_products` (bf16, f16): the products on the CUDA cores in f32,
  in the stream's own design (U whole in f32 in shared memory, L10 rebuilt
  from its parts, the accumulator's layout), the alternative to the split;
- `stages4` (bf16, f16): a ring of four stages beside one U buffer (the
  budget holds three beside two);
- `one_group` (bf16, f16): one consumer warpgroup for the whole 64 x 256
  tile (m64n256k16 products, two columns of U solved a thread) in place of
  two of 64 x 128.

`--parent DIR` adds the library built from `DIR/fused_schur.cu` and DIR's
headers, called through the ABI its source declares: the first one (tiles
`bm`, `bc` before `unit`, no mode) in trees before the persistent body, or
the current one: unpack one with `git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C <dir>` and pass
`<dir>/src/repro_torch/kernels/csrc`.  Its 2-byte entries are timed where it
has them.

At each LU path's shape (the batched [256, 512, 512, 32] and the single
[16384, 16384, 32], unit, R01 zero before C // 3 and L10's top quarter of
rows zero as the LU step passes them), in f32, bf16 and f16, it prints a
JSON line per build: its `device_ms` as `chip_smoke.py` measures it
(torch.profiler), taken in turns (kept, other, other, kept), and whether
its out and U01 equal the kept build's bit for bit; and, for 2-byte data,
as a yardstick of the copies alone, the device time of one PyTorch `copy_`
of A into a result.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fused_schur as fs  # noqa: E402

PARENT_ARGTYPES = (
    *(ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 6,
    *(ctypes.c_int,) * 7,
    ctypes.c_void_p,
)


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the kept source no longer holds {old[:60]!r}: update the variant")
    return src.replace(old, new, 1)


def thread0_issues(src: str) -> str:
    head = "      if (tid >= kMathThreads) {\n        if (tid > kMathThreads) return;\n"
    start = src.index(head)
    issue0 = src.index("        issue(-1);\n", start)
    tail = "        return;\n      }\n"
    end = src.index(tail, issue0) + len(tail)
    issue = _swap(src[start + len(head):issue0], "next <= done + kStages;",
                  "next <= done + kStages - 1;")
    src = src[:start] + issue + "        if (tid == 0) issue(-1);\n" + src[end:]
    src = _swap(src, "constexpr int kThreads = kMathThreads + 32;",
                "constexpr int kThreads = kMathThreads;")
    return _swap(src, r"""        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * (n % kStages));
      }
      return;
""", r"""        math_sync();
        if (tid == 0) {
          tma_store_3d(&tm_out, smem0 + (n % kStages) * S::kStage,
                       static_cast<int>(key % nst) * kBN, static_cast<int>(tau % nrt) * kBM,
                       static_cast<int>(key / nst), stream_policy);
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          issue(n);
        }
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      return;
""")


def _cut(src: str, head: str, tail: str, new: str = "") -> str:
    """src with the span from `head` through the next `tail` replaced by `new`."""
    start = src.index(head)
    end = src.index(tail, start) + len(tail)
    return src[:start] + new + src[end:]


def no_solve(src: str) -> str:
    src = _swap(src, """          solve_column<T>(x, reinterpret_cast<const T*>(base + S::kL00Off + b * S::kL00), v,
                          unit);
""", "")
    return _cut(src, "#pragma unroll\n  for (int r = 0; r < kWV; ++r) {\n    if (r >= v) break;\n"
                "    float p[kWCols]", "      x[j][r] = unit ? y : y / d;\n    }\n  }\n")


WGMMA_PRODUCTS = ("    wgmma_fence();\n#pragma unroll\n    for (int p = 0; p < 3; ++p) {",
                  "    wgmma_wait<0>();\n    pin(acc);\n")


def no_products(src: str) -> str:
    return _cut(src, *WGMMA_PRODUCTS, "    for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;\n")


CUDA_CORE_PRODUCTS = r"""    {
      // The products on the CUDA cores in f32: U whole in f32 (the solve
      // wrote it over the hi and mid parts), L10 rebuilt from its parts,
      // in the accumulator's layout.
      const int m0 = 16 * (tid % 128 / 32) + lane / 4;
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int k = 0; k < v; ++k) {
        float l0 =
            __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m0, 2 * k)));
        float l1 =
            __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m0 + 8, 2 * k)));
        if constexpr (kHalves == 2) {
          l0 += __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m0, 64 + 2 * k)));
          l1 += __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(Ls + sw128(m0 + 8, 64 + 2 * k)));
        }
        const float* ur =
            reinterpret_cast<const float*>(ub + k * 4 * kBN) + gcol + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < kWN / 8; ++j) {
          const float2 uu = *reinterpret_cast<const float2*>(ur + 8 * j);
          acc[4 * j] += l0 * uu.x;
          acc[4 * j + 1] += l0 * uu.y;
          acc[4 * j + 2] += l1 * uu.x;
          acc[4 * j + 3] += l1 * uu.y;
        }
      }
    }
"""


def cuda_core_products(src: str) -> str:
    src = _swap(src, """      uint32_t h, m, l;
      split3(x[j][k], h, m, l);
      reinterpret_cast<uint16_t*>(ub + o)[j] = static_cast<uint16_t>(h);
      reinterpret_cast<uint16_t*>(ub + WSmem::kPart + o)[j] = static_cast<uint16_t>(m);
      reinterpret_cast<uint16_t*>(lo + o)[j] = static_cast<uint16_t>(l);
""", """      *reinterpret_cast<float*>(ub + k * 4 * kBN + 4 * (kWCols * tid + j)) = x[j][k];
""")
    return _cut(src, *WGMMA_PRODUCTS, CUDA_CORE_PRODUCTS)


def one_group(src: str) -> str:
    return _swap(src, "constexpr int kWGroups = 2;", "constexpr int kWGroups = 1;")


def stages4(src: str) -> str:
    src = _swap(src, "constexpr int kWStages = 3;", "constexpr int kWStages = 4;")
    return _swap(src, "constexpr int kWUBufs = 2;", "constexpr int kWUBufs = 1;")


# Each variant's edit, and the storage types whose body it edits.
VARIANTS = {"thread0_issues": (thread0_issues, ("f32",)),
            "no_solve": (no_solve, ("f32", "bf16", "f16")),
            "no_products": (no_products, ("bf16", "f16")),
            "cuda_core_products": (cuda_core_products, ("bf16", "f16")),
            "stages4": (stages4, ("bf16", "f16")),
            "one_group": (one_group, ("bf16", "f16"))}


def build(sources: dict[str, tuple[str, Path, str]]) -> dict[str, Path]:
    """Compile each (source text, headers directory, file stem) in parallel
    into `variants/<name>/<stem>.so` of the build directory (the stem names
    the kernels' anonymous namespace); the libraries' paths by name."""
    jobs = {}
    for name, (text, headers, stem) in sources.items():
        out = _build.BUILD_DIR / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for header in headers.glob("*.cuh"):
            shutil.copy(header, out)
        (out / f"{stem}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{stem}.so"),
               str(out / f"{stem}.cu")]
        jobs[name] = (out / f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = lib
    return libs


def caller(fn, first_abi: bool):
    """A call of the C entry `fn` on [B, ...] operands: (out, U01)."""
    def call(A, L00, R01, L10):
        B, M, C = A.shape
        v = L00.shape[-1]
        out = torch.empty_like(A)
        U01 = torch.empty_like(R01)
        ptrs = [x for t in (A, L00, R01, L10, out, U01)
                for x in (t.data_ptr(), t.stride(1), t.stride(0))]
        stream = _build.current_stream(A.device.index)
        if first_abi:
            err = fn(*ptrs, B, M, C, v, ops._fit(1024, M), ops._fit(128, C), 1, stream)
        else:
            err = fn(*ptrs, B, M, C, v, 1, ctypes.byref(ctypes.c_int()), stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out, U01
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a csrc directory of an earlier tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fused_schur_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kept_src = (_build.CSRC / "fused_schur.cu").read_text()
    sources = {name: (edit(kept_src), _build.CSRC, "fused_schur")
               for name, (edit, _) in VARIANTS.items()}
    timed = {name: dtypes for name, (_, dtypes) in VARIANTS.items()}
    if args.parent:
        text = (args.parent / "fused_schur.cu").read_text()
        sources["parent"] = (text, args.parent, "fused_schur")
        timed["parent"] = tuple(s for s in ("f32", "bf16", "f16")
                                if f"FUSED_ENTRY({s}" in text or s == "f32")
    _build.build(("fused_schur",))
    libs = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.float16, "f16")):
        kept = caller(_build.function("fused_schur", f"fused_trsm_schur_{suffix}", fs._ARGTYPES),
                      False)
        calls = {}
        for name, path in libs.items():
            if suffix not in timed[name]:
                continue
            fn = getattr(ctypes.CDLL(str(path)), f"fused_trsm_schur_{suffix}")
            first_abi = name == "parent" and "int* mode" not in sources[name][0]
            fn.argtypes = list(PARENT_ARGTYPES if first_abi else fs._ARGTYPES)
            fn.restype = ctypes.c_int
            calls[name] = caller(fn, first_abi)
        for B, M, C, v in ((chip_smoke.BATCH, chip_smoke.BATCH_N, chip_smoke.BATCH_N, 32),
                           (1, chip_smoke.N, chip_smoke.N, 32)):
            operands = [t.to(dt) for t in chip_smoke.fused_inputs(
                (B,), M, C, v, True, torch.float32, None, gen, dev)]
            A, L00, R01, L10 = operands
            R01[..., :C // 3] = 0.0
            L10[..., :M // 4, :] = 0.0
            want = kept(*operands)
            head = {"dtype": suffix, "shape": [B, M, C, v], "card": smi,
                    "kept_mode": fs.stream_mode(*operands)}
            if dt != torch.float32:
                # A yardstick of the copies alone: one PyTorch copy of A into
                # a result, the same bytes read and written (L00, R01, L10 and
                # U01 aside).
                out = torch.empty_like(A)
                print(json.dumps({
                    **head, "build": "torch copy_ of A",
                    "device_ms": chip_smoke.device_ms(lambda: out.copy_(A)),
                    "kept_device_ms": chip_smoke.device_ms(lambda: kept(*operands))}), flush=True)
                del out
            for name, call in calls.items():
                got = call(*operands)
                torch.cuda.synchronize()
                times = [chip_smoke.device_ms(lambda f=f: f(*operands))
                         for f in (kept, call, call, kept)]
                print(json.dumps({
                    **head, "build": name, "device_ms": times[1:3],
                    "kept_device_ms": [times[0], times[3]],
                    "out_bits_equal_kept": chip_smoke.same_bits(got[0], want[0]),
                    "U01_bits_equal_kept": chip_smoke.same_bits(got[1], want[1]),
                }), flush=True)
                del got
            del A, L00, R01, L10, operands, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
