"""Hold `fused_trsm_schur`'s CUDA body against variants of its source, and
against an earlier tree's build, on one CUDA card: bits and device time.

    python3 tools/fused_schur_variants.py [--parent DIR]

Each variant is `src/repro_torch/kernels/csrc/fused_schur.cu` with one named
edit (`VARIANTS`), built with nvcc and the port's flags into
`build/repro_torch/variants/` and called through ctypes as the wrappers call
the kept build:

- `thread0_issues`: no producer warp; thread 0 of the math warps issues the
  copies after a barrier of all of them on every tile, as
  `csrc/schur_update.cu` does;
- `no_solve`: the per-item solve left out (its results are wrong; its time
  less the kept body's is the solve's cost).

`--parent DIR` adds the library built from `DIR/fused_schur.cu` and DIR's
headers, called through the ABI its source declares: the first one (tiles
`bm`, `bc` before `unit`, no mode) in trees before the persistent body, or
the current one: unpack one with `git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C <dir>`.

At each LU path's shape (the batched [256, 512, 512, 32] and the single
[16384, 16384, 32], f32, unit, R01 zero before C // 3 and L10's top quarter
of rows zero as the LU step passes them) it prints a JSON line per build:
its `device_ms` as `chip_smoke.py` measures it (torch.profiler), taken in
turns (kept, other, other, kept), and whether its out and U01 equal the kept
build's bit for bit.  Needs a CUDA card and nvcc.
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


def no_solve(src: str) -> str:
    return _swap(src, """          solve_column<T>(x, reinterpret_cast<const T*>(base + S::kL00Off + b * S::kL00), v,
                          unit);
""", "")


VARIANTS = {"thread0_issues": thread0_issues, "no_solve": no_solve}


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
               for name, edit in VARIANTS.items()}
    if args.parent:
        sources["parent"] = ((args.parent / "fused_schur.cu").read_text(), args.parent,
                             "fused_schur")
    libs = build(sources)
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).fused_trsm_schur_f32
        first_abi = name == "parent" and "int* mode" not in sources[name][0]
        fn.argtypes = list(PARENT_ARGTYPES if first_abi else fs._ARGTYPES)
        fn.restype = ctypes.c_int
        calls[name] = caller(fn, first_abi)
    kept = caller(_build.function("fused_schur", "fused_trsm_schur_f32", fs._ARGTYPES), False)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for B, M, C, v in ((chip_smoke.BATCH, chip_smoke.BATCH_N, chip_smoke.BATCH_N, 32),
                       (1, chip_smoke.N, chip_smoke.N, 32)):
        operands = chip_smoke.fused_inputs((B,), M, C, v, True, torch.float32, None, gen, dev)
        A, L00, R01, L10 = operands
        R01[..., :C // 3] = 0.0
        L10[..., :M // 4, :] = 0.0
        want = kept(*operands)
        for name, call in calls.items():
            got = call(*operands)
            torch.cuda.synchronize()
            times = [chip_smoke.device_ms(lambda: f(*operands)) for f in (kept, call, call, kept)]
            print(json.dumps({
                "shape": [B, M, C, v], "build": name, "card": smi,
                "device_ms": times[1:3], "kept_device_ms": [times[0], times[3]],
                "out_bits_equal_kept": chip_smoke.same_bits(got[0], want[0]),
                "U01_bits_equal_kept": chip_smoke.same_bits(got[1], want[1]),
            }), flush=True)
            del got
        del A, L00, R01, L10, operands, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
