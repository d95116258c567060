"""Hold the bf16 / f16 `schur_update` stream against variants of its source,
and against an earlier tree's build, on one CUDA card: device time, bits,
and whether the machine code of the kernels the earlier tree shares stayed.

    python3 tools/schur_update_variants.py [--parent DIR]

Each variant is `src/repro_torch/kernels/csrc/schur_update.cu` with one named
edit of the `wgmma` stream (`VARIANTS`; their results are wrong on purpose),
built with nvcc and the port's flags into `build/repro_torch/variants/` and
called through ctypes as the wrapper calls the kept build:

- `no_products`: the `wgmma` products left out (a zero accumulator): the
  copies and the epilogue;
- `no_epilogue`: the epilogue left out (each A tile goes out as it came):
  the copies and the products;
- `copies_only`: both left out: the stream's copies alone, the floor of
  this design of the pipeline.

`--parent DIR` adds the library built from `DIR/schur_update.cu` and DIR's
headers (unpack an earlier tree with `git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C <dir>` and pass
`<dir>/src/repro_torch/kernels/csrc`), called through the same C entry
points, and compares the SASS (`cuobjdump -sass`, names of the anonymous
namespace normalised) of every kernel that DIR's `flash_attention.cu`,
`fused_schur.cu` and `schur_update.cu` share with the kept builds.

At the Cholesky paths' shapes, bf16 and f16 (A, L, U standard normal, K =
32: the batched [256, 512, 512] and the single [16384, 16384]) it prints a
JSON line per build: its `device_ms` as `chip_smoke.py` measures it
(torch.profiler), taken in turns (kept, other, other, kept), and whether its
result equals the kept build's bit for bit; and, as a yardstick of the
copies alone, the device time of one PyTorch `copy_` of A into a result.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from fused_schur_variants import _swap, build  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import schur_update as su  # noqa: E402

PRODUCTS = """#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // k16 step kk: 32 bytes into L's 128-byte rows; 16 rows of U's boxes.
      mma_ss_t<kBN, St>(acc, sw128_desc(stage + W::kA + kk * 32, 16, 1024),
                        sw128_desc(u + kk * 2048, W::kUBox, 1024), kk > 0);
    }
"""
EPILOGUE_HEAD = "#pragma unroll\n    for (int j = 0; j < kBN / 4; ++j) {\n"
EPILOGUE_TAIL = "      *p = Pair<St>::narrow(x.x - acc[2 * j], x.y - acc[2 * j + 1]);\n    }\n"


def no_products(src: str) -> str:
    return _swap(src, PRODUCTS, "    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;\n")


def no_epilogue(src: str) -> str:
    start = src.index(EPILOGUE_HEAD)
    end = src.index(EPILOGUE_TAIL, start) + len(EPILOGUE_TAIL)
    return src[:start] + src[end:]


VARIANTS = {"no_products": no_products, "no_epilogue": no_epilogue,
            "copies_only": lambda src: no_epilogue(no_products(src))}


def sass(lib: Path) -> dict[str, str]:
    """Each kernel's SASS in the library, by name with the anonymous
    namespace's per-build tag taken out, one instruction a line with its
    spacing collapsed."""
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(" ".join(line.split()))  # the listing's column padding varies
    return {k: "\n".join(v) for k, v in funcs.items()}


def caller(fn):
    """A call of the C entry `fn` on [B, ...] operands: the result."""
    def call(A, L, U):
        B, M, N = A.shape
        out = torch.empty_like(A)
        err = fn(*(x for t in (A, L, U, out) for x in (t.data_ptr(), t.stride(1), t.stride(0))),
                 B, M, N, L.shape[-1], ctypes.byref(ctypes.c_int()),
                 _build.current_stream(A.device.index))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a csrc directory of an earlier tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("schur_update_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kept_src = (_build.CSRC / "schur_update.cu").read_text()
    sources = {name: (edit(kept_src), _build.CSRC, "schur_update")
               for name, edit in VARIANTS.items()}
    shared = ("flash_attention", "fused_schur", "schur_update")
    if args.parent:
        for name in shared:
            sources[f"parent_{name}"] = ((args.parent / f"{name}.cu").read_text(), args.parent,
                                         name)
    _build.build(shared)
    libs = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.parent:
        for name in shared:
            old, new = sass(libs[f"parent_{name}"]), sass(_build.library_path(name))
            common = sorted(set(old) & set(new))
            differ = {}
            for k in common:
                a, b = old[k].splitlines(), new[k].splitlines()
                if a != b:
                    pairs = [(x, y) for x, y in zip(a, b) if x != y]
                    differ[k] = {"lines": [len(a), len(b)], "lines_differing": len(pairs),
                                 "first": pairs[:3]}
            print(json.dumps({
                "sass_of": f"{name}.cu", "kernels_in_both": len(common),
                "identical": [k for k in common if k not in differ], "differ": differ,
                "only_in_kept": sorted(set(new) - set(old)),
                "only_in_parent": sorted(set(old) - set(new))}), flush=True)
    runs = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()
            if name == "parent_schur_update" or name in VARIANTS}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt, suffix in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        kept = caller(_build.function("schur_update", f"schur_update_{suffix}", su._ARGTYPES))
        calls = {}
        for name, lib in runs.items():
            fn = getattr(lib, f"schur_update_{suffix}")
            fn.argtypes, fn.restype = list(su._ARGTYPES), ctypes.c_int
            calls[name] = caller(fn)
        for B, M in ((chip_smoke.BATCH, chip_smoke.BATCH_N), (1, chip_smoke.N)):
            A, L, U = (torch.randn(B, *s, generator=gen, device=dev).to(dt)
                       for s in ((M, M), (M, 32), (32, M)))
            want = kept(A, L, U)
            # A yardstick of the copy alone: one PyTorch copy of A into a
            # result, the same bytes read and written (L and U aside).
            out = torch.empty_like(A)
            print(json.dumps({
                "dtype": suffix, "shape": [B, M, M, 32], "build": "torch copy_ of A",
                "card": smi, "device_ms": chip_smoke.device_ms(lambda: out.copy_(A)),
                "kept_device_ms": chip_smoke.device_ms(lambda: kept(A, L, U))}), flush=True)
            del out
            for name, call in calls.items():
                got = call(A, L, U)
                torch.cuda.synchronize()
                times = [chip_smoke.device_ms(lambda f=f: f(A, L, U))
                         for f in (kept, call, call, kept)]
                print(json.dumps({
                    "dtype": suffix, "shape": [B, M, M, 32], "build": name, "card": smi,
                    "kept_mode": su.stream_mode(A, L, U), "device_ms": times[1:3],
                    "kept_device_ms": [times[0], times[3]],
                    "bits_equal_kept": chip_smoke.same_bits(got, want)}), flush=True)
                del got
            del A, L, U, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
