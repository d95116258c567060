"""Hold the bf16 / f16 body of `trsm_right_upper[_batched]` against an earlier
tree's build and against launch-shape variants of its source, on one CUDA
card: bits, device time, and whether the machine code of the kernels that
the 2-byte redesign must leave alone stayed.

    python3 tools/trsm_variants.py [--parent DIR]

Each variant is `src/repro_torch/kernels/csrc/trsm.cu` with one named edit
(`VARIANTS`), built with nvcc and the port's flags into
`build/repro_torch/variants/` and called through ctypes as the wrappers call
the kept build.  The edits change the register body of every storage type;
only the 2-byte entries are timed:

- `rows64`: 64 rows (threads) a block of the register body in place of 128
  (256 blocks at [16384, 32]);
- `rows32`: 32 rows, one warp, a block (512 blocks);
- `no_solve`: the column-by-column solve left out (X = B, rounded): the
  loads, the staging of U and the stores, the floor of this design's
  traffic (its results are wrong on purpose).

`--parent DIR` adds the library built from `DIR/trsm.cu` and DIR's headers
(unpack an earlier tree with `git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C <dir>` and pass
`<dir>/src/repro_torch/kernels/csrc`), called through the ABI its source
declares (before the right solve reported its body, its entries took no
`mode`).  Against it the tool checks:

- that the kept build's results equal the parent's bit for bit, NaN
  payloads included, in bf16, f16, f32 and f64, on every case of
  `chip_smoke.RIGHT_MIXED_CASES` (the paths' shapes; v = 1, 24, 31, 33, 128;
  R = 1, 9, 100,000; a window and one offset by one column; NaN / inf rows,
  a zero on U's diagonal, f16 quotients past 65504);
- that the SASS (`cuobjdump -sass`, names of the anonymous namespace
  normalised) of every f32 and f64 `trsm_right_upper` kernel and of every
  `trsm_left_lower` kernel is identical to the parent's.

At the paths' shapes (the single [16384, 32] and the batched [256, 512, 32],
U = L00^T, B's top quarter of rows zero) in bf16 and f16 it prints a JSON
line per build: its `device_ms` as `chip_smoke.py` measures it
(torch.profiler), taken in turns (kept, other, other, kept), and whether its
result equals the kept build's bit for bit; and the kept f32 body's time and,
as a yardstick of the bytes alone, the device time of one PyTorch `copy_` of
B into a new tensor of X's shape.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from fused_schur_variants import _cut, _swap, build  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import trsm  # noqa: E402
from schur_update_variants import sass  # noqa: E402

ROWS = "constexpr int kRightRows = 128;"
SOLVE = ("  T partial[kRegV];\n",
         "        if (m0 + e > j) partial[m0 + e] += xj * run.x[e];\n    }\n  }\n")
VARIANTS = {"rows64": lambda src: _swap(src, ROWS, "constexpr int kRightRows = 64;"),
            "rows32": lambda src: _swap(src, ROWS, "constexpr int kRightRows = 32;"),
            "no_solve": lambda src: _cut(src, *SOLVE)}
SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.float64: "f64"}


def caller(fn, with_mode: bool):
    """A call of the C entry `fn` on B [R, v] or [Bb, R, v] and U: X."""
    def call(B, U):
        X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
        Bb, bsb, bsu = (B.shape[0], B.stride(0), U.stride(0)) if B.ndim == 3 else (1, 0, 0)
        args = [B.data_ptr(), B.stride(-2), bsb, U.data_ptr(), U.stride(-2), U.stride(-1), bsu,
                X.data_ptr(), Bb, *B.shape[-2:]]
        if with_mode:
            args.append(ctypes.byref(ctypes.c_int()))
        err = fn(*args, _build.current_stream(B.device.index))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return X
    return call


def entry(lib: ctypes.CDLL, suffix: str, with_mode: bool):
    fn = getattr(lib, f"trsm_right_upper_{suffix}")
    # Before the mode pointer (the last argument but the stream) the ABI was
    # the same.
    fn.argtypes = list(trsm._ARGTYPES if with_mode else trsm._ARGTYPES[:-2] + trsm._ARGTYPES[-1:])
    fn.restype = ctypes.c_int
    return caller(fn, with_mode)


def raw_bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN payloads included."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def compare_sass(parent: Path, kept: Path) -> dict:
    """The f32 / f64 right solves' and every left solve's SASS, kept against
    parent, and which 2-byte right-solve kernels changed."""
    old, new = sass(parent), sass(kept)

    def held(name: str) -> bool:
        return "trsm_left_lower" in name or (
            "trsm_right_upper" in name and ("IfE" in name or "IdE" in name))

    common = sorted(set(old) & set(new))
    differ = {}
    for k in common:
        a, b = old[k].splitlines(), new[k].splitlines()
        if a != b:
            differ[k] = {"lines": [len(a), len(b)],
                         "lines_differing": sum(x != y for x, y in zip(a, b))}
    return {"sass_of": "trsm.cu",
            "held_identical": [k for k in common if held(k) and k not in differ],
            "held_differ": {k: d for k, d in differ.items() if held(k)},
            "held_missing": sorted(k for k in set(old) ^ set(new) if held(k)),
            "changed_2byte": {k: d for k, d in differ.items() if not held(k)}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a csrc directory of an earlier tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trsm_variants: no CUDA device is available", file=sys.stderr)
        return 1
    kept_src = (_build.CSRC / "trsm.cu").read_text()
    sources = {name: (edit(kept_src), _build.CSRC, "trsm") for name, edit in VARIANTS.items()}
    if args.parent:
        sources["parent"] = ((args.parent / "trsm.cu").read_text(), args.parent, "trsm")
    _build.build(("trsm",))
    libs = build(sources)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_log.get("trsm", "").splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)
    all_ok = True
    if args.parent:
        report = compare_sass(libs["parent"], _build.library_path("trsm"))
        report["ok"] = bool(report["held_identical"]) and not (
            report["held_differ"] or report["held_missing"])
        all_ok &= report["ok"]
        print(json.dumps(report), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    kept_lib = ctypes.CDLL(str(_build.library_path("trsm")))
    cdlls = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    with_mode = {name: "int* mode" in text for name, (text, _, _) in sources.items()}
    for dt, suffix in SUFFIX.items():
        kept = entry(kept_lib, suffix, True)
        calls = {name: entry(lib, suffix, with_mode[name]) for name, lib in cdlls.items()}
        if "parent" in calls:
            bits = {}
            for Bb, R, v, ukind, special, _ in chip_smoke.RIGHT_MIXED_CASES:
                Bm, U = chip_smoke.right_solve_inputs(Bb, R, v, ukind, special, dt, gen, dev)
                bits[f"{[1 if Bb is None else Bb, R, v]} {special}"] = raw_bits_equal(
                    kept(Bm, U), calls["parent"](Bm, U))
            ok = all(bits.values())
            all_ok &= ok
            print(json.dumps({"dtype": suffix, "bits_equal_parent": ok, "cases": bits}),
                  flush=True)
        for Bb, R in ((None, chip_smoke.N), (chip_smoke.BATCH, chip_smoke.BATCH_N)):
            Bm, U = chip_smoke.right_solve_inputs(Bb, R, chip_smoke.CHOL_V, "mT", None, dt,
                                                  gen, dev)
            shape = list(Bm.shape)
            want = kept(Bm, U)
            out = torch.empty_like(Bm)
            print(json.dumps({
                "dtype": suffix, "shape": shape, "build": "kept", "card": smi,
                "mode": trsm.right_mode(Bm, U),
                "device_ms": chip_smoke.device_ms(lambda: kept(Bm, U)),
                "copy_device_ms": chip_smoke.device_ms(lambda: out.copy_(Bm))}), flush=True)
            del out
            if dt.itemsize != 2:
                continue
            for name, call in calls.items():
                got = call(Bm, U)
                torch.cuda.synchronize()
                times = [chip_smoke.device_ms(lambda f=f: f(Bm, U))
                         for f in (kept, call, call, kept)]
                print(json.dumps({
                    "dtype": suffix, "shape": shape, "build": name, "card": smi,
                    "device_ms": times[1:3], "kept_device_ms": [times[0], times[3]],
                    "bits_equal_kept": raw_bits_equal(got, want)}), flush=True)
                if name != "no_solve":
                    all_ok &= raw_bits_equal(got, want)
            del Bm, U, want
            torch.cuda.empty_cache()
    print(json.dumps({"ok": all_ok}), flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
