"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in `csrc/` compiles, with nvcc, into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds).  Libraries go to
`build/repro_torch/` at the root of the checkout, named by a hash of the
source, the shared headers and the flags, so a build reruns only when one of
them changes.  `build()` starts one nvcc for every missing library, all at
once, and waits for them.

Every C entry point takes PyTorch's current stream last and returns the
`cudaError_t` of its launch; `launch` passes the stream and raises when that
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lu_panel", "fused_schur", "chol_panel", "trsm", "schur_update",
           "flash_attention", "mamba_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# nvcc's report (ptxas registers, shared memory, spills) of each build done
# in this process, by source name.
build_log: dict[str, str] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "kernels are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` (and the shared headers
    `csrc/*.cuh`) lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _build_locked(names) -> float:
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            text, _ = proc.communicate()
            build_log[name] = text
            if proc.returncode:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{text}")
            else:
                os.replace(tmp, out)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build(names=SOURCES) -> float:
    """Compile every library of `names` not built yet, in parallel.

    Returns the seconds spent (0.0 when all were built already).
    """
    with _lock:
        return _build_locked(names)


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of `csrc/<name>.cu`, building it if needed."""
    key = (name, symbol)
    fn = _functions.get(key)  # entries are only ever added, so no lock to read
    if fn is not None:
        return fn
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                _build_locked((name,))
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
                err = getattr(lib, f"{name}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            _functions[key] = fn
        return fn


# PyTorch's current stream on a device as a plain handle, through the
# private call that PyTorch's own generated code uses: building a
# `torch.cuda.Stream` only to read `.cuda_stream` is a large share of a small
# kernel's host time per call.  The public call stands in where the private
# one is missing.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(index: int) -> int:
    """PyTorch's current CUDA stream on device `index`, as an integer handle."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """Call the C entry point `fn` of `csrc/<name>.cu` with `args` and PyTorch's
    current stream on `device`, making `device` current only if it is not
    already, and raise if the launch failed."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, current_stream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, current_stream(index))
    check(name, err)


def check(name: str, err: int) -> None:
    """Raise if a launch in `csrc/<name>.cu` returned a CUDA error."""
    if err:
        text = getattr(_libs[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
