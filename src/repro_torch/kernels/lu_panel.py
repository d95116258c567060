"""Masked panel LUP: the wrappers of the CUDA kernels in `csrc/lu_panel.cu`.

Ports of `repro/kernels/lu_panel.py::lu_panel` and `::lu_panel_batched`.  A
CPU tensor goes to the plain version (`repro_torch.kernels.ref.lu_panel` /
`.lu_panel_batched`); a CUDA tensor launches the kernel or raises.  Each call
is one launch: the kernel reads `weights` as given (converted only when its
dtype or layout differs from the panel's compute dtype) and keeps the pivot
mask on chip.
`lu_panel.launches` and `lu_panel_batched.launches` count the launches.

bf16 and f16 panels have entry points of their own: the kernel widens each
value to f32 as it loads it, runs the f32 rounds, and rounds F once as it
stores it, as the plain version does (`ref.lu_panel` upcasts and rounds
back).  Their weights are read in f32, and the generic bodies (v > 32, or
more rows than the register bodies hold) update their rows in an f32 work
buffer that the wrapper allocates.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, ref

MAX_V = 128  # the generic bodies' shared pivot-row buffer
MAX_ROWS = 2**31 - 1  # row indices are int32
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
# The register bodies take v <= 32 and up to REG_ROWS rows of one system
# without a work buffer (and a single panel up to 132 * 1024 rows on an
# H100); a bf16 or f16 call that may go past them passes one.
REG_V, REG_ROWS = 32, 1024
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)
_BATCHED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
)
# The single-panel kernel's scratch (its cross-block slots and epoch), one
# zero-filled buffer per (device, stream): launches on one stream run in
# turn, and launches that could run at once are on two streams.  The kernel
# advances the epoch in the buffer itself; the buffer is zero-filled again
# every REZERO calls, long before a 32-bit epoch could come round.
REZERO = 2**30
_scratch: dict[tuple[int, int], list] = {}  # (device, stream) -> [buffer, calls]
_scratch_lock = threading.Lock()


@functools.cache
def _entry(symbol: str, argtypes):
    """The C entry point `symbol`, resolved (and built) at first use."""
    return _build.function("lu_panel", symbol, argtypes)


def _scratch_for(device: torch.device) -> torch.Tensor:
    """The scratch buffer of PyTorch's current stream on `device`."""
    key = (device.index, _build.current_stream(device.index))
    entry = _scratch.get(key)
    if entry is None:
        with _scratch_lock:
            entry = _scratch.get(key)
            if entry is None:
                nbytes = _entry("lu_panel_scratch_bytes", ())()
                entry = _scratch[key] = [
                    torch.zeros(nbytes, dtype=torch.uint8, device=device), 0]
    entry[1] += 1
    if entry[1] >= REZERO:
        entry[0].zero_()
        entry[1] = 0
    return entry[0]


def _check(name: str, panel: torch.Tensor, weights: torch.Tensor, ndim: int) -> None:
    shape, wshape = ("[R, v]", "[R]") if ndim == 2 else ("[B, R, v]", "[B, R]")
    if (panel.ndim != ndim or not 1 <= panel.shape[-1] <= MAX_V
            or not 1 <= panel.shape[-2] <= MAX_ROWS):
        raise ValueError(
            f"{name}: panel must be {shape} with 1 <= R < 2^31 and 1 <= v <= {MAX_V}, "
            f"got {tuple(panel.shape)}"
        )
    if panel.stride(-1) != 1:
        raise ValueError(f"{name}: the panel's columns must have unit stride")
    if weights.shape != panel.shape[:-1] or weights.device != panel.device:
        raise ValueError(
            f"{name}: weights must be {wshape} on {panel.device}, got "
            f"{tuple(weights.shape)} on {weights.device}"
        )
    if panel.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {panel.device}")
    if panel.dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: the kernel takes float32, float64, bfloat16 or float16, got {panel.dtype}"
        )


def _weights(weights: torch.Tensor, panel: torch.Tensor) -> torch.Tensor:
    """The weights as the kernel reads them: the panel's compute dtype (f32
    for a bf16 or f16 panel), contiguous (no copy, and no launch, when they
    already are)."""
    return weights.to(ref._work_dtype(panel)).contiguous()


def _work(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor | None:
    """The f32 work buffer of a bf16 or f16 call that may reach a generic
    body; None where the kernel needs none."""
    R, v = shape[-2:]
    if dtype.itemsize >= 4 or (v <= REG_V and R <= REG_ROWS):
        return None
    return torch.empty(shape, dtype=torch.float32, device=device)


def lu_panel(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of panel [R, v] (any row stride) with weights [R] of 0/1.

    Returns (F [R, v] contiguous, order [v] int32, ok [v] bool); rows of
    weight 0 come back unchanged unless a NaN or infinite entry spreads to
    them, as in the plain version.
    """
    if panel.device.type == "cpu":
        return ref.lu_panel(panel, weights)
    _check("lu_panel", panel, weights, 2)
    R, v = panel.shape
    w = _weights(weights, panel)
    F = torch.empty((R, v), dtype=panel.dtype, device=panel.device)
    order = torch.empty(v, dtype=torch.int32, device=panel.device)
    ok = torch.empty(v, dtype=torch.bool, device=panel.device)
    work = _work((R, v), panel.dtype, panel.device)
    scratch = _scratch_for(panel.device)
    _build.launch("lu_panel", _entry(f"lu_panel_{_SUFFIX[panel.dtype]}", _ARGTYPES),
                  panel.device, panel.data_ptr(), panel.stride(0), w.data_ptr(),
                  None if work is None else work.data_ptr(), F.data_ptr(), R, v,
                  order.data_ptr(), ok.data_ptr(), scratch.data_ptr())
    lu_panel.launches += 1
    return F, order, ok


lu_panel.launches = 0


def lu_panel_batched(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of B panels [B, R, v] (any row and batch strides) with
    weights [B, R] of 0/1, one block of the kernel per panel.

    Returns (F [B, R, v] contiguous, order [B, v] int32, ok [B, v] bool);
    lane b equals `lu_panel(panel[b], weights[b])` bit for bit.
    """
    if panel.device.type == "cpu":
        return ref.lu_panel_batched(panel, weights)
    _check("lu_panel_batched", panel, weights, 3)
    B, R, v = panel.shape
    F = torch.empty((B, R, v), dtype=panel.dtype, device=panel.device)
    order = torch.empty((B, v), dtype=torch.int32, device=panel.device)
    ok = torch.empty((B, v), dtype=torch.bool, device=panel.device)
    if B == 0:
        return F, order, ok
    w = _weights(weights, panel)
    work = _work((B, R, v), panel.dtype, panel.device)
    _build.launch("lu_panel",
                  _entry(f"lu_panel_batched_{_SUFFIX[panel.dtype]}", _BATCHED_ARGTYPES),
                  panel.device, panel.data_ptr(), panel.stride(1), panel.stride(0),
                  w.data_ptr(), None if work is None else work.data_ptr(), F.data_ptr(), B,
                  R, v, order.data_ptr(), ok.data_ptr())
    lu_panel_batched.launches += 1
    return F, order, ok


lu_panel_batched.launches = 0
