"""Masked panel LUP: the wrappers of the CUDA kernels in `csrc/lu_panel.cu`.

Ports of `repro/kernels/lu_panel.py::lu_panel` and `::lu_panel_batched`.  A
CPU tensor goes to the plain version (`repro_torch.kernels.ref.lu_panel` /
`.lu_panel_batched`); a CUDA tensor launches the kernel or raises.
`lu_panel.launches` and `lu_panel_batched.launches` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_V = 128  # the kernel's shared pivot-row buffer
MAX_ROWS = 2**31 - 1  # row indices are int32
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)
_BATCHED_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)


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
            f"{name}: the kernel takes float32 or float64, got {panel.dtype} "
            f"(bf16/f16 arrive with ROADMAP.md module item 7, mixed precision)"
        )


def lu_panel(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of panel [R, v] (any row stride) with weights [R] of 0/1.

    Returns (F [R, v] contiguous, order [v] int32, ok [v] bool); rows of
    weight 0 come back unchanged.
    """
    if panel.device.type == "cpu":
        return ref.lu_panel(panel, weights)
    _check("lu_panel", panel, weights, 2)
    R, v = panel.shape
    F = torch.empty((R, v), dtype=panel.dtype, device=panel.device)
    w = torch.empty(R, dtype=panel.dtype, device=panel.device)
    w.copy_(weights)  # the kernel masks pivots in this copy
    order = torch.empty(v, dtype=torch.int32, device=panel.device)
    ok = torch.empty(v, dtype=torch.bool, device=panel.device)
    fn = _build.function("lu_panel", f"lu_panel_{_SUFFIX[panel.dtype]}", _ARGTYPES)
    nbytes = _build.function("lu_panel", "lu_panel_scratch_bytes", ())()
    # partial argmaxes and the grid barrier's counters, which start at 0
    scratch = torch.zeros(nbytes, dtype=torch.uint8, device=panel.device)
    _build.launch("lu_panel", fn, panel.device, panel.data_ptr(), panel.stride(0),
                  F.data_ptr(), w.data_ptr(), R, v, order.data_ptr(), ok.data_ptr(),
                  scratch.data_ptr())
    lu_panel.launches += 1
    return F, order, ok


lu_panel.launches = 0


def lu_panel_batched(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of B panels [B, R, v] (any row and batch strides) with
    weights [B, R] of 0/1, one block of the kernel per panel.

    Returns (F [B, R, v] contiguous, order [B, v] int32, ok [B, v] bool);
    rows of weight 0 come back unchanged.
    """
    if panel.device.type == "cpu":
        return ref.lu_panel_batched(panel, weights)
    _check("lu_panel_batched", panel, weights, 3)
    B, R, v = panel.shape
    F = torch.empty((B, R, v), dtype=panel.dtype, device=panel.device)
    w = torch.empty((B, R), dtype=panel.dtype, device=panel.device)
    w.copy_(weights)  # the kernel masks pivots in this copy
    order = torch.empty((B, v), dtype=torch.int32, device=panel.device)
    ok = torch.empty((B, v), dtype=torch.bool, device=panel.device)
    if B == 0:
        return F, order, ok
    fn = _build.function("lu_panel", f"lu_panel_batched_{_SUFFIX[panel.dtype]}",
                         _BATCHED_ARGTYPES)
    _build.launch("lu_panel", fn, panel.device, panel.data_ptr(), panel.stride(1),
                  panel.stride(0), F.data_ptr(), w.data_ptr(), B, R, v, order.data_ptr(),
                  ok.data_ptr())
    lu_panel_batched.launches += 1
    return F, order, ok


lu_panel_batched.launches = 0
