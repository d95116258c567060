"""Triangular solves X = B U^-1 and X = L^-1 B: the wrappers of the CUDA
kernels in `csrc/trsm.cu`.

Ports of `repro/kernels/trsm.py::trsm_right_upper`,
`::trsm_right_upper_batched`, `::trsm_left_lower` and
`::trsm_left_lower_batched`.  The single and batched wrappers of each solve
launch the same kernel, a single system as a batch of one, so a batched lane
equals the single call bit for bit.  A CPU tensor goes to the plain version
(`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or raises.
Each wrapper counts its launches in `<wrapper>.launches`.  The right solve's
wrappers also set `.mode` to the body their last launch took: "wide" (the
register body, a warp loading whole rows in 16-byte runs), "plain" (the
register body, one value a load) or "smem" (v > 32, the shared-memory body).
`right_mode(B, U)` predicts it from the operands alone.

bf16 and f16 operands have entry points of their own: they widen every value
to f32 as they load it, solve in f32 with the f32 kernels' operations, and
round each result once where they store it, as the plain versions do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

MAX_V = 128  # the triangle and a row (column) tile share one block's shared memory
REG_V = 32  # v up to which the register bodies hold a row (column)
MAX_BATCH = 65535  # systems on gridDim.z
MAX_ROWS = 2**31 - 1  # rows of B (right solve), columns of B (left solve)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ctypes.c_void_p,
)
_LEFT_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


_MODES = {0: "plain", 1: "wide", 2: "smem"}  # `csrc/trsm.cu::RightMode`


def right_mode(B: torch.Tensor, U: torch.Tensor) -> str:
    """The body that the right solve's launcher takes for B [R, v] or
    [Bb, R, v] (U takes any strides, so the rule reads B alone): "smem" for
    v > 32; else "wide" where B's base is 16-byte aligned and its row stride,
    batch stride (0 for a single system) and v are whole 16-byte runs (4
    values in f32, 2 in f64, 8 in bf16 and f16); else "plain".

    Reads shapes, strides, dtype and the address only; any device."""
    v = B.shape[-1]
    if v > REG_V:
        return "smem"
    run = 16 // B.element_size()
    bsb = B.stride(0) if B.ndim == 3 else 0
    wide = (B.data_ptr() % 16 == 0 and B.stride(-2) % run == 0 and bsb % run == 0
            and v % run == 0)
    return "wide" if wide else "plain"


@functools.cache
def _entry(kind: str, dtype: torch.dtype):
    """The C entry point `trsm_<kind>_<dtype>`, resolved (and built) at first use."""
    return _build.function("trsm", f"trsm_{kind}_{_SUFFIX[dtype]}",
                           _ARGTYPES if kind == "right_upper" else _LEFT_ARGTYPES)


def _check_common(name: str, B: torch.Tensor, T: torch.Tensor, lead: tuple) -> None:
    if B.stride(-1) != 1:
        raise ValueError(f"{name}: B's columns must have unit stride")
    if lead and lead[0] > MAX_BATCH:
        raise ValueError(f"{name}: at most {MAX_BATCH} systems per launch, got Bb={lead[0]}")
    if B.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {B.device}")
    if B.dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: the kernel takes float32, float64, bfloat16 or float16, got {B.dtype}"
        )
    if T.device != B.device or T.dtype != B.dtype:
        raise ValueError(f"{name}: the triangle is {T.dtype} on {T.device}, "
                         f"B is {B.dtype} on {B.device}")


def _check(name: str, B: torch.Tensor, U: torch.Tensor, ndim: int) -> None:
    lead = tuple(B.shape[:-2])
    if (B.ndim != ndim or U.ndim != ndim or not 1 <= B.shape[-1] <= MAX_V
            or tuple(U.shape) != lead + (B.shape[-1], B.shape[-1])
            or not 1 <= B.shape[-2] <= MAX_ROWS):
        pre = "Bb, " if ndim == 3 else ""
        raise ValueError(
            f"{name}: need B [{pre}R, v] and U [{pre}v, v] with 1 <= v <= {MAX_V}; "
            f"got B {tuple(B.shape)}, U {tuple(U.shape)}"
        )
    _check_common(name, B, U, lead)


def _check_left(name: str, L: torch.Tensor, B: torch.Tensor, ndim: int) -> None:
    lead = tuple(B.shape[:-2])
    if (B.ndim != ndim or L.ndim != ndim or not 1 <= B.shape[-2] <= MAX_V
            or tuple(L.shape) != lead + (B.shape[-2], B.shape[-2])
            or not 1 <= B.shape[-1] <= MAX_ROWS):
        pre = "Bb, " if ndim == 3 else ""
        raise ValueError(
            f"{name}: need L [{pre}v, v] and B [{pre}v, C] with 1 <= v <= {MAX_V}; "
            f"got L {tuple(L.shape)}, B {tuple(B.shape)}"
        )
    _check_common(name, B, L, lead)


def _launch(B: torch.Tensor, U: torch.Tensor, Bb: int, bsb: int, bsu: int, out_shape):
    """Launch the right solve on Bb systems B [R, v], U [v, v] (batch strides
    bsb and bsu) into a new X of `out_shape`.  Returns (X, mode)."""
    R, v = B.shape[-2:]
    X = torch.empty(out_shape, dtype=B.dtype, device=B.device)
    mode = ctypes.c_int(-1)
    _build.launch("trsm", _entry("right_upper", B.dtype), B.device,
                  B.data_ptr(), B.stride(-2), bsb, U.data_ptr(), U.stride(-2), U.stride(-1), bsu,
                  X.data_ptr(), Bb, R, v, ctypes.byref(mode))
    return X, _MODES[mode.value]


def _launch_left(L: torch.Tensor, B: torch.Tensor, unit: bool, Bb: int, bsl: int, bsb: int,
                 out_shape) -> torch.Tensor:
    """Launch the left solve on Bb systems L [v, v], B [v, C] (batch strides
    bsl and bsb) into a new X of `out_shape`."""
    v, C = B.shape[-2:]
    X = torch.empty(out_shape, dtype=B.dtype, device=B.device)
    _build.launch("trsm", _entry("left_lower", B.dtype), B.device,
                  L.data_ptr(), L.stride(-2), L.stride(-1), bsl, B.data_ptr(), B.stride(-2), bsb,
                  X.data_ptr(), Bb, v, C, int(unit))
    return X


def trsm_right_upper(B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """X = B U^-1 for B [R, v] (any row stride) and U [v, v] upper with a
    non-unit diagonal (any strides, e.g. a transposed lower factor).

    Returns X [R, v] contiguous; rows that are zero in B come out zero.
    """
    if B.device.type == "cpu":
        return ref.trsm_right_upper(B, U)
    _check("trsm_right_upper", B, U, 2)
    X, trsm_right_upper.mode = _launch(B, U, 1, 0, 0, B.shape)
    trsm_right_upper.launches += 1
    return X


def trsm_right_upper_batched(B: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Per-system X_b = B_b U_b^-1 for B [Bb, R, v] and U [Bb, v, v] (any row
    and batch strides, Bb <= 65535).  Returns X [Bb, R, v] contiguous."""
    if B.device.type == "cpu":
        return ref.trsm_right_upper_batched(B, U)
    _check("trsm_right_upper_batched", B, U, 3)
    if B.shape[0] == 0:
        return torch.empty_like(B)
    X, trsm_right_upper_batched.mode = _launch(B, U, B.shape[0], B.stride(0), U.stride(0),
                                               B.shape)
    trsm_right_upper_batched.launches += 1
    return X


def trsm_left_lower(L: torch.Tensor, B: torch.Tensor, *, unit: bool = True) -> torch.Tensor:
    """X = L^-1 B for L [v, v] lower (any strides; unit diagonal if `unit`,
    so only its strictly lower part is read) and B [v, C] (any row stride).

    Returns X [v, C] contiguous.
    """
    if B.device.type == "cpu":
        return ref.trsm_left_lower(L, B, unit=unit)
    _check_left("trsm_left_lower", L, B, 2)
    X = _launch_left(L, B, unit, 1, 0, 0, B.shape)
    trsm_left_lower.launches += 1
    return X


def trsm_left_lower_batched(L: torch.Tensor, B: torch.Tensor, *,
                            unit: bool = True) -> torch.Tensor:
    """Per-system X_b = L_b^-1 B_b for L [Bb, v, v] and B [Bb, v, C] (any row
    and batch strides, Bb <= 65535).  Returns X [Bb, v, C] contiguous."""
    if B.device.type == "cpu":
        return ref.trsm_left_lower_batched(L, B, unit=unit)
    _check_left("trsm_left_lower_batched", L, B, 3)
    if B.shape[0] == 0:
        return torch.empty_like(B)
    X = _launch_left(L, B, unit, B.shape[0], L.stride(0), B.stride(0), B.shape)
    trsm_left_lower_batched.launches += 1
    return X


trsm_right_upper.launches = 0
trsm_right_upper_batched.launches = 0
trsm_left_lower.launches = 0
trsm_left_lower_batched.launches = 0
trsm_right_upper.mode = trsm_right_upper_batched.mode = None
