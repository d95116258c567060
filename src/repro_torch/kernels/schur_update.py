"""Schur-complement update A - L @ U: the wrappers of the CUDA kernel in
`csrc/schur_update.cu`.

Ports of `repro/kernels/schur_update.py::schur_update` and
`::schur_update_batched`.  Both launch the same kernel, a single system as
a batch of one, so a batched lane equals the single call bit for bit.  A
CPU tensor goes to the plain version (`repro_torch.kernels.ref`); a CUDA
tensor launches the kernel or raises.  `schur_update.launches` and
`schur_update_batched.launches` count the launches, and `.mode` says which
body the last launch took: "tma" (the f32 TMA stream), "wgmma" (the bf16 /
f16 stream, products on the tensor cores) or "plain" (plain loads).
`stream_mode(A, L, U)` predicts it from the operands alone.

bf16 and f16 operands have entry points of their own.  Both bodies widen
every value to f32, form A - L @ U with exact products summed in f32, and
round each result once where they store it, as the plain version does; the
order of the sum differs, so they agree with it within a 2-byte rounding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# The entry points' limits: M <= TILE_M * MAX_GRID_YZ rows and at most
# MAX_GRID_YZ systems a launch (the first kernel's grid; the persistent one
# walks any number of tiles, and the limits stay so that what runs is
# unchanged).
TILE_M = 64
MAX_GRID_YZ = 65535
MAX_DIM = 2**31 - 1
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = (
    *(ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 4,
    *(ctypes.c_int,) * 4,
    ctypes.POINTER(ctypes.c_int),
    ctypes.c_void_p,
)


_MODES = {0: "plain", 1: "tma", 2: "wgmma"}
# The K of one chunk of each streamed storage size (bytes): 32 f32, 64 bf16 / f16.
_STREAM_K = {4: 32, 2: 64}


def tma_fits(ptr: int, ld: int, bs: int, B: int, rows: int, cols: int, size: int) -> bool:
    """Whether TMA takes an operand of `size`-byte elements over [B, rows,
    cols] at address `ptr` with row stride `ld` and batch stride `bs`
    (elements), by the rule of `csrc/tma.cuh::tma_fits`: a 16-byte aligned
    base, row and (in a batch of more than one) batch strides of whole
    16-byte runs, and rows of at least 16 bytes."""
    run = 16 // size
    bs = ld * rows if B == 1 else bs
    return ptr % 16 == 0 and ld % run == 0 and bs % run == 0 and bs > 0 and cols >= run


def stream_mode(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> str:
    """The body that the kernel's launcher picks for these operands, by the
    rule it applies before the launch: "tma" for f32 and "wgmma" for bf16 /
    f16 where K is at most one chunk (32 resp. 64) and TMA takes every
    operand (A, L, U and the contiguous result), else "plain" (always for
    f64 and for an empty result).  TMA takes an operand whose base is
    16-byte aligned, whose row stride and (in a batch of more than one) batch
    stride are whole 16-byte runs, and whose rows hold at least 16 bytes.

    Reads shapes, strides, dtype and addresses only; any device."""
    A3, L3, U3 = (t if t.ndim == 3 else t[None] for t in (A, L, U))
    B, M, N = A3.shape
    K = L3.shape[-1]
    size = A.element_size()
    if B == 0 or M == 0 or N == 0 or K > _STREAM_K.get(size, -1):
        return "plain"

    def fits(t: torch.Tensor, rows: int, cols: int) -> bool:
        return tma_fits(t.data_ptr(), t.stride(1), t.stride(0), B, rows, cols, size)

    ok = (fits(A3, M, N) and fits(L3, M, K) and fits(U3, K, N)
          and tma_fits(0, N, M * N, B, M, N, size))  # the result: contiguous, aligned
    return ("tma" if size == 4 else "wgmma") if ok else "plain"


def _check(name: str, A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> None:
    ndim = A.ndim
    if ndim not in (2, 3) or L.ndim != ndim or U.ndim != ndim:
        raise ValueError(f"{name}: the operands must all be 2-D, or all 3-D with a batch axis")
    lead = tuple(A.shape[:-2])
    M, N = A.shape[-2:]
    K = L.shape[-1]
    if (tuple(L.shape) != lead + (M, K) or tuple(U.shape) != lead + (K, N)
            or max(M, N, K) > MAX_DIM or -(-M // TILE_M) > MAX_GRID_YZ):
        pre = "B, " if lead else ""
        raise ValueError(
            f"{name}: need A [{pre}M, N], L [{pre}M, K], U [{pre}K, N] with "
            f"M <= {TILE_M * MAX_GRID_YZ}; got A {tuple(A.shape)}, L {tuple(L.shape)}, "
            f"U {tuple(U.shape)}"
        )
    if any(t.stride(-1) != 1 for t in (A, L, U)):
        raise ValueError(f"{name}: every operand needs unit column stride")
    if lead and lead[0] > MAX_GRID_YZ:
        raise ValueError(f"{name}: at most {MAX_GRID_YZ} systems per launch, got B={lead[0]}")
    if A.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {A.device}")
    if A.dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: the kernel takes float32, float64, bfloat16 or float16, got {A.dtype}"
        )
    for arg, t in (("L", L), ("U", U)):
        if t.device != A.device or t.dtype != A.dtype:
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, A is {A.dtype} on {A.device}"
            )


def _launch(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor):
    """Launch the kernel on B systems given as 3-D tensors [B, ...].

    Returns (out, mode)."""
    B, M, N = A.shape
    out = torch.empty((B, M, N), dtype=A.dtype, device=A.device)
    fn = _build.function("schur_update", f"schur_update_{_SUFFIX[A.dtype]}", _ARGTYPES)
    mode = ctypes.c_int(0)
    _build.launch("schur_update", fn, A.device,
                  *(x for t in (A, L, U, out) for x in (t.data_ptr(), t.stride(1), t.stride(0))),
                  B, M, N, L.shape[-1], ctypes.byref(mode))
    return out, _MODES[mode.value]


def schur_update(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """A - L @ U for A [M, N], L [M, K], U [K, N] (any row strides, unit
    column strides), out of place.  Returns [M, N] contiguous."""
    if A.device.type == "cpu":
        return ref.schur_update(A, L, U)
    _check("schur_update", A, L, U)
    out, schur_update.mode = _launch(A[None], L[None], U[None])
    schur_update.launches += 1
    return out[0]


def schur_update_batched(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Per-system A_b - L_b @ U_b for A [B, M, N], L [B, M, K], U [B, K, N]
    (any row and batch strides, B <= 65535).  Returns [B, M, N] contiguous."""
    if A.device.type == "cpu":
        return ref.schur_update_batched(A, L, U)
    _check("schur_update_batched", A, L, U)
    if A.shape[0] == 0:
        return torch.empty_like(A)
    out, schur_update_batched.mode = _launch(A, L, U)
    schur_update_batched.launches += 1
    return out


schur_update.launches = 0
schur_update_batched.launches = 0
schur_update.mode = schur_update_batched.mode = None
