"""Fused TRSM -> Schur update: the wrappers of the CUDA kernel in
`csrc/fused_schur.cu`.

Ports of `repro/kernels/fused_schur.py::fused_trsm_schur` and
`::fused_trsm_schur_batched`.  Both launch the same kernel, a single system
as a batch of one, so a batched lane equals the single call bit for bit.  A
CPU tensor goes to the plain version (`repro_torch.kernels.ref`); a CUDA
tensor launches the kernel or raises.  `fused_trsm_schur.launches` and
`fused_trsm_schur_batched.launches` count the launches, and `.mode` says
which body the last launch took: "tma" (the f32 TMA stream), "wgmma" (the
bf16 / f16 stream, products on the tensor cores) or "plain" (plain loads).
`stream_mode(A, L00, R01, L10)` predicts it from the operands alone.

bf16 and f16 operands have entry points of their own.  Both of their
bodies solve U01 in f32, form A - L10 @ U01 with exact products summed in
f32 (the stream splits U01 exactly into three bf16 parts, and f16 L10 into
two, for the tensor cores), and round each result once where they store
it, as the plain version does; the order of the sum differs, so they agree
with it within a 2-byte rounding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import collectives
from repro_torch.kernels import _build, ref
from repro_torch.kernels.schur_update import tma_fits

# The entry points' limits.  The kernel picks its own tiles; `bm` and `bc`
# mirror the JAX API's tiles and must cover A exactly, within these limits,
# so that the entry points refuse what they always refused.
MAX_V = 128  # the plain loads' solve keeps a column of U01 in each thread
MAX_BC = 128
MAX_GRID_YZ = 65535
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = (
    *(ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) * 6,
    *(ctypes.c_int,) * 5,
    ctypes.POINTER(ctypes.c_int),
    ctypes.c_void_p,
)


_MODES = {0: "plain", 1: "tma", 2: "wgmma"}
# The v that each streamed storage size (bytes) takes: rows of L00 and L10
# of at least 16 bytes, and at most one chunk.
_STREAM_V = {4: (4, 32), 2: (8, 32)}


def stream_mode(A: torch.Tensor, L00: torch.Tensor, R01: torch.Tensor,
                L10: torch.Tensor) -> str:
    """The body that the kernel's launcher picks for these operands, by the
    rule it applies before the launch: "tma" for f32 and "wgmma" for bf16 /
    f16 where v is within `_STREAM_V` (4..32 resp. 8..32), A has rows, and
    TMA takes every operand (A, L00, R01, L10 and the contiguous result),
    else "plain" (always for f64 and for an empty result).  TMA takes an
    operand whose base is 16-byte aligned, whose row stride and (in a batch
    of more than one) batch stride are whole 16-byte runs, and whose rows
    hold at least 16 bytes.

    Reads shapes, strides, dtype and addresses only; any device."""
    A3, L003, R013, L103 = (t if t.ndim == 3 else t[None] for t in (A, L00, R01, L10))
    B, M, C = A3.shape
    v = L003.shape[-1]
    size = A.element_size()
    lo, hi = _STREAM_V.get(size, (1, 0))
    if B == 0 or M == 0 or C == 0 or not lo <= v <= hi:
        return "plain"

    def fits(t: torch.Tensor, rows: int, cols: int) -> bool:
        return tma_fits(t.data_ptr(), t.stride(1), t.stride(0), B, rows, cols, size)

    ok = (fits(A3, M, C) and fits(L003, v, v) and fits(R013, v, C) and fits(L103, M, v)
          and tma_fits(0, C, M * C, B, M, C, size))  # the result: contiguous, aligned
    return ("tma" if size == 4 else "wgmma") if ok else "plain"


def _check(name: str, A, L00, R01, L10, bm: int, bc: int) -> None:
    ndim = A.ndim
    if ndim not in (2, 3) or any(t.ndim != ndim for t in (L00, R01, L10)):
        raise ValueError(f"{name}: the operands must all be 2-D, or all 3-D with a batch axis")
    lead = tuple(A.shape[:-2])
    M, C = A.shape[-2:]
    v = L00.shape[-1]
    want = {"L00": lead + (v, v), "R01": lead + (v, C), "L10": lead + (M, v)}
    got = {"L00": L00.shape, "R01": R01.shape, "L10": L10.shape}
    if any(tuple(got[k]) != want[k] for k in want) or not 1 <= v <= MAX_V:
        pre = "B, " if lead else ""
        raise ValueError(
            f"{name}: need A [{pre}M, C], L00 [{pre}v, v], R01 [{pre}v, C], "
            f"L10 [{pre}M, v] with 1 <= v <= {MAX_V}; got A {tuple(A.shape)}, "
            + ", ".join(f"{k} {tuple(s)}" for k, s in got.items())
        )
    if any(t.stride(-1) != 1 for t in (A, L00, R01, L10)):
        raise ValueError(f"{name}: every operand needs unit column stride")
    if lead and lead[0] > MAX_GRID_YZ:
        raise ValueError(f"{name}: at most {MAX_GRID_YZ} systems per launch, got B={lead[0]}")
    if not (1 <= bc <= MAX_BC and C % bc == 0 and bm >= 1 and M % bm == 0
            and M // bm <= MAX_GRID_YZ):
        raise ValueError(
            f"{name}: tiles must cover A exactly: bc={bc} (<= {MAX_BC}) must divide "
            f"C={C}, bm={bm} must divide M={M} with M / bm <= {MAX_GRID_YZ}"
        )
    if A.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {A.device}")
    if A.dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: the kernel takes float32, float64, bfloat16 or float16, got {A.dtype}"
        )
    for arg, t in (("L00", L00), ("R01", R01), ("L10", L10)):
        if t.device != A.device or t.dtype != A.dtype:
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, A is {A.dtype} on {A.device}"
            )


def _launch(A, L00, R01, L10, unit: bool):
    """Launch the kernel on B systems given as 3-D tensors [B, ...].

    Returns (out, U01, mode)."""
    B, M, C = A.shape
    v = L00.shape[-1]
    out = torch.empty((B, M, C), dtype=A.dtype, device=A.device)
    U01 = torch.empty((B, v, C), dtype=A.dtype, device=A.device)
    fn = _build.function("fused_schur", f"fused_trsm_schur_{_SUFFIX[A.dtype]}", _ARGTYPES)
    operands = (A, L00, R01, L10, out, U01)
    mode = ctypes.c_int(0)
    _build.launch("fused_schur", fn, A.device,
                  *(x for t in operands for x in (t.data_ptr(), t.stride(1), t.stride(0))),
                  B, M, C, v, int(unit), ctypes.byref(mode))
    return out, U01, _MODES[mode.value]


def fused_trsm_schur(A, L00, R01, L10, *, bm: int, bc: int, unit: bool = True):
    """(A - L10 @ U01, U01) with U01 = L00^-1 R01, out of place.

    A [M, C], L00 [v, v] (unit-)lower, R01 [v, C], L10 [M, v], any row
    strides.  The kernel picks its own tiles; `bm` must divide M and `bc`
    (<= 128) must divide C, as the JAX API's tiles must.  Returns
    (A_new [M, C], U01 [v, C]), both contiguous.
    """
    if A.device.type == "cpu":
        if collectives.RECORDER is not None:
            collectives.record_kernel("fused_trsm_schur", "cpu", A, L00, R01, L10)
        return ref.fused_trsm_schur(A, L00, R01, L10, unit=unit)
    _check("fused_trsm_schur", A, L00, R01, L10, bm, bc)
    out, U01, fused_trsm_schur.mode = _launch(A[None], L00[None], R01[None], L10[None], unit)
    fused_trsm_schur.launches += 1
    if collectives.RECORDER is not None:
        collectives.record_kernel("fused_trsm_schur", fused_trsm_schur.mode, A, L00, R01, L10)
    return out[0], U01[0]


def fused_trsm_schur_batched(A, L00, R01, L10, *, bm: int, bc: int, unit: bool = True):
    """Per-system (A_b - L10_b @ U01_b, U01_b) with U01_b = L00_b^-1 R01_b.

    A [B, M, C], L00 [B, v, v], R01 [B, v, C], L10 [B, M, v], any row and
    batch strides; tiles as in `fused_trsm_schur`, with B <= 65535.  Returns
    (A_new [B, M, C], U01 [B, v, C]), both contiguous.
    """
    if A.device.type == "cpu":
        if collectives.RECORDER is not None:
            collectives.record_kernel("fused_trsm_schur_batched", "cpu", A, L00, R01, L10)
        return ref.fused_trsm_schur_batched(A, L00, R01, L10, unit=unit)
    _check("fused_trsm_schur_batched", A, L00, R01, L10, bm, bc)
    if A.shape[0] == 0:
        return torch.empty_like(A), torch.empty_like(R01)
    out, U01, fused_trsm_schur_batched.mode = _launch(A, L00, R01, L10, unit)
    fused_trsm_schur_batched.launches += 1
    if collectives.RECORDER is not None:
        collectives.record_kernel("fused_trsm_schur_batched", fused_trsm_schur_batched.mode,
                                  A, L00, R01, L10)
    return out, U01


fused_trsm_schur.launches = 0
fused_trsm_schur_batched.launches = 0
fused_trsm_schur.mode = fused_trsm_schur_batched.mode = None
