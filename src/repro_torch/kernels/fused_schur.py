"""Fused TRSM -> Schur update: the wrapper of the CUDA kernel in
`csrc/fused_schur.cu`.

Port of `repro/kernels/fused_schur.py::fused_trsm_schur`.  A CPU tensor goes
to the plain version (`repro_torch.kernels.ref.fused_trsm_schur`); a CUDA
tensor launches the kernel or raises.  `fused_trsm_schur.launches` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_V = 128  # keeps the shared U01 tile and L10 chunk within one block's budget
MAX_BC = 128  # column threads per block
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = (
    *(ctypes.c_void_p, ctypes.c_longlong) * 6,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)


def _check(A, L00, R01, L10, bm: int, bc: int) -> None:
    if A.device.type != "cuda":
        raise ValueError(f"fused_trsm_schur: the kernel needs CUDA tensors, got {A.device}")
    if A.dtype not in _SUFFIX:
        raise TypeError(
            f"fused_trsm_schur: the kernel takes float32 or float64, got {A.dtype} "
            f"(bf16/f16 arrive with ROADMAP.md module item 7, mixed precision)"
        )
    for name, t in (("L00", L00), ("R01", R01), ("L10", L10)):
        if t.device != A.device or t.dtype != A.dtype:
            raise ValueError(
                f"fused_trsm_schur: {name} is {t.dtype} on {t.device}, "
                f"A is {A.dtype} on {A.device}"
            )
    if any(t.ndim != 2 for t in (A, L00, R01, L10)):
        raise ValueError("fused_trsm_schur: every operand must be 2-D")
    M, C = A.shape
    v = L00.shape[0]
    want = {"L00": (v, v), "R01": (v, C), "L10": (M, v)}
    got = {"L00": L00.shape, "R01": R01.shape, "L10": L10.shape}
    if any(tuple(got[k]) != want[k] for k in want) or not 1 <= v <= MAX_V:
        raise ValueError(
            f"fused_trsm_schur: need A [M, C], L00 [v, v], R01 [v, C], L10 [M, v] "
            f"with 1 <= v <= {MAX_V}; got A {tuple(A.shape)}, "
            + ", ".join(f"{k} {tuple(s)}" for k, s in got.items())
        )
    if any(t.stride(1) != 1 for t in (A, L00, R01, L10)):
        raise ValueError("fused_trsm_schur: every operand needs unit column stride")
    if not (1 <= bc <= MAX_BC and C % bc == 0 and bm >= 1 and M % bm == 0
            and M // bm <= 65535):
        raise ValueError(
            f"fused_trsm_schur: tiles must cover A exactly: bc={bc} (<= {MAX_BC}) "
            f"must divide C={C}, bm={bm} must divide M={M} with M / bm <= 65535"
        )


def fused_trsm_schur(A, L00, R01, L10, *, bm: int, bc: int, unit: bool = True):
    """(A - L10 @ U01, U01) with U01 = L00^-1 R01, out of place.

    A [M, C], L00 [v, v] (unit-)lower, R01 [v, C], L10 [M, v], any row
    strides.  Each block of the kernel owns a [bm, bc] tile of the output;
    `bm` must divide M and `bc` (<= 128) must divide C.  Returns
    (A_new [M, C], U01 [v, C]), both contiguous.
    """
    if A.device.type == "cpu":
        return ref.fused_trsm_schur(A, L00, R01, L10, unit=unit)
    _check(A, L00, R01, L10, bm, bc)
    M, C = A.shape
    v = L00.shape[0]
    out = torch.empty((M, C), dtype=A.dtype, device=A.device)
    U01 = torch.empty((v, C), dtype=A.dtype, device=A.device)
    fn = _build.function("fused_schur", f"fused_trsm_schur_{_SUFFIX[A.dtype]}", _ARGTYPES)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), A.stride(0), L00.data_ptr(), L00.stride(0),
                 R01.data_ptr(), R01.stride(0), L10.data_ptr(), L10.stride(0),
                 out.data_ptr(), out.stride(0), U01.data_ptr(), U01.stride(0),
                 M, C, v, bm, bc, int(unit),
                 torch.cuda.current_stream(A.device).cuda_stream)
    _build.check("fused_schur", err)
    fused_trsm_schur.launches += 1
    return out, U01


fused_trsm_schur.launches = 0
