"""Cholesky panel: the wrappers of the CUDA kernel in `csrc/chol_panel.cu`.

Ports of `repro/kernels/chol_panel.py::chol_panel` and
`::chol_panel_batched`.  Both launch the same kernel, a single block as a
batch of one, so a batched lane equals the single call bit for bit.  A CPU
tensor goes to the plain version (`repro_torch.kernels.ref`); a CUDA tensor
launches the kernel or raises.  `chol_panel.launches` and
`chol_panel_batched.launches` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_V = 128  # the block's shared-memory copy of the [v, v] panel
MAX_BATCH = 2**31 - 1  # systems on gridDim.x
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _check(name: str, A: torch.Tensor, ndim: int) -> None:
    shape = "[v, v]" if ndim == 2 else "[B, v, v]"
    if A.ndim != ndim or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_V:
        raise ValueError(f"{name}: A must be {shape} with 1 <= v <= {MAX_V}, "
                         f"got {tuple(A.shape)}")
    if A.stride(-1) != 1:
        raise ValueError(f"{name}: the block's columns must have unit stride")
    if A.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {A.device}")
    if A.dtype not in _SUFFIX:
        raise TypeError(
            f"{name}: the kernel takes float32 or float64, got {A.dtype} "
            f"(bf16/f16 arrive with ROADMAP.md module item 7, mixed precision)"
        )


def _launch(A: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on B blocks given as a 3-D tensor [B, v, v]."""
    B, v, _ = A.shape
    L = torch.empty((B, v, v), dtype=A.dtype, device=A.device)
    fn = _build.function("chol_panel", f"chol_panel_{_SUFFIX[A.dtype]}", _ARGTYPES)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), A.stride(1), A.stride(0), L.data_ptr(), B, v,
                 torch.cuda.current_stream(A.device).cuda_stream)
    _build.check("chol_panel", err)
    return L


def chol_panel(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one SPD block A [v, v] (any row stride).

    Returns L [v, v] contiguous with A = L L^T and a zero upper triangle; a
    block that is not SPD gives non-finite values, never an exception.
    """
    if A.device.type == "cpu":
        return ref.chol_panel(A)
    _check("chol_panel", A, 2)
    L = _launch(A[None])
    chol_panel.launches += 1
    return L[0]


def chol_panel_batched(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of B SPD blocks A [B, v, v] (any row and batch
    strides), one block of the kernel per system.  Returns L [B, v, v]."""
    if A.device.type == "cpu":
        return ref.chol_panel_batched(A)
    _check("chol_panel_batched", A, 3)
    if A.shape[0] > MAX_BATCH:
        raise ValueError(f"chol_panel_batched: at most {MAX_BATCH} systems per launch")
    if A.shape[0] == 0:
        return torch.empty_like(A)
    L = _launch(A)
    chol_panel_batched.launches += 1
    return L


chol_panel.launches = 0
chol_panel_batched.launches = 0
