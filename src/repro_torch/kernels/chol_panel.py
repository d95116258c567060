"""Cholesky panel: the wrappers of the CUDA kernel in `csrc/chol_panel.cu`.

Ports of `repro/kernels/chol_panel.py::chol_panel` and
`::chol_panel_batched`.  Both launch the same kernel, a single block as a
batch of one, so a batched lane equals the single call bit for bit.  A CPU
tensor goes to the plain version (`repro_torch.kernels.ref`); a CUDA tensor
launches the kernel or raises.  `chol_panel.launches` and
`chol_panel_batched.launches` count the launches, and `.mode` names the
body the last launch took: "warp" (v <= 32) or "smem" (`body(v)`).

bf16 and f16 blocks have entry points of their own: they widen every value
to f32 as they load it, factor in f32 with the f32 kernel's operations, and
round each result once where they store it, as the plain version does, so
they agree with it bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import collectives
from repro_torch.kernels import _build, ref

MAX_V = 128  # the shared-memory body's copy of the [v, v] panel
MAX_BATCH = 2**31 - 1  # systems on gridDim.x
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for `dtype`, resolved (and built) at first use."""
    return _build.function("chol_panel", f"chol_panel_{_SUFFIX[dtype]}", _ARGTYPES)


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
            f"{name}: the kernel takes float32, float64, bfloat16 or float16, got {A.dtype}"
        )


def body(v: int) -> str:
    """The body that the launcher takes for a [v, v] block: "warp" (one warp
    a system) for v <= 32, else "smem".  The wrappers set `.mode` to it."""
    return "warp" if v <= 32 else "smem"


def _launch(A: torch.Tensor, B: int, v: int, lda: int, bsa: int, out_shape) -> torch.Tensor:
    """Launch the kernel on B blocks [v, v] with row stride lda and batch stride bsa."""
    L = torch.empty(out_shape, dtype=A.dtype, device=A.device)
    _build.launch("chol_panel", _entry(A.dtype), A.device, A.data_ptr(), lda, bsa,
                  L.data_ptr(), B, v)
    return L


def chol_panel(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one SPD block A [v, v] (any row stride).

    Returns L [v, v] contiguous with A = L L^T and a zero upper triangle; a
    block that is not SPD gives non-finite values, never an exception.
    """
    if A.device.type == "cpu":
        if collectives.RECORDER is not None:
            collectives.record_kernel("chol_panel", "cpu", A)
        return ref.chol_panel(A)
    _check("chol_panel", A, 2)
    v = A.shape[0]
    L = _launch(A, 1, v, A.stride(0), 0, (v, v))
    chol_panel.mode = body(v)
    chol_panel.launches += 1
    if collectives.RECORDER is not None:
        collectives.record_kernel("chol_panel", chol_panel.mode, A)
    return L


def chol_panel_batched(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of B SPD blocks A [B, v, v] (any row and batch
    strides), one warp (v <= 32) or one block of the kernel per system.
    Returns L [B, v, v]."""
    if A.device.type == "cpu":
        if collectives.RECORDER is not None:
            collectives.record_kernel("chol_panel_batched", "cpu", A)
        return ref.chol_panel_batched(A)
    _check("chol_panel_batched", A, 3)
    if A.shape[0] > MAX_BATCH:
        raise ValueError(f"chol_panel_batched: at most {MAX_BATCH} systems per launch")
    if A.shape[0] == 0:
        return torch.empty_like(A)
    B, v, _ = A.shape
    L = _launch(A, B, v, A.stride(1), A.stride(0), (B, v, v))
    chol_panel_batched.mode = body(v)
    chol_panel_batched.launches += 1
    if collectives.RECORDER is not None:
        collectives.record_kernel("chol_panel_batched", chol_panel_batched.mode, A)
    return L


chol_panel.launches = 0
chol_panel_batched.launches = 0
chol_panel.mode = chol_panel_batched.mode = None
