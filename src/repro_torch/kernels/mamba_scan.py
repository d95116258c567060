"""Selective scan of the Mamba-1 SSM: the wrapper of the CUDA kernel in
`csrc/mamba_scan.cu`.

Port of `repro/kernels/mamba_scan.py::mamba_scan`, which also hands back the
final state h_S when asked (`return_state=True`): the prefill -> decode
handoff needs it, and the TPU kernel held it in scratch.  A CPU tensor goes
to the plain version (`repro_torch.kernels.ref.mamba_scan`, the sequential
recurrence); a CUDA tensor launches the kernel or raises.  The launch count
is in `mamba_scan.launches`.

What bounds it on the card, and what the design does about that: see the
note at the top of `csrc/mamba_scan.cu` (bytes: a and b are streamed once,
and the [B, S, di, N] state history is never written).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

STATE_SIZES = (1, 2, 4, 8, 16, 32)  # N: the lanes of one channel's shuffle group
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _check(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor) -> None:
    if a.ndim != 4 or b.shape != a.shape or C.ndim != 3 or tuple(C.shape) != (
            a.shape[0], a.shape[1], a.shape[3]):
        raise ValueError(f"mamba_scan: need a, b [B, S, di, N] and C [B, S, N]; got "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, C {tuple(C.shape)}")
    if a.shape[3] not in STATE_SIZES:
        raise ValueError(f"mamba_scan: the kernel takes N in {STATE_SIZES}, got {a.shape[3]}")
    if min(a.shape[:3]) < 1:
        raise ValueError(f"mamba_scan: empty input {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b), ("C", C)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"mamba_scan: {name} is on {t.device}; the kernel needs a, b "
                             f"and C on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous")


def mamba_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor, *,
               return_state: bool = False):
    """h_t = a_t h_{t-1} + b_t, y_t = sum_n C_t[n] h_t[:, n], h_0 = 0.

    a, b [B, S, di, N] f32, C [B, S, N] f32 -> y [B, S, di] f32, and with
    `return_state` also (y, h_S [B, di, N]).
    """
    if a.device.type == "cpu":
        return ref.mamba_scan(a, b, C, return_state=return_state)
    _check(a, b, C)
    B, S, di, N = a.shape
    y = torch.empty((B, S, di), dtype=torch.float32, device=a.device)
    h = torch.empty((B, di, N), dtype=torch.float32, device=a.device)
    fn = _build.function("mamba_scan", "mamba_scan_f32", _ARGTYPES)
    _build.launch("mamba_scan", fn, a.device, a.data_ptr(), b.data_ptr(), C.data_ptr(),
                  y.data_ptr(), h.data_ptr(), B, S, di, N)
    mamba_scan.launches += 1
    return (y, h) if return_state else y


mamba_scan.launches = 0
