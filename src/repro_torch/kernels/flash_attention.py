"""Forward GQA attention with an online softmax: the wrapper of the CUDA
kernel in `csrc/flash_attention.cu`.

Port of `repro/kernels/flash_attention.py::flash_attention`.  A CPU tensor
goes to the plain version (`repro_torch.kernels.ref.flash_attention`, dense
softmax); a CUDA tensor launches the kernel or raises.  The kernel reads q,
k and v in the JAX package's `[B, S, heads, hd]` layout as they are, so they
must be contiguous: the model's q, k (rotary output) and v (a view of one
product) already are, and the wrapper raises rather than copy.  The launch
count is in `flash_attention.launches`.

What bounds it on the card: operations (1.37e11 at qwen3-8b's prefill
shape, 0.139 ms at the tensor cores' bf16 rate).  The bf16 kernel runs both
products on the tensor cores (`wgmma`), with K and V brought by TMA into a
three-stage ring that the consumer warps themselves refill; two warpgroups
of 64 packed rows take turns on the tensor cores, and each runs its softmax
under its previous PV product.  The f32 kernel keeps f32 FMAs on the CUDA
cores, since a tensor-core f32 product is TF32 (about three digits).  The
note at the top of `csrc/flash_attention.cu` has the details.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import collectives
from repro_torch.kernels import _build, ref

MAX_BATCH_HEADS = 65535  # B * KV on gridDim.y
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, softcap) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: need q [B, S, H, hd] and k, v [B, S, KV, hd]; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(same B, S and hd, H % KV == 0)")
    if not (16 <= hd <= 256 and hd % 16 == 0):
        raise ValueError(f"flash_attention: the kernel takes hd in 16, 32, ..., 256; got {hd}")
    if B * KV > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: B * KV = {B * KV} > {MAX_BATCH_HEADS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0 or None, got {softcap}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; the kernel needs "
                             f"q, k and v on one CUDA device")
        if t.dtype not in _SUFFIX or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: the kernel takes bf16 or f32 inputs of one dtype; "
                            f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous [B, S, heads, hd]")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 {name} must start on a 16-byte boundary "
                             f"(the kernel reads it through TMA and 16-byte loads)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None) -> torch.Tensor:
    """q [B, S, H, hd], k and v [B, S, KV, hd] -> [B, S, H, hd] in q's dtype.

    Query and key positions are both arange(S).  `window` keeps the keys j
    with q - window < j; `softcap` maps each score s to cap * tanh(s / cap).
    """
    if q.device.type == "cpu":
        if collectives.RECORDER is not None:
            collectives.record_kernel("flash_attention", "cpu", q, k, v)
        return ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", f"flash_attention_{_SUFFIX[q.dtype]}", _ARGTYPES)
    _build.launch("flash_attention", fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, S, H, k.shape[2], hd, int(causal), window or 0,
                  softcap or 0.0, hd**-0.5)
    flash_attention.launches += 1
    if collectives.RECORDER is not None:
        collectives.record_kernel("flash_attention", "kernel", q, k, v)
    return out


flash_attention.launches = 0
