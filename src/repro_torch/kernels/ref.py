"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, on any device.  The kernel
wrappers use them for CPU tensors, the CPU tests hold them against the JAX
package, and `chip_smoke.py` holds each kernel against its plain version on
the card.  Sub-4-byte inputs compute in f32 and round back, as the TPU
kernels did.
"""

from __future__ import annotations

import torch

from repro_torch.core.lu.sequential import masked_lup, masked_lup_batched


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.element_size() < 4 else t.dtype


def lu_panel(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of panel [R, v] with candidate weights [R].

    Returns (F [R, v] in the panel's dtype, order [v] int32, ok [v] bool).
    """
    wd = _work_dtype(panel)
    F, order, ok = masked_lup(panel.to(wd), weights.to(wd), panel.shape[1])
    return F.to(panel.dtype), order, ok


def lu_panel_batched(panel: torch.Tensor, weights: torch.Tensor):
    """Masked LUP of B panels [B, R, v] with weights [B, R].

    Returns (F [B, R, v], order [B, v] int32, ok [B, v] bool); lane b equals
    `lu_panel(panel[b], weights[b])` bit for bit.
    """
    wd = _work_dtype(panel)
    F, order, ok = masked_lup_batched(panel.to(wd), weights.to(wd), panel.shape[-1])
    return F.to(panel.dtype), order, ok


def fused_trsm_schur(A, L00, R01, L10, unit: bool = True):
    """(A - L10 @ U01, U01) with U01 = L00^-1 R01 (L00 unit-lower if `unit`).

    Out of place, as the kernel: A is not modified.
    """
    wd = _work_dtype(A)
    U01 = torch.linalg.solve_triangular(
        L00.to(wd), R01.to(wd), upper=False, unitriangular=unit
    )
    return (A.to(wd) - L10.to(wd) @ U01).to(A.dtype), U01.to(R01.dtype)


# The batched form [B, M, C], [B, v, v], [B, v, C], [B, M, v] is the same
# code: `solve_triangular` and `@` broadcast over the leading batch axis.
fused_trsm_schur_batched = fused_trsm_schur
