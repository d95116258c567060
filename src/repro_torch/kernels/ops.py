"""Public wrappers of the port's kernels.

`fused_trsm_schur[_batched]` keep the JAX API's tile arguments: each
requested tile (`bm`/`bc`) shrinks to the largest divisor of its array
dimension that does not exceed it, as the JAX wrappers' grids need, and the
kernel wrappers check them.  The CUDA kernel picks its own tiles
(persistent streams of 32 x 256 tiles in f32 and 64 x 256 in bf16 / f16,
see `csrc/fused_schur.cu`), so the values change nothing of what it
computes.

The other kernels (`chol_panel`, `trsm_right_upper`, `trsm_left_lower`,
`schur_update` and their `_batched` forms, and the LM stack's
`flash_attention` and `mamba_scan`) take any shape: their tiles are fixed in
the CUDA source and the ragged edges are masked there, so nothing needs
fitting and ops exports their wrappers as they are.
"""

from __future__ import annotations

from repro_torch.kernels import fused_schur as _fs
from repro_torch.kernels.chol_panel import chol_panel, chol_panel_batched
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lu_panel import lu_panel, lu_panel_batched
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.schur_update import schur_update, schur_update_batched
from repro_torch.kernels.trsm import (
    trsm_left_lower,
    trsm_left_lower_batched,
    trsm_right_upper,
    trsm_right_upper_batched,
)

__all__ = [
    "chol_panel", "chol_panel_batched", "flash_attention", "fused_trsm_schur",
    "fused_trsm_schur_batched", "lu_panel", "lu_panel_batched", "mamba_scan",
    "schur_update", "schur_update_batched",
    "trsm_left_lower", "trsm_left_lower_batched", "trsm_right_upper",
    "trsm_right_upper_batched",
]


def _fit(block: int, dim: int) -> int:
    """Largest tile <= min(block, dim) dividing dim (grids need exact cover)."""
    for d in range(min(block, dim), 0, -1):
        if dim % d == 0:
            return d
    return 1


def fused_trsm_schur(A, L00, R01, L10, bm: int = 1024, bc: int = 128, unit: bool = True):
    """U01 = L00^-1 R01 and A - L10 @ U01 in one launch.

    Returns (A_new, U01) — see `repro_torch.kernels.fused_schur`.
    """
    M, C = A.shape
    return _fs.fused_trsm_schur(A, L00, R01, L10, bm=_fit(bm, M), bc=_fit(bc, C), unit=unit)


def fused_trsm_schur_batched(A, L00, R01, L10, bm: int = 1024, bc: int = 128,
                             unit: bool = True):
    """Per-system U01 = L00^-1 R01 and A - L10 @ U01 for B systems in one launch.

    Returns (A_new, U01) with leading batch axes — see
    `repro_torch.kernels.fused_schur`.
    """
    _, M, C = A.shape
    return _fs.fused_trsm_schur_batched(A, L00, R01, L10, bm=_fit(bm, M), bc=_fit(bc, C),
                                        unit=unit)
