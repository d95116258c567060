"""Factor-level solve over raw packed masked factors.

`lu_solve` consumes (F, rows) arrays that came from anywhere — a
`Factorization`, a checkpoint, the JAX package — and is what
`Factorization.solve` runs.
"""

from __future__ import annotations

import torch


def lu_solve(F: torch.Tensor, rows: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given packed masked factors (PA = LU => x = U^-1 L^-1 Pb).

    One system: F [N, N], rows [N], b [N] or [N, k].  A batch: F [B, N, N],
    rows [B, N], b [B, N] or [B, N, k], each system against its own factors
    in one batched call of each solve.  The two triangular solves read L
    (unit lower) and U straight from the row-gathered factors:
    `solve_triangular` touches only the triangle it is told to, so neither L
    nor U is built.
    """
    if F.ndim == 2:
        Fp, pb = F[rows], b[rows]
    else:
        lanes = torch.arange(F.shape[0], device=F.device)[:, None]
        Fp, pb = F[lanes, rows], b[lanes, rows]
    vector = pb.ndim == F.ndim - 1
    rhs = pb[..., None] if vector else pb
    y = torch.linalg.solve_triangular(Fp, rhs, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(Fp, y, upper=True)
    return x[..., 0] if vector else x
