"""Factor-level solve over raw packed masked factors.

`lu_solve` consumes (F, rows) arrays that came from anywhere — a
`Factorization`, a checkpoint, the JAX package — and is what
`Factorization.solve` runs.
"""

from __future__ import annotations

import torch


def lu_solve(F: torch.Tensor, rows: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given packed masked factors (PA = LU => x = U^-1 L^-1 Pb).

    b is [N] or [N, k].  The two triangular solves read L (unit lower) and U
    straight from the row-gathered factors: `solve_triangular` touches only
    the triangle it is told to, so neither L nor U is built.
    """
    Fp = F[rows]
    pb = b[rows]
    rhs = pb[:, None] if pb.ndim == 1 else pb
    y = torch.linalg.solve_triangular(Fp, rhs, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(Fp, y, upper=True)
    return x[:, 0] if pb.ndim == 1 else x
