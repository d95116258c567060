"""Blocked Cholesky for SPD systems (arXiv:2108.09337): no pivoting, a
symmetric rank-v Schur update.  The single-device oracle of the JAX
package's 2.5D schedule, on the same kernel-backend layer as the LU."""

from repro_torch.core.cholesky.sequential import (
    chol_blocked_sequential,
    chol_blocked_sequential_batched,
    chol_reconstruct,
    chol_solve,
)

__all__ = [
    "chol_blocked_sequential",
    "chol_blocked_sequential_batched",
    "chol_reconstruct",
    "chol_solve",
]
