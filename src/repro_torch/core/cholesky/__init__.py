"""Blocked Cholesky for SPD systems (arXiv:2108.09337): no pivoting, a
symmetric rank-v Schur update.  The single-device path (`sequential`) and
the 2.5D schedule (`conflux25d`) run on the same kernel-backend layer as
the LU."""

from repro_torch.core.cholesky.conflux25d import chol_comm_volume
from repro_torch.core.cholesky.sequential import (
    chol_blocked_sequential,
    chol_blocked_sequential_batched,
    chol_reconstruct,
    chol_solve,
)
from repro_torch.core.lu.cost_models import chol_model

__all__ = [
    "chol_blocked_sequential",
    "chol_blocked_sequential_batched",
    "chol_comm_volume",
    "chol_model",
    "chol_reconstruct",
    "chol_solve",
]
