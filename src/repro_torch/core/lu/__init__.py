"""Masked LU (paper §7.3): rows are masked, never swapped."""

from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.lu.sequential import (
    lu_masked_sequential,
    masked_lup,
    permutation_sign,
    reconstruct,
    unpack_factors,
)

__all__ = [
    "GridConfig",
    "lu_masked_sequential",
    "masked_lup",
    "permutation_sign",
    "reconstruct",
    "unpack_factors",
]
