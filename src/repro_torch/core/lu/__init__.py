"""Masked LU (paper §7.3): rows are masked, never swapped."""

from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.lu.sequential import (
    lu_masked_sequential,
    lu_masked_sequential_batched,
    masked_lup,
    masked_lup_batched,
    permutation_sign,
    permutation_signs,
    reconstruct,
    unpack_factors,
)

__all__ = [
    "GridConfig",
    "lu_masked_sequential",
    "lu_masked_sequential_batched",
    "masked_lup",
    "masked_lup_batched",
    "permutation_sign",
    "permutation_signs",
    "reconstruct",
    "unpack_factors",
]
