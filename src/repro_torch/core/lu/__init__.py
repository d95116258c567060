"""COnfLUX and baselines: near-communication-optimal parallel LU (paper §7).

Masked LU (paper §7.3): rows are masked, never swapped.  The sequential
path runs on one device; the 2.5D schedule (`conflux`) and the 2D baseline
run on a `torch.distributed` process group.
"""

from repro_torch.core.lu.conflux import lu_comm_volume
from repro_torch.core.lu.cost_models import (
    COMM_MODELS,
    candmc_model,
    chol_model,
    conflux_model,
    scalapack2d_model,
    slate_model,
)
from repro_torch.core.lu.grid import GridConfig, optimize_grid, validate_layout
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
    "COMM_MODELS",
    "GridConfig",
    "candmc_model",
    "chol_model",
    "conflux_model",
    "lu_comm_volume",
    "lu_masked_sequential",
    "lu_masked_sequential_batched",
    "masked_lup",
    "masked_lup_batched",
    "optimize_grid",
    "permutation_sign",
    "permutation_signs",
    "reconstruct",
    "scalapack2d_model",
    "slate_model",
    "unpack_factors",
    "validate_layout",
]
