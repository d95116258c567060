"""The COnfLUX upper bound of the paper's I/O analysis (§7.4), as the grid
optimizer's cost models need it."""

from repro_torch.core.xpart.lu_bound import conflux_io_cost

__all__ = ["conflux_io_cost"]
