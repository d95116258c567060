"""X-partitioning I/O lower-bound machinery (paper §2–§6)."""

from repro_torch.core.xpart.daap import Access, Statement, Program
from repro_torch.core.xpart.bounds import (
    psi,
    max_computational_intensity,
    sequential_io_lower_bound,
    parallel_io_lower_bound,
)
from repro_torch.core.xpart.reuse import (
    input_reuse,
    output_reuse_coefficient,
    program_io_lower_bound,
)
from repro_torch.core.xpart.lu_bound import (
    lu_statements,
    lu_sequential_lower_bound,
    lu_parallel_lower_bound,
    conflux_io_cost,
)

__all__ = [
    "Access",
    "Statement",
    "Program",
    "psi",
    "max_computational_intensity",
    "sequential_io_lower_bound",
    "parallel_io_lower_bound",
    "input_reuse",
    "output_reuse_coefficient",
    "program_io_lower_bound",
    "lu_statements",
    "lu_sequential_lower_bound",
    "lu_parallel_lower_bound",
    "conflux_io_cost",
]
