"""repro_torch.api — the plan/execute solver surface.

    from repro_torch.api import SolverConfig, plan

    p = plan(N, SolverConfig())   # cached per (config key, device)
    fact = p.execute(A)           # Factorization, on the CUDA card
    x = fact.solve(b)             # [N] or [N, k]
    s, ld = fact.slogdet()

    bp = plan((B, N))             # batched: B independent systems at once
    facts = bp.execute(As)        # As [B, N, N]; facts.solve(bs [B, N])

    cp = plan(N, strategy="sequential_chol")   # SPD: blocked Cholesky
    L = cp.execute(A_spd).unpack()             # A_spd = L @ L.T

    # on every rank of a torch.distributed process group, with the same A:
    dp = plan(N, strategy="conflux", grid=GridConfig(2, 2, 2, 32, N))
    fact = dp.execute(A)          # the whole F and rows on every rank
    print(fact.comm_report())     # the schedule's volume per collective
    comm_volume(N, dp.grid)       # the same count, without a plan

Plans run on the card unless the caller passes `device="cpu"`.  Ported so
far: the single-device and batched LU and Cholesky paths, the distributed
2.5D schedules, strategies "sequential", "sequential_chol", "conflux",
"baseline2d", "cholesky25d" and "auto" (calibrated: the predicted-wall
argmin of the cost-model table fitted on the plan's device kind; analytic
where no table covers it: conflux on the comm-volume argmin grid with more
than one rank, sequential otherwise), the "cuda" (default) and "ref" kernel
backends, and `FactorizationPlan.profile_hotloop`.
"""

import repro_torch.api.strategies  # noqa: F401  (registers the built-ins)
from repro_torch.api.config import SolverConfig
from repro_torch.api.plan import (
    FactorizationPlan,
    clear_plan_cache,
    factor,
    plan,
    plan_cache_stats,
    resolve,
    set_plan_cache_capacity,
)
from repro_torch.api.registry import available_strategies, get_strategy, register_strategy
from repro_torch.api.result import Factorization
from repro_torch.core.lu.grid import GridConfig, optimize_grid, validate_layout
from repro_torch.kernels.backend import available_backends


def comm_volume(N: int, grid: GridConfig, pivot: str = "tournament",
                kind: str = "lu") -> dict:
    """Instrumented per-processor communication volume of the schedule.

    kind="lu" counts the COnfLUX schedule (pivot selects tournament/partial
    accounting); kind="cholesky" counts the SPD 2.5D schedule (no pivoting,
    symmetric trailing update — roughly half the LU volume at equal grid).
    """
    if kind == "cholesky":
        from repro_torch.core.cholesky.conflux25d import chol_comm_volume

        return chol_comm_volume(N, grid)
    from repro_torch.core.lu.conflux import lu_comm_volume

    return lu_comm_volume(N, grid, pivot=pivot)


__all__ = [
    "SolverConfig",
    "GridConfig",
    "optimize_grid",
    "validate_layout",
    "FactorizationPlan",
    "Factorization",
    "plan",
    "factor",
    "resolve",
    "plan_cache_stats",
    "clear_plan_cache",
    "set_plan_cache_capacity",
    "available_backends",
    "register_strategy",
    "get_strategy",
    "available_strategies",
    "comm_volume",
]
