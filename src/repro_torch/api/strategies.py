"""Built-in strategies of the port: sequential, sequential_chol and auto.

Each strategy is a plan builder ``(N, config, device) -> FactorizationPlan``
plus an attached ``resolve(N, config) -> SolverConfig`` hook that pins the
open choices (panel width, grid) so the plan cache key is concrete.
"""

from __future__ import annotations

import torch

from repro_torch.api.config import SolverConfig
from repro_torch.api.plan import FactorizationPlan
from repro_torch.api.registry import register_strategy
from repro_torch.core.cholesky.sequential import (
    chol_blocked_sequential,
    chol_blocked_sequential_batched,
)
from repro_torch.core.lu.sequential import lu_masked_sequential, lu_masked_sequential_batched

# ---------------------------------------------------------------------------
# sequential — single-device masked LU.
# ---------------------------------------------------------------------------


def default_panel_width(N: int, start: int = 32) -> int:
    """Largest v <= min(start, N) dividing N."""
    v = min(start, N)
    while N % v:
        v -= 1
    return v


def _resolve_sequential(N: int, config: SolverConfig) -> SolverConfig:
    if config.pivot == "none":
        raise ValueError(
            "pivot='none' is Cholesky-only (SPD needs no pivoting); LU "
            "strategies need 'tournament' or 'partial'"
        )
    v = config.v
    if v is None:
        v = default_panel_width(N)
    elif not 1 <= v <= N or N % v:
        raise ValueError(f"sequential strategy needs a panel width dividing N: v={v}, N={N}")
    return config.with_(v=v, grid=None)


@register_strategy("sequential")
def build_sequential(N: int, config: SolverConfig, device: torch.device) -> FactorizationPlan:
    """The masked LU of one system, or of B systems at once when `config.B`
    is set (the many-small-systems path)."""
    lu = lu_masked_sequential if config.B is None else lu_masked_sequential_batched

    def run(A):
        return lu(A, v=config.v, backend=config.backend, device=device)

    return FactorizationPlan(N, config, device, run=run)


build_sequential.resolve = _resolve_sequential


# ---------------------------------------------------------------------------
# sequential_chol — the SPD family (arXiv:2108.09337) on the same kernel
# backend: no pivoting, symmetric rank-v Schur update.
# ---------------------------------------------------------------------------


def _resolve_sequential_chol(N: int, config: SolverConfig) -> SolverConfig:
    v = config.v
    if v is None:
        v = default_panel_width(N)
    elif not 1 <= v <= N or N % v:
        raise ValueError(
            f"sequential_chol strategy needs a panel width dividing N: v={v}, N={N}"
        )
    # Pivoting is meaningless for SPD: normalize so every requested pivot
    # resolves to (and cache-shares) the same plan.
    return config.with_(v=v, grid=None, pivot="none")


@register_strategy("sequential_chol")
def build_sequential_chol(N: int, config: SolverConfig,
                          device: torch.device) -> FactorizationPlan:
    """The blocked Cholesky of one SPD system, or of B at once when
    `config.B` is set.  The result's `rows` is the identity order."""
    batched = config.B is not None
    chol = chol_blocked_sequential_batched if batched else chol_blocked_sequential

    def run(A):
        L = chol(A, v=config.v, backend=config.backend, device=device)
        rows = torch.arange(N, dtype=torch.int64, device=device)
        if batched:
            rows = rows.expand(config.B, N).contiguous()
        return L, rows

    return FactorizationPlan(N, config, device, run=run, kind="cholesky")


build_sequential_chol.resolve = _resolve_sequential_chol


# ---------------------------------------------------------------------------
# auto — sequential for a plan on one device.  The calibrated cost model
# (ROADMAP.md item 9) and the multi-device grid ranking (item 10) are not
# ported yet, so this is the analytic single-device branch.
# ---------------------------------------------------------------------------


def _resolve_auto(N: int, config: SolverConfig) -> SolverConfig:
    if config.B is not None and config.grid is not None:
        # Batched = many small independent systems; a grid shards one large one.
        raise ValueError(
            f"auto: batched plans (B={config.B}) are sequential-only; an "
            f"explicit grid {config.grid} cannot be honored"
        )
    if config.grid is not None:
        raise ValueError(
            f"auto: an explicit grid {config.grid} needs the distributed "
            f"schedules, not ported yet (ROADMAP.md module item 10); drop the grid"
        )
    return _resolve_sequential(N, config.with_(strategy="sequential"))


@register_strategy("auto")
def build_auto(N: int, config: SolverConfig, device: torch.device) -> FactorizationPlan:
    raise RuntimeError("'auto' resolves to a concrete strategy before building")


build_auto.resolve = _resolve_auto
