"""Built-in strategies: sequential, conflux, baseline2d, auto (LU) and
sequential_chol, cholesky25d (SPD Cholesky on the same kernel backends).

Each strategy is a plan builder
``(N, config, device, mesh=None) -> FactorizationPlan`` plus an attached
``resolve(N, config, device=None) -> SolverConfig`` hook that pins the
open choices (grid, panel width, pivot) so the plan cache key is concrete;
`device` is the device the plan runs on (only `auto` reads it, to price
candidates with the table fitted on that device kind).  The
distributed strategies size their grid for the default process group
(`P_target` defaults to its world size, 1 without one).

A builder's ``primitives`` name the `KernelBackend` primitives its
strategy calls (either hot loop, for the 2.5D schedules).  Plan resolution
checks the "cuda" kernels of exactly those in the compute dtype; every
primitive has f32, f64, bf16 and f16 kernels, so every strategy takes
every compute dtype.
"""

from __future__ import annotations

import torch

from repro_torch.api.config import SolverConfig
from repro_torch.api.plan import FactorizationPlan
from repro_torch.api.registry import register_strategy
from repro_torch.core.cholesky.conflux25d import chol_comm_volume, distributed_cholesky
from repro_torch.core.cholesky.sequential import (
    chol_blocked_sequential,
    chol_blocked_sequential_batched,
)
from repro_torch.core.collectives import LuMesh, world_size
from repro_torch.core.lu.baseline2d import scalapack2d_grid
from repro_torch.core.lu.conflux import distributed_lu, lu_comm_volume, make_lu_mesh
from repro_torch.core.lu.grid import optimize_grid, validate_layout
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


def _resolve_sequential(N: int, config: SolverConfig, device=None) -> SolverConfig:
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
def build_sequential(N: int, config: SolverConfig, device: torch.device,
                     mesh=None) -> FactorizationPlan:
    """The masked LU of one system, or of B systems at once when `config.B`
    is set (the many-small-systems path)."""
    lu = lu_masked_sequential if config.B is None else lu_masked_sequential_batched

    def run(A):
        return lu(A, v=config.v, backend=config.backend, device=device)

    return FactorizationPlan(N, config, device, run=run)


build_sequential.resolve = _resolve_sequential
build_sequential.primitives = ("panel_lup", "fused_trsm_schur")


# ---------------------------------------------------------------------------
# sequential_chol — the SPD family (arXiv:2108.09337) on the same kernel
# backend: no pivoting, symmetric rank-v Schur update.
# ---------------------------------------------------------------------------


def _resolve_sequential_chol(N: int, config: SolverConfig, device=None) -> SolverConfig:
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
def build_sequential_chol(N: int, config: SolverConfig, device: torch.device,
                          mesh=None) -> FactorizationPlan:
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
build_sequential_chol.primitives = ("panel_chol", "trsm_right_upper", "schur_update")


# ---------------------------------------------------------------------------
# conflux / baseline2d / cholesky25d — the block-cyclic schedules on a
# torch.distributed process group.
# ---------------------------------------------------------------------------


def _reject_batched(strategy: str, config: SolverConfig) -> None:
    if config.B is not None:
        raise ValueError(
            f"strategy {strategy!r} shards one large matrix and does not "
            f"support batched plans (B={config.B}); use 'sequential' / "
            f"'sequential_chol' (or 'auto') for the many-small-systems path"
        )


def _resolve_conflux(N: int, config: SolverConfig, device=None) -> SolverConfig:
    _reject_batched("conflux", config)
    if config.pivot == "none":
        raise ValueError(
            "pivot='none' is Cholesky-only (SPD needs no pivoting); LU "
            "strategies need 'tournament' or 'partial'"
        )
    if config.grid is not None:
        return config
    grid = optimize_grid(N, config.P_target or world_size(), config.M, v=config.v)
    return config.with_(grid=grid)


def _mesh_for(config: SolverConfig, mesh: LuMesh | None) -> LuMesh:
    """The plan's mesh: the caller's, which must have the grid's shape, or
    one built over the default process group."""
    grid = config.grid
    if mesh is None:
        return make_lu_mesh(grid)
    shape = (grid.Px, grid.Py, grid.c)
    if (mesh.grid.Px, mesh.grid.Py, mesh.grid.c) != shape:
        raise ValueError(
            f"mesh {mesh.grid} does not match the plan's grid {grid}: the mesh has "
            f"P_used={mesh.grid.P_used}, the grid needs {grid.P_used} as {list(shape)}"
        )
    return mesh


def _build_distributed(N: int, config: SolverConfig, device: torch.device, mesh,
                       kind: str) -> FactorizationPlan:
    """Shared builder of the block-cyclic strategies: every rank passes the
    same A and gets the whole factorization back."""
    grid = config.grid
    if grid is None:
        raise ValueError(f"strategy {config.strategy!r} needs a resolved grid")
    validate_layout(N, grid, pivot=config.pivot)
    mesh = _mesh_for(config, mesh)
    opts = dict(backend=config.backend, hotloop=config.hotloop)

    if kind == "cholesky":
        comm = chol_comm_volume(N, grid)

        def run(A):
            L = distributed_cholesky(A, grid, mesh, **opts)
            return L, torch.arange(N, dtype=torch.int64, device=A.device)
    else:
        comm = lu_comm_volume(N, grid, pivot=config.pivot)

        def run(A):
            return distributed_lu(A, grid, mesh, pivot=config.pivot, **opts)

    return FactorizationPlan(N, config, device, grid=grid, mesh=mesh, comm=comm, run=run,
                             kind=kind)


@register_strategy("conflux")
def build_conflux(N: int, config: SolverConfig, device: torch.device,
                  mesh=None) -> FactorizationPlan:
    """The 2.5D near-communication-optimal LU (paper §7)."""
    return _build_distributed(N, config, device, mesh, "lu")


build_conflux.resolve = _resolve_conflux
build_conflux.primitives = ("panel_lup", "trsm_right_upper", "fused_trsm_schur",
                            "trsm_left_lower", "schur_update")


def _resolve_baseline2d(N: int, config: SolverConfig, device=None) -> SolverConfig:
    _reject_batched("baseline2d", config)
    changes: dict = {}
    if config.pivot != "partial":
        changes["pivot"] = "partial"  # the 2D baseline is defined by it
    if config.grid is None:
        changes["grid"] = scalapack2d_grid(N, config.P_target or world_size(),
                                           v=config.v or 32)
    return config.with_(**changes) if changes else config


@register_strategy("baseline2d")
def build_baseline2d(N: int, config: SolverConfig, device: torch.device,
                     mesh=None) -> FactorizationPlan:
    """ScaLAPACK/LibSci-style 2D grid with partial pivoting (§8)."""
    return _build_distributed(N, config, device, mesh, "lu")


build_baseline2d.resolve = _resolve_baseline2d
build_baseline2d.primitives = build_conflux.primitives


def _resolve_cholesky25d(N: int, config: SolverConfig, device=None) -> SolverConfig:
    _reject_batched("cholesky25d", config)
    changes: dict = {"pivot": "none"} if config.pivot != "none" else {}
    if config.grid is None:
        changes["grid"] = optimize_grid(N, config.P_target or world_size(), config.M,
                                        v=config.v, volume=chol_comm_volume)
    return config.with_(**changes) if changes else config


@register_strategy("cholesky25d")
def build_cholesky25d(N: int, config: SolverConfig, device: torch.device,
                      mesh=None) -> FactorizationPlan:
    """The 2.5D Cholesky of SPD systems (arXiv:2108.09337)."""
    return _build_distributed(N, config, device, mesh, "cholesky")


build_cholesky25d.resolve = _resolve_cholesky25d
build_cholesky25d.primitives = ("panel_chol", "trsm_right_upper", "fused_trsm_schur",
                                "trsm_left_lower", "schur_update")


# ---------------------------------------------------------------------------
# auto — trace-calibrated wall-time argmin, with the analytic comm-volume
# ranking as fallback.
# ---------------------------------------------------------------------------


def _resolve_auto_analytic(N: int, config: SolverConfig, n_ranks: int) -> SolverConfig:
    """Comm-volume argmin grid on > 1 rank, sequential otherwise.  Used when
    no calibration covers the combo."""
    if n_ranks > 1:
        try:
            grid = optimize_grid(N, config.P_target or n_ranks, config.M, v=config.v)
            return config.with_(strategy="conflux", grid=grid)
        except ValueError:
            pass  # no feasible distributed grid: fall through to sequential
    return _resolve_sequential(N, config.with_(strategy="sequential", grid=None))


def _resolve_auto(N: int, config: SolverConfig, device=None) -> SolverConfig:
    n_ranks = world_size()
    if config.B is not None:
        # Batched = many small independent systems; the distributed schedules
        # shard one large matrix, so auto always picks the batched sequential.
        if config.grid is not None:
            raise ValueError(
                f"auto: batched plans (B={config.B}) are sequential-only; an "
                f"explicit grid {config.grid} cannot be honored"
            )
        return _resolve_sequential(N, config.with_(strategy="sequential"))
    if config.grid is not None:
        if n_ranks < config.grid.P_used:
            raise ValueError(
                f"auto: explicit grid {config.grid} needs {config.grid.P_used} "
                f"ranks but the process group has {n_ranks}; drop the grid to let "
                f"auto choose, or use strategy='sequential'"
            )
        return config.with_(strategy="conflux")
    # Score every candidate (strategy, grid, v, backend, hotloop) tuple with
    # the cost-model table fitted on the plan's device kind and take the
    # predicted wall-time argmin; on a CPU plan the pick may change the
    # backend too, on a CUDA plan it keeps `config.backend`.  The
    # choice is recorded under the resolved cache key so plan() can attach
    # it and execute() can report the measured-vs-predicted residual; the
    # calibration version is stamped on the config so the pick never
    # outlives the table that made it.
    from repro_torch.analysis import costmodel

    choice = costmodel.autotune_choice(N, config, n_dev=n_ranks, device=device)
    if choice is not None:
        resolved = config.with_(
            strategy=choice["strategy"], grid=choice["grid"], v=choice["v"],
            backend=choice["backend"], hotloop=choice["hotloop"],
            calibration=choice["calibration_version"],
        )
        costmodel.record_decision(resolved.cache_key(N), choice)
        return resolved
    # No table covers (device kind, backend, dtype): the analytic ranking.
    return _resolve_auto_analytic(N, config, n_ranks)


@register_strategy("auto")
def build_auto(N: int, config: SolverConfig, device: torch.device,
               mesh=None) -> FactorizationPlan:
    raise RuntimeError("'auto' resolves to a concrete strategy before building")


build_auto.resolve = _resolve_auto
