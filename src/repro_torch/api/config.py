"""SolverConfig — the single declarative input to `repro_torch.api.plan`.

The same fields, validation and cache key as the JAX package's config.
`plan()` resolves it against the problem size into a concrete
`FactorizationPlan`.  Combinations whose path is not ported yet are
refused at resolve time (`repro_torch.api.plan.resolve`), naming their
ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.lu.grid import GridConfig

PIVOTS = ("tournament", "partial", "none")
HOTLOOPS = ("windowed", "flat")

# The computation dtype used when a caller gives none.
DEFAULT_DTYPE = "float32"

# Dtypes the factorization may *compute* in (SolverConfig.compute_dtype).
COMPUTE_DTYPES = ("bfloat16", "float16", "float32", "float64")


def resolve_dtype(name) -> torch.dtype:
    """The torch dtype named by a string, numpy dtype or torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if not isinstance(name, str):
        name = np.dtype(name).name  # numpy dtypes and scalar types
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"{name!r} is not a known dtype")
    return dt


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; anything else through `numpy.asarray`, which keeps
    a Python float's float64 where `torch.as_tensor` would make it float32."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@dataclass(frozen=True)
class SolverConfig:
    """Declarative solver selection.

    strategy: a registered strategy name: "sequential", "sequential_chol",
        "conflux", "baseline2d", "cholesky25d", or "auto", which takes the
        predicted-wall argmin (strategy, grid, v, backend, hotloop) of the
        cost-model table fitted on the plan's device kind
        (`repro_torch.analysis.costmodel`), and without such a table
        resolves to "conflux" on the comm-volume argmin grid when the
        default process group has more than one rank, else to "sequential".
    pivot:    "tournament" or "partial"; "none" is Cholesky-only and the LU
              strategies reject it.
    grid:     explicit GridConfig; None lets the strategy choose one.
    dtype:    *working* dtype (normalized to its name, so configs hash).
    compute_dtype: the dtype the kernels run in, or None to compute in
              `dtype` (`compute_dtype == dtype` normalizes to None).  Must
              not be wider than `dtype`.  The plan factors in it and keeps A
              in `dtype`, so `solve(b, refine_tol=...)` can refine back.
    M:        fast-memory budget per processor, in elements (grid choice).
    P_target: processor budget for grid selection; None = the ranks of the
              default process group (1 without one).
    v:        panel width override; None lets the strategy choose.
    backend:  registered KernelBackend name — "cuda" (the hand-written Hopper
              kernels; the default) or "ref" (plain PyTorch).  A plan the
              kernels cannot run is refused, never moved to another backend.
    hotloop:  step-body variant of the 2.5D schedules ("windowed"/"flat").
    B:        batch size for the many-small-systems path, or None.  A plan
              with B factorizes a [B, N, N] stack of independent systems in
              one run (`plan((B, N))`); strategies "sequential" and "auto".
    calibration: version tag of the cost-model calibration that resolved
              this config; callers leave it None.
    """

    strategy: str = "auto"
    pivot: str = "tournament"
    grid: GridConfig | None = None
    dtype: str = DEFAULT_DTYPE
    M: float = 2.0**14
    P_target: int | None = None
    v: int | None = None
    backend: str = "cuda"
    hotloop: str = "windowed"
    B: int | None = None
    compute_dtype: str | None = None
    calibration: str | None = None

    def __post_init__(self):
        try:
            dt = resolve_dtype(self.dtype)
        except TypeError:
            raise ValueError(f"dtype {self.dtype!r} is not a known dtype") from None
        if dt.is_complex:
            raise ValueError(
                f"complex dtype {dtype_name(dt)!r} is not supported; factorize the "
                f"real and imaginary parts separately or use a real 2N x 2N embedding"
            )
        if not dt.is_floating_point or dt == torch.bfloat16:
            # bfloat16 is a compute dtype only, as in the JAX package (whose
            # numpy dtype check refuses it): factor in it under an f32
            # working dtype and refine.
            hint = (" (bfloat16 is a compute dtype: pass dtype='float32', "
                    "compute_dtype='bfloat16')" if dt == torch.bfloat16 else "")
            raise ValueError(
                f"SolverConfig.dtype must be an inexact (floating) dtype — the "
                f"factorizations divide by pivots, so {dtype_name(dt)!r} cannot "
                f"work; cast the matrix or pass dtype='float32'/'float64'{hint}"
            )
        object.__setattr__(self, "dtype", dtype_name(dt))
        if self.compute_dtype is not None:
            try:
                cdt = resolve_dtype(self.compute_dtype)
            except TypeError:
                raise ValueError(
                    f"compute_dtype {self.compute_dtype!r} is not a known "
                    f"dtype; choose from {COMPUTE_DTYPES}"
                ) from None
            if dtype_name(cdt) not in COMPUTE_DTYPES:
                raise ValueError(
                    f"compute_dtype {dtype_name(cdt)!r} is not a supported kernel "
                    f"dtype; choose from {COMPUTE_DTYPES}"
                )
            if cdt.itemsize > dt.itemsize:
                raise ValueError(
                    f"compute_dtype {dtype_name(cdt)!r} is wider than the working "
                    f"dtype {self.dtype!r}; low-precision compute + iterative "
                    f"refinement only makes sense with compute_dtype <= dtype"
                )
            object.__setattr__(
                self, "compute_dtype", None if cdt == dt else dtype_name(cdt)
            )
        if self.pivot not in PIVOTS:
            raise ValueError(f"unknown pivot {self.pivot!r}; choose from {PIVOTS}")
        if not isinstance(self.backend, str) or not self.backend:
            raise ValueError(
                f"backend must be a registered KernelBackend name, got {self.backend!r}"
            )
        if self.hotloop not in HOTLOOPS:
            raise ValueError(f"unknown hotloop {self.hotloop!r}; choose from {HOTLOOPS}")
        if self.B is not None and (not isinstance(self.B, int) or self.B < 1):
            raise ValueError(f"B must be a positive int batch size or None, got {self.B!r}")
        if self.calibration is not None and not isinstance(self.calibration, str):
            raise ValueError(
                f"calibration must be a version string or None, got {self.calibration!r}"
            )

    def with_(self, **changes) -> "SolverConfig":
        """Functional update (dataclasses.replace with validation rerun)."""
        return replace(self, **changes)

    @property
    def effective_compute_dtype(self) -> str:
        """The dtype the kernels actually run in (compute_dtype or dtype)."""
        return self.compute_dtype or self.dtype

    def cache_key(self, N: int) -> tuple:
        """Key identifying the plan this (resolved) config builds.

        The plan cache adds the device, so a CPU plan and a card plan of the
        same problem never share an entry.
        """
        return (N, self.dtype, self.strategy, self.pivot, self.grid, self.v,
                self.backend, self.hotloop, self.B, self.compute_dtype,
                self.calibration)
