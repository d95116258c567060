"""plan/execute core: FactorizationPlans and their LRU cache.

`plan(N, config, device=...)` resolves a `SolverConfig` to a concrete
strategy + grid + kernel backend, then returns the cached
`FactorizationPlan` for that key and device — building one only on a cache
miss.  `plan.execute(A)` factorizes on the plan's device.  `plan((B, N))`
builds a batched plan that factorizes a [B, N, N] stack of independent
systems in one run.

The distributed strategies ("conflux", "baseline2d", "cholesky25d") run on
the default `torch.distributed` process group: every rank calls `plan` and
`execute` with the same arguments, and every rank gets the whole result.
The plan owns its `LuMesh` (the process groups of the grid's axes); a
caller-built mesh (`plan(..., mesh=...)`) bypasses the cache.

Plans run on the CUDA card unless the caller passes `device="cpu"`; a host
without CUDA raises instead of running on the CPU.

A plan with `SolverConfig(compute_dtype=...)` factors in that dtype and
keeps the input in the working dtype on the result (`A_ref`), for
`solve(b, refine_tol=...)`.

The cache is LRU-bounded (`set_plan_cache_capacity`, default
REPRO_PLAN_CACHE_CAPACITY or 64).  Evictions only drop the cache's
reference: plans already held keep working.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from collections import OrderedDict

import torch

from repro_torch.api.config import SolverConfig, as_tensor, dtype_name, resolve_dtype
from repro_torch.api.registry import get_strategy
from repro_torch.api.result import Factorization
from repro_torch.core.collectives import group_key
from repro_torch.core.lu.grid import GridConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.backend import (
    KERNEL_DTYPES,
    available_backends,
    check_hopper_constraints,
)


class FactorizationPlan:
    """A reusable factorization program for one (N, config, device).

    Attributes:
        N, config:     the resolved problem/strategy this plan was built for.
        B:             batch size of a batched plan ([B, N, N] stacks), or None.
        device:        where `execute` runs.
        grid, mesh:    processor grid and this rank's `LuMesh` (None on one
                       device).
        comm:          instrumented per-processor schedule volume (elements).
        trace_count:   times the plan prepared its program.  PyTorch runs
                       eagerly, so this is 1 from the first execute on (the
                       kernels are loaded then) and never grows.
        execute_count: times `execute` ran.
        hotloop:       per-primitive timings of `profile_hotloop` ({} before).
        autotune:      the calibrated `strategy="auto"` decision that produced
                       this plan (tuple, predicted wall, calibration version),
                       or None for a plan from an explicit or analytic config.

    `lowered_text("trace")` gives the plan's program as text.
    """

    def __init__(self, N: int, config: SolverConfig, device: torch.device, *,
                 grid: GridConfig | None = None, mesh=None, comm: dict | None = None,
                 run=None, kind: str = "lu"):
        self.N = N
        self.B = config.B
        self.config = config
        self.device = device
        self.grid = grid
        self.mesh = mesh
        self.comm = dict(comm or {})
        self.kind = kind
        self.hotloop: dict = {}
        self.autotune: dict | None = None
        self.trace_count = 0
        self.execute_count = 0
        # Cached plans are shared across threads, so the counter bumps are
        # locked: a bare `+= 1` can drop increments under concurrent executes.
        self._count_lock = threading.Lock()
        # (A: tensor [N, N] or [B, N, N] on device) -> (F, rows); set by the strategy
        self._run = run
        self._trace_text: str | None = None

    def lowered_text(self, stage: str = "trace") -> str:
        """The plan's program as text: one JSON line per kernel-wrapper call,
        collective and step boundary (`repro_torch.analysis.trace`).

        Unlike the JAX package, which lowers a plan without running it, the
        port runs the plan once to trace it: on a deterministic input of its
        shape (standard normal from `numpy.random.default_rng(0)`, made SPD
        for a Cholesky plan) on its own device.  The text is cached on the
        plan.  A distributed plan's ranks must all call this together, as
        they call `execute`.  The JAX package's stages "stablehlo" and "hlo"
        have no counterpart (PyTorch emits no StableHLO) and raise."""
        if stage != "trace":
            raise ValueError(
                f"lowered_text: stage {stage!r} is the JAX package's lowered program; "
                f"PyTorch emits no StableHLO, so the port's program text is stage 'trace'"
            )
        if self._trace_text is None:
            import numpy as np

            from repro_torch.analysis.trace import recording

            n = self.N
            shape = (n, n) if self.B is None else (self.B, n, n)
            A = np.random.default_rng(0).standard_normal(shape)
            if self.kind == "cholesky":
                A = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
            A = torch.from_numpy(A).to(device=self.device, dtype=resolve_dtype(self.config.dtype))
            compute = self.config.compute_dtype
            A_lo = A if compute is None else A.to(resolve_dtype(compute))
            self._sync()
            with recording() as rec:
                self._run(A_lo)
                self._sync()
            self._trace_text = rec.text()
        return self._trace_text

    def profile_hotloop(self, repeats: int = 3) -> dict:
        """Measure per-primitive hot-loop wall times on this plan's shapes.

        Times the backend's panel / TRSM / Schur / gather / fused primitives
        standalone on the plan's device (see `repro_torch.api.hotloop`) and
        caches the result on the plan; every later `execute` carries it into
        `Factorization.hotloop` / `comm_report()`.
        """
        from repro_torch.api.hotloop import profile_primitives

        self.hotloop = profile_primitives(self.N, self.config, grid=self.grid,
                                          repeats=repeats, device=self.device)
        return self.hotloop

    def execute(self, A) -> Factorization:
        """Factorize A [N, N], or [B, N, N] on a batched plan (numpy array,
        tensor or nested lists, which numpy reads as float64), on the plan's
        device.

        On a plan from the calibrated `strategy="auto"`, the result's
        `autotune` carries the decision and this execute's measured wall
        time (host clock, ending in `torch.cuda.synchronize()` on the card;
        other executes do not wait for the card).
        """
        A = as_tensor(A)
        if A.is_complex():
            raise ValueError(
                f"complex matrices are not supported (plan computes in "
                f"{self.config.dtype}); factorize the real and imaginary parts "
                f"separately or use a real 2N x 2N embedding"
            )
        work = resolve_dtype(self.config.dtype)
        if A.is_floating_point() and A.dtype.itemsize > work.itemsize:
            warnings.warn(
                f"plan computes in {self.config.dtype}; input {dtype_name(A.dtype)} "
                f"will be downcast (set SolverConfig.dtype to keep precision)",
                stacklevel=2,
            )
        want = (self.N, self.N) if self.B is None else (self.B, self.N, self.N)
        if tuple(A.shape) != want:
            what = f"N={self.N}" if self.B is None else f"B={self.B}, N={self.N}"
            raise ValueError(
                f"plan was built for {what} (expects shape {want}), "
                f"got A of shape {tuple(A.shape)}"
            )
        A = A.to(device=self.device, dtype=work)
        # Mixed precision: the kernels run in the (lower) compute dtype, while
        # A_ref keeps the working-precision matrix for refinement residuals.
        compute = self.config.compute_dtype
        A_lo = A if compute is None else A.to(resolve_dtype(compute))
        stamp = self.autotune is not None
        if stamp:
            self._sync()  # the measured wall starts with nothing queued
        t0 = time.perf_counter()
        F, rows = self._run(A_lo)
        autotune = None
        if stamp:
            # Close the autotuner's feedback loop: stamp the measured wall
            # beside the cost model's prediction.
            self._sync()
            wall_us = (time.perf_counter() - t0) * 1e6
            autotune = {k: v for k, v in self.autotune.items() if k != "grid"}
            autotune["grid"] = str(self.autotune.get("grid"))
            autotune["measured_wall_us"] = wall_us
            pred = self.autotune.get("predicted_wall_us")
            if pred:
                autotune["wall_residual"] = (wall_us - pred) / pred
        with self._count_lock:
            self.trace_count = 1
            self.execute_count += 1
        return Factorization(
            F=F, rows=rows, grid=self.grid, comm=dict(self.comm),
            strategy=self.config.strategy, backend=self.config.backend,
            kind=self.kind, hotloop=dict(self.hotloop), A_ref=A, work_dtype=work,
            autotune=autotune,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        batch = "" if self.B is None else f"B={self.B}, "
        return (f"FactorizationPlan({batch}N={self.N}, strategy={self.config.strategy!r}, "
                f"pivot={self.config.pivot!r}, backend={self.config.backend!r}, "
                f"device={self.device}, grid={self.grid}, "
                f"traces={self.trace_count}, executes={self.execute_count})")


def _capacity_from_env(default: int = 64) -> int:
    """Parse REPRO_PLAN_CACHE_CAPACITY: a non-integer or negative value falls
    back to the default with a warning (0 = unbounded)."""
    raw = os.environ.get("REPRO_PLAN_CACHE_CAPACITY")
    if raw is None:
        return default
    try:
        cap = int(raw)
        if cap < 0:
            raise ValueError
        return cap
    except ValueError:
        warnings.warn(
            f"ignoring REPRO_PLAN_CACHE_CAPACITY={raw!r} (want an integer >= 0, "
            f"0 = unbounded); using {default}",
            stacklevel=2,
        )
        return default


_PLAN_CACHE: OrderedDict[tuple, FactorizationPlan] = OrderedDict()
_BUILDING: dict[tuple, threading.Event] = {}
_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_CAPACITY = _capacity_from_env()
_LOCK = threading.Lock()


def _resolve_backend(N: int, config: SolverConfig) -> SolverConfig:
    """Validate the kernel backend.  Runs after strategy resolution, so the
    panel width is concrete and the strategy names the primitives it calls
    (its builder's `primitives`; all of them when it names none).  The
    kernels are checked in the effective compute dtype, so a float64 plan
    that computes in float32 runs on the f32 kernels.  A plan the kernels
    cannot run raises."""
    if config.backend == "pallas":
        raise ValueError(
            "backend 'pallas' is the JAX package's TPU kernels; the port's "
            "hand-written kernels are backend 'cuda' (or 'ref' for plain PyTorch)"
        )
    if config.backend not in available_backends():
        raise ValueError(
            f"unknown kernel backend {config.backend!r}; available: {available_backends()}"
        )
    if config.backend == "cuda":
        v = config.grid.v if config.grid is not None else config.v
        primitives = getattr(get_strategy(config.strategy), "primitives", tuple(KERNEL_DTYPES))
        check_hopper_constraints(config.effective_compute_dtype, v, config.B, primitives)
    return config


def resolve(N: int, config: SolverConfig, device=None) -> SolverConfig:
    """Resolve "auto"/missing-grid/panel-width/backend configs to concrete choices.

    `device` is the device the plan will run on: the calibrated `auto`
    prices candidates with the cost-model table fitted on that device kind
    (None: the port's default device, the current card when CUDA is
    available, else the CPU; see `analysis.costmodel.device_kind`).
    """
    for _ in range(3):
        builder = get_strategy(config.strategy)
        resolver = getattr(builder, "resolve", None)
        resolved = config if resolver is None else resolver(N, config, device=device)
        if resolved.strategy == config.strategy:
            return _resolve_backend(N, resolved)
        config = resolved
    raise RuntimeError(f"strategy resolution did not converge for {config}")


def plan(N: int, config: SolverConfig | None = None, *, device=None, mesh=None,
         **overrides) -> FactorizationPlan:
    """Get (or build) the plan for factorizing N x N matrices on `device`.

    `N` may be a `(B, N)` tuple, which builds a *batched* plan factorizing a
    [B, N, N] stack of independent systems in one run (the
    many-small-systems path; the same as `plan(N, B=B)`).  `device=None` is
    the CUDA card (raises when there is none; pass `device="cpu"` for the
    plain PyTorch versions on the CPU).  `overrides` are SolverConfig
    fields, so `plan(256, v=16)` works without building a config.

    A distributed strategy builds `make_lu_mesh(grid)` over the default
    process group; passing an explicit `mesh` (an `LuMesh` of the same
    [Px, Py, c]) uses that one and bypasses the cache.
    """
    dev = resolve_device(device)
    config = config or SolverConfig()
    if overrides:
        config = config.with_(**overrides)
    if isinstance(N, tuple):
        if len(N) != 2:
            raise ValueError(
                f"plan() shape must be N or (B, N), got tuple of length {len(N)}"
            )
        B, N = N
        if config.B is not None and config.B != B:
            raise ValueError(f"plan((B={B}, N)) conflicts with SolverConfig.B={config.B}")
        config = config.with_(B=int(B))
    resolved = resolve(N, config, device=dev)
    builder = get_strategy(resolved.strategy)
    if mesh is not None:
        return _attach_autotune(builder(N, resolved, dev, mesh=mesh), resolved.cache_key(N))
    # A distributed plan holds process groups: it serves only the group it
    # was built over.
    key = (resolved.cache_key(N), str(dev), group_key() if resolved.grid else None)
    while True:
        with _LOCK:
            cached = _PLAN_CACHE.get(key)
            if cached is not None:
                _STATS["hits"] += 1
                _PLAN_CACHE.move_to_end(key)  # LRU touch
                return _attach_autotune(cached, key[0])
            pending = _BUILDING.get(key)
            if pending is None:
                # We own the build: others with the same key wait for it.
                _BUILDING[key] = pending = threading.Event()
                _STATS["misses"] += 1
                break
        pending.wait()  # owner finished (or failed) — re-check the cache
    try:
        built = builder(N, resolved, dev)
        with _LOCK:
            _PLAN_CACHE[key] = built
            _evict_lru_locked()
        return _attach_autotune(built, key[0])
    finally:
        with _LOCK:
            _BUILDING.pop(key, None)
        pending.set()


def _attach_autotune(p: FactorizationPlan, key: tuple) -> FactorizationPlan:
    """Copy the calibrated-auto decision (tuple + predicted wall) onto the
    plan so execute() can report the measured-vs-predicted residual.  Plans
    from explicit configs (calibration is None) never carry one."""
    if p.autotune is None and p.config.calibration is not None:
        from repro_torch.analysis import costmodel

        p.autotune = costmodel.get_decision(key)
    return p


def factor(A, config: SolverConfig | None = None, *, device=None,
           **overrides) -> Factorization:
    """One-shot convenience: plan (cached) + execute.

    A 2-D A factorizes one system; a 3-D [B, N, N] stack gets a batched
    plan (`plan((B, N))`) factorizing all B systems in one run.  With no
    explicit config or dtype, the computation dtype follows A (float64 for
    nested lists of Python floats, as numpy reads them).
    """
    A = as_tensor(A)
    if config is None and "dtype" not in overrides and A.is_floating_point():
        overrides["dtype"] = dtype_name(A.dtype)
    if A.ndim == 3:
        return plan((A.shape[0], A.shape[1]), config, device=device, **overrides).execute(A)
    return plan(A.shape[0], config, device=device, **overrides).execute(A)


def _evict_lru_locked() -> None:
    """Drop least-recently-used plans until within capacity (lock held)."""
    if _CAPACITY <= 0:  # 0 = unbounded
        return
    while len(_PLAN_CACHE) > _CAPACITY:
        _PLAN_CACHE.popitem(last=False)
        _STATS["evictions"] += 1


def set_plan_cache_capacity(capacity: int) -> int:
    """Set the LRU bound (number of cached plans; 0 = unbounded).

    Shrinks the cache immediately if it already exceeds the new bound.
    Returns the previous capacity so callers can restore it.
    """
    global _CAPACITY
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0 (0 = unbounded), got {capacity}")
    with _LOCK:
        prev, _CAPACITY = _CAPACITY, capacity
        _evict_lru_locked()
    return prev


def plan_cache_stats() -> dict:
    with _LOCK:
        return {**_STATS, "size": len(_PLAN_CACHE), "capacity": _CAPACITY}


def clear_plan_cache() -> None:
    with _LOCK:
        _PLAN_CACHE.clear()
        _STATS.update(hits=0, misses=0, evictions=0)
