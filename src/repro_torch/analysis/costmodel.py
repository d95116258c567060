"""Trace-calibrated cost model: measured per-primitive constants drive
`strategy="auto"`.

The paper's analytic model (`optimize_grid` scoring `lu_comm_volume`) counts
communicated *elements*, but wall time on a real machine is set by hidden
per-primitive constants (panel vs TRSM vs Schur throughput, collective
latency) that element counts cannot rank.  This module closes the loop that
`FactorizationPlan.profile_hotloop` opens:

  1. **fit**: `fit_calibration` turns measured per-primitive wall times
     (`profile_primitives` at many shapes) into per-primitive affine costs
     `t_us = alpha + beta * work`, weighted by each sample's spread so noisy
     samples count less, plus an alpha-beta collective term (latency per op
     + cost per wire byte, against `audit.executed_comm_bytes`).
  2. **persist**: `Calibration` round-trips through a versioned JSON
     artifact (schema `repro.calibration.v1`, the JAX package's schema and
     content hash, so a table's version is the same string in both
     packages), keyed by (backend, compute dtype) under one device kind.
     The port's default table, fitted on the card, ships with the package
     (`calibration_default.json`; `python -m repro_torch.analysis.calibrate`
     refits it).
  3. **predict**: `predict_wall` composes the fitted constants over the
     schedule's per-bucket trip counts into a wall-time estimate for any
     candidate (strategy, grid, v, backend, hotloop) tuple.
  4. **choose**: `autotune_choice` enumerates the candidate tuples
     `strategy="auto"` may resolve to and returns the predicted-wall argmin;
     `repro_torch.api.strategies._resolve_auto` consumes it, falling back
     to the analytic comm-volume ranking whenever no calibration covers the
     combo (no table, an unknown backend or dtype, another device kind).

A table is keyed by the device kind of the plan it prices: "cpu", or the
CUDA card's name (`torch.cuda.get_device_name`).  A table fitted on one kind
never prices a plan on another, so a CPU plan on the card's host never uses
the card's table.

Two things differ from the JAX package's model, on purpose:

- The in-core (sequential) prediction charges each step two `gather` calls
  (work v*N each) where the JAX package charges two one-hot products
  (`gather_dense`, 2*v*N^2 flops each): the port's step gathers its pivot
  rows with `index_select` and writes U01 back with an indexed copy
  (`core/lu/sequential.py`), and never runs the one-hot product.
  `gather_dense` stays in the profile and the table, as measured.
- Backends are screened with `kernels.backend.check_hopper_constraints`
  (the "cuda" kernels' dtypes and panel widths) where the JAX package
  screens its Pallas kernels.

The chosen tuple and its predicted wall time are recorded on the resolved
plan (`FactorizationPlan.autotune`), and every execute stamps the measured
wall beside it, so `Factorization.comm_report()` shows the residual.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
from dataclasses import dataclass, field

import torch

CALIB_SCHEMA = "repro.calibration.v1"

# The fitted primitives.  Work units are per-primitive (flop counts for the
# compute primitives, moved elements for the gathers): consistency within a
# primitive is what matters, the fitted beta absorbs the unit.
PRIMITIVES = ("panel", "trsm", "schur", "fused", "gather", "gather_dense")

# The collective term's key in a calibration table.
COLLECTIVE = "collective"

_ENV_PATH = "REPRO_TORCH_CALIBRATION"
_CWD_TABLE = "calibration_torch.json"
_DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "calibration_default.json")


def _plan_device(device=None) -> torch.device:
    """`device`, or the port's default device when None: the current card
    when CUDA is available, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def device_kind(device=None) -> str:
    """The device kind a calibration table is keyed by: "cpu", or the CUDA
    card's name.  `device=None` is the port's default device (`_plan_device`)."""
    dev = _plan_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


# ---------------------------------------------------------------------------
# Fits and the calibration artifact.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrimitiveFit:
    """Affine cost `t_us = alpha_us + beta_us * work` for one primitive."""

    alpha_us: float
    beta_us: float
    n_samples: int = 0
    spread: float = 0.0  # mean relative spread of the fitted samples

    def predict(self, work: float) -> float:
        return self.alpha_us + self.beta_us * work

    def to_json(self) -> dict:
        return {"alpha_us": self.alpha_us, "beta_us": self.beta_us,
                "n_samples": self.n_samples, "spread": self.spread}

    @classmethod
    def from_json(cls, d: dict) -> "PrimitiveFit":
        return cls(alpha_us=float(d["alpha_us"]), beta_us=float(d["beta_us"]),
                   n_samples=int(d.get("n_samples", 0)),
                   spread=float(d.get("spread", 0.0)))


def fit_affine(samples: list[tuple[float, float, float]]) -> PrimitiveFit:
    """Weighted least squares of `t = alpha + beta * work`, clamped to the
    physical quadrant (alpha, beta >= 0).

    samples: (work, t_us, rel_spread) triples; a sample's weight is
    1/(1 + rel_spread), so a primitive timed during a load spike (large
    best-to-worst spread) drags the fit less than a quiet one.
    """
    pts = [(float(w), float(t), max(float(s), 0.0))
           for w, t, s in samples if w > 0 and t > 0]
    if not pts:
        raise ValueError("fit_affine needs at least one sample with "
                         "positive work and time")
    mean_spread = sum(s for _, _, s in pts) / len(pts)
    if len(pts) == 1:
        w, t, _ = pts[0]
        return PrimitiveFit(0.0, t / w, 1, mean_spread)
    sw = sx = sy = sxx = sxy = 0.0
    for w, t, s in pts:
        u = 1.0 / (1.0 + s)
        sw += u
        sx += u * w
        sy += u * t
        sxx += u * w * w
        sxy += u * w * t
    den = sw * sxx - sx * sx
    if den <= 0:  # all samples at one shape: no intercept information
        return PrimitiveFit(0.0, sy / sx, len(pts), mean_spread)
    beta = (sw * sxy - sx * sy) / den
    alpha = (sy - beta * sx) / sw
    if beta < 0:  # time shrinking with work is noise, not physics
        return PrimitiveFit(max(sy / sw, 0.0), 0.0, len(pts), mean_spread)
    if alpha < 0:
        return PrimitiveFit(0.0, sxy / sxx, len(pts), mean_spread)
    return PrimitiveFit(alpha, beta, len(pts), mean_spread)


@dataclass
class Calibration:
    """A fitted cost table: (backend, compute dtype) -> primitive fits.

    `version` identifies the fit (content hash + tag), `device_kind` the
    device it was measured on ("cpu" or a CUDA card's name; a table fitted
    on one kind never prices another).  `collective` holds the alpha-beta
    wire model (us per collective op, us per wire byte) shared across
    backends.
    """

    version: str
    device_kind: str
    tables: dict[tuple[str, str], dict[str, PrimitiveFit]]
    collective: PrimitiveFit | None = None
    meta: dict = field(default_factory=dict)

    def covers(self, backend: str, dtype: str) -> bool:
        return (backend, dtype) in self.tables

    def fits(self, backend: str, dtype: str) -> dict[str, PrimitiveFit] | None:
        return self.tables.get((backend, dtype))

    def to_json(self) -> dict:
        return {
            "schema": CALIB_SCHEMA,
            "version": self.version,
            "device_kind": self.device_kind,
            "collective": self.collective.to_json() if self.collective else None,
            "tables": [
                {"backend": b, "dtype": d,
                 "fits": {p: f.to_json() for p, f in fits.items()}}
                for (b, d), fits in sorted(self.tables.items())
            ],
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Calibration":
        if obj.get("schema") != CALIB_SCHEMA:
            raise ValueError(
                f"calibration schema {obj.get('schema')!r} is not "
                f"{CALIB_SCHEMA!r}; refit with `python -m "
                f"repro_torch.analysis.calibrate`")
        tables = {}
        for entry in obj.get("tables", []):
            fits = {p: PrimitiveFit.from_json(f)
                    for p, f in entry["fits"].items()}
            tables[(entry["backend"], entry["dtype"])] = fits
        coll = obj.get("collective")
        return cls(version=str(obj["version"]),
                   device_kind=str(obj["device_kind"]),
                   tables=tables,
                   collective=PrimitiveFit.from_json(coll) if coll else None,
                   meta=dict(obj.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)


def content_version(tables: dict, collective: PrimitiveFit | None,
                    tag: str = "fit") -> str:
    """Deterministic version string: tag + content hash of the constants."""
    canon = json.dumps(
        {f"{b}/{d}": {p: f.to_json() for p, f in sorted(fits.items())}
         for (b, d), fits in sorted(tables.items())}
        | {"collective": collective.to_json() if collective else None},
        sort_keys=True)
    return f"{tag}-{hashlib.sha256(canon.encode()).hexdigest()[:12]}"


def fit_calibration(samples: dict[tuple[str, str], dict[str, list]],
                    device_kind: str,
                    collective: PrimitiveFit | None = None,
                    tag: str = "fit", meta: dict | None = None) -> Calibration:
    """Fit a full calibration from per-(backend, dtype) primitive samples.

    samples: {(backend, dtype): {primitive: [(work, t_us, spread), ...]}}.
    """
    tables: dict[tuple[str, str], dict[str, PrimitiveFit]] = {}
    for key, prim_samples in samples.items():
        fits = {}
        for prim, pts in prim_samples.items():
            if pts:
                fits[prim] = fit_affine(pts)
        if fits:
            tables[key] = fits
    if not tables:
        raise ValueError("no samples to fit a calibration from")
    version = content_version(tables, collective, tag=tag)
    return Calibration(version=version, device_kind=device_kind,
                       tables=tables, collective=collective,
                       meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# Loading / the active calibration.
# ---------------------------------------------------------------------------

_UNSET = object()
_active = _UNSET
_active_lock = threading.Lock()


def load_calibration(path: str | None = None) -> Calibration | None:
    """Load a calibration artifact.

    Search order: explicit `path` -> $REPRO_TORCH_CALIBRATION ->
    ./calibration_torch.json -> the committed package default.  The JAX
    package's $REPRO_CALIBRATION and ./calibration.json are never read:
    their timings are the JAX package's.  Returns None when nothing loadable
    is found (`auto` then falls back to the analytic comm-volume ranking).
    """
    candidates = []
    if path is not None:
        candidates.append(path)
    else:
        env = os.environ.get(_ENV_PATH)
        if env:
            candidates.append(env)
        candidates.append(os.path.join(os.getcwd(), _CWD_TABLE))
        candidates.append(_DEFAULT_TABLE)
    for cand in candidates:
        if not os.path.exists(cand):
            continue
        try:
            with open(cand) as fh:
                return Calibration.from_json(json.load(fh))
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            continue  # unreadable/foreign artifact: try the next candidate
    return None


def active_calibration() -> Calibration | None:
    """The process-wide calibration `strategy="auto"` scores with (loaded
    once; see `set_calibration` / `reset_calibration`)."""
    global _active
    with _active_lock:
        if _active is _UNSET:
            _active = load_calibration()
        return _active  # type: ignore[return-value]


def set_calibration(calib: "Calibration | str | None") -> Calibration | None:
    """Override the active calibration (tests / operators).

    Accepts a `Calibration`, a path to load, or None to *disable* the
    calibrated path entirely (auto then always uses the analytic ranking).
    Returns the previous value.  Clears the autotune decision memo: a new
    table must re-rank.
    """
    global _active
    if isinstance(calib, str):
        loaded = load_calibration(calib)
        if loaded is None:
            raise FileNotFoundError(f"no loadable calibration at {calib!r}")
        calib = loaded
    with _active_lock:
        prev = None if _active is _UNSET else _active
        _active = calib
        _decisions.clear()
    return prev  # type: ignore[return-value]


def reset_calibration() -> None:
    """Forget the override and reload lazily from the default search path."""
    global _active
    with _active_lock:
        _active = _UNSET
        _decisions.clear()


# ---------------------------------------------------------------------------
# Work model: per-primitive work terms on the schedule's shapes.
# ---------------------------------------------------------------------------


def primitive_work(prim: str, kind: str, *, R: int, C: int, v: int,
                   wr: int, wc: int) -> float:
    """Work units for one primitive call at the given local shapes.

    Matches the shapes `repro_torch.api.hotloop.profile_primitives` times:
    R/C are the full local extents, wr/wc the current trailing-window
    extents.  LU keeps full row extent (masked pivot rows stay scattered,
    paper §7.3); Cholesky windows both axes.
    """
    lu = kind != "cholesky"
    if prim == "panel":
        return R * v * v if lu else v ** 3 / 3.0
    if prim == "trsm":
        # LU: L00^-1 @ R01 ([v, wc]); Cholesky: panel @ L00^-T ([wr, v]).
        return v * v * wc if lu else wr * v * v
    if prim == "schur":
        return 2.0 * wr * v * wc
    if prim == "fused":
        return (v * v * wc) + 2.0 * wr * v * wc
    if prim == "gather":
        return float(v * wc)  # moved elements (indexed take / slice)
    if prim == "gather_dense":
        return 2.0 * v * R * C  # one-hot [v, R] @ [R, C] product
    raise ValueError(f"unknown primitive {prim!r}")


def profile_sample_points(timings: dict, kind: str) -> dict[str, tuple]:
    """Convert one `profile_primitives` result into fitter samples.

    Returns {primitive: (work, t_us, rel_spread)} on the profiled shapes.
    """
    sh = timings["shapes"]
    out = {}
    for prim, key in (("panel", "panel_us"), ("trsm", "trsm_us"),
                      ("schur", "schur_us"), ("fused", "fused_us"),
                      ("gather", "gather_us"),
                      ("gather_dense", "gather_dense_us")):
        t = timings.get(key)
        if not isinstance(t, (int, float)) or t <= 0:
            continue
        work = primitive_work(prim, kind, R=sh["R"], C=sh["C"], v=sh["v"],
                              wr=sh["wr"], wc=sh["wc"])
        spread = float(timings.get(f"{key[:-3]}_spread", 0.0))
        out[prim] = (work, float(t), spread)
    return out


# ---------------------------------------------------------------------------
# Schedule composition: predict_wall.
# ---------------------------------------------------------------------------


def _bucket_trips(N: int, v: int, hotloop: str) -> list[tuple[int | None, int]]:
    """(window cap in tiles, trip count) per bucket of the hot loop.

    cap=None means the full-extent (flat) body.  The windowed loop's caps
    and counts are `audit._window_caps`, the bucket model of the executed
    comm model.
    """
    nsteps = N // v
    if hotloop != "windowed":
        return [(None, nsteps)]
    from repro_torch.analysis.audit import _window_caps

    trips: dict[int, int] = {}
    for cap in _window_caps(nsteps):
        trips[cap] = trips.get(cap, 0) + 1
    return sorted(trips.items())


def collective_op_count(kind: str, N: int, grid, pivot: str) -> float:
    """Collective *operations* issued by the 2.5D schedule (the alpha term's
    multiplier; byte volume is `audit.executed_comm_bytes`)."""
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    nsteps = N // v
    if kind == "cholesky":
        per = ((1 if c > 1 else 0) + (1 if Px * Py > 1 else 0)
               + (1 if Py > 1 else 0) + (1 if Px * c > 1 else 0))
        return float(nsteps * per)
    per = (1 if c > 1 else 0) + (1 if Px * c > 1 else 0)
    if Py > 1:
        per += 3  # gids + a00 + l10 broadcasts
    if Px > 1:
        # tournament: log2(Px) butterfly rounds x (values + ids); partial:
        # the |max|/owner/pivot-row reductions (vectorized over the panel).
        per += 2 * int(math.log2(Px)) if pivot == "tournament" else 3
    return float(nsteps * per)


def predict_wall(N: int, cfg=None, grid=None, v: int | None = None,
                 backend: str | None = None, hotloop: str | None = None,
                 *, kind: str = "lu", pivot: str | None = None,
                 calibration: Calibration | None = None,
                 device=None) -> dict | None:
    """Predict the full-run wall time (us) of one candidate tuple.

    `cfg` (a SolverConfig) supplies defaults for grid/v/backend/hotloop/
    pivot and the compute dtype; explicit arguments override it, so the
    autotuner can sweep tuples against one base config.  Composes the
    fitted per-primitive constants over the windowed schedule's per-bucket
    trip counts plus the collective alpha-beta term over
    `audit.executed_comm_bytes`.  `device` is the device the plan runs on
    (None: the port's default device, see `device_kind`).

    Returns {"wall_us", "terms", "version"}, or None when the active (or
    given) calibration does not cover the (backend, dtype) combo on this
    device kind: the caller's cue to fall back to the analytic comm-volume
    ranking.
    """
    calib = calibration if calibration is not None else active_calibration()
    if calib is None:
        return None
    grid = grid if grid is not None else getattr(cfg, "grid", None)
    backend = backend or getattr(cfg, "backend", "ref")
    hotloop = hotloop or getattr(cfg, "hotloop", "windowed")
    pivot = pivot or getattr(cfg, "pivot", "tournament")
    dtype = getattr(cfg, "effective_compute_dtype", None) or "float32"
    if v is None:
        v = grid.v if grid is not None else getattr(cfg, "v", None)
    if not v:
        return None
    fits = calib.fits(backend, dtype)
    if fits is None:
        return None
    if calib.device_kind != device_kind(device):
        return None  # a table fitted on one device kind never prices another

    terms = {p: 0.0 for p in ("panel", "fused", "gather", "gather_dense")}

    def cost(prim: str, work: float) -> float:
        f = fits.get(prim)
        return f.predict(work) if f else 0.0

    if grid is None:
        # In-core masked loop: full-extent [N, N] step bodies (rows stay
        # scattered), one panel + one fused + two indexed gathers per step
        # (the pivot rows' `index_select` and U01's indexed copy), the calls
        # `lu_masked_sequential` makes.
        nsteps = N // v
        shapes = dict(R=N, C=N, v=v, wr=N, wc=N)
        terms["panel"] = nsteps * cost(
            "panel", primitive_work("panel", kind, **shapes))
        terms["fused"] = nsteps * cost(
            "fused", primitive_work("fused", kind, **shapes))
        terms["gather"] = nsteps * 2 * cost(
            "gather", primitive_work("gather", kind, **shapes))
        wall = sum(terms.values())
        return {"wall_us": wall, "terms": terms, "version": calib.version}

    Px, Py = grid.Px, grid.Py
    nbi = N // grid.v
    R = (nbi // Px) * grid.v
    C = (nbi // Py) * grid.v
    for cap, trips in _bucket_trips(N, grid.v, hotloop):
        wc = C if cap is None else min(-(-cap // Py) * grid.v, C)
        wr = R if cap is None else min(-(-cap // Px) * grid.v, R)
        if kind != "cholesky":
            wr = R  # LU keeps full row extent (§7.3)
        shapes = dict(R=R, C=C, v=grid.v, wr=wr, wc=wc)
        terms["panel"] += trips * cost(
            "panel", primitive_work("panel", kind, **shapes))
        terms["fused"] += trips * cost(
            "fused", primitive_work("fused", kind, **shapes))
        terms["gather"] += trips * cost(
            "gather", primitive_work("gather", kind, **shapes))
    coll = calib.collective
    if coll is not None and grid.P_used > 1:
        from repro_torch.analysis.audit import executed_comm_bytes
        from repro_torch.api.config import resolve_dtype

        itemsize = resolve_dtype(dtype).itemsize
        wire = executed_comm_bytes(kind, N, grid, pivot, hotloop, itemsize)
        n_ops = collective_op_count(kind, N, grid, pivot)
        terms["collective"] = (n_ops * coll.alpha_us
                               + wire["total"] * coll.beta_us)
    wall = sum(terms.values())
    return {"wall_us": wall, "terms": terms, "version": calib.version}


# ---------------------------------------------------------------------------
# The autotuner: enumerate candidate tuples, pick the predicted argmin.
# ---------------------------------------------------------------------------

# Resolved-config cache key -> the decision that produced it; plan() copies
# the entry onto FactorizationPlan.autotune so execute() can report the
# measured-vs-predicted residual.  Cleared when the calibration changes.
_decisions: dict[tuple, dict] = {}


def record_decision(key: tuple, decision: dict) -> None:
    _decisions[key] = decision


def get_decision(key: tuple) -> dict | None:
    return _decisions.get(key)


def _sequential_v_candidates(N: int, v: int | None) -> list[int]:
    if v is not None:
        return [v]
    from repro_torch.api.strategies import default_panel_width

    cands = {w for w in (8, 16, 32, 64) if w <= N and N % w == 0}
    cands.add(default_panel_width(N))
    return sorted(cands)


def _backend_candidates(cfg, v: int, dtype: str, device=None) -> list[str]:
    """Backends a candidate may use, among those whose constraints admit
    (dtype, v).  On a CPU plan, every registered backend, as in the JAX
    package: each runs the plain versions there.  On a CUDA plan, only
    `cfg.backend`: auto never trades the card's kernels for the plain
    versions, and a width the kernels refuse leaves no candidate, so the
    resolve falls back to the analytic pick and raises on that width.  The
    calibration coverage filter happens at scoring time (an uncovered
    backend just contributes no candidate)."""
    from repro_torch.kernels.backend import available_backends, check_hopper_constraints

    on_card = _plan_device(device).type == "cuda"
    out = []
    for b in ([cfg.backend] if on_card else available_backends()):
        if b == "cuda":
            try:
                check_hopper_constraints(dtype, v)
            except ValueError:
                continue
        out.append(b)
    return out


def autotune_choice(N: int, config, n_dev: int | None = None,
                    calibration: Calibration | None = None,
                    device=None) -> dict | None:
    """Score every candidate (strategy, grid, v, backend, hotloop) tuple
    with `predict_wall` and return the argmin, or None when the calibration
    covers no candidate (analytic fallback).

    Multi-rank: candidates are the feasible 2.5D grids (the same layout-
    constraint enumeration `optimize_grid` searches) x hotloop x backend;
    auto keeps its contract of using the ranks when they exist, but ranks
    the grids by predicted *wall time* instead of communicated elements.
    One rank: the in-core sequential tuples (v x backend).  `n_dev=None` is
    the default process group's world size; `device` is the device the plan
    runs on (see `predict_wall`).
    """
    calib = calibration if calibration is not None else active_calibration()
    if calib is None:
        return None
    if n_dev is None:
        from repro_torch.core.collectives import world_size

        n_dev = world_size()
    dtype = config.effective_compute_dtype
    candidates: list[dict] = []
    if n_dev > 1:
        from repro_torch.core.lu.grid import enumerate_grids

        P = config.P_target or n_dev
        for g in enumerate_grids(N, P, config.M, v=config.v):
            for backend in _backend_candidates(config, g.v, dtype, device):
                for hotloop in ("windowed", "flat"):
                    candidates.append({
                        "strategy": "conflux", "grid": g, "v": g.v,
                        "backend": backend, "hotloop": hotloop,
                    })
    if not candidates:  # one rank, or no feasible grid: in-core tuples
        for v in _sequential_v_candidates(N, config.v):
            for backend in _backend_candidates(config, v, dtype, device):
                candidates.append({
                    "strategy": "sequential", "grid": None, "v": v,
                    "backend": backend, "hotloop": config.hotloop,
                })
    best = None
    scored = 0
    for cand in candidates:
        pred = predict_wall(
            N, config, grid=cand["grid"], v=cand["v"],
            backend=cand["backend"], hotloop=cand["hotloop"],
            pivot=config.pivot, calibration=calib, device=device)
        if pred is None:
            continue
        scored += 1
        if best is None or pred["wall_us"] < best["predicted_wall_us"]:
            best = {**cand, "predicted_wall_us": pred["wall_us"],
                    "terms": pred["terms"]}
    if best is None:
        return None
    best["source"] = "calibrated"
    best["calibration_version"] = calib.version
    best["n_candidates"] = len(candidates)
    best["n_scored"] = scored
    return best
