"""Fit the cost model's calibration table on the device the plans run on.

    python -m repro_torch.analysis.calibrate [--smoke] [--out PATH]

Two stages, from measured timings:

1. **Primitive sweep**: `profile_primitives` (interleaved best-of-k with
   per-primitive spread) over a grid of (N, v) shapes for each (backend,
   compute dtype) combo, fitted into per-primitive `t = alpha + beta * work`
   constants by `costmodel.fit_calibration`.
2. **Loop-overhead correction**: standalone timings carry a per-call
   overhead that a step of the hot loop need not pay in full (launches
   queue behind the running kernels), so the fitted alphas misprice
   many-step plans.  A few full `plan(N).execute(A)` probes at different v
   on the "cuda" backend regress one alpha scale `s >= 0` (measured wall =
   beta terms + s * alpha terms) applied to every table.

3. **Guard**: before it writes, the tool times the table's pick at each
   guarded cell (`GUARD`: the card's main path, N = 16384 in f32 and bf16)
   against the analytic pick (sequential, v = 32, "cuda") and refuses to
   write a table whose pick there is slower by more than AUTOTUNE_TOLERANCE
   (the JAX package's `benchmarks.run --validate` bound).  The probes'
   walls also give the pick's wall against v = 32's at each probe size
   (`meta["probe_picks"]`); that is recorded, not enforced: one affine fit
   per primitive in flop units places the best v near sqrt(alpha / (beta N)),
   so no alpha scale keeps v = 32 at both N = 4096 and 16384 (fault F7).

The collective term (the JAX package's third stage) needs more than one
card and is not fitted: the table ships with `"collective": null`, and
distributed candidates score without a collective term.

The table is keyed by the device kind (`costmodel.device_kind`: the card's
name).  It is written to `--out`, by default `./calibration_torch.json`,
which `costmodel.load_calibration` reads before the committed default;
`--out src/repro_torch/analysis/calibration_default.json` refits the
committed table.  `meta` records the sweep, the probes, the alpha scale and
the card as `nvidia-smi --query-gpu=name,power.limit` reports it, the guard's
rows and the probe sizes' picks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The (backend, compute dtype) combos of the committed table: every dtype
# on the kernels, the 4-byte and one 2-byte dtype on the plain versions, so
# `auto` ranks both backends.
COMBOS = (("cuda", "float32"), ("cuda", "float64"), ("cuda", "bfloat16"),
          ("cuda", "float16"), ("ref", "float32"), ("ref", "bfloat16"))
SMOKE_COMBOS = (("cuda", "float32"),)

# Every v of `costmodel._sequential_v_candidates` at each N, so the fits see
# every body a candidate runs.
SWEEP = tuple((N, v) for N in (1024, 4096, 16384) for v in (8, 16, 32, 64))
SMOKE_SWEEP = ((1024, 8), (1024, 32), (2048, 16), (2048, 32))

# Full executes that fit the alpha scale, on ("cuda", "float32"): every
# candidate v at the sizes where a step's wall is its overhead, not its work.
# At N = 16384 the wall is the work, whose error in the beta fits (one affine
# fit per primitive across bodies) the regression would read as overhead.
PROBES = tuple((N, v) for N in (1024, 4096) for v in (8, 16, 32, 64))
SMOKE_PROBES = ((1024, 8), (1024, 32))

# The guard: at each (N, compute dtype) cell the table's pick may be slower
# than the analytic pick (sequential, v = ANALYTIC_V, "cuda") by at most
# AUTOTUNE_TOLERANCE, the JAX package's (benchmarks/autotune.py).  The smoke
# table checks the tool and is not one to use, so it has no guard.
AUTOTUNE_TOLERANCE = 0.25
ANALYTIC_V = 32
GUARD = ((16384, "float32"), (16384, "bfloat16"))
SMOKE_GUARD = ()


class CalibrationRefused(RuntimeError):
    """The fitted table failed its guard and was not written."""


def _config_kw(dtype: str) -> dict:
    """SolverConfig fields that compute in `dtype`: a 2-byte dtype is a
    compute dtype under an f32 working dtype."""
    if dtype in ("bfloat16", "float16"):
        return dict(dtype="float32", compute_dtype=dtype)
    return dict(dtype=dtype)


def collect_samples(combos, shapes, repeats: int = 5, device=None) -> dict:
    """Primitive samples per (backend, compute dtype) across the shapes."""
    from repro_torch.analysis.costmodel import profile_sample_points
    from repro_torch.api.config import SolverConfig
    from repro_torch.api.hotloop import profile_primitives

    samples: dict = {}
    for backend, dtype in combos:
        per_prim: dict = {}
        for N, v in shapes:
            cfg = SolverConfig(strategy="sequential", backend=backend, v=v, **_config_kw(dtype))
            t = profile_primitives(N, cfg, grid=None, repeats=repeats, device=device)
            for prim, pt in profile_sample_points(t, "lu").items():
                per_prim.setdefault(prim, []).append(pt)
        samples[(backend, dtype)] = per_prim
    return samples


def _measure_execute(p, A, rounds: int = 3) -> float:
    """Best-of-`rounds` wall (us) of a warmed plan's execute, each ending in
    `torch.cuda.synchronize()` on the card."""
    sync = (lambda: torch.cuda.synchronize(p.device)) if p.device.type == "cuda" else (
        lambda: None)
    p.execute(A)
    sync()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        p.execute(A)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _beta_only(calib):
    """`calib` with every alpha set to 0."""
    from repro_torch.analysis.costmodel import Calibration, PrimitiveFit

    return Calibration(
        version=calib.version + "-beta-only", device_kind=calib.device_kind,
        tables={k: {p: PrimitiveFit(0.0, f.beta_us, f.n_samples, f.spread)
                    for p, f in fits.items()}
                for k, fits in calib.tables.items()},
        collective=None)


def fit_alpha_scale(calib, probes, device=None, backend: str = "cuda",
                    record: list | None = None) -> float:
    """Regress the global in-loop alpha scale from full-run probes.

    `predict_wall` with the standalone alphas splits into a beta part and an
    alpha part per probe; least squares of s >= 0 on
    `wall_i = beta_i + s * alpha_i` reprices the per-step overhead at what
    the hot loop pays.  `record`, when given, receives [N, v, wall_us,
    beta_us, alpha_us] per probe.
    """
    from repro_torch.analysis.costmodel import predict_wall
    from repro_torch.api.config import SolverConfig
    from repro_torch.api.plan import plan

    zero_alpha = _beta_only(calib)
    rng = np.random.default_rng(3)
    num = den = 0.0
    for N, v in probes:
        cfg = SolverConfig(strategy="sequential", backend=backend, v=v)
        full = predict_wall(N, cfg, v=v, calibration=calib, device=device)
        beta_only = predict_wall(N, cfg, v=v, calibration=zero_alpha, device=device)
        if full is None or beta_only is None:
            continue
        alpha_part = full["wall_us"] - beta_only["wall_us"]
        if alpha_part <= 0:
            continue
        A = rng.standard_normal((N, N)).astype(np.float32)
        wall = _measure_execute(plan(N, cfg, device=device), A)
        if record is not None:
            record.append([N, v, wall, beta_only["wall_us"], alpha_part])
        num += max(wall - beta_only["wall_us"], 0.0) * alpha_part
        den += alpha_part * alpha_part
    return num / den if den > 0 else 1.0


def _scale_alphas(calib, scale: float):
    from repro_torch.analysis.costmodel import Calibration, PrimitiveFit, content_version

    tables = {k: {p: PrimitiveFit(f.alpha_us * scale, f.beta_us, f.n_samples, f.spread)
                  for p, f in fits.items()}
              for k, fits in calib.tables.items()}
    tag = calib.version.rsplit("-", 1)[0]
    return Calibration(
        version=content_version(tables, calib.collective, tag=tag),
        device_kind=calib.device_kind, tables=tables,
        collective=calib.collective,
        meta={**calib.meta, "alpha_scale": scale})


def auto_against_widths(n: int, dtype: str = "float32", widths=(ANALYTIC_V,),
                        rounds: int = 3, device=None, seed: int = 26) -> dict:
    """The execute wall of the active table's pick for `plan(n)` computing in
    `dtype` against sequential "cuda" plans at each v of `widths` (which
    holds ANALYTIC_V), on one matrix drawn on the device: one warm execute
    each, then `rounds` in turns, reversed every other round so drift lands
    on all, each timed on the host clock ending in `torch.cuda.synchronize()`
    on the card.  Returns the pick, every wall, the pick's predicted and
    measured walls and residual (from the `Factorization`), and
    `auto_over_analytic`, the best wall of the pick over that of v =
    ANALYTIC_V."""
    from repro_torch.api.config import SolverConfig, resolve_dtype
    from repro_torch.api.plan import plan
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    kw = _config_kw(dtype)
    plans = {"auto": plan(n, SolverConfig(**kw), device=dev)}
    for v in widths:
        plans[f"v={v}"] = plan(n, SolverConfig(strategy="sequential", v=v, backend="cuda", **kw),
                               device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(n, n, generator=gen, device=dev, dtype=resolve_dtype(kw["dtype"]))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for p in plans.values():
        p.execute(A)
    walls = {k: [] for k in plans}
    fact = None
    for r in range(rounds):
        for k in (list(plans) if r % 2 == 0 else list(plans)[::-1]):
            sync()
            t0 = time.perf_counter()
            f = plans[k].execute(A)
            sync()
            walls[k].append(time.perf_counter() - t0)
            fact = f if k == "auto" else fact
            del f
    cfg = plans["auto"].config
    stamp = (fact.autotune or {}) if fact is not None else {}
    return {"N": n, "dtype": cfg.dtype, "compute_dtype": cfg.effective_compute_dtype,
            "pick": {"strategy": cfg.strategy, "v": cfg.v, "backend": cfg.backend,
                     "hotloop": cfg.hotloop},
            "calibration": cfg.calibration,
            "best_s": {k: min(w) for k, w in walls.items()}, "walls_s": walls,
            "predicted_wall_us": stamp.get("predicted_wall_us"),
            "measured_wall_us": stamp.get("measured_wall_us"),
            "wall_residual": stamp.get("wall_residual"),
            "auto_over_analytic": min(walls["auto"]) / min(walls[f"v={ANALYTIC_V}"])}


def pick_alpha_range(calib, n: int, dtype: str = "float32", device=None) -> dict:
    """The alpha scales under which `calib` keeps its in-core pick at (n,
    dtype) on the "cuda" backend: rescaled from the table's own
    (`meta["alpha_scale"]`) to s, the pick stays the argmin of beta part +
    s * alpha part for s in [lo, hi] (hi None: no upper edge).  Reads the
    table only."""
    from repro_torch.analysis.costmodel import _sequential_v_candidates, predict_wall
    from repro_torch.api.config import SolverConfig

    scale = calib.meta.get("alpha_scale", 1.0) or 1.0
    cfg = SolverConfig(strategy="sequential", backend="cuda", **_config_kw(dtype))
    zero_alpha = _beta_only(calib)
    parts = {}
    for v in _sequential_v_candidates(n, None):
        full = predict_wall(n, cfg, v=v, calibration=calib, device=device)
        beta = predict_wall(n, cfg, v=v, calibration=zero_alpha, device=device)
        if full is not None and beta is not None:
            parts[v] = (beta["wall_us"], (full["wall_us"] - beta["wall_us"]) / scale)
    if not parts:
        return {"v": None, "alpha_scale": scale, "lo": None, "hi": None}
    pick = min(parts, key=lambda v: parts[v][0] + scale * parts[v][1])
    bp, ap = parts[pick]
    lo, hi = 0.0, None
    for b, a in parts.values():
        if a < ap:  # less overhead: wins once s > its edge
            hi = (b - bp) / (ap - a) if hi is None else min(hi, (b - bp) / (ap - a))
        elif a > ap:  # more overhead: wins below its edge
            lo = max(lo, (bp - b) / (a - ap))
    return {"v": pick, "alpha_scale": scale, "lo": lo, "hi": hi}


def check_guard(calib, cells, device=None, rounds: int = 3) -> list[dict]:
    """`auto_against_widths` at each guarded (N, dtype) cell that `calib`
    covers on "cuda", with `calib` active while it runs.  Each row gains
    `ok`: the ratio is within 1 + AUTOTUNE_TOLERANCE."""
    from repro_torch.analysis import costmodel

    rows = []
    prev = costmodel.set_calibration(calib)
    try:
        for n, dtype in cells:
            if calib.covers("cuda", dtype):
                row = auto_against_widths(n, dtype, rounds=rounds, device=device)
                row["ok"] = row["auto_over_analytic"] <= 1 + AUTOTUNE_TOLERANCE
                rows.append(row)
    finally:
        if prev is None:
            costmodel.reset_calibration()
        else:
            costmodel.set_calibration(prev)
    return rows


def _probe_picks(calib, probe_walls, device) -> list:
    """[N, pick v, wall(pick) / wall(ANALYTIC_V)] at each probe size whose
    probes timed both widths."""
    from repro_torch.analysis.costmodel import autotune_choice
    from repro_torch.api.config import SolverConfig

    walls = {(N, v): w for N, v, w, *_ in probe_walls}
    out = []
    for N in sorted({N for N, _ in walls}):
        choice = autotune_choice(N, SolverConfig(), n_dev=1, calibration=calib, device=device)
        v = choice and choice["v"]
        if (N, v) in walls and (N, ANALYTIC_V) in walls:
            out.append([N, v, walls[(N, v)] / walls[(N, ANALYTIC_V)]])
    return out


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def calibrate(smoke: bool = False, out_path: str = "calibration_torch.json", combos=None,
              shapes=None, probes=None, repeats: int = 5, device=None, guard=None):
    """Sweep -> fit -> alpha rescale -> guard -> save.  Returns the fitted
    Calibration; raises CalibrationRefused, writing nothing, when a guarded
    cell's pick is too slow."""
    from repro_torch.analysis.costmodel import device_kind, fit_calibration
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    combos = tuple(combos or (SMOKE_COMBOS if smoke else COMBOS))
    shapes = tuple(shapes or (SMOKE_SWEEP if smoke else SWEEP))
    probes = tuple(probes or (SMOKE_PROBES if smoke else PROBES))
    guard = tuple((SMOKE_GUARD if smoke else GUARD) if guard is None else guard)
    t0 = time.perf_counter()
    samples = collect_samples(combos, shapes, repeats=repeats, device=dev)
    meta = {"sweep": [list(s) for s in shapes], "combos": [list(c) for c in combos],
            "repeats": repeats, "alpha_probes": [list(p) for p in probes],
            "card": card_line() if dev.type == "cuda" else None,
            "torch": torch.__version__}
    calib = fit_calibration(samples, device_kind(dev), tag="smoke" if smoke else "full",
                            meta=meta)
    print(f"# calibrate: fitted {len(calib.tables)} (backend, dtype) tables in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    probe_walls: list = []
    scale = fit_alpha_scale(calib, probes, device=dev, record=probe_walls)
    calib.meta["alpha_probe_walls_us"] = probe_walls  # [N, v, wall, beta part, alpha part]
    calib = _scale_alphas(calib, scale)
    print(f"# calibrate: in-loop alpha scale {scale:.4f}", flush=True)
    calib.meta["probe_picks"] = _probe_picks(calib, probe_walls, dev)
    print(f"# calibrate: [N, pick v, wall / v = {ANALYTIC_V}'s] at the probe sizes "
          f"{calib.meta['probe_picks']}", flush=True)
    rows = check_guard(calib, guard, device=dev)
    calib.meta["guard"] = [{k: r[k] for k in ("N", "compute_dtype", "pick", "best_s",
                                              "auto_over_analytic", "ok")} for r in rows]
    for r in calib.meta["guard"]:
        print(f"# calibrate: guard {json.dumps(r)}", flush=True)
    if not all(r["ok"] for r in rows):
        raise CalibrationRefused(
            f"the table's pick is slower than v = {ANALYTIC_V} by more than "
            f"{AUTOTUNE_TOLERANCE:.0%} at a guarded cell; {out_path} not written")
    calib.save(out_path)
    print(f"# calibrate: wrote {out_path} (version {calib.version}, device kind "
          f"{calib.device_kind!r}, {time.perf_counter() - t0:.1f} s)", flush=True)
    return calib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a short sweep on ('cuda', 'float32') only")
    ap.add_argument("--out", default="calibration_torch.json")
    args = ap.parse_args(argv)
    try:
        calibrate(smoke=args.smoke, out_path=args.out)
    except CalibrationRefused as e:
        print(f"# calibrate: refused: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
