"""The JAX package's cost model, calibrated `auto`, hot-loop profile and
refined solves from Python lists, for the port's tests.

    python tests/multidev/jax_costmodel_cases.py TABLES.json OUT.json

TABLES.json maps a name to a calibration table file.  For each case below
the script writes what the JAX package gives to OUT.json:

- `auto`: `costmodel.autotune_choice` on one device and `plan.resolve` of
  `SolverConfig()` under the table "auto" (strategy, v, backend, hotloop,
  predicted wall, calibration version) at each N of `AUTO_NS`;
- `predict`: `costmodel.predict_wall` of each `GRID_CASES` case on each
  table (its collective term needs `repro.api.config`);
- `profile`: the key set and `shapes` of `api.hotloop.profile_primitives`
  for each `PROFILE_CASES` case (repeats=1);
- `refined`: `plan(N, SolverConfig(dtype="float64", ...)).execute(A.tolist())
  .solve(b.tolist(), refine_tol=1e-12)` for each `REFINED_CASES` case.

`tests/test_torch_costmodel.py`, `tests/test_torch_hotloop.py` and
`tests/test_torch_api.py` run it and compute the same with the port.
`repro.api` imports `jax.experimental.enable_x64`, which jax 0.9.0 calls
`jax.enable_x64`; this process sets that name before the import, in a
process of its own so that the shim never reaches the test process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

AUTO_NS = (64, 256, 1024, 16384)

# (kind, N, (Px, Py, c, v), hotloop, pivot, dtype, compute dtype)
GRID_CASES = (
    ("lu", 256, (2, 2, 1, 16), "windowed", "tournament", "float32", None),
    ("lu", 256, (2, 2, 2, 16), "flat", "partial", "float32", None),
    ("lu", 512, (4, 2, 1, 32), "windowed", "tournament", "float32", "bfloat16"),
    ("lu", 512, (2, 4, 1, 8), "flat", "tournament", "float64", None),
    ("cholesky", 256, (2, 2, 2, 16), "windowed", "none", "float32", None),
    ("cholesky", 256, (2, 4, 1, 8), "flat", "none", "float64", "float32"),
    ("lu", 128, (1, 1, 1, 16), "windowed", "tournament", "float32", None),
)

# (strategy, N, v, (Px, Py, c) or None)
PROFILE_CASES = (
    ("sequential", 64, 16, None),
    ("sequential_chol", 64, 16, None),
    ("conflux", 64, 8, (1, 1, 1)),
    ("cholesky25d", 64, 8, (1, 1, 1)),
    ("conflux", 64, 8, (2, 2, 1)),
    ("cholesky25d", 128, 16, (2, 1, 2)),
)

# name -> (N, compute dtype under a float64 working dtype)
REFINED_CASES = {"f64": (64, None), "f64_over_f32": (64, "float32")}


def refined_inputs(name: str):
    """(A, b) of a refined case in float64: A with singular values
    logspace(0, -0.5) (condition number 3.2), so a solve refined to a
    relative residual under 1e-12 is within about 3e-12 of the answer, and
    in practice well under 1e-12."""
    N, _ = REFINED_CASES[name]
    rng = np.random.default_rng(sorted(REFINED_CASES).index(name) + 26)
    u, _ = np.linalg.qr(rng.standard_normal((N, N)))
    w, _ = np.linalg.qr(rng.standard_normal((N, N)))
    A = (u * np.logspace(0.0, -0.5, N)) @ w.T
    return A, rng.standard_normal(N)


def write_tables(out_dir) -> dict:
    """The tables of the cases, as files in `out_dir`: "auto" is the JAX
    package's committed CPU table reduced to its "ref" combos and to the
    primitives both packages price alike (no `gather` / `gather_dense`
    fits), with its collective term; "nocoll" is the same without it.
    Returns {name: path}."""
    src = Path(__file__).resolve().parents[2] / "src" / "repro" / "analysis"
    table = json.loads((src / "calibration_default.json").read_text())
    table["tables"] = [t for t in table["tables"] if t["backend"] == "ref"]
    for t in table["tables"]:
        for prim in ("gather", "gather_dense"):
            t["fits"].pop(prim, None)
    paths = {}
    for name, coll in (("auto", table["collective"]), ("nocoll", None)):
        paths[name] = str(Path(out_dir) / f"{name}.json")
        Path(paths[name]).write_text(json.dumps({**table, "collective": coll}))
    return paths


def run(out_dir, timeout: float = 300) -> tuple[dict, dict]:
    """Write the tables into `out_dir`, run this script on them in a process
    of its own, and return ({name: table path}, its results)."""
    paths = write_tables(out_dir)
    tables, out = Path(out_dir) / "tables.json", Path(out_dir) / "jax.json"
    tables.write_text(json.dumps(paths))
    root = Path(__file__).resolve().parents[2]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, str(tables), str(out)], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX side failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return paths, json.loads(out.read_text())


def _pick(d: dict) -> dict:
    return {k: d.get(k) for k in ("strategy", "v", "backend", "hotloop", "predicted_wall_us",
                                  "calibration_version")}


def main(tables_path: str, out: str) -> None:
    import jax

    jax.experimental.enable_x64 = jax.enable_x64  # jax 0.9.0's name for it

    from repro.analysis import costmodel
    from repro.api import GridConfig, SolverConfig, plan
    from repro.api.hotloop import profile_primitives
    from repro.api.plan import resolve

    with open(tables_path) as fh:
        tables = {k: costmodel.load_calibration(p) for k, p in json.load(fh).items()}
    res: dict = {"auto": {}, "resolve": {}, "predict": {}, "profile": {}, "refined": {}}

    auto = tables["auto"]
    for N in AUTO_NS:
        choice = costmodel.autotune_choice(N, SolverConfig(), n_dev=1, calibration=auto)
        res["auto"][str(N)] = _pick(choice) if choice else None
    costmodel.set_calibration(auto)
    for N in AUTO_NS:
        r = resolve(N, SolverConfig())
        d = costmodel.get_decision(r.cache_key(N)) or {}
        res["resolve"][str(N)] = {"strategy": r.strategy, "v": r.v, "backend": r.backend,
                                  "hotloop": r.hotloop, "calibration": r.calibration,
                                  "predicted_wall_us": d.get("predicted_wall_us")}
    costmodel.reset_calibration()

    for i, (kind, N, (Px, Py, c, v), hotloop, pivot, dtype, compute) in enumerate(GRID_CASES):
        grid = GridConfig(Px=Px, Py=Py, c=c, v=v, N=N)
        cfg = SolverConfig(dtype=dtype, compute_dtype=compute)
        for name, calib in tables.items():
            pred = costmodel.predict_wall(N, cfg, grid=grid, hotloop=hotloop, kind=kind,
                                          pivot=pivot, backend="ref", calibration=calib)
            res["predict"][f"{i}/{name}"] = pred and {"wall_us": pred["wall_us"],
                                                      "terms": pred["terms"]}

    for i, (strategy, N, v, axes) in enumerate(PROFILE_CASES):
        grid = None if axes is None else GridConfig(*axes, v=v, N=N)
        pivot = "none" if strategy in ("sequential_chol", "cholesky25d") else "tournament"
        cfg = SolverConfig(strategy=strategy, pivot=pivot, v=v, backend="ref", grid=grid)
        t = profile_primitives(N, cfg, grid=grid, repeats=1)
        res["profile"][str(i)] = {"keys": sorted(t), "shapes": t["shapes"]}

    for name, (N, compute) in REFINED_CASES.items():
        A, b = refined_inputs(name)
        cfg = SolverConfig(dtype="float64", compute_dtype=compute, backend="ref", v=16)
        rs = plan(N, cfg).execute(A.tolist()).solve(b.tolist(), refine_tol=1e-12)
        x = np.asarray(rs.x)
        res["refined"][name] = {"x": x.tolist(), "x_dtype": x.dtype.name,
                                "iters": int(rs.refinement_iters),
                                "final_residual": float(rs.final_residual),
                                "converged": bool(rs.converged)}
    with open(out, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
