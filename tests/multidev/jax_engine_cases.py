"""The JAX package's serving engines on the distributed strategies, for the port's tests.

    python tests/multidev/jax_engine_cases.py p1 OUT.npz
    python tests/multidev/jax_engine_cases.py grid8 OUT.npz

Runs `drive` (one scenario of `SolveEngine` and `AsyncSolveEngine` calls)
on the JAX package's engines for every case of the chosen set: `p1` the
1x1x1 grids of "conflux", "baseline2d" and "cholesky25d" (N = 64), `grid8`
their 2x2x2 / 2x4x1 grids on 8 forced host devices (N = 128).  Writes each
case's answers, pivot order and engine stats to OUT.npz (`flatten`).

The port's tests run the same `drive` on the port's engines: in-process
for `p1` (tests/test_torch_serving.py) and on eight gloo CPU ranks for
`grid8` (tests/multidev/torch_grid_cases.py, compared in
tests/test_torch_distributed.py).  Both make their inputs with `inputs`
from numpy seeds.  Importing this module loads numpy only.

`repro.serving` imports `jax.experimental.enable_x64`, which jax 0.9.0
calls `jax.enable_x64`; `main` sets that name before the import.  It runs
in a process of its own so that the shim never reaches the test process.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

# set -> (N, v, {name: (strategy, (Px, Py, c))})
CASES = {
    "p1": (64, 8, {"conflux": ("conflux", (1, 1, 1)),
                   "baseline2d": ("baseline2d", (1, 1, 1)),
                   "cholesky25d": ("cholesky25d", (1, 1, 1))}),
    "grid8": (128, 16, {"conflux": ("conflux", (2, 2, 2)),
                        "baseline2d": ("baseline2d", (2, 4, 1)),
                        "cholesky25d": ("cholesky25d", (2, 2, 2))}),
}
SYSTEM_SIZES = (5, 24, 40)  # ragged whole systems: three N slots
N_RHS = 4
# The engine stats both packages report and `drive` keeps.
STATS = ("strategy", "grid", "factorizations", "solves", "batched_solves", "batched_rhs",
         "batched_factorizations", "batched_systems", "batch_pad_systems", "batch_pad_waste",
         "pending", "pending_systems", "refined_systems")
ASYNC_STATS = ("flushes", "served", "failed", "shed", "spilled", "pending")


def _system(n: int, spd: bool, rng) -> np.ndarray:
    G = rng.standard_normal((n, n))
    return (G @ G.T / n + np.eye(n) if spd else G).astype(np.float32)


def inputs(N: int, strategy: str) -> dict:
    """The scenario's f32 inputs: A [N, N] (standard normal, or G G^T / N + I
    for a Cholesky engine), b [N], N_RHS right-hand sides [N_RHS, N] and
    ragged whole systems of SYSTEM_SIZES (SPD on a Cholesky engine)."""
    spd = strategy == "cholesky25d"
    rng = np.random.default_rng([N, len(strategy)])
    return {"A": _system(N, spd, rng),
            "b": rng.standard_normal(N).astype(np.float32),
            "rhs": rng.standard_normal((N_RHS, N)).astype(np.float32),
            "systems": [(_system(n, spd, rng), rng.standard_normal(n).astype(np.float32))
                        for n in SYSTEM_SIZES]}


def drive(SolveEngine, AsyncSolveEngine, N: int, config, inp: dict, **engine_kw) -> dict:
    """One scenario on a package's engines; numpy results.

    `solve(A, b)`, `resolve(2 b)`, N_RHS RHS through `submit` / `flush`, the
    ragged systems through `submit_system` / `flush_systems`; then an
    `AsyncSolveEngine` (no executor thread, drained with `pump(force=True)`):
    `engine.factor(A)`, N_RHS `submit_rhs` futures and the systems again.
    The factorizations are collectives on a distributed engine, made in the
    same order on every rank; the rest is rank-local."""
    eng = SolveEngine(N, config, **engine_kw)
    x = eng.solve(inp["A"], inp["b"])
    x2 = eng.resolve(2 * inp["b"])
    tickets = [eng.submit(r) for r in inp["rhs"]]
    flushed = eng.flush()
    sys_tickets = [eng.submit_system(A, b) for A, b in inp["systems"]]
    systems = eng.flush_systems()
    st = eng.stats()
    a = AsyncSolveEngine(N, config, start=False, max_batch=16, **engine_kw)
    a.engine.factor(inp["A"])
    rhs_futs = [a.submit_rhs(r) for r in inp["rhs"]]
    sys_futs = [a.submit(A, b) for A, b in inp["systems"]]
    while a.pump(force=True):
        pass
    ast = a.stats()
    a.close()
    return {
        "x": np.asarray(x), "x2": np.asarray(x2),
        "flush": np.stack([np.asarray(flushed[t]) for t in tickets]),
        "rows": np.asarray(eng._last.rows),
        "systems": [np.asarray(systems[t]) for t in sys_tickets],
        "async_rhs": np.stack([np.asarray(f.result(timeout=0)) for f in rhs_futs]),
        "async_systems": [np.asarray(f.result(timeout=0)) for f in sys_futs],
        "async_rows": np.asarray(a.engine._last.rows),
        "stats": {k: st[k] for k in STATS},
        "async_stats": {k: ast["async"][k] for k in ASYNC_STATS},
    }


def flatten(name: str, result: dict) -> dict:
    """npz entries of one case: arrays as they are, lists by index, the
    stats as JSON text."""
    out = {}
    for key, val in result.items():
        if isinstance(val, list):
            for i, arr in enumerate(val):
                out[f"{name}_{key}_{i}"] = arr
        elif isinstance(val, dict):
            out[f"{name}_{key}"] = np.asarray(json.dumps(val, sort_keys=True))
        else:
            out[f"{name}_{key}"] = val
    return out


def unflatten(npz, name: str) -> dict:
    """The inverse of `flatten` for one case of a loaded npz."""
    out = {}
    for key in ("x", "x2", "flush", "rows", "async_rhs", "async_rows"):
        out[key] = npz[f"{name}_{key}"]
    for key in ("systems", "async_systems"):
        out[key] = [npz[f"{name}_{key}_{i}"] for i in range(len(SYSTEM_SIZES))]
    for key in ("stats", "async_stats"):
        out[key] = json.loads(str(npz[f"{name}_{key}"]))
    return out


def main(which: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64  # jax 0.9.0's name for it
    import warnings

    from repro.api import GridConfig, SolverConfig
    from repro.serving import AsyncSolveEngine, SolveEngine

    N, v, cases = CASES[which]
    res = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, (strategy, shape) in cases.items():
            cfg = SolverConfig(strategy=strategy, grid=GridConfig(*shape, v, N))
            res.update(flatten(name, drive(SolveEngine, AsyncSolveEngine, N, cfg,
                                           inputs(N, strategy))))
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
