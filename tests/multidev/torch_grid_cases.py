"""The distributed schedules on eight processes, JAX package against the port.

    python tests/multidev/torch_grid_cases.py jax OUT.npz
    python tests/multidev/torch_grid_cases.py torch OUT_DIR

`jax` runs the JAX package's local programs (`_local_lu`, `_local_chol`)
under `jax.shard_map` on 8 forced host devices and writes each case's
gathered F and rows to OUT.npz.  `torch` spawns 8 gloo CPU ranks of the
port, which run the same cases through `plan(...).execute(A)`; rank 0
writes F and rows to OUT_DIR/port.npz, and every rank writes the hashes of
its results and a few resolve/plan facts to OUT_DIR/rank<r>.json.  The
ranks then drive the serving engines on the same grids
(`jax_engine_cases.drive`, whose JAX side is `jax_engine_cases.py grid8`)
and an engine on the default config; rank 0 adds their answers to
port.npz, and every rank the hashes of its own.  Both
make their inputs from the same numpy seed.  `tests/test_torch_distributed.py`
runs both and compares them.  Each mode exits non-zero when a rank fails or
does not finish within its time limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

WORLD = 8
N, V = 128, 16
RANK_TIMEOUT_S = 150  # for all ranks together
# name -> (strategy, pivot, (Px, Py, c), hotloop); "conflux_2x2x1_idle"
# leaves ranks 4..7 idle: they join the group creation and the final gather.
CASES = {
    "conflux_windowed": ("conflux", "tournament", (2, 2, 2), "windowed"),
    "conflux_flat": ("conflux", "tournament", (2, 2, 2), "flat"),
    "baseline2d": ("baseline2d", "partial", (2, 4, 1), "windowed"),
    "cholesky25d_windowed": ("cholesky25d", "none", (2, 2, 2), "windowed"),
    "cholesky25d_flat": ("cholesky25d", "none", (2, 2, 2), "flat"),
    "conflux_2x2x1_idle": ("conflux", "tournament", (2, 2, 1), "windowed"),
}
# The same, factored in a 2-byte compute dtype (the JAX side casts A to it):
# name -> (strategy, pivot, (Px, Py, c), hotloop, compute dtype).  The flat
# hot loop on both sides: the JAX "ref" fused step rounds U01 first.
LOW_CASES = {
    "conflux_flat_bf16": ("conflux", "tournament", (2, 2, 2), "flat", "bfloat16"),
}


def _all_cases():
    """(name, strategy, pivot, (Px, Py, c), hotloop, compute dtype or None)."""
    for name, case in CASES.items():
        yield name, *case, None
    for name, case in LOW_CASES.items():
        yield name, *case


def inputs():
    """(A, A_spd): a standard normal matrix and G G^T / N + I, float32."""
    rng = np.random.default_rng(2024)
    A = rng.standard_normal((N, N)).astype(np.float32)
    G = rng.standard_normal((N, N)).astype(np.float32)
    return A, G @ G.T / np.float32(N) + np.eye(N, dtype=np.float32)


def run_jax(out: str) -> None:
    # Eight host devices; no backend optimization, which halves the compile
    # time and leaves the program as written (the rounding may differ from
    # an optimized build, within the tests' tolerance).
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro.core.lu  # noqa: F401  (before repro.kernels.backend: no import cycle)
    from repro.core.cholesky.conflux25d import _local_chol
    from repro.core.lu.conflux import (
        _local_lu,
        block_cyclic_gather,
        block_cyclic_scatter,
        make_lu_mesh,
    )
    from repro.core.lu.grid import GridConfig

    A, A_spd = inputs()
    spec = P("px", "py", None, None)
    res = {}
    for name, strategy, pivot, (Px, Py, c), hotloop, compute in _all_cases():
        grid = GridConfig(Px, Py, c, V, N)
        mesh = make_lu_mesh(grid)
        if strategy == "cholesky25d":
            body, outs, Ain = (lambda b, g=grid, h=hotloop: _local_chol(g, "ref", b, hotloop=h),
                               spec, A_spd)
        else:
            body, outs, Ain = (lambda b, g=grid, p=pivot, h=hotloop:
                               _local_lu(g, p, "ref", b, hotloop=h), (spec, P()), A)
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=outs,
                                   check_vma=False))
        Aloc = block_cyclic_scatter(Ain, Px, Py, V)
        got = fn(Aloc if compute is None else jnp.asarray(Aloc).astype(compute))
        blocks, rows = (got, np.arange(N)) if strategy == "cholesky25d" else got
        res[f"{name}_F"] = block_cyclic_gather(np.asarray(blocks.astype(jnp.float32)), N, V)
        res[f"{name}_rows"] = np.asarray(rows).astype(np.int64)
    np.savez(out, **res)


def _digest(t) -> str:
    import torch

    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # its bits: numpy has no bfloat16
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _rank_main(rank: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.api import GridConfig, SolverConfig, plan, resolve
    from repro_torch.core.lu.conflux import make_lu_mesh

    torch.set_num_threads(1)  # eight ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            rank=rank, world_size=WORLD)
    try:
        A, A_spd = inputs()
        facts, port = {}, {}
        for name, strategy, pivot, (Px, Py, c), hotloop, compute in _all_cases():
            cfg = SolverConfig(strategy=strategy, pivot=pivot, hotloop=hotloop,
                               grid=GridConfig(Px, Py, c, V, N), compute_dtype=compute)
            fact = plan(N, cfg, device="cpu").execute(A_spd if strategy == "cholesky25d" else A)
            facts[name] = {"F": _digest(fact.F), "rows": _digest(fact.rows),
                           "comm_total": fact.comm["total"], "kind": fact.kind,
                           "grid": [fact.grid.Px, fact.grid.Py, fact.grid.c]}
            port[f"{name}_F"] = fact.F.float().numpy()
            port[f"{name}_rows"] = fact.rows.numpy()
        auto = resolve(N, SolverConfig())
        base = resolve(N, SolverConfig(strategy="baseline2d", v=V))
        facts["resolve"] = {"auto": [auto.strategy, auto.grid.Px, auto.grid.Py, auto.grid.c,
                                     auto.grid.v],
                            "baseline2d": [base.grid.Px, base.grid.Py, base.grid.c]}
        try:
            plan(N, SolverConfig(strategy="conflux", grid=GridConfig(4, 4, 1, 8, N)),
                 device="cpu")
            facts["too_small_group"] = None
        except ValueError as e:
            facts["too_small_group"] = str(e)
        grid = GridConfig(2, 2, 2, V, N)
        mesh = make_lu_mesh(grid)
        cfg = SolverConfig(strategy="conflux", grid=grid)
        p1, p2 = plan(N, cfg, device="cpu", mesh=mesh), plan(N, cfg, device="cpu", mesh=mesh)
        facts["explicit_mesh"] = {"distinct": p1 is not p2, "mesh_kept": p1.mesh is mesh,
                                  "same_F": torch.equal(p1.execute(A).F, p2.execute(A).F)}
        facts["engines"] = _engines(port)
        if rank == 0:
            np.savez(Path(out_dir) / "port.npz", **port)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def _engines(port: dict) -> dict:
    """This rank's engine runs: `jax_engine_cases.drive` on each case of its
    `grid8` set, and `SolveEngine(N, SolverConfig())` (the default config,
    resolved as `plan()` resolves it on this group); adds the answers to
    `port` and returns their hashes with a few facts."""
    import torch

    import jax_engine_cases as cases
    from repro_torch.api import GridConfig, SolverConfig, plan, resolve
    from repro_torch.serving import AsyncSolveEngine, SolveEngine

    n, v, table = cases.CASES["grid8"]
    out = {}
    for name, (strategy, shape) in table.items():
        cfg = SolverConfig(strategy=strategy, grid=GridConfig(*shape, v, n))
        inp = cases.inputs(n, strategy)
        got = cases.flatten(f"engine_{name}", cases.drive(SolveEngine, AsyncSolveEngine, n, cfg,
                                                          inp, device="cpu"))
        port.update(got)
        x_plan = plan(n, cfg, device="cpu").execute(inp["A"]).solve(inp["b"]).numpy()
        out[name] = {"digests": {k: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                                 for k, a in got.items()},
                     "x_equals_plan": bool(np.array_equal(got[f"engine_{name}_x"], x_plan))}
    inp = cases.inputs(n, "conflux")
    eng = SolveEngine(n, SolverConfig(), device="cpu")
    x = eng.solve(inp["A"], inp["b"])
    resolved = resolve(n, SolverConfig())
    x_plan = plan(n, resolved, device="cpu").execute(inp["A"]).solve(inp["b"])
    st = eng.stats()
    out["default"] = {"strategy": st["strategy"], "grid": st["grid"],
                      "resolved": [resolved.strategy, str(resolved.grid)],
                      "x_equals_plan": torch.equal(x, x_plan), "x": _digest(x),
                      "hpl_ok": bool(np.abs(inp["A"] @ x.numpy() - inp["b"]).max() < 1e-3)}
    return out


def run_torch(out_dir: str) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, out_dir)) for r in range(WORLD)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if hung or failed:
        raise SystemExit(f"ranks {failed} failed (of which {hung} hung past "
                         f"{RANK_TIMEOUT_S} s)")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    {"jax": run_jax, "torch": run_torch}[sys.argv[1]](sys.argv[2])
