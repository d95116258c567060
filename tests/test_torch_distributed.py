"""The port's distributed schedules (conflux, baseline2d, cholesky25d) on the
CPU, against the JAX package.

Inputs are made from a seed with numpy.  The grid optimizer, the layout
helpers and the communication counters are pure Python and must equal the
JAX package's.  The factorizations run the port's plain versions (the
wrappers' path for CPU tensors) and hold:

- pivot orders `rows` identical to the JAX package's;
- F within LU_F_TOL_FACTOR * N * eps * max|F| of the JAX package's: each
  side drifts from the exact factors by up to about N * eps * max|F| and the
  two round differently (the sums run in another order than XLA's);
- the windowed hot loop equal to the flat one bit for bit.

`repro.api` does not import on this jax, so the JAX side is its local
programs (`_local_lu`, `_local_chol`) under `jax.shard_map`: on one CPU
device in-process for 1x1x1 grids, and on 8 forced host devices in a
subprocess (`tests/multidev/torch_grid_cases.py`), beside 8 gloo CPU ranks
of the port spawned by the same script.  Each subprocess has its own time
limit, so a deadlocked collective fails its test instead of hanging the run.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.linalg
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
import repro.core.lu.baseline2d as jbase
import repro.core.lu.conflux as jconflux
import repro.core.lu.cost_models as jcost
import repro.core.lu.grid as jgrid
import repro.core.windows as jwindows
from repro.core.cholesky import conflux25d as jchol
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan, resolve
from repro_torch.api.strategies import _resolve_auto_analytic
from repro_torch.core import windows
from repro_torch.core.cholesky import conflux25d
from repro_torch.core.lu import baseline2d, conflux, cost_models, grid
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
CASES_SCRIPT = ROOT / "tests" / "multidev" / "torch_grid_cases.py"
ENGINE_SCRIPT = ROOT / "tests" / "multidev" / "jax_engine_cases.py"
LU_F_TOL_FACTOR = 4.0
SUBPROCESS_TIMEOUT_S = 240
# trsm_left_lower against XLA's solve: a v-term sum in another order, f32.
TRSM_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    grid.clear_grid_search_cache()
    yield
    clear_plan_cache()


def _jgrid(g: GridConfig):
    return jgrid.GridConfig(g.Px, g.Py, g.c, g.v, g.N)


def _same_grid(a, b) -> bool:
    return (a.Px, a.Py, a.c, a.v, a.N) == (b.Px, b.Py, b.c, b.v, b.N)


def _f_tol(F_ref: np.ndarray) -> float:
    return LU_F_TOL_FACTOR * F_ref.shape[-1] * np.finfo(np.float32).eps * np.abs(F_ref).max()


def _inputs(N: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)).astype(np.float32)
    G = rng.standard_normal((N, N)).astype(np.float32)
    return A, G @ G.T / np.float32(N) + np.eye(N, dtype=np.float32)


# --------------------------------------------------------------------------
# Pure Python: equal to the JAX package.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N,g,pivot", [
    (64, GridConfig(2, 2, 1, 8, 64), "tournament"),
    (64, GridConfig(3, 1, 1, 8, 64), "tournament"),
    (64, GridConfig(3, 1, 1, 8, 64), "partial"),
    (64, GridConfig(2, 2, 1, 8, 128), "tournament"),
    (96, GridConfig(1, 4, 1, 16, 96), "none"),
    (64, GridConfig(0, 1, 1, 8, 64), "tournament"),
])
def test_validate_layout_messages_match_reference(N, g, pivot):
    def outcome(fn, gg):
        try:
            fn(N, gg, pivot=pivot)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(grid.validate_layout, g) == outcome(jgrid.validate_layout, _jgrid(g))


@pytest.mark.parametrize("P", [1, 2, 3, 4, 6, 8, 16, 64])
def test_enumerate_and_optimize_grid_match_reference(P):
    for N in (64, 96, 128, 1024, 16384):
        for M in (2.0**10, 2.0**14, 2.0**20):
            for v in (None, 8, 32):
                mine = grid.enumerate_grids(N, P, M, v=v)
                theirs = jgrid.enumerate_grids(N, P, M, v=v)
                assert len(mine) == len(theirs)
                assert all(_same_grid(a, b) for a, b in zip(mine, theirs))
                for volume, jvolume in ((None, None),
                                        (conflux25d.chol_comm_volume, jchol.chol_comm_volume)):
                    try:
                        got = grid.optimize_grid(N, P, M, v=v, volume=volume)
                    except ValueError as e:
                        with pytest.raises(ValueError) as want:
                            jgrid.optimize_grid(N, P, M, v=v, volume=jvolume)
                        assert str(e) == str(want.value)
                        continue
                    assert _same_grid(got, jgrid.optimize_grid(N, P, M, v=v, volume=jvolume))


def test_grid_search_is_memoized():
    grid.optimize_grid(1024, 8, 2.0**20)
    grid.optimize_grid(1024, 8, 2.0**20)
    assert grid.grid_search_stats() == {"searches": 1, "hits": 1}
    with pytest.raises(ValueError, match="no feasible grid"):
        grid.optimize_grid(1000, 8, 2.0**14, v=7)
    with pytest.raises(ValueError, match="no feasible grid"):
        grid.optimize_grid(1000, 8, 2.0**14, v=7)
    assert grid.grid_search_stats() == {"searches": 2, "hits": 2}
    grid.clear_grid_search_cache()
    assert grid.grid_search_stats() == {"searches": 0, "hits": 0}


def _close_dicts(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-12 * max(abs(b[k]), 1.0), (k, a[k], b[k])


@pytest.mark.parametrize("g", [
    GridConfig(1, 1, 1, 8, 64), GridConfig(2, 2, 2, 16, 128), GridConfig(2, 4, 1, 16, 128),
    GridConfig(4, 2, 2, 32, 1024), GridConfig(8, 8, 4, 32, 16384),
])
def test_comm_volumes_match_reference(g):
    for pivot in ("tournament", "partial"):
        _close_dicts(conflux.lu_comm_volume(g.N, g, pivot=pivot),
                     jconflux.lu_comm_volume(g.N, _jgrid(g), pivot=pivot))
    _close_dicts(conflux25d.chol_comm_volume(g.N, g), jchol.chol_comm_volume(g.N, _jgrid(g)))


@pytest.mark.parametrize("N,P_", [(64, 1), (1024, 8), (16384, 64)])
def test_cost_models_and_2d_grid_match_reference(N, P_):
    M = 2.0**14
    for name, fn in cost_models.COMM_MODELS.items():
        assert fn(N, P_, M) == jcost.COMM_MODELS[name](N, P_, M)
    assert cost_models.chol_model(N, P_, M, v=32) == jcost.chol_model(N, P_, M, v=32)
    assert _same_grid(baseline2d.scalapack2d_grid(N, P_, v=16),
                      jbase.scalapack2d_grid(N, P_, v=16))


@pytest.mark.parametrize("N,Px,Py,v", [(64, 1, 1, 8), (64, 2, 4, 8), (96, 2, 2, 16),
                                       (128, 4, 2, 16)])
def test_block_cyclic_layout_matches_reference(N, Px, Py, v):
    A = np.random.default_rng(N + Px).standard_normal((N, N)).astype(np.float32)
    blocks = conflux.block_cyclic_scatter(torch.from_numpy(A), Px, Py, v)
    want = jconflux.block_cyclic_scatter(A, Px, Py, v)
    np.testing.assert_array_equal(blocks.numpy(), want)
    np.testing.assert_array_equal(
        conflux._block_cyclic_scatter_loop(torch.from_numpy(A), Px, Py, v).numpy(),
        jconflux._block_cyclic_scatter_loop(A, Px, Py, v))
    np.testing.assert_array_equal(conflux.block_cyclic_gather(blocks, N, v).numpy(), A)
    np.testing.assert_array_equal(conflux._block_cyclic_gather_loop(blocks, N, v).numpy(),
                                  jconflux._block_cyclic_gather_loop(want, N, v))
    g = GridConfig(Px, Py, 1, v, N)
    for px in range(Px):
        for py in range(Py):
            np.testing.assert_array_equal(
                conflux.local_block(torch.from_numpy(A), g, px, py).numpy(), want[px, py])


@pytest.mark.parametrize("nb", [1, 2, 3, 12, 16, 17, 512])
def test_window_buckets_and_index_match_reference(nb):
    assert windows.window_buckets(nb) == jwindows.window_buckets(nb)
    for t in range(nb):
        assert windows.window_bucket_index(t, nb) == int(jwindows.window_bucket_index(t, nb))


# --------------------------------------------------------------------------
# The kernel's plain version.
# --------------------------------------------------------------------------


def _lower(shape, unit: bool, seed: int, dtype=np.float32):
    """A well-conditioned lower triangle: 0.3 * N(0, 1) below the diagonal,
    1 or 2 on it."""
    v = shape[-1]
    L = 0.3 * np.tril(np.random.default_rng(seed).standard_normal(shape), -1)
    return (L + (1.0 if unit else 2.0) * np.eye(v)).astype(dtype)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("v,C", [
    (8, 64), (16, 77), (32, 256), (32, 513),
    # the edges of the kernel's two bodies (registers up to v = 32, shared
    # memory above), with ragged column tiles
    *((v, C) for v in (1, 31, 33, 128) for C in (1, 63, 65)),
])
def test_trsm_left_lower_matches_jax(v, C, unit):
    L = _lower((v, v), unit, seed=v + C)
    L[np.triu_indices(v, 1)] = 9.0  # the upper triangle is never read
    Bm = np.random.default_rng(C).standard_normal((v, C)).astype(np.float32)
    X = ops.trsm_left_lower(torch.from_numpy(L), torch.from_numpy(Bm), unit=unit)
    assert X.shape == (v, C) and X.dtype == torch.float32
    for jX in (jops.trsm_left_lower(jax.numpy.asarray(L), jax.numpy.asarray(Bm), unit=unit),
               jref.trsm_left_lower(jax.numpy.asarray(L), jax.numpy.asarray(Bm), unit=unit)):
        np.testing.assert_allclose(X.numpy(), np.asarray(jX), **TRSM_TOL)


@pytest.mark.parametrize("unit", [True, False])
def test_trsm_left_lower_f64_matches_scipy_and_jax(unit):
    v, C = 16, 45
    L = _lower((v, v), unit, seed=5, dtype=np.float64)
    Bm = np.random.default_rng(6).standard_normal((v, C))
    X = ops.trsm_left_lower(torch.from_numpy(L), torch.from_numpy(Bm), unit=unit)
    assert X.dtype == torch.float64
    want = scipy.linalg.solve_triangular(L, Bm, lower=True, unit_diagonal=unit)
    np.testing.assert_allclose(X.numpy(), want, rtol=1e-12, atol=1e-12)
    # this jax computes in f32 (x64 is off), so the f32 tolerance holds
    jX = jops.trsm_left_lower(jax.numpy.asarray(L.astype(np.float32)),
                              jax.numpy.asarray(Bm.astype(np.float32)), unit=unit)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), **TRSM_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("Bb,v,C,unit", [(3, 8, 64, True), (2, 16, 77, False),
                                         (4, 32, 96, True), (2, 1, 63, True),
                                         (2, 33, 65, False)])
def test_trsm_left_lower_batched_lanes_equal_single(Bb, v, C, unit, dtype):
    L = _lower((Bb, v, v), unit, seed=Bb + v, dtype=dtype)
    Bm = np.random.default_rng(C).standard_normal((Bb, v, C)).astype(dtype)
    Lt, Bt = torch.from_numpy(L), torch.from_numpy(Bm)
    X = ops.trsm_left_lower_batched(Lt, Bt, unit=unit)
    assert X.shape == (Bb, v, C)
    for b in range(Bb):
        assert torch.equal(X[b], ops.trsm_left_lower(Lt[b], Bt[b], unit=unit))
    assert torch.equal(X, ref.trsm_left_lower_batched(Lt, Bt, unit=unit))
    if dtype == np.float32:
        jX = jops.trsm_left_lower_batched(jax.numpy.asarray(L), jax.numpy.asarray(Bm), unit=unit)
        np.testing.assert_allclose(X.numpy(), np.asarray(jX), **TRSM_TOL)


# --------------------------------------------------------------------------
# 1x1x1 grids in-process, against the JAX package's local programs.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_1x1x1(kind: str, pivot: str, N: int, v: int, seed: int):
    """The JAX package's flat local program on one CPU device: (F, rows)."""
    A, A_spd = _inputs(N, seed)
    g = jgrid.GridConfig(1, 1, 1, v, N)
    mesh = jconflux.make_lu_mesh(g, devices=jax.devices()[:1])
    spec = P("px", "py", None, None)
    if kind == "cholesky":
        body, outs, Ain = (lambda b: jchol._local_chol(g, "ref", b, hotloop="flat")), spec, A_spd
    else:
        body, outs, Ain = ((lambda b: jconflux._local_lu(g, pivot, "ref", b, hotloop="flat")),
                           (spec, P()), A)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=outs, check_vma=False))
    got = fn(jconflux.block_cyclic_scatter(Ain, 1, 1, v))
    blocks, rows = (got, np.arange(N)) if kind == "cholesky" else got
    return jconflux.block_cyclic_gather(np.asarray(blocks), N, v), np.asarray(rows)


@pytest.mark.parametrize("v", [8, 32])
@pytest.mark.parametrize("N", [64, 96])
@pytest.mark.parametrize("strategy,pivot", [("conflux", "tournament"), ("conflux", "partial"),
                                            ("baseline2d", "partial"), ("cholesky25d", "none")])
def test_grid_1x1x1_matches_reference(strategy, pivot, N, v):
    kind = "cholesky" if strategy == "cholesky25d" else "lu"
    A, A_spd = _inputs(N, seed=N + v)
    Ain = A_spd if kind == "cholesky" else A
    g = GridConfig(1, 1, 1, v, N)
    facts = {hl: plan(N, SolverConfig(strategy=strategy, pivot=pivot, grid=g, hotloop=hl),
                      device="cpu").execute(Ain)
             for hl in ("windowed", "flat")}
    w, f = facts["windowed"], facts["flat"]
    assert torch.equal(w.rows, f.rows) and torch.equal(w.F, f.F)
    assert w.kind == kind and w.grid == g and w.strategy == strategy and w.backend == "cuda"
    F_ref, rows_ref = _reference_1x1x1(kind, pivot, N, v, N + v)
    np.testing.assert_array_equal(w.rows.numpy(), rows_ref)
    assert np.abs(w.F.numpy() - F_ref).max() <= _f_tol(F_ref)
    assert float((w.reconstruct() - torch.from_numpy(Ain)).abs().max()) < 1e-4 * N


# --------------------------------------------------------------------------
# Eight ranks: the JAX package on 8 host devices, the port on 8 gloo ranks.
# --------------------------------------------------------------------------


def _cases_module():
    sys.path.insert(0, str(CASES_SCRIPT.parent))
    try:
        import torch_grid_cases
    finally:
        sys.path.remove(str(CASES_SCRIPT.parent))
    return torch_grid_cases


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Runs the three subprocesses at once: the JAX local programs and the
    JAX engines (`jax_engine_cases.py grid8`, under the `enable_x64` shim)
    on 8 forced host devices, and the port's 8 gloo ranks.  Returns their
    output directory."""
    out = tmp_path_factory.mktemp("grid8")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    commands = {"jax": [str(CASES_SCRIPT), "jax", str(out / "ref.npz")],
                "torch": [str(CASES_SCRIPT), "torch", str(out)],
                "jax_engines": [str(ENGINE_SCRIPT), "grid8", str(out / "engines.npz")]}
    procs = {mode: subprocess.Popen([sys.executable, *cmd], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for mode, cmd in commands.items()}
    logs = {}
    try:
        for mode, p in procs.items():
            logs[mode], _ = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for mode, p in procs.items():
        assert p.returncode == 0, f"{mode} side failed:\n{logs.get(mode, '')[-4000:]}"
    return out


@pytest.fixture(scope="module")
def eight_ranks(grid_runs):
    """(reference npz, port npz, facts of every rank)."""
    facts = [json.loads((grid_runs / f"rank{r}.json").read_text()) for r in range(8)]
    return np.load(grid_runs / "ref.npz"), np.load(grid_runs / "port.npz"), facts


@pytest.mark.parametrize("case", ["conflux_windowed", "conflux_flat", "baseline2d",
                                  "cholesky25d_windowed", "cholesky25d_flat",
                                  "conflux_2x2x1_idle"])
def test_eight_ranks_match_reference(eight_ranks, case):
    jres, port, facts = eight_ranks
    strategy, pivot, shape, _ = _cases_module().CASES[case]
    np.testing.assert_array_equal(port[f"{case}_rows"], jres[f"{case}_rows"])
    F_ref = jres[f"{case}_F"]
    assert np.abs(port[f"{case}_F"] - F_ref).max() <= _f_tol(F_ref)
    # every rank, idle ones too, returned the same F and rows, bit for bit
    assert len({(f[case]["F"], f[case]["rows"]) for f in facts}) == 1
    g = GridConfig(*shape, 16, 128)
    want = (conflux25d.chol_comm_volume(128, g) if strategy == "cholesky25d"
            else conflux.lu_comm_volume(128, g, pivot=pivot))
    assert facts[0][case]["comm_total"] == want["total"]
    assert facts[0][case]["grid"] == list(shape)


@pytest.mark.parametrize("case", ["conflux_flat_bf16"])
def test_eight_ranks_2byte_matches_reference(eight_ranks, case):
    """A 2x2x2 conflux run factored in bf16 on both sides: the pivots equal,
    F within N / 8 * eps(bf16) * max|F| (`_low_tol` of
    tests/test_torch_mixed_precision.py: f32 sums in another order that land
    beside a bf16 rounding boundary, carried by later steps), and every rank
    returned the same bits."""
    jres, port, facts = eight_ranks
    strategy, pivot, shape, _, compute = _cases_module().LOW_CASES[case]
    np.testing.assert_array_equal(port[f"{case}_rows"], jres[f"{case}_rows"])
    F_ref = jres[f"{case}_F"]
    eps = torch.finfo(getattr(torch, compute)).eps
    assert np.abs(port[f"{case}_F"] - F_ref).max() <= 128 / 8 * eps * np.abs(F_ref).max()
    assert len({(f[case]["F"], f[case]["rows"]) for f in facts}) == 1
    assert facts[0][case]["grid"] == list(shape)
    g = GridConfig(*shape, 16, 128)
    assert facts[0][case]["comm_total"] == conflux.lu_comm_volume(128, g, pivot=pivot)["total"]
    assert strategy == "conflux"


def test_eight_ranks_windowed_equals_flat(eight_ranks):
    _, port, _ = eight_ranks
    for name in ("conflux", "cholesky25d"):
        np.testing.assert_array_equal(port[f"{name}_windowed_F"], port[f"{name}_flat_F"])
        np.testing.assert_array_equal(port[f"{name}_windowed_rows"], port[f"{name}_flat_rows"])


def test_eight_ranks_resolve_plan_and_mesh(eight_ranks):
    _, _, facts = eight_ranks
    best = grid.optimize_grid(128, 8, SolverConfig().M)
    assert _same_grid(best, jgrid.optimize_grid(128, 8, SolverConfig().M))
    for f in facts:
        assert f["resolve"]["auto"] == ["conflux", best.Px, best.Py, best.c, best.v]
        assert f["resolve"]["baseline2d"] == [2, 4, 1]
        assert "needs P_used=16 ranks, but the process group has 8" in f["too_small_group"]
        assert f["explicit_mesh"] == {"distinct": True, "mesh_kept": True, "same_F": True}


def test_interop_carries_a_distributed_reference_run(eight_ranks):
    """The JAX package's gathered 2x2x2 factors, grid and volume become the
    port's Factorization and solve as the port's own 8-rank factors do."""
    jres, port, _ = eight_ranks
    A, _ = _cases_module().inputs()
    b = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    jg = jgrid.GridConfig(2, 2, 2, 16, 128)
    jf = interop.factorization_from_numpy(
        jres["conflux_windowed_F"], jres["conflux_windowed_rows"], device="cpu", grid=jg,
        comm=jconflux.lu_comm_volume(128, jg), strategy="conflux")
    pf = interop.factorization_from_numpy(port["conflux_windowed_F"],
                                          port["conflux_windowed_rows"], device="cpu")
    x_j, x_p = jf.solve(b).numpy(), pf.solve(b).numpy()
    np.testing.assert_allclose(x_j, x_p, rtol=0, atol=1e-3 * np.abs(x_p).max())
    np.testing.assert_allclose(A @ x_j, b, atol=1e-3 * 128)
    assert jf.grid == GridConfig(2, 2, 2, 16, 128)
    assert jf.comm == conflux.lu_comm_volume(128, jf.grid)
    assert "u01_gather" in jf.comm_report() and "[2x2x2]" in jf.comm_report()


def _engine_cases():
    sys.path.insert(0, str(CASES_SCRIPT.parent))
    try:
        import jax_engine_cases
    finally:
        sys.path.remove(str(CASES_SCRIPT.parent))
    return jax_engine_cases


@pytest.mark.parametrize("name", ["conflux", "baseline2d", "cholesky25d"])
def test_eight_rank_engines_match_the_jax_engines(grid_runs, eight_ranks, name):
    """`SolveEngine` and `AsyncSolveEngine` on conflux 2x2x2, baseline2d
    2x4x1 and cholesky25d 2x2x2, the port on eight gloo ranks against the
    JAX engines on 8 host devices: the same stats, pivot rows equal, every
    answer within 1e-4 of its scale (the f32 tolerance of
    tests/test_torch_serving.py); every rank returned the same bits, and
    `solve`'s x equals the rank's `plan(...).execute(A).solve(b)` bit for
    bit."""
    cases = _engine_cases()
    _, port, facts = eight_ranks
    got = cases.unflatten(port, f"engine_{name}")
    want = cases.unflatten(np.load(grid_runs / "engines.npz"), name)
    assert got["stats"] == want["stats"]
    assert got["async_stats"] == want["async_stats"]
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["async_rows"], want["async_rows"])
    for key in ("x", "x2", "flush", "async_rhs", "systems", "async_systems"):
        pairs = zip(got[key], want[key]) if isinstance(got[key], list) else [(got[key],
                                                                             want[key])]
        for g, w in pairs:
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)
    assert len({json.dumps(f["engines"][name]["digests"], sort_keys=True) for f in facts}) == 1
    assert all(f["engines"][name]["x_equals_plan"] for f in facts)


def test_eight_rank_default_engine_resolves_as_plan(eight_ranks):
    """`SolveEngine(N, SolverConfig())` on the 8-rank group resolves as
    `plan()` does (conflux on the analytic ranking, with no CPU table; the
    JAX package's "cpu" table may pick another v), and every rank answers
    the same bits as its plan."""
    _, _, facts = eight_ranks
    best = grid.optimize_grid(128, 8, SolverConfig().M)
    for f in facts:
        d = f["engines"]["default"]
        assert d["strategy"] == "conflux" and d["resolved"] == ["conflux", str(best)]
        assert d["grid"] == str(best) and d["x_equals_plan"] and d["hpl_ok"]
    assert len({f["engines"]["default"]["x"] for f in facts}) == 1


# --------------------------------------------------------------------------
# plan and resolve in-process.
# --------------------------------------------------------------------------


def test_explicit_mesh_bypasses_the_cache():
    g = GridConfig(1, 1, 1, 8, 64)
    cfg = SolverConfig(strategy="conflux", grid=g)
    mesh = conflux.make_lu_mesh(g)
    p1, p2 = plan(64, cfg, device="cpu", mesh=mesh), plan(64, cfg, device="cpu", mesh=mesh)
    assert p1 is not p2 and p1.mesh is mesh and p2.mesh is mesh
    p3 = plan(64, cfg, device="cpu")
    assert plan(64, cfg, device="cpu") is p3 and p3.mesh is not mesh
    A, _ = _inputs(64, seed=1)
    assert torch.equal(p1.execute(A).F, p3.execute(A).F)
    with pytest.raises(ValueError, match=r"P_used=1, the grid needs 2"):
        plan(64, SolverConfig(strategy="conflux", grid=GridConfig(2, 1, 1, 8, 64)),
             device="cpu", mesh=mesh)


@pytest.mark.parametrize("strategy", ["conflux", "baseline2d", "cholesky25d"])
def test_grid_larger_than_the_group_raises(strategy, tmp_path):
    cfg = SolverConfig(strategy=strategy, grid=GridConfig(2, 2, 1, 8, 64))
    with pytest.raises(ValueError, match="needs P_used=4 ranks, but there is no process group"):
        plan(64, cfg, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs P_used=4 ranks, but the process group has 1"):
            plan(64, cfg, device="cpu")
        # one rank: the group's size is the default processor budget
        assert resolve(64, SolverConfig(strategy=strategy)).grid.P_used == 1
        assert resolve(64, SolverConfig()).strategy == "sequential"
        A, A_spd = _inputs(64, seed=2)
        Ain = A_spd if strategy == "cholesky25d" else A
        g1 = GridConfig(1, 1, 1, 8, 64)
        in_group = plan(64, SolverConfig(strategy=strategy, grid=g1), device="cpu")
        F_in_group = in_group.execute(Ain).F
        dist.destroy_process_group()
        alone = plan(64, SolverConfig(strategy=strategy, grid=g1), device="cpu")
        assert alone is not in_group  # a plan serves only the group it was built over
        assert torch.equal(alone.execute(Ain).F, F_in_group)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_auto_ranks_grids_on_many_ranks_and_is_sequential_on_one():
    cfg = SolverConfig()
    r8 = _resolve_auto_analytic(128, cfg, 8)
    assert r8.strategy == "conflux" and r8.grid == grid.optimize_grid(128, 8, cfg.M)
    assert _resolve_auto_analytic(128, cfg.with_(P_target=4), 8).grid.P_used <= 4
    # no feasible grid (the local share N^2/P outgrows M): sequential
    assert _resolve_auto_analytic(1024, cfg, 8).strategy == "sequential"
    assert _resolve_auto_analytic(128, cfg, 1).strategy == "sequential"
    assert resolve(128, cfg).strategy == "sequential"  # no process group here
    with pytest.raises(ValueError, match="needs 4 ranks but the process group has 1"):
        resolve(64, SolverConfig(grid=GridConfig(2, 2, 1, 8, 64)))
    assert resolve(64, SolverConfig(grid=GridConfig(1, 1, 1, 8, 64))).strategy == "conflux"


@pytest.mark.parametrize("strategy", ["conflux", "baseline2d", "cholesky25d"])
def test_batched_distributed_plans_raise_the_reference_message(strategy):
    want = (f"strategy '{strategy}' shards one large matrix and does not support batched "
            f"plans (B=4); use 'sequential' / 'sequential_chol' (or 'auto') for the "
            f"many-small-systems path")
    with pytest.raises(ValueError) as e:
        resolve(64, SolverConfig(strategy=strategy, B=4))
    assert str(e.value) == want


def test_interop_factorization_with_grid_and_comm_matches_the_ports_run():
    N, v = 64, 8
    A, _ = _inputs(N, seed=N + v)
    b = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    g = GridConfig(1, 1, 1, v, N)
    F_ref, rows_ref = _reference_1x1x1("lu", "tournament", N, v, N + v)
    jf = interop.factorization_from_numpy(
        F_ref.copy(), rows_ref, device="cpu", A_ref=A, grid=dataclasses.asdict(g),
        comm=jconflux.lu_comm_volume(N, _jgrid(g)), strategy="conflux")
    own = plan(N, SolverConfig(strategy="conflux", grid=g), device="cpu").execute(A)
    np.testing.assert_allclose(jf.solve(b).numpy(), own.solve(b).numpy(), rtol=0,
                               atol=1e-3 * np.abs(own.solve(b).numpy()).max())
    for got, want in zip(jf.slogdet(), own.slogdet()):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert jf.grid == own.grid and jf.comm == own.comm
    # the reports differ only in the backend, which the JAX side does not carry
    assert jf.comm_report().replace("backend=?", "backend=cuda") == own.comm_report()


def test_config_from_jax_round_trips_a_conflux_config():
    jg = jgrid.GridConfig(2, 2, 2, 16, 128)
    fields = {f.name: getattr(SolverConfig(), f.name) for f in dataclasses.fields(SolverConfig)}
    fields.update(strategy="conflux", backend="pallas", grid=jg, hotloop="flat")
    cfg = interop.config_from_jax(fields)
    assert cfg.strategy == "conflux" and cfg.backend == "cuda" and cfg.hotloop == "flat"
    assert cfg.grid == GridConfig(2, 2, 2, 16, 128)
    assert resolve(128, cfg) == cfg  # an explicit grid resolves to itself
    back = interop.config_from_jax({**dataclasses.asdict(cfg), "backend": "ref"})
    assert back.grid == cfg.grid and back.backend == "ref"
