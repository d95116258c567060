"""`FactorizationPlan.profile_hotloop` and `repro_torch.api.hotloop`, against
the JAX package's `profile_primitives`.

The JAX side runs in the subprocess of `tests/multidev/jax_costmodel_cases.py`
(`repro.api` needs the `enable_x64` shim there).  Times differ between the
packages by nature; the key set and the profiled shapes are compared for
equality.  A recording backend shows which primitives the profile calls, on
which shapes and in which dtype: on the card, the six kernels of the plan's
path.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan
from repro_torch.api import hotloop as thl
from repro_torch.kernels import backend as tbackend

ROOT = Path(__file__).resolve().parents[1]
TIME_KEYS = {f"{p}_{s}" for p in ("panel", "trsm", "schur", "fused", "gather", "gather_dense")
             for s in ("us", "spread")}


def _cases_module():
    sys.path.insert(0, str(ROOT / "tests" / "multidev"))
    try:
        import jax_costmodel_cases
    finally:
        sys.path.remove(str(ROOT / "tests" / "multidev"))
    return jax_costmodel_cases


CASES = _cases_module()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return CASES.run(tmp_path_factory.mktemp("hotloop"))[1]


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _config(strategy, N, v, axes):
    grid = None if axes is None else GridConfig(*axes, v=v, N=N)
    pivot = "none" if strategy in ("sequential_chol", "cholesky25d") else "tournament"
    return SolverConfig(strategy=strategy, pivot=pivot, v=v, backend="cuda", grid=grid), grid


@pytest.mark.parametrize("case", range(len(CASES.PROFILE_CASES)))
def test_profile_keys_and_shapes_match_jax(case, jax_side):
    strategy, N, v, axes = CASES.PROFILE_CASES[case]
    cfg, grid = _config(strategy, N, v, axes)
    if grid is None or grid.P_used == 1:
        # through the entry point: a plan the CPU can build in this process
        p = plan(N, cfg, device="cpu")
        assert p.grid == grid
        t = p.profile_hotloop(repeats=1)
        assert p.hotloop is t
    else:  # a grid over several ranks: the shapes alone, no process group
        t = thl.profile_primitives(N, cfg, grid=grid, repeats=1, device="cpu")
    want = jax_side["profile"][str(case)]
    assert sorted(t) == want["keys"]
    assert t["shapes"] == want["shapes"]
    for k in TIME_KEYS:
        assert isinstance(t[k], float) and t[k] >= 0.0, k
    assert all(t[f"{p}_us"] > 0 for p in ("panel", "trsm", "schur", "fused"))


@pytest.mark.parametrize("strategy", ["sequential", "sequential_chol"])
def test_profile_carries_into_the_factorization_and_report(strategy):
    p = plan(64, SolverConfig(strategy=strategy, v=16), device="cpu")
    A = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    A = A @ A.T / 64 + np.eye(64, dtype=np.float32)
    assert p.execute(A).hotloop == {}
    assert "hot-loop" not in p.execute(A).comm_report()
    prof = p.profile_hotloop(repeats=2)
    fact = p.execute(A)
    assert fact.hotloop == prof and fact.hotloop is not p.hotloop
    report = fact.comm_report()
    assert "hot-loop primitives (us, profiled local shapes):" in report
    for k in ("panel_us", "fused_us", "gather_dense_spread"):
        assert k in report
    assert "'R'" not in report  # the shapes dict is not listed, only the numbers


class _Recording:
    """A backend that records each primitive call and runs the plain version."""

    name = "recording"

    def __init__(self):
        self.calls = []
        self._ref = tbackend.RefBackend()

    def __getattr__(self, prim):
        fn = getattr(self._ref, prim)

        def call(*args, **kw):
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            dtypes = {a.dtype for a in args
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            self.calls.append((prim, shapes, dtypes, kw))
            return fn(*args, **kw)

        return call


@pytest.fixture
def recording():
    rec = _Recording()
    tbackend.register_backend("recording", rec)
    try:
        yield rec
    finally:
        tbackend._BACKENDS.pop("recording")


@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_profile_calls_the_paths_primitives(kind, compute, recording):
    """LU: panel_lup, trsm_left_lower (unit), schur_update, fused (unit);
    Cholesky: panel_chol, trsm_right_upper against L00^T, schur_update,
    fused (unit=False).  Each once to warm up and once per repeat, in the
    compute dtype."""
    N, v = 64, 16
    pivot = "none" if kind == "cholesky" else "tournament"
    cfg = SolverConfig(strategy="sequential", pivot=pivot, v=v, backend="recording",
                       compute_dtype=compute)
    thl.profile_primitives(N, cfg, repeats=2, device="cpu")
    if kind == "lu":
        want = {"panel_lup": [(N, v), (N,)], "trsm_left_lower": [(v, v), (v, N)]}
    else:
        want = {"panel_chol": [(v, v)], "trsm_right_upper": [(N, v), (v, v)]}
    want |= {"schur_update": [(N, N), (N, v), (v, N)],
             "fused_trsm_schur": [(N, N), (v, v), (v, N), (N, v)]}
    dt = torch.bfloat16 if compute else torch.float32
    seen = {}
    for prim, shapes, dtypes, kw in recording.calls:
        seen[prim] = seen.get(prim, 0) + 1
        assert shapes == want[prim], prim
        assert dtypes == {dt}, prim
        if prim == "fused_trsm_schur" or prim == "trsm_left_lower":
            assert kw["unit"] is (kind == "lu")
    assert seen == {prim: 3 for prim in want}


def test_best_of_interleaved_warms_every_entry_up_before_timing(monkeypatch):
    events = []
    clock = iter(range(1000))
    monkeypatch.setattr(thl.time, "perf_counter", lambda: float(next(clock)))

    def entry(name):
        return (name, lambda *a: events.append(("call", name, a)), (name,))

    entries = [entry("a"), entry("b"), entry("c")]
    out = thl._best_of_interleaved(entries, repeats=3, sync=lambda: events.append(("sync",)))
    # a first pass over every entry, then one wait, before any timer runs
    assert events[:4] == [("call", "a", ("a",)), ("call", "b", ("b",)), ("call", "c", ("c",)),
                          ("sync",)]
    timed = events[4:]
    # then rounds: each entry once per round, each call followed by a wait
    assert [e[1] for e in timed if e[0] == "call"] == ["a", "b", "c"] * 3
    assert all(timed[i + 1] == ("sync",) for i in range(0, len(timed), 2))
    assert set(out) == {"a", "b", "c"}
    for m in out.values():  # each timed call spans one clock tick here
        assert m == {"best_us": 1e6, "spread": 0.0}


def test_best_of_interleaved_spread_is_worst_over_best(monkeypatch):
    ticks = iter([0.0, 1e-6, 10.0, 10.000004])
    monkeypatch.setattr(thl.time, "perf_counter", lambda: next(ticks))
    out = thl._best_of_interleaved([("x", lambda: None, ())], repeats=2)
    assert out["x"]["best_us"] == pytest.approx(1.0)
    assert out["x"]["spread"] == pytest.approx(3.0)


def test_profile_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thl.profile_primitives(64, SolverConfig(v=16))
