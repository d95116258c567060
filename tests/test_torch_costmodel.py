"""The port's cost model and calibrated `strategy="auto"`, against the JAX
package's.

`repro.analysis.costmodel` and `repro.analysis.audit` import on this jax, so
fits, tables, work terms, bucket trips, the executed comm model and
`predict_wall` without a collective term are compared in this process.
Whatever goes through `repro.api` (the collective term, which reads
`repro.api.config`; `autotune_choice` on one device; `_resolve_auto`) runs
in the subprocess of `tests/multidev/jax_costmodel_cases.py`, which sets
the `enable_x64` shim there and only there.

The one stated difference: the port's in-core prediction charges each step
two `gather` calls where the JAX package charges two one-hot products
(`gather_dense`).  Calibration state is process-global, so every test that
touches it runs under the `restore_calibration` fixture.
"""

from __future__ import annotations

import inspect
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.lu  # noqa: F401  (before repro.kernels.backend: import order)
from repro.analysis import audit as jaudit
from repro.analysis import costmodel as jcm
from repro_torch.analysis import audit as taudit
from repro_torch.analysis import calibrate as tcal
from repro_torch.analysis import costmodel as tcm
from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan, resolve
from repro_torch.api.strategies import _resolve_auto_analytic

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
REL = 1e-12


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
    return CASES.run(tmp_path_factory.mktemp("costmodel"))


@pytest.fixture
def restore_calibration():
    """Snapshot/restore the port's process-global active calibration."""
    prev = tcm.set_calibration(None)
    clear_plan_cache()
    try:
        yield
    finally:
        clear_plan_cache()
        if prev is None:
            tcm.reset_calibration()
        else:
            tcm.set_calibration(prev)


def _synthetic(mod, collective=None, beta=1e-6, alpha=0.0, device_kind="cpu", tag="syn",
               keys=(("ref", "float32"), ("cuda", "float32"))):
    """A uniform synthetic table of `mod` (either package's costmodel)."""
    fits = {p: mod.PrimitiveFit(alpha, beta) for p in mod.PRIMITIVES}
    tables = {k: dict(fits) for k in keys}
    return mod.Calibration(version=mod.content_version(tables, collective, tag),
                           device_kind=device_kind, tables=tables, collective=collective)


def _seeded_samples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    work = rng.uniform(1e3, 1e7, n)
    t = 12.0 + 3e-5 * work * rng.uniform(0.8, 1.25, n)
    spread = rng.uniform(0.0, 1.5, n)
    return [(float(w), float(x), float(s)) for w, x, s in zip(work, t, spread)]


FIT_CASES = {
    "clean_affine": [(w, 5.0 + 0.25 * w, 0.0) for w in (10.0, 100.0, 1000.0)],
    "single_sample": [(200.0, 50.0, 0.1)],
    "negative_slope": [(10.0, 90.0, 0.0), (100.0, 50.0, 0.2), (1000.0, 10.0, 0.0)],
    "negative_intercept": [(100.0, 1.0, 0.0), (200.0, 30.0, 0.0), (300.0, 60.0, 0.5)],
    "one_shape": [(64.0, 10.0, 0.0), (64.0, 12.0, 0.3)],
    "dropped_points": [(0.0, 5.0, 0.0), (10.0, -1.0, 0.0), (50.0, 20.0, -0.5),
                       (80.0, 26.0, 0.1)],
    "seeded_3": _seeded_samples(3, 12),
    "seeded_7": _seeded_samples(7, 40),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_affine_matches_jax(case):
    pts = FIT_CASES[case]
    got, want = tcm.fit_affine(pts), jcm.fit_affine(pts)
    assert got.to_json() == want.to_json()
    t_tables = {("ref", "float32"): {"fused": got}}
    j_tables = {("ref", "float32"): {"fused": want}}
    assert tcm.content_version(t_tables, None, "x") == jcm.content_version(j_tables, None, "x")


def test_fit_affine_refuses_no_usable_sample():
    for mod in (tcm, jcm):
        with pytest.raises(ValueError, match="at least one sample"):
            mod.fit_affine([(0.0, 1.0, 0.0), (5.0, 0.0, 0.0)])


def _samples(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for key in (("ref", "float32"), ("cuda", "bfloat16"), ("ref", "float64")):
        out[key] = {p: [(float(w), float(5.0 + 1e-4 * w * rng.uniform(0.9, 1.1)),
                         float(rng.uniform(0, 0.5)))
                        for w in rng.uniform(1e2, 1e6, 6)]
                    for p in tcm.PRIMITIVES}
    return out


@pytest.mark.parametrize("collective", [None, (22.5, 0.078)])
def test_fit_calibration_matches_jax(collective):
    samples = _samples(11)
    coll_t = tcm.PrimitiveFit(*collective, 3) if collective else None
    coll_j = jcm.PrimitiveFit(*collective, 3) if collective else None
    got = tcm.fit_calibration(samples, "cpu", collective=coll_t, tag="full", meta={"a": 1})
    want = jcm.fit_calibration(samples, "cpu", collective=coll_j, tag="full", meta={"a": 1})
    assert got.version == want.version
    assert got.to_json() == want.to_json()
    with pytest.raises(ValueError, match="no samples"):
        tcm.fit_calibration({("ref", "float32"): {"panel": []}}, "cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_table_saved_by_one_package_loads_in_the_other(writer, tmp_path):
    samples = _samples(5)
    fitted = {
        "port": tcm.fit_calibration(samples, "cpu", tcm.PrimitiveFit(20.0, 0.05, 3), "full"),
        "jax": jcm.fit_calibration(samples, "cpu", jcm.PrimitiveFit(20.0, 0.05, 3), "full"),
    }
    path = str(tmp_path / "table.json")
    fitted[writer].save(path)
    t_loaded, j_loaded = tcm.load_calibration(path), jcm.load_calibration(path)
    assert t_loaded.to_json() == j_loaded.to_json() == fitted["jax"].to_json()
    assert t_loaded.version == fitted["port"].version == fitted["jax"].version
    # the same predictions from the loaded tables (one rank: no collective term)
    cfg = SolverConfig(dtype="float64")
    for N, v in ((256, 16), (512, 32)):
        grid = GridConfig(1, 1, 1, v, N)
        for hotloop in ("windowed", "flat"):
            got = tcm.predict_wall(N, cfg, grid=grid, hotloop=hotloop, backend="ref",
                                   calibration=t_loaded, device="cpu")
            want = jcm.predict_wall(N, cfg, grid=grid, hotloop=hotloop, backend="ref",
                                    calibration=j_loaded)
            assert got["wall_us"] == pytest.approx(want["wall_us"], rel=REL)


@pytest.mark.parametrize("prim", tcm.PRIMITIVES)
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_primitive_work_matches_jax(prim, kind):
    for R, C, v, wr, wc in ((64, 64, 8, 64, 64), (1024, 512, 32, 1024, 96),
                            (16384, 16384, 64, 8192, 128)):
        sh = dict(R=R, C=C, v=v, wr=wr, wc=wc)
        assert tcm.primitive_work(prim, kind, **sh) == jcm.primitive_work(prim, kind, **sh)
    with pytest.raises(ValueError, match="unknown primitive"):
        tcm.primitive_work("nope", kind, **sh)


def test_profile_sample_points_match_jax():
    timings = {"panel_us": 10.0, "panel_spread": 0.2, "trsm_us": 0.0, "schur_us": 5.5,
               "fused_us": 7.0, "fused_spread": 0.1, "gather_us": "x", "gather_dense_us": 3.0,
               "shapes": {"R": 256, "C": 256, "v": 16, "wr": 128, "wc": 96}}
    for kind in ("lu", "cholesky"):
        assert tcm.profile_sample_points(timings, kind) == jcm.profile_sample_points(timings,
                                                                                     kind)


@pytest.mark.parametrize("hotloop", ["windowed", "flat"])
def test_bucket_trips_match_jax(hotloop):
    for N, v in ((64, 8), (96, 8), (256, 16), (1024, 32), (16384, 64), (4096, 4096)):
        assert tcm._bucket_trips(N, v, hotloop) == jcm._bucket_trips(N, v, hotloop)
        assert taudit._window_caps(N // v) == jaudit._window_caps(N // v)


GRIDS = [(1, 1, 1, 8), (2, 2, 1, 16), (2, 2, 2, 16), (4, 2, 1, 8), (2, 4, 2, 8), (8, 1, 1, 16)]


@pytest.mark.parametrize("axes", GRIDS, ids=str)
def test_executed_comm_bytes_and_op_counts_match_jax(axes):
    """The JAX package's executed model and op count, as the port keeps them
    (`audit.jax_executed_comm_bytes`); the port's own schedule is priced by
    `audit.executed_comm_bytes`, held to the trace in test_torch_audit.py."""
    grid = GridConfig(*axes, N=512)
    for kind, pivot in (("lu", "tournament"), ("lu", "partial"), ("cholesky", "none")):
        assert (tcm.collective_op_count(kind, 512, grid, pivot)
                == jcm.collective_op_count(kind, 512, grid, pivot))
        for hotloop in ("windowed", "flat"):
            for itemsize in (2, 4, 8):
                assert (taudit.jax_executed_comm_bytes(kind, 512, grid, pivot, hotloop, itemsize)
                        == jaudit.executed_comm_bytes(kind, 512, grid, pivot, hotloop, itemsize))
    assert taudit._ar(100.0, 1) == 0.0 and taudit._ar(100.0, 4) == jaudit._ar(100.0, 4)


def _table(mod, keys=(("ref", "float32"),), prims=("panel", "trsm", "schur", "fused"),
           collective=None):
    rng = np.random.default_rng(17)
    tables = {k: {p: mod.PrimitiveFit(float(rng.uniform(1, 50)), float(rng.uniform(1e-6, 1e-3)))
                  for p in prims} for k in keys}
    coll = mod.PrimitiveFit(*collective) if collective else None
    return mod.Calibration(mod.content_version(tables, coll, "t"), "cpu", tables, coll)


@pytest.mark.parametrize("case", range(len(CASES.GRID_CASES)))
def test_predict_wall_on_grids_without_a_collective_term_matches_jax(case):
    kind, N, axes, hotloop, pivot, dtype, compute = CASES.GRID_CASES[case]
    grid = GridConfig(*axes, N=N)
    cfg = SolverConfig(dtype=dtype, compute_dtype=compute)
    keys = (("ref", cfg.effective_compute_dtype),)
    prims = tcm.PRIMITIVES
    got = tcm.predict_wall(N, cfg, grid=grid, hotloop=hotloop, kind=kind, pivot=pivot,
                           backend="ref", calibration=_table(tcm, keys, prims), device="cpu")
    want = jcm.predict_wall(N, cfg, grid=grid, hotloop=hotloop, kind=kind, pivot=pivot,
                            backend="ref", calibration=_table(jcm, keys, prims))
    assert got["terms"].keys() == want["terms"].keys()
    for term, val in want["terms"].items():
        assert got["terms"][term] == pytest.approx(val, rel=REL), term
    assert got["wall_us"] == pytest.approx(want["wall_us"], rel=REL)


@pytest.mark.parametrize("case", range(len(CASES.GRID_CASES)))
@pytest.mark.parametrize("table", ["auto", "nocoll"])
def test_predict_wall_on_grids_matches_jax_through_the_shim(case, table, jax_side):
    paths, res = jax_side
    kind, N, axes, hotloop, pivot, dtype, compute = CASES.GRID_CASES[case]
    cfg = SolverConfig(dtype=dtype, compute_dtype=compute)
    got = tcm.predict_wall(N, cfg, grid=GridConfig(*axes, N=N), hotloop=hotloop, kind=kind,
                           pivot=pivot, backend="ref",
                           calibration=tcm.load_calibration(paths[table]), device="cpu")
    want = res["predict"][f"{case}/{table}"]
    assert got["terms"].keys() == want["terms"].keys()
    for term, val in want["terms"].items():
        if term != "collective":
            assert got["terms"][term] == pytest.approx(val, rel=REL), term
    has_coll = table == "auto" and GridConfig(*axes, N=N).P_used > 1
    assert ("collective" in got["terms"]) == has_coll
    if has_coll:
        # A stated difference: the port prices its own collectives.
        grid = GridConfig(*axes, N=N)
        coll = tcm.load_calibration(paths[table]).collective
        itemsize = torch.tensor([], dtype=getattr(torch, cfg.effective_compute_dtype)).itemsize
        wire = taudit.executed_comm_bytes(kind, N, grid, pivot, hotloop, itemsize)["total"]
        ops = taudit.executed_collective_ops(kind, N, grid, pivot)
        port = ops * coll.alpha_us + wire * coll.beta_us
        assert got["terms"]["collective"] == pytest.approx(port, rel=REL)
        jwire = taudit.jax_executed_comm_bytes(kind, N, grid, pivot, hotloop, itemsize)["total"]
        jops = tcm.collective_op_count(kind, N, grid, pivot)
        assert want["terms"]["collective"] == pytest.approx(
            jops * coll.alpha_us + jwire * coll.beta_us, rel=REL)
        assert got["wall_us"] == pytest.approx(
            want["wall_us"] - want["terms"]["collective"] + port, rel=REL)
    else:
        assert got["wall_us"] == pytest.approx(want["wall_us"], rel=REL)


@pytest.mark.parametrize("N,v", [(64, 8), (256, 32), (1024, 16), (16384, 64)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_in_core_predict_wall_without_gather_fits_matches_jax(N, v, compute):
    cfg = SolverConfig(compute_dtype=compute)
    keys = (("ref", cfg.effective_compute_dtype),)
    got = tcm.predict_wall(N, cfg, v=v, backend="ref", calibration=_table(tcm, keys),
                           device="cpu")
    want = jcm.predict_wall(N, cfg, v=v, backend="ref", calibration=_table(jcm, keys))
    assert got["terms"] == pytest.approx(want["terms"], rel=REL)
    assert got["wall_us"] == pytest.approx(want["wall_us"], rel=REL)


@pytest.mark.parametrize("N,v", [(64, 8), (256, 32), (1024, 16), (16384, 64)])
def test_in_core_gather_term_is_a_stated_difference(N, v):
    """The port charges two `gather` calls a step (its `index_select` and
    indexed copy), the JAX package two one-hot products (`gather_dense`)."""
    cfg = SolverConfig()
    t_table = _table(tcm, prims=tcm.PRIMITIVES)
    got = tcm.predict_wall(N, cfg, v=v, backend="ref", calibration=t_table, device="cpu")
    j_table = _table(jcm, prims=jcm.PRIMITIVES)
    want = jcm.predict_wall(N, cfg, v=v, backend="ref", calibration=j_table)
    gather = t_table.fits("ref", "float32")["gather"].predict(v * N)
    assert want["terms"]["gather"] == 0.0 and want["terms"]["gather_dense"] > 0
    assert got["terms"]["gather_dense"] == 0.0
    assert got["terms"]["gather"] == pytest.approx(2 * (N // v) * gather, rel=REL)
    expected = want["wall_us"] - want["terms"]["gather_dense"] + 2 * (N // v) * gather
    assert got["wall_us"] == pytest.approx(expected, rel=REL)


@pytest.mark.parametrize("N", CASES.AUTO_NS)
def test_autotune_choice_matches_jax_through_the_shim(N, jax_side):
    paths, res = jax_side
    choice = tcm.autotune_choice(N, SolverConfig(), n_dev=1,
                                 calibration=tcm.load_calibration(paths["auto"]), device="cpu")
    want = res["auto"][str(N)]
    got = {k: choice[k] for k in want}
    assert got.pop("predicted_wall_us") == pytest.approx(want.pop("predicted_wall_us"), rel=REL)
    assert got == want
    assert choice["source"] == "calibrated" and choice["n_scored"] >= 1


@pytest.mark.parametrize("N", CASES.AUTO_NS)
def test_resolve_auto_matches_jax_through_the_shim(N, jax_side, restore_calibration):
    paths, res = jax_side
    tcm.set_calibration(paths["auto"])
    r = resolve(N, SolverConfig(), device="cpu")
    decision = tcm.get_decision(r.cache_key(N))
    want = dict(res["resolve"][str(N)])
    got = {"strategy": r.strategy, "v": r.v, "backend": r.backend, "hotloop": r.hotloop,
           "calibration": r.calibration}
    assert decision["predicted_wall_us"] == pytest.approx(want.pop("predicted_wall_us"), rel=REL)
    assert got == want


def test_the_jax_tables_picks_vary_with_N(jax_side):
    """The shim's table is not degenerate: its picks differ across N."""
    _, res = jax_side
    assert len({res["resolve"][str(N)]["v"] for N in CASES.AUTO_NS}) > 1


@pytest.mark.parametrize("P", [4, 8])
def test_multi_rank_autotune_choice_matches_jax(P):
    """More than one rank: the 2.5D grids x hotloop x backend, ranked by the
    predicted wall (a table without a collective term, so the JAX side needs
    no `repro.api`)."""
    keys = (("ref", "float32"),)
    cfg = SolverConfig(M=2.0**14)
    got = tcm.autotune_choice(256, cfg, n_dev=P, calibration=_table(tcm, keys, tcm.PRIMITIVES),
                              device="cpu")
    want = jcm.autotune_choice(256, cfg, n_dev=P, calibration=_table(jcm, keys, jcm.PRIMITIVES))
    for k in ("strategy", "v", "backend", "hotloop", "n_scored"):
        assert got[k] == want[k], k
    shape = ("Px", "Py", "c", "v", "N")
    assert [getattr(got["grid"], a) for a in shape] == [getattr(want["grid"], a) for a in shape]
    assert got["predicted_wall_us"] == pytest.approx(want["predicted_wall_us"], rel=REL)


def test_backend_screen_uses_the_hopper_constraints():
    cfg = SolverConfig()
    assert tcm._backend_candidates(cfg, 32, "float32", "cpu") == ["cuda", "ref"]
    assert tcm._backend_candidates(cfg, 128, "bfloat16", "cpu") == ["cuda", "ref"]
    assert tcm._backend_candidates(cfg, 256, "float32", "cpu") == ["ref"]  # over MAX_PANEL_WIDTH


CARD = torch.device("cuda")


@pytest.fixture
def card_kind(monkeypatch):
    """A CUDA plan's device kind on a host without a card: the H100's name."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: H100)


@pytest.mark.parametrize("backend, v, dtype, want", [
    ("cuda", 32, "float32", ["cuda"]),
    ("cuda", 128, "bfloat16", ["cuda"]),
    ("cuda", 256, "float32", []),  # over MAX_PANEL_WIDTH: no candidate, never "ref"
    ("ref", 32, "float32", ["ref"]),
    ("ref", 256, "float32", ["ref"]),
])
def test_backend_screen_keeps_the_configs_backend_on_the_card(backend, v, dtype, want):
    cfg = SolverConfig(backend=backend)
    assert tcm._backend_candidates(cfg, v, dtype, CARD) == want


def _card_table(cuda_beta: float, ref_beta: float, keys=(("cuda", "float32"), ("ref", "float32"))):
    betas = {"cuda": cuda_beta, "ref": ref_beta}
    tables = {k: {p: tcm.PrimitiveFit(0.0, betas[k[0]]) for p in tcm.PRIMITIVES} for k in keys}
    return tcm.Calibration(tcm.content_version(tables, None, "card"), H100, tables)


def test_calibrated_auto_on_the_card_keeps_the_kernels(card_kind, restore_calibration):
    """On a CUDA plan the pick keeps `config.backend`, even where the table
    prices the plain versions cheaper; on a CPU plan it may change it."""
    tcm.set_calibration(_card_table(cuda_beta=9e-6, ref_beta=1e-6))
    r = resolve(64, SolverConfig(), device=CARD)
    assert (r.backend, r.calibration) == ("cuda", tcm.active_calibration().version)
    assert resolve(64, SolverConfig(backend="cuda"), device=CARD).backend == "cuda"
    assert resolve(64, SolverConfig(backend="ref"), device=CARD).backend == "ref"
    tcm.set_calibration(_card_table(cuda_beta=9e-6, ref_beta=1e-6, keys=(("ref", "float32"),)))
    r = resolve(64, SolverConfig(), device=CARD)  # no kernel fits: the analytic pick
    assert (r.backend, r.calibration) == ("cuda", None)


@pytest.mark.parametrize("keys", [(("cuda", "float32"), ("ref", "float32")), (("ref", "float32"),)])
def test_calibrated_auto_on_the_card_raises_on_a_width_the_kernels_refuse(
        keys, card_kind, restore_calibration):
    """A width over the kernels' limit raises on a CUDA plan, as without a
    table, where a table that covers the plain versions could price them."""
    tcm.set_calibration(_card_table(cuda_beta=1e-6, ref_beta=1e-6, keys=keys))
    with pytest.raises(ValueError, match="got v=256"):
        resolve(512, SolverConfig(v=256), device=CARD)
    with pytest.raises(ValueError, match="got v=256"):
        resolve(512, SolverConfig(backend="cuda", v=256), device=CARD)


def test_sequential_v_candidates():
    assert tcm._sequential_v_candidates(64, None) == [8, 16, 32, 64]
    assert tcm._sequential_v_candidates(48, None) == [8, 16, 24]
    assert tcm._sequential_v_candidates(12, None) == [12]
    assert tcm._sequential_v_candidates(64, 16) == [16]


# --------------------------------------------------------------------------
# The device kind: a table prices only plans on the device kind it was fitted on
# --------------------------------------------------------------------------


def test_device_kind_of_the_cpu():
    assert tcm.device_kind("cpu") == "cpu"
    assert tcm.device_kind(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        assert tcm.device_kind(None) == "cpu"


def test_predict_wall_prices_only_its_device_kind():
    cfg = SolverConfig()
    cpu, card = _synthetic(tcm), _synthetic(tcm, device_kind=H100)
    assert tcm.predict_wall(64, cfg, v=16, calibration=cpu, device="cpu") is not None
    assert tcm.predict_wall(64, cfg, v=16, calibration=card, device="cpu") is None
    assert tcm.autotune_choice(64, cfg, n_dev=1, calibration=card, device="cpu") is None


# --------------------------------------------------------------------------
# The calibrated resolve and its fall-backs (tests/test_costmodel.py's cases)
# --------------------------------------------------------------------------


def test_cache_key_isolated_across_versions(restore_calibration):
    a, b = _synthetic(tcm, beta=1e-6, tag="a"), _synthetic(tcm, beta=9e-6, tag="b")
    assert (SolverConfig(calibration=a.version).cache_key(48)
            != SolverConfig(calibration=b.version).cache_key(48))
    tcm.set_calibration(a)
    pa = plan(48, SolverConfig(strategy="auto"), device="cpu")
    assert pa.config.calibration == a.version
    tcm.set_calibration(b)
    pb = plan(48, SolverConfig(strategy="auto"), device="cpu")
    assert pb.config.calibration == b.version
    assert pa is not pb  # different table versions never share a plan
    tcm.set_calibration(a)
    assert plan(48, SolverConfig(strategy="auto"), device="cpu") is pa  # cache hit
    assert pa.autotune["calibration_version"] == a.version


def test_decision_recorded_on_plan(restore_calibration):
    tcm.set_calibration(_synthetic(tcm, tag="rec"))
    p = plan(48, SolverConfig(strategy="auto"), device="cpu")
    assert p.autotune is not None
    assert p.autotune["source"] == "calibrated"
    assert p.autotune["predicted_wall_us"] > 0
    assert p.autotune["calibration_version"] == p.config.calibration
    assert (p.config.strategy, p.config.v, p.config.backend) == (
        p.autotune["strategy"], p.autotune["v"], p.autotune["backend"])
    explicit = plan(48, SolverConfig(strategy="sequential", v=16), device="cpu")
    assert explicit.autotune is None


def test_calibrated_auto_picks_the_backend_too(restore_calibration):
    """As in the JAX package, the pick overrides `config.backend`."""
    fits = {p: tcm.PrimitiveFit(0.0, 1e-6) for p in tcm.PRIMITIVES}
    tables = {("ref", "float32"): fits}
    tcm.set_calibration(tcm.Calibration(tcm.content_version(tables, None, "r"), "cpu", tables))
    assert resolve(64, SolverConfig(backend="cuda"), device="cpu").backend == "ref"


def test_disabled_calibration_falls_back_to_analytic(restore_calibration):
    tcm.set_calibration(None)
    resolved = resolve(48, SolverConfig(strategy="auto"), device="cpu")
    analytic = _resolve_auto_analytic(48, SolverConfig(strategy="auto"), 1)
    assert resolved.calibration is None
    assert (resolved.strategy, resolved.v, resolved.backend) == (
        analytic.strategy, analytic.v, analytic.backend)


@pytest.mark.parametrize("kind", ["tpu", H100])
def test_foreign_device_table_falls_back(kind, restore_calibration):
    """A table fitted on another device kind never prices a CPU plan (the
    card's table included, on the card's own host)."""
    tcm.set_calibration(_synthetic(tcm, device_kind=kind))
    assert resolve(48, SolverConfig(strategy="auto"), device="cpu").calibration is None
    assert plan(48, SolverConfig(), device="cpu").autotune is None


def test_uncovered_dtype_falls_back(restore_calibration):
    tcm.set_calibration(_synthetic(tcm, keys=(("ref", "float64"),)))  # no float32 table
    assert resolve(48, SolverConfig(strategy="auto"), device="cpu").calibration is None
    f64 = resolve(48, SolverConfig(dtype="float64"), device="cpu")
    assert f64.calibration is not None and f64.backend == "ref"


def test_batched_and_explicit_grid_bypass_the_table(restore_calibration):
    tcm.set_calibration(_synthetic(tcm, tag="bypass"))
    assert resolve(32, SolverConfig(B=4), device="cpu").calibration is None
    grid = GridConfig(1, 1, 1, 8, 64)
    r = resolve(64, SolverConfig(grid=grid), device="cpu")
    assert (r.strategy, r.grid, r.calibration) == ("conflux", grid, None)


def test_execute_stamps_measured_wall(restore_calibration):
    tcm.set_calibration(_synthetic(tcm, tag="stamp"))
    p = plan(48, SolverConfig(strategy="auto"), device="cpu")
    rng = np.random.default_rng(3)
    A = rng.standard_normal((48, 48)).astype(np.float32) + 48 * np.eye(48, dtype=np.float32)
    fact = p.execute(A)
    assert fact.autotune is not None
    assert fact.autotune["measured_wall_us"] > 0
    assert fact.autotune["wall_residual"] == pytest.approx(
        (fact.autotune["measured_wall_us"] - fact.autotune["predicted_wall_us"])
        / fact.autotune["predicted_wall_us"])
    assert fact.autotune["grid"] == "None"
    report = fact.comm_report()
    assert "autotune (calibrated, calibration" in report and "predicted" in report
    assert "residual" in report


# --------------------------------------------------------------------------
# The search path: the port's own variable and file, never the JAX package's
# --------------------------------------------------------------------------


def test_port_ignores_the_jax_packages_table(tmp_path, monkeypatch):
    jax_table = _synthetic(tcm, tag="jaxtable")
    jax_table.save(str(tmp_path / "calibration.json"))
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "calibration.json"))
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION", raising=False)
    monkeypatch.chdir(tmp_path)
    loaded = tcm.load_calibration()
    assert loaded is None or loaded.version != jax_table.version
    default = tcm.load_calibration(tcm._DEFAULT_TABLE)
    assert (loaded and loaded.version) == (default and default.version)


def test_port_reads_its_own_variable_then_file(tmp_path, monkeypatch):
    env_table, cwd_table = _synthetic(tcm, tag="env"), _synthetic(tcm, tag="cwd")
    env_table.save(str(tmp_path / "env.json"))
    cwd_table.save(str(tmp_path / "calibration_torch.json"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "env.json"))
    assert tcm.load_calibration().version == env_table.version
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION")
    assert tcm.load_calibration().version == cwd_table.version
    (tmp_path / "calibration_torch.json").write_text('{"schema": "other"}')
    fallback = tcm.load_calibration()  # a foreign artifact: on to the next candidate
    assert fallback is None or fallback.version not in (env_table.version, cwd_table.version)
    with pytest.raises(FileNotFoundError):
        tcm.set_calibration(str(tmp_path / "missing.json"))


# --------------------------------------------------------------------------
# The committed table and the tool that fits it
# --------------------------------------------------------------------------


def test_committed_table_was_fitted_on_the_card():
    table = tcm.load_calibration(tcm._DEFAULT_TABLE)
    assert table is not None
    assert table.device_kind.startswith("NVIDIA"), table.device_kind
    for combo in tcal.COMBOS:
        assert table.covers(*combo), combo
        keys = set(table.fits(*combo))
        assert {tcm.split_key(k)[0] for k in keys} == set(tcm.PRIMITIVES)
        # The kernels' fits are per body (F7); the plain versions have one.
        bodies = {tcm.split_key(k)[1] for k in keys}
        assert (bodies == {"any"}) == (combo[0] == "ref"), (combo, keys)
    assert table.collective is None  # one card: no collective fit
    swept = {tuple(s) for s in table.meta["sweep"]}
    assert {(N, v) for N in (1024, 4096, 16384) for v in (8, 16, 32, 64)} <= swept
    assert table.meta["card"].startswith(table.device_kind)
    assert "W" in table.meta["card"]  # the power limit
    assert table.meta["alpha_scale"] >= 0
    tables = table.tables
    assert table.version == tcm.content_version(tables, None, table.version.rsplit("-", 1)[0])
    # Fits with bytes and bodies: the port's own schema, which the JAX
    # package refuses (a table of its kind would load in both, see
    # test_a_reference_kind_table_hashes_and_saves_as_the_jax_packages).
    assert table.schema == tcm.CALIB_SCHEMA_V2
    assert jcm.load_calibration(tcm._DEFAULT_TABLE) is None
    # The guard's rows, timed on the card before the table was written:
    # every guarded cell within 1.25x of v = 32's wall and the fastest width's.
    rows = table.meta["guard"]
    assert {(r["N"], r["compute_dtype"]) for r in rows} == set(tcal.GUARD)
    assert all(r["ok"] and tcal.guard_ok(r) for r in rows)


def test_calibrate_fits_a_table_on_the_cpu(tmp_path):
    out = str(tmp_path / "table.json")
    calib = tcal.calibrate(out_path=out, combos=(("cuda", "float32"), ("ref", "bfloat16")),
                           shapes=((32, 8), (64, 16)), probes=((64, 16),), repeats=1,
                           device="cpu", guard=())
    loaded = tcm.load_calibration(out)
    assert loaded.to_json() == calib.to_json()
    assert loaded.device_kind == "cpu"
    assert loaded.covers("cuda", "float32") and loaded.covers("ref", "bfloat16")
    assert set(loaded.fits("cuda", "float32")) == set(tcm.PRIMITIVES)
    assert loaded.meta["sweep"] == [[32, 8], [64, 16]]
    assert loaded.meta["alpha_probes"] == [[64, 16]]
    assert loaded.meta["card"] is None and loaded.collective is None
    assert loaded.version.startswith("full-")
    json.loads(Path(out).read_text())  # plain JSON


@pytest.mark.parametrize("ratio, written", [(1.0, True), (1.25, True), (1.2501, False), (2.0, False)])
def test_calibrate_refuses_a_table_whose_guarded_pick_is_slow(ratio, written, tmp_path,
                                                              monkeypatch):
    """The guard writes the table only where the pick is within
    AUTOTUNE_TOLERANCE of v = 32's wall at every guarded cell."""
    seen = []

    def fake(n, dtype="float32", widths=(32,), rounds=3, device=None, seed=26):
        seen.append((n, dtype, tcm.active_calibration().version))
        return {"N": n, "compute_dtype": dtype, "pick": {"v": 16}, "best_s": {"auto": ratio,
                "v=32": 1.0}, "auto_over_analytic": ratio, "fastest": "v=32",
                "auto_over_fastest": ratio}

    monkeypatch.setattr(tcal, "auto_against_widths", fake)
    out = tmp_path / "table.json"
    kw = dict(out_path=str(out), combos=(("cuda", "float32"),), shapes=((32, 8), (64, 16)),
              probes=((64, 16),), repeats=1, device="cpu",
              guard=((64, "float32"), (64, "bfloat16")))  # bf16 uncovered: not timed
    if written:
        calib = tcal.calibrate(**kw)
        assert tcm.load_calibration(str(out)).meta["guard"] == calib.meta["guard"]
        assert calib.meta["guard"][0]["ok"] is True
    else:
        with pytest.raises(tcal.CalibrationRefused):
            tcal.calibrate(**kw)
        assert not out.exists()
    assert [(n, d) for n, d, _ in seen] == [(64, "float32")]
    assert seen[0][2].startswith("full-")  # the table under test is active while timed


def test_auto_against_widths_on_the_cpu(restore_calibration):
    table = _synthetic(tcm, tag="widths")
    tcm.set_calibration(table)
    row = tcal.auto_against_widths(64, "float32", (16, 32), rounds=2, device="cpu")
    assert set(row["walls_s"]) == {"auto", "v=16", "v=32"}
    assert all(len(w) == 2 for w in row["walls_s"].values())
    assert row["auto_over_analytic"] == min(row["walls_s"]["auto"]) / min(row["walls_s"]["v=32"])
    assert row["calibration"] == table.version and row["measured_wall_us"] > 0
    assert row["wall_residual"] == pytest.approx(
        (row["measured_wall_us"] - row["predicted_wall_us"]) / row["predicted_wall_us"])


@pytest.mark.parametrize("rounds", [1, 3, tcal.GUARD_ROUNDS])
def test_auto_against_widths_times_exactly_rounds_executes_after_one_warm(
        rounds, restore_calibration, monkeypatch):
    """Each plan (the pick and every width) executes once to warm up, then
    exactly `rounds` times, interleaved (the order reversed every other
    round); each plan's walls are its `rounds` timed executes, its spread
    their max over their min.  The guard's default is the JAX validation's
    7 rounds.  N = 32 on the CPU: the plain path."""
    from repro_torch.api.plan import FactorizationPlan

    tcm.set_calibration(_synthetic(tcm, tag="rounds"))
    calls = []
    execute = FactorizationPlan.execute

    def counted(p, A):
        calls.append(p)
        return execute(p, A)

    monkeypatch.setattr(FactorizationPlan, "execute", counted)
    row = tcal.auto_against_widths(32, "float32", (8, 16, 32), rounds=rounds, device="cpu")
    keys = ["auto", "v=8", "v=16", "v=32"]
    plans = calls[:len(keys)]  # the warm executes, one a plan in order
    assert len({id(p) for p in plans}) == len(keys)
    timed = [keys[plans.index(p)] for p in calls[len(keys):]]
    want = [k for r in range(rounds) for k in (keys if r % 2 == 0 else keys[::-1])]
    assert timed == want
    assert {k: len(w) for k, w in row["walls_s"].items()} == dict.fromkeys(keys, rounds)
    assert row["spread"] == {k: max(w) / min(w) for k, w in row["walls_s"].items()}
    assert all(v >= 1.0 for v in row["spread"].values())
    assert tcal.GUARD_ROUNDS == 7
    assert inspect.signature(tcal.check_guard).parameters["rounds"].default == tcal.GUARD_ROUNDS


def _alpha_table(scale: float):
    fits = {p: tcm.PrimitiveFit(16.0, 1e-4) for p in tcm.PRIMITIVES}
    base = tcm.Calibration("a-0", "cpu", {("cuda", "float32"): fits}, meta={})
    return tcal._scale_alphas(base, scale)


def _pick(calib, n):
    return tcm.autotune_choice(n, SolverConfig(), n_dev=1, calibration=calib, device="cpu")["v"]


def test_pick_alpha_range_brackets_the_pick():
    table = _alpha_table(1.0)
    r = tcal.pick_alpha_range(table, 1024, "float32", "cpu")
    assert r["v"] == _pick(table, 1024) and r["alpha_scale"] == 1.0
    assert 0 < r["lo"] < 1 < r["hi"], r  # a middle width: both edges
    assert _pick(_alpha_table(0.999 * r["lo"]), 1024) != r["v"]
    assert _pick(_alpha_table(1.001 * r["lo"]), 1024) == r["v"]
    assert _pick(_alpha_table(0.999 * r["hi"]), 1024) == r["v"]
    assert _pick(_alpha_table(1.001 * r["hi"]), 1024) != r["v"]
    # the range is the table's, whatever scale it was fitted with
    assert tcal.pick_alpha_range(_alpha_table(r["lo"] * 1.5), 1024, "float32", "cpu")["lo"] == (
        pytest.approx(r["lo"], rel=1e-12))


def test_probe_picks_compare_the_pick_with_v32():
    table = _alpha_table(1.0)
    v = _pick(table, 1024)
    walls = {8: 400.0, 16: 200.0, 32: 100.0, 64: 50.0}
    rows = [[1024, w, t, 0.0, 0.0] for w, t in walls.items()]
    assert tcal._probe_picks(table, rows, "cpu") == [[1024, v, walls[v] / 100.0]]
    assert tcal._probe_picks(table, rows[:1], "cpu") == []  # v = 32 not probed


def test_scale_alphas_rehashes_the_version():
    calib = _table(tcm, prims=tcm.PRIMITIVES)
    scaled = tcal._scale_alphas(calib, 0.5)
    f, g = calib.fits("ref", "float32")["panel"], scaled.fits("ref", "float32")["panel"]
    assert g.alpha_us == 0.5 * f.alpha_us and g.beta_us == f.beta_us
    assert scaled.version != calib.version and scaled.version.startswith("t-")
    assert scaled.meta["alpha_scale"] == 0.5


# --- F7: fits that see bytes and the kernel body each step takes. -----------

@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16", "float16"])
@pytest.mark.parametrize("v", [1, 4, 8, 16, 32, 33, 64, 128])
def test_kernel_body_follows_each_launchers_rule(dtype, v):
    from repro_torch.kernels import chol_panel, fused_schur, lu_panel, schur_update, trsm

    dt = getattr(torch, dtype)
    M = C = 64

    def body(prim, **kw):
        return tcm.kernel_body(prim, dtype, v, "cuda", device=CARD, **kw)

    A = torch.zeros(M, C, dtype=dt)
    assert body("fused") == fused_schur.stream_mode(
        A, torch.zeros(v, v, dtype=dt), torch.zeros(v, C, dtype=dt), torch.zeros(M, v, dtype=dt))
    assert body("schur") == schur_update.stream_mode(
        A, torch.zeros(M, v, dtype=dt), torch.zeros(v, C, dtype=dt))
    assert body("trsm", kind="cholesky") == trsm.right_mode(
        torch.zeros(M, v, dtype=dt), torch.zeros(v, v, dtype=dt))
    assert body("trsm") == trsm.left_mode(torch.zeros(v, v, dtype=dt))
    assert body("panel", kind="cholesky") == chol_panel.body(v)
    for rows in (256, 1024, 4096, 16384, 10**6):
        assert body("panel", rows=rows) == lu_panel.panel_mode(rows, v, dt)
        assert body("panel", rows=rows, batched=True) == lu_panel.panel_mode(
            rows, v, dt, batched=True)
    for prim in ("gather", "gather_dense"):
        assert body(prim) == "any"
    # The plain versions and CPU plans have one body.
    assert tcm.kernel_body("fused", dtype, v, "ref", device=CARD) == "any"
    assert tcm.kernel_body("fused", dtype, v, "cuda", device="cpu") == "any"


def test_the_path_bodies_of_fault_f7():
    """f32 at N = 4096: the stream for v <= 32, the plain loads at v = 64."""
    assert [tcm.kernel_body("fused", "float32", v, "cuda", device=CARD)
            for v in (8, 16, 32, 64)] == ["tma", "tma", "tma", "plain"]
    assert [tcm.kernel_body("panel", "float32", v, "cuda", rows=4096, device=CARD)
            for v in (8, 16, 32, 64)] == ["grid", "grid", "grid", "generic"]
    assert tcm.kernel_body("fused", "bfloat16", 64, "cuda", device=CARD) == "plain"
    assert tcm.kernel_body("fused", "float64", 32, "cuda", device=CARD) == "plain"


def test_three_term_fit_recovers_synthetic_constants():
    rng = np.random.default_rng(27)
    flops = rng.uniform(1e6, 1e10, 12)
    nbytes = rng.uniform(1e5, 1e9, 12)
    t = 7.0 + 2e-7 * flops + 3e-6 * nbytes
    fit = tcm.fit_cost([(f, b, x, 0.0) for f, b, x in zip(flops, nbytes, t)])
    assert (fit.alpha_us, fit.beta_us, fit.gamma_us) == pytest.approx((7.0, 2e-7, 3e-6),
                                                                      rel=1e-6)
    assert fit.n_samples == 12 and fit.body == "any"
    # Non-negative: a term that would come out negative is dropped.
    t2 = 7.0 + 2e-7 * flops - 1e-9 * nbytes
    fit2 = tcm.fit_cost([(f, b, x, 0.0) for f, b, x in zip(flops, nbytes, t2)])
    assert min(fit2.alpha_us, fit2.beta_us, fit2.gamma_us) >= 0.0 and fit2.gamma_us == 0.0
    # Noisy samples weigh less.
    noisy = [(f, b, x * (3.0 if i == 0 else 1.0), 9.0 if i == 0 else 0.0)
             for i, (f, b, x) in enumerate(zip(flops, nbytes, t))]
    assert tcm.fit_cost(noisy).predict(1e9, 1e8) == pytest.approx(
        7.0 + 2e-7 * 1e9 + 3e-6 * 1e8, rel=0.05)
    with pytest.raises(ValueError):
        tcm.fit_cost([(0.0, 0.0, 1.0, 0.0)])


def _byte_bound_table():
    """A card table whose v <= 32 `fused_trsm_schur` bodies are byte-bound
    streams (3.35 TB/s) and whose v = 64 body, the plain loads, runs its flops
    at 10 TFLOP/s: what the H100 does, in round numbers."""
    per_byte, per_flop = 1 / 3.35e6, 1 / 10e6  # us
    fits = {
        "panel@block": tcm.PrimitiveFit(20.0, 0.0, 3, gamma_us=per_byte, body="block"),
        "panel@grid": tcm.PrimitiveFit(20.0, 0.0, 6, gamma_us=per_byte, body="grid"),
        "panel@generic": tcm.PrimitiveFit(200.0, 0.0, 3, gamma_us=per_byte, body="generic"),
        "fused@tma": tcm.PrimitiveFit(10.0, 0.0, 9, gamma_us=per_byte, body="tma"),
        "fused@plain": tcm.PrimitiveFit(10.0, per_flop, 3, body="plain"),
        "gather": tcm.PrimitiveFit(5.0, 0.0, 12, gamma_us=per_byte),
    }
    tables = {("cuda", "float32"): fits}
    return tcm.Calibration(tcm.content_version(tables, None, "bytes"), H100, tables)


@pytest.mark.parametrize("N", [4096, 16384])
def test_a_byte_bound_table_picks_v32(N, card_kind):
    table = _byte_bound_table()
    assert table.schema == tcm.CALIB_SCHEMA_V2
    walls = {v: tcm.predict_wall(N, SolverConfig(backend="cuda"), v=v, backend="cuda",
                                 calibration=table, device=CARD)["wall_us"]
             for v in (8, 16, 32, 64)}
    choice = tcm.autotune_choice(N, SolverConfig(), n_dev=1, calibration=table, device=CARD)
    assert choice["v"] == 32 == min(walls, key=walls.get)
    assert walls[64] > walls[32]


def test_a_body_without_a_fit_leaves_the_candidate_unscored(card_kind):
    table = _byte_bound_table()
    fits = dict(table.fits("cuda", "float32"))
    del fits["fused@plain"]  # no fit of the plain loads, and no body-agnostic one
    tables = {("cuda", "float32"): fits}
    partial = tcm.Calibration(tcm.content_version(tables, None, "nop"), H100, tables)
    cfg = SolverConfig(backend="cuda")
    assert tcm.predict_wall(4096, cfg, v=64, backend="cuda", calibration=partial,
                            device=CARD) is None
    assert tcm.predict_wall(4096, cfg, v=32, backend="cuda", calibration=partial,
                            device=CARD) is not None
    choice = tcm.autotune_choice(4096, SolverConfig(), n_dev=1, calibration=partial,
                                 device=CARD)
    assert choice["n_scored"] == choice["n_candidates"] - 1 and choice["v"] != 64
    # A body-agnostic fit prices every body (a table fitted without bodies).
    fits["fused"] = tcm.PrimitiveFit(10.0, 1e-7)
    agnostic = tcm.Calibration("agnostic-1", H100, {("cuda", "float32"): fits})
    assert tcm.predict_wall(4096, cfg, v=64, backend="cuda", calibration=agnostic,
                            device=CARD) is not None


def test_a_reference_kind_table_hashes_and_saves_as_the_jax_packages(tmp_path):
    samples = {("ref", "float32"): {p: _seeded_samples(i, 6)
                                    for i, p in enumerate(tcm.PRIMITIVES)}}
    t = tcm.fit_calibration(samples, "cpu", tag="full")
    j = jcm.fit_calibration(samples, "cpu", tag="full")
    assert t.version == j.version and t.schema == tcm.CALIB_SCHEMA == jcm.CALIB_SCHEMA
    assert all(f.gamma_us == 0.0 and f.body == "any" for f in t.fits("ref", "float32").values())
    assert t.to_json()["tables"] == j.to_json()["tables"]
    # A fit with a byte term or a body: the port's own schema, and it round-trips.
    key = tcm.fit_key("fused", "tma")
    three = {("cuda", "float32"): {key: [(1e9, 1e8, 50.0, 0.1), (2e9, 3e8, 110.0, 0.0),
                                         (4e9, 2e8, 140.0, 0.2)]}}
    v2 = tcm.fit_calibration(three, "cpu", tag="full")
    fit = v2.fits("cuda", "float32")[key]
    assert fit.body == "tma" and v2.schema == tcm.CALIB_SCHEMA_V2
    path = tmp_path / "v2.json"
    v2.save(str(path))
    back = tcm.load_calibration(str(path))
    assert back.fits("cuda", "float32")[key] == fit and back.version == v2.version


def test_profile_cost_points_are_keyed_by_body():
    p = plan(64, SolverConfig(strategy="sequential", v=16), device="cpu")
    t = p.profile_hotloop(repeats=1)
    bodies = {"panel": "grid", "fused": "tma"}
    pts = tcm.profile_cost_points(t, "lu", 4, bodies)
    assert {"panel@grid", "fused@tma", "trsm", "schur", "gather", "gather_dense"} == set(pts)
    work, nbytes, us, _ = pts["fused@tma"]
    sh = t["shapes"]
    assert work == tcm.primitive_work("fused", "lu", **sh)
    assert nbytes == tcm.primitive_bytes("fused", "lu", itemsize=4, **sh) == 4 * (
        2 * 64 * 64 + 16 * 16 + 2 * 16 * 64 + 64 * 16)
    # On the CPU every wrapper reports no body: the samples are "any".
    tcm.reset_bodies("lu")
    assert set(tcm.observed_bodies("lu").values()) == {"any"}


def test_the_guard_holds_the_pick_to_the_fastest_width(tmp_path, monkeypatch):
    """The stricter guard: within AUTOTUNE_TOLERANCE of v = 32 is not enough
    when another width is faster still."""
    def fake(n, dtype="float32", widths=(32,), rounds=3, device=None, seed=26):
        assert set(widths) == set(tcm._sequential_v_candidates(n, None))
        return {"N": n, "compute_dtype": dtype, "pick": {"v": 32}, "best_s": {},
                "auto_over_analytic": 1.0, "fastest": "v=16", "auto_over_fastest": 1.3}

    monkeypatch.setattr(tcal, "auto_against_widths", fake)
    out = tmp_path / "table.json"
    with pytest.raises(tcal.CalibrationRefused):
        tcal.calibrate(out_path=str(out), combos=(("cuda", "float32"),),
                       shapes=((32, 8), (64, 16)), probes=((64, 16),), repeats=1,
                       device="cpu", guard=((64, "float32"),))
    assert not out.exists()
    assert (4096, "float32") in tcal.GUARD and (16384, "float32") in tcal.GUARD


def test_the_committed_tables_picks_on_the_card(card_kind):
    """F7: the card's table picks v = 32 at N = 4096 as at 16384 (f32,
    bf16), inside its alpha-scale range with room on both sides."""
    table = tcm.load_calibration(tcm._DEFAULT_TABLE)
    for n, dtype in ((4096, "float32"), (16384, "float32"), (16384, "bfloat16")):
        kw = tcal._config_kw(dtype)
        choice = tcm.autotune_choice(n, SolverConfig(**kw), n_dev=1, calibration=table,
                                     device=CARD)
        assert (choice["v"], choice["backend"]) == (32, "cuda"), (n, dtype)
        rng = tcal.pick_alpha_range(table, n, dtype, CARD)
        assert rng["v"] == 32 and rng["lo"] < 0.5 * rng["alpha_scale"]
        assert rng["hi"] is None or rng["hi"] > 2 * rng["alpha_scale"]
