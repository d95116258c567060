"""The port's plan auditor (`repro_torch.analysis.audit`) and the program
trace it reads (`repro_torch.analysis.trace`).

- `python -m repro_torch.analysis.audit` on the CPU, run in a subprocess: its
  eight gloo ranks trace every distributed combo (conflux windowed and flat,
  tournament and partial pivoting, baseline2d, cholesky25d, on 2x2x2 and
  2x2x1 grids at N = 64, v = 8), and every rank's traced bytes equal the
  port's executed model exactly, site by site; the run reports no error.
- The rows' `schedule_bytes` and `lower_bound_bytes` equal the JAX audit's
  (`tests/multidev/jax_audit_cases.py`, the JAX package under the
  `enable_x64` shim in a process of its own).
- The sites where the port's executed model departs from the JAX package's
  are pinned.
- Each rule fires on a seeded violation.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import audit, trace
from repro_torch.api import GridConfig, SolverConfig, plan
from repro_torch.core import collectives

ROOT = Path(__file__).resolve().parents[1]
N, V = 64, 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI (all rules, eight gloo ranks) and the JAX audit rows,
    run at once, each in a subprocess with a time limit."""
    tmp = tmp_path_factory.mktemp("audit")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--device", "cpu",
         "--json", str(tmp / "port.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jax_side = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "multidev" / "jax_audit_cases.py"),
         str(tmp / "jax.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out, _ = port.communicate(timeout=600)
    jout, _ = jax_side.communicate(timeout=600)
    assert jax_side.returncode == 0, jout[-3000:]
    return {"rc": port.returncode, "stdout": out,
            "report": json.loads((tmp / "port.json").read_text()),
            "jax": json.loads((tmp / "jax.json").read_text())}


def _comm(report):
    return [f for f in report["findings"] if f["rule"] == "comm-conformance"]


def test_the_cli_reports_no_error_on_the_cpu(runs):
    assert runs["rc"] == 0, runs["stdout"][-3000:]
    assert runs["report"]["counts"]["error"] == 0
    assert "audit: 0 error(s)" in runs["stdout"]
    rules = {f["rule"] for f in runs["report"]["findings"]}
    assert {"comm-conformance", "mesh-uniformity", "kernel-resources", "kernel-divisibility",
            "kernel-accum", "kernel-check", "cache-key"} <= rules


def test_every_ranks_traced_bytes_equal_the_port_model_exactly(runs):
    dist = [f["data"] for f in _comm(runs["report"]) if f["data"].get("grid")]
    combos = {(d["strategy"], d["backend"], d["hotloop"], d["pivot"], d["compute_dtype"],
               tuple(d["grid_shape"])) for d in dist}
    assert len(combos) == len(audit._distributed_matrix(N, V)) == 14
    assert len(dist) == 8 * len(combos)  # every rank of every combo
    assert {(s, p, tuple(g[:3])) for s, _, _, p, _, g in combos} == {
        ("conflux", "tournament", (2, 2, 2)), ("conflux", "partial", (2, 2, 2)),
        ("conflux", "tournament", (2, 2, 1)), ("baseline2d", "partial", (2, 2, 1)),
        ("cholesky25d", "none", (2, 2, 2))}
    for d in dist:
        assert d["rel_err"] == 0.0 and d["extracted_bytes"] == d["predicted_bytes"], d
        model = {k: x for k, x in d["model"].items() if k != "total" and x}
        assert d["traced_by_site"] == model, d
        grid = GridConfig(*d["grid_shape"], N=N)
        ops = audit.executed_collective_ops(d["kind"], N, grid, d["pivot"], world=d["world"])
        if d["active"]:
            assert d["collectives"] == ops, d
        else:  # an idle rank joins the final gather only
            assert d["collectives"] == 4 + (d["kind"] == "lu"), d
    idle = [d for d in dist if not d["active"]]
    assert idle and all(d["predicted_bytes"] == d["model"]["gather"] > 0 for d in idle)


def test_schedule_and_lower_bound_bytes_equal_the_jax_audits(runs):
    def key(r):
        backend = "cuda" if r["backend"] == "pallas" else r["backend"]
        return (r["strategy"], backend, r["hotloop"], r["compute_dtype"], r["grid"],
                r["pivot"] if r["grid"] else None)

    jax_rows = {key(r): r for r in runs["jax"]["rows"]}
    matched = 0
    for r in runs["report"]["comm_rows"]:
        j = jax_rows.get(key(r))
        if j is None:
            continue  # a combo of the port's matrix only
        assert r["schedule_bytes"] == pytest.approx(j["schedule_bytes"], rel=1e-12), key(r)
        if j["lower_bound_bytes"] is None:
            assert r["lower_bound_bytes"] is None
        else:
            assert r["lower_bound_bytes"] == pytest.approx(j["lower_bound_bytes"], rel=1e-12)
        matched += 1
    assert matched >= 12
    assert runs["jax"]["errors"] == 0


def test_mesh_uniformity_sees_the_windows_by_design(runs):
    mesh = [f for f in runs["report"]["findings"] if f["rule"] == "mesh-uniformity"]
    assert mesh and all(f["severity"] == "info" for f in mesh)
    assert any("window width" in f["detail"] and "windowed" in f["location"] for f in mesh)


# --- The port's executed model against the JAX package's, site by site. ------

G222 = GridConfig(2, 2, 2, V, N)


def _ar(b, g):
    return 2.0 * b * (g - 1) / g if g > 1 else 0.0


def test_port_model_departs_from_jax_at_the_stated_sites():
    steps = N // V
    port = audit.executed_comm_bytes("lu", N, G222, "tournament", "windowed", 4, world=8)
    jax = audit.jax_executed_comm_bytes("lu", N, G222, "tournament", "windowed", 4)
    # The same sites, the same bytes: panel, l10, r01.
    for site in ("panel", "l10", "r01"):
        assert port[site] == jax[site], site
    # The tournament's slab all-reduce over px = 2: twice the ppermutes' payload.
    assert port["pivot"] == steps * _ar(2 * V * (V + 1) * 4, 2) == 2 * jax["pivot"]
    # A00 and its ids in one psum: the JAX package's "a00" + "gids" in f32 ...
    assert port["a00"] == jax["a00"] + jax["gids"]
    # ... and the ids at 8 bytes under f64.
    p64 = audit.executed_comm_bytes("lu", N, G222, "tournament", "windowed", 8, world=8)
    j64 = audit.jax_executed_comm_bytes("lu", N, G222, "tournament", "windowed", 8)
    assert p64["a00"] == steps * _ar(V * (V + 1) * 8, 2) > j64["a00"] + j64["gids"]
    # Partial pivoting: one [Px, v + 2] slab a column.
    pp = audit.executed_comm_bytes("lu", N, G222, "partial", "flat", 4, world=8)
    jp = audit.jax_executed_comm_bytes("lu", N, G222, "partial", "flat", 4)
    assert pp["pivot"] == steps * V * _ar(2 * (V + 2) * 4, 2) != jp["pivot"]
    # 2-byte compute dtypes: the values travel in 2 bytes, the ids in 4.
    pb = audit.executed_comm_bytes("lu", N, G222, "tournament", "windowed", 2, world=8)
    jb = audit.jax_executed_comm_bytes("lu", N, G222, "tournament", "windowed", 2)
    assert pb["panel"] == jb["panel"] / 2 and pb["r01"] == jb["r01"] / 2
    assert pb["pivot"] == port["pivot"]
    # The final gather, which the JAX package's model leaves out: N^2 values,
    # and the pivot order to idle ranks.
    assert "gather" not in jax and port["gather"] == N * N * 4
    g221 = GridConfig(2, 2, 1, V, N)
    assert audit.executed_comm_bytes("lu", N, g221, "tournament", "flat", 4,
                                     world=8)["gather"] == N * N * 4 + 8 * N
    assert audit.executed_comm_bytes("cholesky", N, g221, "none", "flat", 4,
                                     world=8)["gather"] == N * N * 4
    # Totals of the CLI's 2x2x2 f32 conflux (traced on eight gloo ranks).
    assert port["total"] == 48128.0 and jax["total"] == 29440.0


def test_cost_model_prices_the_ports_collectives():
    from repro_torch.analysis import costmodel as cm

    fits = {p: cm.PrimitiveFit(1.0, 1e-6) for p in cm.PRIMITIVES}
    calib = cm.Calibration("t-1", "cpu", {("ref", "float32"): fits},
                           collective=cm.PrimitiveFit(5.0, 1e-3))
    got = cm.predict_wall(N, SolverConfig(), grid=G222, backend="ref", calibration=calib,
                          device="cpu")
    wire = audit.executed_comm_bytes("lu", N, G222, "tournament", "windowed", 4)["total"]
    ops = audit.executed_collective_ops("lu", N, G222, "tournament")
    assert got["terms"]["collective"] == pytest.approx(5.0 * ops + 1e-3 * wire)


# --- The trace. -----------------------------------------------------------------

def test_the_trace_counts_launches_and_steps_and_is_cached():
    p = plan(N, SolverConfig(strategy="sequential", v=V), device="cpu")
    text = p.lowered_text("trace")
    rep = trace.analyze_trace(text)
    assert rep["launches"] == {"lu_panel": N // V, "fused_trsm_schur": N // V}
    assert rep["steps"] == N // V and rep["collectives"] == 0 and rep["wire_bytes"] == 0
    assert rep["bodies"]["lu_panel"] == {"cpu": N // V}
    assert p.lowered_text() is text
    ref = plan(N, SolverConfig(strategy="sequential", v=V, backend="ref"), device="cpu")
    assert trace.analyze_trace(ref.lowered_text())["launches"] == {}
    chol = plan(N, SolverConfig(strategy="sequential_chol", v=V), device="cpu")
    assert set(trace.analyze_trace(chol.lowered_text())["launches"]) == {
        "chol_panel", "trsm_right_upper", "schur_update"}
    assert collectives.RECORDER is None


@pytest.mark.parametrize("stage", ["hlo", "stablehlo"])
def test_lowered_text_of_the_jax_stages_raises(stage):
    p = plan(N, SolverConfig(strategy="sequential", v=V), device="cpu")
    with pytest.raises(ValueError, match="'trace'"):
        p.lowered_text(stage)


def test_run_audit_in_process_on_the_cpu_is_clean():
    report = audit.run_audit(N=N, v=V, device="cpu", world=0)
    assert not report.errors, [f.detail for f in report.errors]
    assert [f.location for f in report.warnings] == ["ranks"]  # the skipped combos
    resources = [f for f in report.findings if f.rule == "kernel-resources"]
    assert len(resources) == 1 and "needs the card" in resources[0].detail
    out = audit.bench_audit_rows(N=N, v=V, device="cpu", world=0)
    assert out["errors"] == 0 and len(out["rows"]) == len(audit._in_core_matrix(V))


# --- One seeded violation per rule. ---------------------------------------------

def _synthetic(events_per_rank):
    """Trace texts from [(kind, site, ranks, shape, root)] per rank."""
    texts = []
    for events in events_per_rank:
        rec = trace.Recorder()
        for kind, site, ranks, shape, root in events:
            n = 1
            for d in shape:
                n *= d
            rec.collective(kind=kind, site=site, axes=["px"], ranks=ranks, shape=list(shape),
                           dtype="float32", nbytes=4 * n, root=root)
        texts.append(rec.text())
    return texts


def _errors(findings, rule):
    return [f for f in findings if f.rule == rule and f.severity == "error"]


def test_seeded_collective_in_an_in_core_plan():
    p = plan(N, SolverConfig(strategy="sequential", v=V), device="cpu")
    text = _synthetic([[("all_reduce", "panel", [0, 1], (N, V), None)]])[0]
    findings, _ = audit.check_comm_conformance(p, text=text)
    assert _errors(findings, "comm-conformance")
    findings, _ = audit.check_comm_conformance(p)  # the real trace
    assert not _errors(findings, "comm-conformance")


def test_seeded_rank_that_skips_a_collective():
    both = [("all_reduce", "panel", [0, 1], (N, V), None),
            ("all_reduce", "l10", [0, 1], (N, V), None)]
    assert not _errors(audit.check_mesh_uniformity(_synthetic([both, both]), "x"),
                       "mesh-uniformity")
    texts = _synthetic([both, both[:1]])
    assert _errors(audit.check_mesh_uniformity(texts, "x"), "mesh-uniformity")


def test_seeded_rank_in_a_different_group():
    mine = [("all_reduce", "panel", [0, 1], (N, V), None)]
    other = [("all_reduce", "panel", [1, 2], (N, V), None)]
    texts = _synthetic([mine, other, other])
    assert _errors(audit.check_mesh_uniformity(texts, "x"), "mesh-uniformity")


def test_window_widths_across_steps_are_info():
    seq = [("all_reduce", "r01", [0, 1], (V, w), None) for w in (64, 32, 16)]
    findings = audit.check_mesh_uniformity(_synthetic([seq, seq]), "x")
    assert [f.severity for f in findings] == ["info"] and "window" in findings[0].detail


def _resource_row(**kw):
    row = {"source": "s", "kernel": "k<f32>", "dtype": "f32", "registers": 64,
           "static_smem": 1024, "dynamic_smem": 0, "spill_bytes": 0, "max_threads": 256,
           "block": 256}
    row.update(kw)
    return row


@pytest.mark.parametrize("kw,severity", [
    ({}, "info"),
    ({"static_smem": 200000, "dynamic_smem": 40000}, "error"),  # over 232,448 B a block
    ({"registers": 256}, "error"),  # over 255 a thread
    ({"registers": 255, "block": 512, "max_threads": 512}, "error"),  # over 65,536 an SM
    ({"block": 512}, "error"),  # over the instance's launch bound
    ({"spill_bytes": 8}, "warning"),
])
def test_seeded_kernel_over_budget(kw, severity):
    findings = audit.check_kernel_resources(rows=[_resource_row(**kw)])
    assert [f.severity for f in findings] == [severity]


def test_kernel_resources_on_the_cpu_needs_the_card():
    findings = audit.check_kernel_resources("cpu")
    assert [(f.severity, f.detail.split(":")[0]) for f in findings] == [
        ("info", "needs the card")]


def test_seeded_misaligned_operand():
    def misaligned(name, shapes, dtype, device):
        ops = audit._case_inputs(name, shapes, dtype, device)
        if name == "fused_trsm_schur":
            A = ops[0]
            buf = torch.empty(A.numel() + 1, dtype=A.dtype)
            ops[0] = buf[1:].view(A.shape).copy_(A)  # off a 16-byte boundary
        return ops

    findings = audit.check_kernel_divisibility(operands_fn=misaligned)
    bad = _errors(findings, "kernel-divisibility")
    assert {f.location for f in bad} == {"fused_trsm_schur[float32]",
                                         "fused_trsm_schur[bfloat16]"}
    assert bad[0].data["body"] == "plain"
    assert not _errors(audit.check_kernel_divisibility(), "kernel-divisibility")


def test_seeded_2byte_accumulator():
    def bf16_sum(A, L, U):
        acc = A.clone()
        for k in range(L.shape[-1]):  # a running sum kept in the 2-byte dtype
            acc = acc - L[:, k:k + 1] * U[k:k + 1, :]
        return acc

    findings = audit.check_kernel_accum(fns={"schur_update": bf16_sum})
    assert {f.location for f in _errors(findings, "kernel-accum")} == {
        "schur_update[bfloat16]", "schur_update[float16]"}
    assert not _errors(audit.check_kernel_accum(), "kernel-accum")


def test_seeded_key_with_a_dropped_field():
    cfg = SolverConfig(strategy="sequential", v=8)
    assert not _errors(audit.check_cache_keys(32, cfg, device="cpu"), "cache-key")
    dropped = audit.check_cache_keys(32, cfg, key_fn=lambda c, n: c.with_(v=8).cache_key(n),
                                     device="cpu")
    assert [f.data["field"] for f in _errors(dropped, "cache-key")] == ["v"]
