"""Plan auditor: comm-model conformance, mesh uniformity, the kernels'
resources and rules, and cache-key aliasing (`python -m
repro_torch.analysis.audit`).

The paper's claim — COnfLUX moves N^3/(P*sqrt(M)) elements per processor,
within 1/3x of the X-partitioning lower bound — is checked here against the
program each plan runs.  The JAX package reads that program from the lowered
StableHLO without running it; PyTorch emits none, so the port runs each plan
once and reads its trace (`FactorizationPlan.lowered_text("trace")`,
`repro_torch.analysis.trace`).  A suite of checkers emits `AuditFinding`s.

Rules:
  comm-conformance    the traced per-device collective bytes must match the
                      port's executed-schedule model (below) within
                      `tolerance` (the count is exact; the tolerance is the
                      JAX package's); the instrumented schedule volume and
                      the X-partitioning lower bound are reported alongside.
                      In-core (sequential) plans must issue no collective.
  mesh-uniformity     every rank of a process group issues the same sequence
                      of collectives on it (kind, root, dtype): the invariant
                      that keeps the schedule free of deadlock.  Payload
                      shapes that differ only by the trailing window are
                      reported at info.
  kernel-resources    registers, static and dynamic shared memory and local
                      memory (spills) of every kernel instance each
                      `csrc/*.cu` launcher can take, read with
                      `cudaFuncGetAttributes`, against Hopper's budgets.
                      Needs the card; on the CPU it adds one info finding.
  kernel-divisibility each `_kernel_cases` case passes the kernels' plan
                      screen and the launchers' operand rules, and takes the
                      body that the cost model's `kernel_body` predicts.
  kernel-accum        each 2-byte entry point accumulates in f32: on an input
                      whose exact answer a 2-byte accumulator loses, it must
                      stay within the 2-byte tolerance of its plain version
                      (on the card; on the CPU the plain version against the
                      exact answer).
  kernel-check        (on the card) the twelve solver kernels at
                      `_kernel_cases`' shapes in f32 and bf16, each against
                      its plain version.
  cache-key           perturbing a SolverConfig field must not produce a
                      different program under an unchanged cache_key.

The *executed* comm model.  Every rank joins every collective of a step with
a masked payload, so the executed bytes exceed the instrumented schedule
volume (`lu_comm_volume` / `chol_comm_volume`, which count only the
processors the paper's schedule has communicating).  `executed_comm_bytes`
counts the port's own collectives (ring all-reduce wire 2 S (g - 1) / g per
member, a broadcast's payload per member) and matches the trace exactly.  It
departs from the JAX package's model, `jax_executed_comm_bytes`, at these
sites:

- "pivot", tournament: the butterfly exchange rides on `LuMesh.gather_px`,
  the all-reduce of a zeroed [Px, v, v + 1] slab over px, once per round
  (`core/lu/conflux.py::tournament`), where the JAX package permutes the
  [v, v] candidates and their [v] ids (wire = payload, two ppermutes);
- "pivot", partial: one slab all-reduce of [Px, v + 2] per column (|max|,
  its owner and the pivot row in one payload), where the JAX package reduces
  three payloads;
- "a00": A00 and its pivot ids in one [v, v + 1] psum over py
  (`pivot_panel`), where the JAX package counts them as "a00" and "gids";
- the pivot ids travel as floats of at least 4 bytes (f64 under an f64
  plan), where the JAX package's are int32;
- 2-byte compute dtypes: the values travel in 2 bytes (the collectives carry
  the factors' own dtype), where the JAX package's carry f32 partials;
- "gather": the final `gather_blocks` (one broadcast of each [R, C] block
  over the default group) and, when ranks idle, the pivot order's broadcast
  (`broadcast_from_first`), which the JAX package's model does not count.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field

from repro_torch.analysis.trace import _ar
from repro_torch.core.windows import window_bucket_index, window_buckets

SEVERITIES = ("error", "warning", "info")

# The comm-conformance tolerance, the JAX package's.  The port counts its own
# collectives, so the model is exact and every plan's error is 0.
DEFAULT_TOLERANCE = 0.25

# Hopper's per-block and per-thread budgets (compute capability 9.0): the
# opt-in shared memory of a block, registers of a thread and of an SM.
HOPPER_SMEM_PER_BLOCK = 232448
HOPPER_REGS_PER_THREAD = 255
HOPPER_REGS_PER_SM = 65536

# The 2-byte tolerance of the kernels against their plain versions (a few
# 2-byte roundings at the result's scale) and the f32 one.
TOL_2BYTE = 2e-2
TOL_F32 = 1e-5


@dataclass(frozen=True)
class AuditFinding:
    rule: str
    severity: str  # "error" | "warning" | "info"
    location: str  # plan ("conflux/cuda/windowed N=64") or kernel ("lu_panel[float32]")
    detail: str
    data: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "location": self.location, "detail": self.detail, "data": self.data,
        }


@dataclass
class AuditReport:
    findings: list[AuditFinding] = field(default_factory=list)
    comm_rows: list[dict] = field(default_factory=list)

    def add(self, rule: str, severity: str, location: str, detail: str,
            data: dict | None = None) -> AuditFinding:
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got {severity!r}")
        f = AuditFinding(rule, severity, location, detail, data or {})
        self.findings.append(f)
        return f

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[AuditFinding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[AuditFinding]:
        return [f for f in self.findings if f.severity == "warning"]

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "counts": {s: sum(1 for f in self.findings if f.severity == s)
                       for s in SEVERITIES},
            "comm_rows": self.comm_rows,
        }


# ---------------------------------------------------------------------------
# Executed-schedule communication models.
# ---------------------------------------------------------------------------


def _window_caps(nsteps: int) -> list[int]:
    """Per-step window bucket cap (tiles) of the windowed hot loop."""
    buckets = window_buckets(nsteps)
    return [buckets[window_bucket_index(t, nsteps)] for t in range(nsteps)]


def _extents(N: int, grid, hotloop: str):
    """(R, C, [(wr, wc) per step]) of the schedule's local block and its
    trailing window at each step (the whole block on the flat body)."""
    Px, Py, v = grid.Px, grid.Py, grid.v
    nbi = N // v
    R = (nbi // Px) * v
    C = (nbi // Py) * v
    if hotloop != "windowed":
        return R, C, [(R, C)] * nbi
    return R, C, [(min(-(-cap // Px) * v, R), min(-(-cap // Py) * v, C))
                  for cap in _window_caps(nbi)]


def executed_comm_bytes(kind: str, N: int, grid, pivot: str, hotloop: str,
                        compute_itemsize: int, world: int | None = None) -> dict:
    """Per-device wire bytes of the port's executed 2.5D schedule, on an
    active rank of a default group of `world` ranks (None: the grid's
    P_used; 1: no process group).

    Returns a per-site breakdown ("panel", "pivot", "a00", "l10", "r01" per
    step, and "gather", the final hand-out of the result), plus "total".  The
    values travel in the compute dtype (`compute_itemsize` bytes), the LU's
    pivot ids beside them as floats of at least 4 bytes.  See the module
    docstring for where this departs from `jax_executed_comm_bytes`.
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    world = grid.P_used if world is None else world
    s = float(compute_itemsize)
    si = max(s, 4.0)
    R, C, windows = _extents(N, grid, hotloop)
    rounds = max(int(math.log2(Px)), 0)
    out = {"panel": 0.0, "pivot": 0.0, "a00": 0.0, "l10": 0.0, "r01": 0.0, "gather": 0.0}
    for wr, wc in windows:
        if kind == "cholesky":
            out["panel"] += _ar(wr * v * s, c)
            out["a00"] += _ar(v * v * s, Px * Py)
            out["l10"] += _ar(wr * v * s, Py)
            out["r01"] += _ar(v * wc * s, Px * c)
            continue
        # LU: rows keep full extent (masked pivot rows stay scattered).
        out["panel"] += _ar(R * v * s, c)
        if pivot == "tournament":  # one [Px, v, v + 1] slab a butterfly round
            out["pivot"] += rounds * _ar(Px * v * (v + 1) * si, Px)
        else:  # one [Px, v + 2] slab a column
            out["pivot"] += v * _ar(Px * (v + 2) * si, Px)
        out["a00"] += _ar(v * (v + 1) * si, Py)
        out["l10"] += _ar(R * v * s, Py)
        out["r01"] += _ar(v * wc * s, Px * c)
    if world > 1:
        out["gather"] = Px * Py * R * C * s  # one broadcast of each block
        if kind != "cholesky" and world > grid.P_used:
            out["gather"] += 8.0 * N  # the int64 pivot order, to the idle ranks
    out["total"] = sum(out.values())
    return out


def executed_collective_ops(kind: str, N: int, grid, pivot: str,
                            world: int | None = None) -> float:
    """Collective calls an active rank issues in the port's executed
    schedule (the cost model's per-call term; `executed_comm_bytes` counts
    their bytes)."""
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    world = grid.P_used if world is None else world
    nsteps = N // v
    if kind == "cholesky":
        per = (c > 1) + (Px * Py > 1) + (Py > 1) + (Px * c > 1)
    else:
        per = (c > 1) + 2 * (Py > 1) + (Px * c > 1)
        if Px > 1:
            per += max(int(math.log2(Px)), 0) if pivot == "tournament" else v
    gather = 0
    if world > 1:
        gather = Px * Py + (kind != "cholesky" and world > grid.P_used)
    return float(nsteps * per + gather)


def rank_model(model: dict, active: bool) -> dict:
    """`executed_comm_bytes` as a rank sees it: an idle rank (beyond P_used)
    joins only the final gather."""
    if active:
        return model
    out = {k: 0.0 for k in model}
    out["gather"] = model["gather"]
    out["total"] = model["gather"]
    return out


def jax_executed_comm_bytes(kind: str, N: int, grid, pivot: str, hotloop: str,
                            compute_itemsize: int) -> dict:
    """The JAX package's executed-schedule model
    (`repro/analysis/audit.py::executed_comm_bytes`), as it stands: the
    per-device bytes of its lowered programs.  Kept for comparison; the
    module docstring lists where the port's schedule moves other bytes.
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    s = 4.0 if compute_itemsize < 4 else float(compute_itemsize)
    si = 4.0  # pivot-index payloads are int32
    nbi = N // v
    R = (nbi // Px) * v  # local row extent
    C = (nbi // Py) * v  # local col extent
    caps: list[int | None]
    caps = _window_caps(nbi) if hotloop == "windowed" else [None] * nbi

    def wc(cap):  # window col extent owned locally (cols shard over py)
        return C if cap is None else min(-(-cap // Py) * v, C)

    def wr(cap):  # window row extent (rows shard over px; Cholesky only)
        return R if cap is None else min(-(-cap // Px) * v, R)

    out = {"panel": 0.0, "pivot": 0.0, "gids": 0.0, "a00": 0.0,
           "l10": 0.0, "r01": 0.0}
    for cap in caps:
        if kind == "cholesky":
            out["panel"] += _ar(wr(cap) * v * s, c)
            out["a00"] += _ar(v * v * s, Px * Py)
            out["l10"] += _ar(wr(cap) * v * s, Py)
            out["r01"] += _ar(v * wc(cap) * s, Px * c)
            continue
        out["panel"] += _ar(R * v * s, c)
        if pivot == "tournament":
            out["pivot"] += math.log2(Px) * (v * v * s + v * si) if Px > 1 else 0.0
        else:
            out["pivot"] += v * (_ar(s, Px) + _ar(si, Px) + _ar(v * s, Px))
        out["gids"] += _ar(v * si, Py)
        out["a00"] += _ar(v * v * s, Py)
        out["l10"] += _ar(R * v * s, Py)
        out["r01"] += _ar(v * wc(cap) * s, Px * c)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Checker: comm-conformance.
# ---------------------------------------------------------------------------


def _plan_location(p) -> str:
    cfg = p.config
    loc = f"{cfg.strategy}/{cfg.backend}/{cfg.hotloop} N={p.N}"
    if p.grid is not None:
        loc += f" grid={p.grid.Px}x{p.grid.Py}x{p.grid.c} pivot={cfg.pivot}"
    if cfg.compute_dtype:
        loc += f" compute={cfg.compute_dtype}"
    return loc


def _world(p) -> int:
    return 1 if p.mesh is None else p.mesh.size


def check_comm_conformance(p, tolerance: float = DEFAULT_TOLERANCE, text: str | None = None):
    """Compare the collective bytes of the plan's trace (this rank's, or
    `text`) with the port's executed-schedule model; report the instrumented
    schedule volume and the X-partitioning lower bound alongside.  A
    distributed plan's ranks must all call this together (it runs the plan).

    Returns (findings, row)."""
    from repro_torch.analysis.trace import analyze_trace
    from repro_torch.api.config import resolve_dtype
    from repro_torch.core.xpart import lu_parallel_lower_bound

    cfg = p.config
    loc = _plan_location(p)
    itemsize = resolve_dtype(cfg.effective_compute_dtype).itemsize
    rep = analyze_trace(p.lowered_text("trace") if text is None else text)
    extracted = rep["wire_bytes"]
    row = {
        "strategy": cfg.strategy, "backend": cfg.backend,
        "hotloop": cfg.hotloop, "pivot": cfg.pivot,
        "compute_dtype": cfg.effective_compute_dtype, "N": p.N,
        "extracted_bytes": extracted, "traced_by_site": rep["by_site"],
        "collectives": rep["collectives"],
    }
    findings: list[AuditFinding] = []
    if p.grid is None:
        row.update(grid=None, predicted_bytes=0.0, lower_bound_bytes=None,
                   schedule_bytes=0.0)
        if rep["collectives"]:
            findings.append(AuditFinding(
                "comm-conformance", "error", loc,
                f"in-core plan issued {rep['collectives']} collectives "
                f"({extracted:.0f} bytes); sequential strategies must not communicate",
                {"extracted_bytes": extracted, "sites": rep["sites"]}))
        else:
            findings.append(AuditFinding(
                "comm-conformance", "info", loc,
                "in-core plan: no collectives in its trace", dict(row)))
        return findings, row

    world = _world(p)
    active = p.mesh is None or p.mesh.active
    model = rank_model(executed_comm_bytes(p.kind, p.N, p.grid, cfg.pivot, cfg.hotloop,
                                           itemsize, world=world), active)
    predicted = model["total"]
    s_sched = 4.0 if itemsize < 4 else float(itemsize)
    schedule_bytes = float(p.comm.get("total", 0.0)) * s_sched
    P_used = p.grid.Px * p.grid.Py * p.grid.c
    bound_elems = lu_parallel_lower_bound(p.N, P_used, cfg.M)
    if p.kind == "cholesky":
        # Cholesky's X-partitioning leading term is half LU's (arXiv:2108.09337).
        bound_elems /= 2.0
    bound_bytes = bound_elems * s_sched
    rel = abs(extracted - predicted) / max(predicted, 1.0)
    row.update(grid=str(p.grid), kind=p.kind,
               grid_shape=[p.grid.Px, p.grid.Py, p.grid.c, p.grid.v],
               rank=None if p.mesh is None else p.mesh.rank,
               active=active, world=world, predicted_bytes=predicted,
               schedule_bytes=schedule_bytes, lower_bound_bytes=bound_bytes,
               rel_err=rel, model=model)
    data = dict(row)
    if rel > tolerance:
        findings.append(AuditFinding(
            "comm-conformance", "error", loc,
            f"the trace moves {extracted:.0f} B/device but the executed "
            f"schedule model predicts {predicted:.0f} B "
            f"(rel err {rel:.1%} > tolerance {tolerance:.0%})", data))
    else:
        findings.append(AuditFinding(
            "comm-conformance", "info", loc,
            f"traced {extracted:.0f} B/device vs model {predicted:.0f} B "
            f"(rel err {rel:.1%}); schedule volume {schedule_bytes:.0f} B, "
            f"X-partitioning bound {bound_bytes:.0f} B", data))
    return findings, row


# ---------------------------------------------------------------------------
# Checker: mesh-uniformity across the ranks' traces.
# ---------------------------------------------------------------------------


def check_mesh_uniformity(texts: list[str], location: str) -> list[AuditFinding]:
    """`texts[r]` is rank r's trace of one plan.  Every rank of each process
    group must issue the same sequence of collectives on it — kind, root and
    dtype, in order — or the ranks deadlock (or mismatch payloads).  A
    group's payload shapes that vary only in the trailing (window) dimension
    along its sequence are reported at info."""
    from repro_torch.analysis.trace import parse_trace

    per_group: dict[tuple, dict[int, list]] = {}
    for r, text in enumerate(texts):
        for e in parse_trace(text):
            if e["ev"] in ("kernel", "step"):
                continue
            group = tuple(e["ranks"])
            per_group.setdefault(group, {}).setdefault(r, []).append(
                (e["ev"], e["site"], e["root"], e["dtype"], tuple(e["shape"])))
    findings: list[AuditFinding] = []
    for group, seqs in sorted(per_group.items()):
        sigs = {r: [x[:4] for x in seqs.get(r, [])] for r in group}
        first = sigs[group[0]]
        bad = [r for r in group if sigs[r] != first]
        if bad:
            findings.append(AuditFinding(
                "mesh-uniformity", "error", location,
                f"group {list(group)}: ranks {bad} issue another collective sequence than "
                f"rank {group[0]} ({[len(sigs[r]) for r in group]} calls) — the ranks of "
                f"a group that disagree on it deadlock",
                {"group": list(group), "calls": {r: len(sigs[r]) for r in group}}))
            continue
        shapes = [tuple(x[4]) for x in seqs[group[0]]]
        if any(tuple(seqs[r][i][4]) != shapes[i] for r in group for i in range(len(shapes))):
            findings.append(AuditFinding(
                "mesh-uniformity", "error", location,
                f"group {list(group)}: ranks issue one collective with different payload "
                f"shapes", {"group": list(group)}))
            continue
        by_site: dict[str, set] = {}
        for kind, site, _, _, shape in seqs[group[0]]:
            by_site.setdefault(site, set()).add(shape)
        varying = {site: sorted(sh) for site, sh in by_site.items() if len(sh) > 1}
        if varying and all(len({s[:-1] for s in sh}) == 1 for sh in varying.values()):
            findings.append(AuditFinding(
                "mesh-uniformity", "info", location,
                f"group {list(group)}: {len(first)} collectives uniform across its "
                f"{len(group)} ranks; payload shapes differ by window width (by design)",
                {"group": list(group), "shapes": {k: [list(s) for s in v]
                                                  for k, v in varying.items()}}))
        else:
            findings.append(AuditFinding(
                "mesh-uniformity", "info", location,
                f"group {list(group)}: {len(first)} collectives uniform across its "
                f"{len(group)} ranks", {"group": list(group)}))
    return findings


# ---------------------------------------------------------------------------
# Checkers: the kernels.
# ---------------------------------------------------------------------------


def kernel_resources() -> list[dict]:
    """Every kernel instance of every `csrc/*.cu` (`attributes.cuh`): its
    registers, static shared memory, local memory, largest block, and the
    block and dynamic shared memory its launcher asks for.  Builds the
    libraries; needs the card, and raises when a read fails."""
    from repro_torch.kernels import _build

    _build.build()
    rows = []
    argtypes = (ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_longlong))
    for src in _build.SOURCES:
        n = _build.function(src, f"{src}_instances", ())()
        read = _build.function(src, f"{src}_instance_attributes", argtypes)
        for i in range(n):
            kernel, dtype = ctypes.c_char_p(), ctypes.c_char_p()
            out = (ctypes.c_longlong * 6)()
            _build.check(src, read(i, ctypes.byref(kernel), ctypes.byref(dtype), out))
            regs, static, local, max_threads, block, dyn = (int(x) for x in out)
            rows.append({"source": src, "kernel": kernel.value.decode(),
                         "dtype": dtype.value.decode(), "registers": regs,
                         "static_smem": static, "dynamic_smem": dyn, "spill_bytes": local,
                         "max_threads": max_threads, "block": block})
    return rows


def check_kernel_resources(device=None, rows: list[dict] | None = None) -> list[AuditFinding]:
    """Each kernel instance against Hopper's budgets: shared memory a block
    (static + dynamic) <= 232,448 B, registers a thread <= 255, registers a
    block <= 65,536 (an SM's file), and the launch's block within the
    instance's limit: errors; local memory (spills): a warning.  `rows`
    (`kernel_resources()`) may be given; else on a CUDA device they are
    read, and on the CPU the rule adds one info finding."""
    import torch

    from repro_torch.device import resolve_device

    if rows is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return [AuditFinding("kernel-resources", "info", "csrc/*.cu",
                                 "needs the card: the attributes of the built kernels are "
                                 "read with cudaFuncGetAttributes", {})]
        with torch.cuda.device(dev):
            rows = kernel_resources()
    findings = []
    for r in rows:
        loc = f"{r['kernel']}[{r['dtype']}]"
        smem = r["static_smem"] + r["dynamic_smem"]
        over = []
        if smem > HOPPER_SMEM_PER_BLOCK:
            over.append(f"{smem} B of shared memory a block > {HOPPER_SMEM_PER_BLOCK}")
        if r["registers"] > HOPPER_REGS_PER_THREAD:
            over.append(f"{r['registers']} registers a thread > {HOPPER_REGS_PER_THREAD}")
        if r["registers"] * r["block"] > HOPPER_REGS_PER_SM:
            over.append(f"{r['registers']} x {r['block']} threads = "
                        f"{r['registers'] * r['block']} registers a block > "
                        f"{HOPPER_REGS_PER_SM}")
        if r["block"] > r["max_threads"]:
            over.append(f"a block of {r['block']} threads > the instance's "
                        f"{r['max_threads']}")
        if over:
            findings.append(AuditFinding("kernel-resources", "error", loc, "; ".join(over), r))
        elif r["spill_bytes"] > 0:
            findings.append(AuditFinding(
                "kernel-resources", "warning", loc,
                f"{r['spill_bytes']} B of local memory a thread (register spills)", r))
        else:
            findings.append(AuditFinding(
                "kernel-resources", "info", loc,
                f"{r['registers']} registers x {r['block']} threads, "
                f"{smem} B shared memory: within Hopper's budgets", r))
    return findings


def _kernel_cases(v: int = 32, R: int = 256, C: int = 256, B: int = 4):
    """(name, KernelBackend primitive, operand shapes) for every solver
    kernel (the LM stack's flash_attention and mamba_scan are out of scope,
    as in the JAX package).  Shapes mirror the hot-loop call sites; dtypes
    are swept by the caller."""
    return [
        ("lu_panel", "panel_lup", [(R, v), (R,)]),
        ("lu_panel_batched", "panel_lup", [(B, R, v), (B, R)]),
        ("chol_panel", "panel_chol", [(v, v)]),
        ("chol_panel_batched", "panel_chol", [(B, v, v)]),
        ("trsm_right_upper", "trsm_right_upper", [(R, v), (v, v)]),
        ("trsm_right_upper_batched", "trsm_right_upper", [(B, R, v), (B, v, v)]),
        ("trsm_left_lower", "trsm_left_lower", [(v, v), (v, C)]),
        ("trsm_left_lower_batched", "trsm_left_lower", [(B, v, v), (B, v, C)]),
        ("schur_update", "schur_update", [(R, C), (R, v), (v, C)]),
        ("schur_update_batched", "schur_update", [(B, R, C), (B, R, v), (B, v, C)]),
        ("fused_trsm_schur", "fused_trsm_schur", [(R, C), (v, v), (v, C), (R, v)]),
        ("fused_trsm_schur_batched", "fused_trsm_schur",
         [(B, R, C), (B, v, v), (B, v, C), (B, R, v)]),
    ]


def _case_inputs(name: str, shapes, dtype, device, seed: int = 0):
    """Operands of a `_kernel_cases` case that every kernel takes: 0/1
    weights, SPD blocks, triangles with a dominant diagonal."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    def tri(shape, lower: bool):
        v = shape[-1]
        T = 0.3 * randn(*shape)
        T = torch.tril(T, -1) if lower else torch.triu(T, 1)
        return T + 2.0 * torch.eye(v, dtype=torch.float64)

    if name.startswith("lu_panel"):
        ops = [randn(*shapes[0]), (torch.rand(*shapes[1], generator=g) > 0.1).double()]
    elif name.startswith("chol_panel"):
        G = randn(*shapes[0])
        v = shapes[0][-1]
        ops = [G @ G.mT / v + torch.eye(v, dtype=torch.float64)]
    elif name.startswith("trsm_right_upper"):
        ops = [randn(*shapes[0]), tri(shapes[1], lower=False)]
    elif name.startswith("trsm_left_lower"):
        ops = [tri(shapes[0], lower=True), randn(*shapes[1])]
    elif name.startswith("schur_update"):
        ops = [randn(*s) for s in shapes]
    else:  # fused_trsm_schur
        ops = [randn(*shapes[0]), tri(shapes[1], lower=True), randn(*shapes[2]),
               randn(*shapes[3])]
    return [t.to(device=device, dtype=dtype) for t in ops]


def _wrapper(name: str):
    from repro_torch.kernels import ops

    return getattr(ops, name)


def _call(name: str, fn, operands):
    """One call of a case's wrapper (or plain version); the outputs held
    against the other's."""
    if name.startswith("lu_panel"):
        F, order, ok = fn(*operands)
        return [F, order, ok]
    if name.startswith("fused_trsm_schur"):
        return list(fn(*operands))
    return [fn(*operands)]


def _plain(name: str):
    from repro_torch.kernels import ref

    return getattr(ref, name)


def _predicted_body(name: str, operands) -> str:
    """The body that the launcher's rule takes for these operands (the
    wrappers' `.mode` on the card), from the operands alone."""
    from repro_torch.kernels import chol_panel, fused_schur, lu_panel, schur_update, trsm

    if name.startswith("lu_panel"):
        p = operands[0]
        return lu_panel.panel_mode(p.shape[-2], p.shape[-1], p.dtype,
                                   batched=name.endswith("_batched"))
    if name.startswith("chol_panel"):
        return chol_panel.body(operands[0].shape[-1])
    if name.startswith("trsm_right_upper"):
        return trsm.right_mode(*operands)
    if name.startswith("trsm_left_lower"):
        return trsm.left_mode(operands[0])
    if name.startswith("schur_update"):
        return schur_update.stream_mode(*operands)
    return fused_schur.stream_mode(*operands)


# KernelBackend primitive -> (cost-model primitive, schedule kind) of `kernel_body`.
_COST_PRIMITIVE = {"panel_lup": ("panel", "lu"), "panel_chol": ("panel", "cholesky"),
                   "trsm_left_lower": ("trsm", "lu"), "trsm_right_upper": ("trsm", "cholesky"),
                   "schur_update": ("schur", "lu"), "fused_trsm_schur": ("fused", "lu")}


def check_kernel_divisibility(v: int = 32, dtypes=("float32", "bfloat16"), device=None,
                              operands_fn=None) -> list[AuditFinding]:
    """Each `_kernel_cases` case passes `check_hopper_constraints` (dtype,
    panel width, batch) and takes the body that the cost model predicts for
    the path's shapes (`costmodel.kernel_body`: the streams where v allows
    them, so their operand rules — TMA's 16-byte alignment and runs, the
    widths of `_STREAM_V` — must hold), read from the operands by the
    launchers' rules.  `operands_fn(name, shapes, dtype, device)` may supply
    the operands (default: `_case_inputs` on `device`)."""
    import torch

    from repro_torch.analysis.costmodel import kernel_body
    from repro_torch.api.config import resolve_dtype
    from repro_torch.device import resolve_device
    from repro_torch.kernels.backend import check_hopper_constraints

    dev = resolve_device(device) if device is not None else torch.device("cpu")
    make = operands_fn or (lambda n, sh, dt, d: _case_inputs(n, sh, dt, d))
    findings = []
    for dtype in dtypes:
        dt = resolve_dtype(dtype)
        for name, prim, shapes in _kernel_cases(v=v):
            loc = f"{name}[{dtype}]"
            B = shapes[0][0] if name.endswith("_batched") else None
            try:
                check_hopper_constraints(dtype, v, B, (prim,))
            except ValueError as e:
                findings.append(AuditFinding("kernel-divisibility", "error", loc, str(e), {}))
                continue
            operands = make(name, shapes, dt, dev)
            got = _predicted_body(name, operands)
            cost_prim, kind = _COST_PRIMITIVE[prim]
            want = kernel_body(cost_prim, dtype, v, "cuda", rows=shapes[0][-2], kind=kind,
                               batched=name.endswith("_batched"), device="cuda")
            data = {"shapes": [list(s) for s in shapes], "body": got, "want": want}
            if got != want:
                findings.append(AuditFinding(
                    "kernel-divisibility", "error", loc,
                    f"the operands take the {got!r} body where the path's shapes take "
                    f"{want!r}: an operand breaks the launcher's rule (alignment, row "
                    f"stride or width)", data))
            else:
                findings.append(AuditFinding(
                    "kernel-divisibility", "info", loc, f"takes the {got!r} body", data))
    return findings


def _accum_case(name: str, dtype, device, K: int = 64):
    """An input of an update kernel whose exact answer a 2-byte accumulator
    loses: A = 1, L10 = 1, U01 = -ulp(1)/2 over K = 64 terms (L00 = I for the
    fused kernel), so A - L @ U = 1 + K ulp(1)/2 (1.03125 in f16, 1.25 in
    bf16), exact in the dtype, while a 2-byte running sum rounds each
    1 + ulp/2 back to 1 (a tie, to even): 3% of the result in f16, 20% in
    bf16, over TOL_2BYTE.  K = 64 is the widest that `schur_update`'s wgmma
    stream takes; the fused kernel takes its plain body there."""
    import torch

    step = torch.finfo(dtype).eps / 2
    M = C = 64
    A = torch.ones(M, C, dtype=dtype, device=device)
    L = torch.ones(M, K, dtype=dtype, device=device)
    U = torch.full((K, C), -step, dtype=dtype, device=device)
    exact = 1.0 + K * step
    if name.startswith("fused"):
        eye = torch.eye(K, dtype=dtype, device=device)
        return [A, eye, U, L], exact
    return [A, L, U], exact


def check_kernel_accum(dtypes=("bfloat16", "float16"), device=None, fns=None
                       ) -> list[AuditFinding]:
    """Each 2-byte entry point of the update kernels (`schur_update`,
    `fused_trsm_schur`) on `_accum_case`: on a CUDA device the kernel must
    stay within TOL_2BYTE of its plain version, which accumulates in f32; on
    the CPU the plain version must give the exact answer.  `fns` maps a name
    to a stand-in for the kernel (a seeded violation)."""
    import torch

    from repro_torch.api.config import resolve_dtype
    from repro_torch.device import resolve_device

    dev = resolve_device(device) if device is not None else torch.device("cpu")
    findings = []
    for dtype in dtypes:
        dt = resolve_dtype(dtype)
        for name in ("schur_update", "fused_trsm_schur"):
            loc = f"{name}[{dtype}]"
            operands, exact = _accum_case(name, dt, dev)
            plain = _call(name, _plain(name), operands)[0].double()
            fn = (fns or {}).get(name) or (_wrapper(name) if dev.type == "cuda" else None)
            if fn is None:  # the CPU: the plain version against the exact answer
                got, want, what = plain, torch.full_like(plain, exact), "exact answer"
            else:
                got, want, what = _call(name, fn, operands)[0].double(), plain, "plain version"
            err = float((got - want).abs().max() / want.abs().max())
            data = {"rel_err": err, "tol": TOL_2BYTE, "against": what, "exact": exact}
            if not err <= TOL_2BYTE:
                findings.append(AuditFinding(
                    "kernel-accum", "error", loc,
                    f"{err:.3g} of the result from the {what} (> {TOL_2BYTE}): the sum is "
                    f"not accumulated in f32", data))
            else:
                findings.append(AuditFinding(
                    "kernel-accum", "info", loc,
                    f"accumulates in f32 ({err:.3g} from the {what})", data))
    return findings


def check_kernels(dtypes=("float32", "bfloat16"), v: int = 32, device=None
                  ) -> list[AuditFinding]:
    """Launch the twelve solver kernels at `_kernel_cases`' shapes on a CUDA
    device and hold each against its plain version: f32 within TOL_F32 and
    bf16 within TOL_2BYTE of the largest plain value, pivots equal, and each
    launch in the body its launcher's rule predicts.  On the CPU the wrappers
    run their plain versions; the rule then adds one info finding."""
    import torch

    from repro_torch.api.config import resolve_dtype
    from repro_torch.device import resolve_device

    dev = resolve_device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return [AuditFinding("kernel-check", "info", "kernels",
                             "needs the card: the wrappers run their plain versions on "
                             "CPU tensors", {})]
    findings = []
    for dtype in dtypes:
        dt = resolve_dtype(dtype)
        tol = TOL_F32 if dt.itemsize >= 4 else TOL_2BYTE
        for name, _, shapes in _kernel_cases(v=v):
            loc = f"{name}[{dtype}]"
            operands = _case_inputs(name, shapes, dt, dev)
            before = _launch_count(name)
            got = _call(name, _wrapper(name), operands)
            torch.cuda.synchronize(dev)
            launched = _launch_count(name) - before
            want = _call(name, _plain(name), operands)
            body = _body_of(name)
            predicted = _predicted_body(name, operands)
            err = max(float((g.double() - w.double()).abs().max()) for g, w in
                      zip(got, want) if g.is_floating_point())
            scale = max(float(w.double().abs().max()) for w in want if w.is_floating_point())
            equal_ints = all(torch.equal(g, w) for g, w in zip(got, want)
                             if not g.is_floating_point())
            data = {"max_abs_err": err, "scale": scale, "tol": tol, "launched": launched,
                    "body": body, "predicted_body": predicted, "ints_equal": equal_ints}
            if not (err <= tol * max(scale, 1e-30) and equal_ints and launched == 1
                    and body == predicted):
                findings.append(AuditFinding(
                    "kernel-check", "error", loc,
                    f"the kernel is {err:.3g} from its plain version (tol {tol} x "
                    f"{scale:.3g}), integers equal {equal_ints}, {launched} launches, body "
                    f"{body!r} (predicted {predicted!r})", data))
            else:
                findings.append(AuditFinding(
                    "kernel-check", "info", loc,
                    f"within {err:.3g} of its plain version, body {body!r}", data))
    return findings


def _module_of(name: str):
    from repro_torch.kernels import chol_panel, fused_schur, lu_panel, schur_update, trsm

    for mod in (lu_panel, chol_panel, trsm, schur_update, fused_schur):
        if hasattr(mod, name):
            return mod
    raise KeyError(name)


def _launch_count(name: str) -> int:
    return getattr(_module_of(name), name).launches


def _body_of(name: str):
    return getattr(getattr(_module_of(name), name), "mode", None)


# ---------------------------------------------------------------------------
# Checker: cache-key completeness fuzzer.
# ---------------------------------------------------------------------------


def _fuzz_perturbations(cfg, N: int) -> list[tuple[str, dict]]:
    """One perturbed value per SolverConfig field (None = not applicable)."""
    from repro_torch.core.lu.grid import GridConfig

    v = cfg.v or 8
    perts: list[tuple[str, dict]] = [
        ("dtype", {"dtype": "float64" if cfg.dtype == "float32" else "float32"}),
        ("compute_dtype", {"compute_dtype": "bfloat16"
                           if cfg.compute_dtype != "bfloat16" else "float16"}),
        ("v", {"v": v * 2 if N % (v * 2) == 0 else max(v // 2, 1)}),
        ("hotloop", {"hotloop": "flat" if cfg.hotloop == "windowed" else "windowed"}),
        ("pivot", {"pivot": "partial" if cfg.pivot == "tournament" else "tournament"}),
        ("backend", {"backend": "cuda" if cfg.backend == "ref" else "ref"}),
        ("B", {"B": 2 if cfg.B is None else cfg.B * 2}),
        ("M", {"M": cfg.M / 4}),
        ("P_target", {"P_target": 4 if cfg.P_target != 4 else 2}),
    ]
    if cfg.grid is not None:
        g = cfg.grid
        perts.append(("grid", {"grid": GridConfig(g.Py, g.Px, g.c, g.v, g.N)}))
    return perts


def check_cache_keys(N: int, base_cfg, key_fn=None, device=None) -> list[AuditFinding]:
    """Perturb each SolverConfig field; any perturbation that changes the
    plan's program (`lowered_text("trace")`) but not the cache key is an
    aliasing bug (two distinct programs sharing one plan-cache slot).

    key_fn(resolved_cfg, N) defaults to `cfg.cache_key(N)` — injectable so the
    tests can prove the fuzzer catches a key with a dropped field.  Plans are
    built directly from the builders (never through `plan()`): the plan cache
    keys on the very function under test, so going through it would hand
    back the aliased plan and mask the bug.  A distributed base config needs
    all the ranks of its process group to call this together.
    """
    from repro_torch.api.plan import resolve
    from repro_torch.api.registry import get_strategy
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    key_fn = key_fn or (lambda cfg, n: cfg.cache_key(n))
    findings: list[AuditFinding] = []

    def build_text(cfg):
        resolved = resolve(N, cfg, device=dev)
        p = get_strategy(resolved.strategy)(N, resolved, dev)
        return resolved, p.lowered_text("trace")

    try:
        base_resolved, base_text = build_text(base_cfg)
    except Exception as e:
        return [AuditFinding("cache-key", "error", f"{base_cfg.strategy} N={N}",
                             f"base config failed to trace: {type(e).__name__}: {e}", {})]
    base_key = key_fn(base_resolved, N)
    loc_base = f"{base_resolved.strategy}/{base_resolved.backend} N={N}"

    for fieldname, change in _fuzz_perturbations(base_resolved, N):
        try:
            pert_cfg = base_cfg.with_(**change)
        except (ValueError, TypeError):
            continue  # invalid for this config: nothing to alias
        try:
            pert_resolved, pert_text = build_text(pert_cfg)
        except Exception:
            continue  # strategy rejects the perturbation: nothing to alias
        if pert_resolved == base_resolved:
            continue  # normalized away (e.g. pivot on Cholesky): same plan
        pert_key = key_fn(pert_resolved, N)
        same_key = pert_key == base_key
        same_text = pert_text == base_text
        data = {"field": fieldname, "perturbation": repr(change),
                "same_key": same_key, "same_text": same_text}
        if same_key and not same_text:
            findings.append(AuditFinding(
                "cache-key", "error", loc_base,
                f"field {fieldname!r}: perturbation changes the plan's program "
                f"but not cache_key — two distinct programs would "
                f"share one plan-cache entry", data))
        elif not same_key and same_text:
            findings.append(AuditFinding(
                "cache-key", "info", loc_base,
                f"field {fieldname!r}: distinct keys trace to identical "
                f"programs (benign over-keying: plans never shared)", data))
    if not any(f.severity == "error" for f in findings):
        findings.append(AuditFinding(
            "cache-key", "info", loc_base,
            "no cache-key aliasing across field perturbations", {}))
    return findings


# ---------------------------------------------------------------------------
# The plan matrix, the distributed traces, the audit run and the CLI.
# ---------------------------------------------------------------------------

WORLD = 8  # ranks of the distributed combos (2x2x2 and 2x2x1 grids)


def _in_core_matrix(v: int):
    from repro_torch.api.config import SolverConfig

    combos = []
    for backend in ("ref", "cuda"):
        combos.append(SolverConfig(strategy="sequential", v=v, backend=backend))
        combos.append(SolverConfig(strategy="sequential", v=v, backend=backend,
                                   compute_dtype="bfloat16"))
        combos.append(SolverConfig(strategy="sequential_chol", v=v, backend=backend,
                                   pivot="none"))
    return combos


def _distributed_matrix(N: int, v: int):
    """The 2.5D combos: conflux and cholesky25d on 2x2x2 (both hot loops,
    both backends), baseline2d on 2x2x1, a bf16 conflux, and conflux with
    partial pivoting on 2x2x2 and with the tournament on 2x2x1 (four ranks
    idle)."""
    from repro_torch.api.config import SolverConfig
    from repro_torch.core.lu.grid import GridConfig

    g222 = GridConfig(2, 2, 2, v, N)
    g221 = GridConfig(2, 2, 1, v, N)
    combos = []
    for backend in ("ref", "cuda"):
        for hotloop in ("windowed", "flat"):
            combos.append(SolverConfig(strategy="conflux", grid=g222, backend=backend,
                                       hotloop=hotloop))
            combos.append(SolverConfig(strategy="cholesky25d", grid=g222, backend=backend,
                                       hotloop=hotloop, pivot="none"))
        combos.append(SolverConfig(strategy="baseline2d", grid=g221, backend=backend,
                                   pivot="partial", hotloop="windowed"))
    combos.append(SolverConfig(strategy="conflux", grid=g222, hotloop="windowed",
                               compute_dtype="bfloat16"))
    combos.append(SolverConfig(strategy="baseline2d", grid=g221, pivot="partial",
                               hotloop="flat"))
    combos.append(SolverConfig(strategy="conflux", grid=g222, pivot="partial", hotloop="flat"))
    combos.append(SolverConfig(strategy="conflux", grid=g221, hotloop="windowed"))
    return combos


def _default_plan_matrix(N: int, v: int, n_ranks: int):
    """The strategy x backend x hotloop x compute_dtype combos to audit."""
    combos = _in_core_matrix(v)
    if n_ranks >= WORLD:
        combos += _distributed_matrix(N, v)
    return combos


def distributed_rank(N: int, v: int, tolerance: float = DEFAULT_TOLERANCE,
                     device=None) -> dict:
    """On every rank of a default process group of at least WORLD ranks:
    trace each distributed combo and check its comm conformance.  Returns
    {combo index: {"location", "text", "findings", "row"}} for this rank."""
    from repro_torch.api import plan

    out = {}
    for i, cfg in enumerate(_distributed_matrix(N, v)):
        p = plan(N, cfg, device=device)
        findings, row = check_comm_conformance(p, tolerance=tolerance)
        out[i] = {"location": _plan_location(p), "text": p.lowered_text("trace"),
                  "findings": [f.to_json() for f in findings], "row": row}
    return out


def _rank_main(rank: int, world: int, out_dir: str, N: int, v: int, tolerance: float,
               device: str) -> None:
    """A spawned rank of `distributed_traces`: joins a gloo group of `world`
    ranks and writes `distributed_rank`'s result to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: loopback
    torch.set_num_threads(1)  # the ranks share the host's cores
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world)
    try:
        res = distributed_rank(N, v, tolerance, device=device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()


def distributed_traces(N: int = 64, v: int = 8, tolerance: float = DEFAULT_TOLERANCE,
                       device: str = "cpu", world: int = WORLD, timeout: float = 600.0
                       ) -> list[dict]:
    """Spawn `world` gloo ranks (on the CPU, or all on one CUDA device) that
    run `distributed_rank`; returns each rank's result, in rank order.
    Raises if a rank fails or outlives `timeout` seconds."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, out_dir, N, v, tolerance, device))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"audit: distributed ranks {failed} failed or timed out")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append({int(k): x for k, x in json.load(fh).items()})
        return ranks


def run_audit(N: int = 64, v: int = 8, tolerance: float = DEFAULT_TOLERANCE,
              rules: set[str] | None = None, device=None, world: int = WORLD) -> AuditReport:
    """Trace every registered plan combo and run all checkers.  `rules`
    restricts to a subset of {"comm", "mesh", "kernels", "cache-key"}.

    The in-core combos run in this process on `device` (None: the card, or
    the CPU where there is none).  The distributed ones run on `world`
    spawned gloo ranks sharing that device (`distributed_traces`); world=0
    skips them with a warning."""
    import torch

    from repro_torch.api import plan
    from repro_torch.api.config import SolverConfig
    from repro_torch.device import resolve_device

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = resolve_device(device)
    rules = rules or {"comm", "mesh", "kernels", "cache-key"}
    report = AuditReport()

    if rules & {"comm", "mesh"}:
        for cfg in _in_core_matrix(v):
            try:
                p = plan(N, cfg, device=dev)
            except Exception as e:
                report.add("audit", "error", f"{cfg.strategy}/{cfg.backend}/{cfg.hotloop}",
                           f"plan build failed: {type(e).__name__}: {e}")
                continue
            if "comm" in rules:
                findings, row = check_comm_conformance(p, tolerance=tolerance)
                report.extend(findings)
                report.comm_rows.append(row)
        if world >= WORLD:
            ranks = distributed_traces(N, v, tolerance, device=str(dev), world=world)
            for i in sorted(ranks[0]):
                per = [r[i] for r in ranks]
                if "comm" in rules:
                    for r in per:
                        report.extend(AuditFinding(**f) for f in r["findings"])
                    report.comm_rows.append(per[0]["row"])
                if "mesh" in rules:
                    report.extend(check_mesh_uniformity([r["text"] for r in per],
                                                        per[0]["location"]))
        else:
            report.add("audit", "warning", "ranks",
                       f"world={world}: the distributed combos need {WORLD} ranks and were "
                       f"skipped")

    if "kernels" in rules:
        report.extend(check_kernel_resources(dev))
        report.extend(check_kernel_divisibility(device=dev))
        report.extend(check_kernel_accum(device=dev))
        report.extend(check_kernels(device=dev))

    if "cache-key" in rules:
        report.extend(check_cache_keys(32, SolverConfig(strategy="sequential", v=8), device=dev))
        report.extend(check_cache_keys(
            32, SolverConfig(strategy="sequential_chol", v=8, pivot="none"), device=dev))
    return report


def bench_audit_rows(N: int = 64, v: int = 8, tolerance: float = DEFAULT_TOLERANCE,
                     device=None, world: int = WORLD) -> dict:
    """The comm-conformance numbers per strategy x backend plus the finding
    counts (the JAX package's BENCH `audit` section)."""
    report = run_audit(N=N, v=v, tolerance=tolerance, rules={"comm", "mesh"}, device=device,
                       world=world)
    return {
        "N": N, "v": v, "tolerance": tolerance,
        "rows": report.comm_rows,
        "errors": len(report.errors),
        "warnings": len(report.warnings),
    }


def _format_findings(report: AuditReport, verbose: bool = False) -> str:
    lines = []
    order = {"error": 0, "warning": 1, "info": 2}
    for f in sorted(report.findings, key=lambda f: order[f.severity]):
        if not verbose and f.severity == "info":
            continue
        lines.append(f"[{f.severity.upper():7s}] {f.rule:20s} {f.location}")
        lines.append(f"          {f.detail}")
    counts = report.to_json()["counts"]
    lines.append(
        f"audit: {counts['error']} error(s), {counts['warning']} warning(s), "
        f"{counts['info']} info finding(s) across {len(report.findings)} total")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Audit of every registered factorization plan: comm-model "
                    "conformance, mesh-uniform collectives, the kernels' resources "
                    "and rules, cache-key completeness.")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full JSON report here")
    ap.add_argument("--n", type=int, default=64, help="audit problem size")
    ap.add_argument("--v", type=int, default=8, help="panel width")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="comm-conformance relative tolerance")
    ap.add_argument("--rules", default="comm,mesh,kernels,cache-key",
                    help="comma-separated subset of comm,mesh,kernels,cache-key")
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the card, else the CPU)")
    ap.add_argument("--world", type=int, default=WORLD,
                    help=f"gloo ranks of the distributed combos ({WORLD}; 0 skips them)")
    ap.add_argument("--verbose", action="store_true",
                    help="also print info-severity findings")
    args = ap.parse_args(argv)

    report = run_audit(N=args.n, v=args.v, tolerance=args.tolerance,
                       rules=set(args.rules.split(",")), device=args.device,
                       world=args.world)
    print(_format_findings(report, verbose=args.verbose))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_json(), fh, indent=2, sort_keys=True, default=str)
        print(f"wrote {args.json}")
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
