"""Mixed precision and iterative refinement in the port, against the JAX package, on the CPU.

- Config: the cases of `tests/test_mixed_precision.py` (compute-dtype
  validation, cache-key isolation, the byte columns of `comm_report`), and
  `SolverConfig(dtype="bfloat16")` refused as the reference refuses it.
- Factors: `lu_masked_sequential[_batched]` in bf16 and f16 against the JAX
  package's on the Pallas kernels (interpret mode), which keep U01 in f32
  for the update as the port's plain versions do.  The JAX "ref" backend
  rounds U01 to the storage dtype first; the tests state that difference
  and show it is the whole difference.
- Refinement: `tests/multidev/jax_refine_cases.py` runs the JAX package's
  plans and refined solves in a subprocess (it needs the `enable_x64` shim,
  which must not reach this process); the port refines the same factors
  (through `interop`) and must take the same iterations and reach the same
  `converged`, with x and the final residual within the tolerances below.
- End to end, serving, the CPU path of backend "cuda" against "ref", the
  `slogdet` sign of a NaN determinant (F1) and the pivots on non-finite
  input (F2, a stated difference).
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu.sequential as jseq
from repro_torch import interop
from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan, resolve
from repro_torch.api.config import resolve_dtype
from repro_torch.api.result import RefinedSolve
from repro_torch.core.lu import sequential as tseq
from repro_torch.core.solve import lu_solve
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import ref as tref
from repro_torch.serving import AsyncSolveEngine, SolveEngine

ROOT = Path(__file__).resolve().parents[1]
CASES_SCRIPT = ROOT / "tests" / "multidev" / "jax_refine_cases.py"
SUBPROCESS_TIMEOUT_S = 300
LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}


def _cases_module():
    sys.path.insert(0, str(CASES_SCRIPT.parent))
    try:
        import jax_refine_cases
    finally:
        sys.path.remove(str(CASES_SCRIPT.parent))
    return jax_refine_cases


def _conditioned(n: int, cond: float, seed: int) -> np.ndarray:
    """f64 A with the singular values logspace(0, -log10 cond)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.logspace(0.0, -np.log10(cond), n)) @ v.T


def _relres(A, x, b) -> float:
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


# --------------------------------------------------------------------------
# Config (tests/test_mixed_precision.py::TestConfigValidation, TestPlanCacheKeys,
# TestCommReportBytes) and F3
# --------------------------------------------------------------------------


def test_unknown_compute_dtype_rejected():
    with pytest.raises(ValueError, match="compute_dtype"):
        SolverConfig(compute_dtype="float8")
    with pytest.raises(ValueError, match="compute_dtype"):
        SolverConfig(compute_dtype="int8")


def test_wider_compute_than_working_rejected():
    with pytest.raises(ValueError, match="compute_dtype"):
        SolverConfig(dtype="float32", compute_dtype="float64")


def test_equal_compute_dtype_normalizes_to_none():
    cfg = SolverConfig(dtype="float32", compute_dtype="float32")
    assert cfg.compute_dtype is None
    assert cfg.effective_compute_dtype == "float32"
    assert SolverConfig(dtype="float64", compute_dtype="bfloat16").effective_compute_dtype == \
        "bfloat16"
    assert resolve_dtype("bfloat16").itemsize == 2


def test_bfloat16_working_dtype_refused_pointing_at_compute_dtype():
    """F3: the reference refuses dtype='bfloat16' (ml_dtypes' bfloat16 is not
    numpy kind 'f'); the port did not.  float16 stays a working dtype."""
    for dt in ("bfloat16", torch.bfloat16):
        with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
            SolverConfig(dtype=dt)
    assert SolverConfig(dtype="float16").dtype == "float16"


def test_mixed_plan_never_shares_a_cache_entry_with_a_plain_plan():
    clear_plan_cache()
    base = SolverConfig(strategy="sequential", dtype="float64", backend="ref", v=8)
    p_plain = plan(16, base, device="cpu")
    p_mixed = plan(16, base.with_(compute_dtype="float32"), device="cpu")
    p_bf16 = plan(16, base.with_(compute_dtype="bfloat16"), device="cpu")
    assert len({id(p_plain), id(p_mixed), id(p_bf16)}) == 3
    keys = {p.config.cache_key(16) for p in (p_plain, p_mixed, p_bf16)}
    assert len(keys) == 3


def test_normalized_compute_dtype_shares_the_plan():
    clear_plan_cache()
    p1 = plan(16, SolverConfig(strategy="sequential", v=8), device="cpu")
    p2 = plan(16, SolverConfig(strategy="sequential", compute_dtype="float32", v=8),
              device="cpu")
    assert p1 is p2


def _total_row(report: str) -> tuple[float, float]:
    for ln in report.splitlines():
        if ln.strip().startswith("total"):
            parts = [p.replace(",", "") for p in ln.split()]
            return float(parts[-2]), float(parts[-1])
    raise AssertionError("no total row in comm_report")


def test_bytes_column_scales_with_compute_dtype():
    n = 32
    grid = GridConfig(Px=1, Py=1, c=1, v=8, N=n)
    A = np.random.default_rng(0).standard_normal((n, n))
    cfg = SolverConfig(strategy="conflux", grid=grid, dtype="float64", backend="ref")
    reports = {cd: plan(n, cfg.with_(compute_dtype=cd), device="cpu").execute(A).comm_report()
               for cd in (None, "float32", "bfloat16")}
    elems, nbytes = _total_row(reports[None])
    assert "working" not in reports[None] and nbytes == pytest.approx(8 * elems)
    for cd, width in (("float32", 4), ("bfloat16", 2)):
        assert "working torch.float64" in reports[cd]
        e, nb = _total_row(reports[cd])
        assert e == pytest.approx(elems) and nb == pytest.approx(width * elems)


# --------------------------------------------------------------------------
# Which plans take bf16/f16 on backend "cuda"
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["bfloat16", "float16"])
@pytest.mark.parametrize("strategy,B", [
    ("sequential", None), ("auto", None), ("auto", 4), ("sequential_chol", None),
    ("sequential_chol", 4), ("conflux", None), ("baseline2d", None), ("cholesky25d", None),
])
def test_cuda_backend_takes_2byte_compute_on_the_lu_strategies(strategy, B, compute):
    """Every primitive has bf16/f16 kernels, so every strategy, the LU ones
    and the Cholesky ones alike, resolves a 2-byte compute dtype on "cuda" as
    on "ref"; f32 compute under f64 runs on every strategy."""
    cfg = SolverConfig(strategy=strategy, B=B, compute_dtype=compute)
    resolved = resolve(64, cfg)
    assert resolved.compute_dtype == compute and resolved.backend == "cuda"
    assert resolve(64, cfg.with_(backend="ref")).compute_dtype == compute
    assert resolve(64, cfg.with_(dtype="float64", compute_dtype="float32")).backend == "cuda"


def test_kernel_dtypes_name_the_2byte_entry_points():
    """Every primitive lists bf16 and f16, and each of its CUDA sources
    defines the `_bf16` and `_f16` entry points its wrappers call."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    entries = {"panel_lup": ("lu_panel", "LU_PANEL_ENTRY"),
               "fused_trsm_schur": ("fused_schur", "FUSED_ENTRY"),
               "panel_chol": ("chol_panel", "CHOL_ENTRY"),
               "trsm_right_upper": ("trsm", "RIGHT_ENTRY"),
               "trsm_left_lower": ("trsm", "LEFT_ENTRY"),
               "schur_update": ("schur_update", "SCHUR_ENTRY")}
    assert set(entries) == set(tbackend.KERNEL_DTYPES)
    for prim, dts in tbackend.KERNEL_DTYPES.items():
        assert {"bfloat16", "float16"} <= set(dts), prim
        source, macro = entries[prim]
        text = (csrc / f"{source}.cu").read_text()
        for suffix, storage in (("bf16", "__nv_bfloat16"), ("f16", "__half")):
            assert f"{macro}({suffix}, {storage})" in text, (prim, suffix)


@pytest.mark.parametrize("compute", ["bfloat16", "float16"])
@pytest.mark.parametrize("B", [None, 3])
def test_cuda_backend_on_cpu_is_bit_identical_to_ref(compute, B):
    """The CPU path of backend "cuda" runs the kernels' plain versions, so a
    bf16 or f16 plan on it equals backend "ref" bit for bit."""
    n = 64
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n) if B is None else (B, n, n)).astype(np.float32)
    shape = n if B is None else (B, n)
    cfg = SolverConfig(compute_dtype=compute, v=16)
    f_k = plan(shape, cfg, device="cpu").execute(A)
    f_p = plan(shape, cfg.with_(backend="ref"), device="cpu").execute(A)
    assert f_k.F.dtype == LOW[compute][0] and f_k.A_ref.dtype == torch.float32
    assert torch.equal(f_k.rows, f_p.rows)
    assert torch.equal(f_k.F.view(torch.int16), f_p.F.view(torch.int16))


# --------------------------------------------------------------------------
# bf16/f16 factors against the JAX package
# --------------------------------------------------------------------------


def _low_tol(dtype: torch.dtype, N: int, F_ref: np.ndarray) -> float:
    """Port against the Pallas kernel: each update's f32 result is summed in
    another order, and a sum that lands beside a rounding boundary of the
    2-byte storage rounds one ulp apart; later steps carry such steps
    along.  Seen on these inputs: up to 8.7 eps * max|F| at N = 128 (f16),
    1.3 at N = 64.  N / 8 * eps * max|F| bounds them."""
    return N / 8 * torch.finfo(dtype).eps * float(np.abs(F_ref).max())


def _candidates(panel: torch.Tensor, weights: torch.Tensor, r: int) -> torch.Tensor:
    """|F[i, r]| * w[i] at round r of the plain panel LUP (f32 rounds on the
    widened panel, as `masked_lup`), for every row i."""
    F, w = panel.float().clone(), weights.float().clone()
    cols = torch.arange(F.shape[1])
    for k in range(r):
        p = int(torch.argmax(F[:, k].abs() * w))
        w[p] = 0
        piv = F[p, k]
        safe = piv if piv.abs() > 0 else torch.ones_like(piv)
        active = w > 0
        mult = torch.where(active, F[:, k] / safe, F[:, k])
        F[:, k] = mult
        F = F - torch.where(active, mult, 0.0)[:, None] * (F[p, :] * (cols > k).float())[None, :]
    return F[:, r].abs() * w


class _Recording(tbackend.RefBackend):
    """The plain backend, keeping each step's panel input."""

    name = "ref_recording"

    def __init__(self):
        self.panels = []

    def panel_lup(self, panel, weights, v):
        self.panels.append((panel.clone(), weights.clone()))
        return super().panel_lup(panel, weights, v)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("N,v", [(64, 16), (64, 32), (128, 16), (128, 32)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_factors_follow_the_pallas_kernel(dtype, N, v, seed):
    """rows equal to the Pallas kernel's (interpret mode) and F within
    `_low_tol`.  Where an ulp apart in the storage dtype flips a near-tied
    pivot (one of these 24 cases on this machine, f16 at N = 128, v = 32,
    seed 2), the rows agree up to that pivot, and the two candidates the
    packages chose lie within the same tolerance of each other in the
    port's state."""
    tdt, jdt = LOW[dtype]
    A = np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)
    jF, jrows = jseq.lu_masked_sequential(jnp.asarray(A).astype(jdt), v=v, backend="pallas")
    jF, jrows = np.asarray(jF.astype(jnp.float32)), np.asarray(jrows)
    rec = _Recording()
    tbackend.register_backend(rec.name, rec, overwrite=True)
    F, rows = tseq.lu_masked_sequential(torch.from_numpy(A).to(tdt), v, rec.name, device="cpu")
    F_k, rows_k = tseq.lu_masked_sequential(torch.from_numpy(A).to(tdt), v, "cuda", device="cpu")
    assert torch.equal(rows_k, rows) and torch.equal(F_k.view(torch.int16), F.view(torch.int16))
    tol = _low_tol(tdt, N, jF)
    diff = np.nonzero(rows.numpy() != jrows)[0]
    if len(diff) == 0:
        assert np.abs(F.float().numpy() - jF).max() <= tol
        return
    k = int(diff[0])
    step, r = divmod(k, v)
    c = _candidates(*rec.panels[step], r)
    gap = float((c[int(rows[k])] - c[int(jrows[k])]).abs())
    assert gap <= tol, f"pivot {k}: candidates {gap} apart, beyond the tolerance {tol}"


@pytest.mark.parametrize("v", [16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_batched_factors_follow_the_pallas_kernel(dtype, v):
    tdt, jdt = LOW[dtype]
    B, N = 3, 64
    A = np.random.default_rng(v).standard_normal((B, N, N)).astype(np.float32)
    jF, jrows = jseq.lu_masked_sequential_batched(jnp.asarray(A).astype(jdt), v=v,
                                                  backend="pallas")
    jF = np.asarray(jF.astype(jnp.float32))
    F, rows = tseq.lu_masked_sequential_batched(torch.from_numpy(A).to(tdt), v, "cuda",
                                                device="cpu")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert np.abs(F.float().numpy() - jF).max() <= _low_tol(tdt, N, jF)
    for b in range(B):  # a lane equals the single plan bit for bit
        F1, r1 = tseq.lu_masked_sequential(torch.from_numpy(A[b]).to(tdt), v, "cuda",
                                           device="cpu")
        assert torch.equal(r1, rows[b]) and torch.equal(F1.view(torch.int16),
                                                        F[b].view(torch.int16))


class _U01Rounded(tbackend.RefBackend):
    """The plain backend with U01 rounded to the storage dtype before the
    update, as the JAX "ref" backend does (`trsm_left_lower(...).astype`)."""

    name = "ref_u01_rounded"

    def fused_trsm_schur(self, A, L00, R01, L10, *, unit=True):
        U01 = tref.trsm_left_lower(L00, R01, unit=unit)
        return tref.schur_update(A, L10, U01), U01


@pytest.mark.parametrize("v", [16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_jax_ref_backend_differs_by_rounding_u01_first(dtype, v):
    """A stated difference: the JAX "ref" backend rounds U01 to bf16/f16
    before the product, the Pallas kernel and the port keep it in f32.  So
    the port's factors differ from JAX ref's in many entries, and a port
    backend that rounds U01 first reproduces JAX ref (rows equal, F within
    `_low_tol`)."""
    tdt, jdt = LOW[dtype]
    N = 64
    A = np.random.default_rng(100 + v).standard_normal((N, N)).astype(np.float32)
    jF, jrows = jseq.lu_masked_sequential(jnp.asarray(A).astype(jdt), v=v, backend="ref")
    jF, jrows = np.asarray(jF.astype(jnp.float32)), np.asarray(jrows)
    F, _ = tseq.lu_masked_sequential(torch.from_numpy(A).to(tdt), v, "cuda", device="cpu")
    assert (np.abs(F.float().numpy() - jF) > 0).mean() > 0.1
    tbackend.register_backend(_U01Rounded.name, _U01Rounded(), overwrite=True)
    F2, rows2 = tseq.lu_masked_sequential(torch.from_numpy(A).to(tdt), v, _U01Rounded.name,
                                          device="cpu")
    np.testing.assert_array_equal(rows2.numpy(), jrows)
    assert np.abs(F2.float().numpy() - jF).max() <= _low_tol(tdt, N, jF)


# --------------------------------------------------------------------------
# Refinement against the JAX package's, on the same factors
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_refined(tmp_path_factory):
    out = tmp_path_factory.mktemp("refine") / "jax.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(CASES_SCRIPT), str(out)], env=env,
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, f"JAX side failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}"
    return dict(np.load(out))


def _jax_factors(res: dict, name: str) -> np.ndarray:
    F = res[f"{name}_F"]
    if str(res[f"{name}_F_dtype"]) == "bfloat16":
        F = F.view(jnp.bfloat16)  # ml_dtypes' bfloat16, as the JAX package holds it
    return F


@pytest.mark.parametrize("name", [
    "lu_f64_f32", "lu_f64_f32_k3", "lu_f32_bf16", "lu_f32_f16", "lu_f64_bf16", "chol_f64_f32",
    "chol_f32_bf16", "lu_batched_f64_f32", "lu_batched_f32_bf16", "chol_batched_f64_f32",
    "lu_zero_cap", "lu_hopeless",
])
def test_refinement_matches_jax_on_the_same_factors(jax_refined, name):
    """The port's refine loop on the JAX package's factors: the same
    iterations and `converged`, system by system.  The solves round in
    other orders, so x and the residuals are held to tolerances: each x is
    within cond(A) times its relative residual of the exact solution
    (normwise), so the two within 2 cond(A) max(res) of each other; a
    converged residual is within its tolerance in both; one that did not
    converge sits at a rounding floor or at the first solve's error and
    agrees within a factor of 2."""
    mod = _cases_module()
    strategy, B, N, _, dtype, _, _, tol, cap, _ = mod.CASES[name]
    A, b = mod.inputs(name)
    work = np.dtype(dtype)
    fact = interop.factorization_from_numpy(
        _jax_factors(jax_refined, name), jax_refined[f"{name}_rows"], device="cpu",
        kind="cholesky" if strategy == "sequential_chol" else "lu", A_ref=A.astype(work))
    rs = fact.solve(b.astype(work), refine_tol=list(tol) if B else tol, max_refine_iters=cap)
    assert isinstance(rs, RefinedSolve) and rs.x.dtype == resolve_dtype(dtype)
    np.testing.assert_array_equal(np.asarray(rs.refinement_iters),
                                  jax_refined[f"{name}_iters"])
    conv = np.atleast_1d(np.asarray(rs.converged))
    np.testing.assert_array_equal(conv, np.atleast_1d(jax_refined[f"{name}_conv"]))
    res_t = np.atleast_1d(np.asarray(rs.final_residual))
    res_j = np.atleast_1d(jax_refined[f"{name}_res"])
    tols = np.broadcast_to(np.asarray(tol), res_t.shape)
    assert ((res_t <= tols) & (res_j <= tols))[conv].all()
    assert (np.abs(np.log2(res_t / res_j)) <= 1)[~conv].all(), (res_t, res_j)
    x_t = np.asarray(rs).reshape(len(res_t), N, -1)
    x_j = jax_refined[f"{name}_x"].reshape(len(res_t), N, -1)
    assert np.isfinite(x_t).all()
    conds = np.linalg.cond(A.reshape(-1, N, N))
    gap = np.linalg.norm(x_t - x_j, axis=1)  # [systems, columns]
    bound = 2 * (conds * np.maximum(res_t, res_j))[:, None] * np.linalg.norm(x_j, axis=1)
    assert (gap <= bound).all(), (gap, bound)


def test_plan_f64_over_f32_end_to_end_matches_jax(jax_refined):
    """plan(128, dtype="float64", compute_dtype="float32") factors and
    refines in the port, the JAX plan in the subprocess: the same pivots,
    the same iteration count, x within 1e-12 of max|x|."""
    name = "e2e_lu_f64_f32"
    mod = _cases_module()
    _, _, N, v, dtype, compute, _, tol, cap, _ = mod.CASES[name]
    A, b = mod.inputs(name)
    fact = plan(N, SolverConfig(dtype=dtype, compute_dtype=compute, v=v),
                device="cpu").execute(A)
    np.testing.assert_array_equal(fact.rows.numpy(), jax_refined[f"{name}_rows"])
    rs = fact.solve(b, refine_tol=tol, max_refine_iters=cap)
    assert rs.converged and bool(jax_refined[f"{name}_conv"])
    assert rs.refinement_iters == int(jax_refined[f"{name}_iters"])
    x_j = jax_refined[f"{name}_x"]
    assert np.abs(np.asarray(rs) - x_j).max() <= 1e-12 * np.abs(x_j).max()


def test_missing_a_ref_raises_in_both(jax_refined):
    assert bool(jax_refined["missing_a_ref_raises"])
    n = 32
    fact = plan(n, SolverConfig(compute_dtype="bfloat16"), device="cpu").execute(
        np.eye(n, dtype=np.float32))
    fact.A_ref = None
    with pytest.raises(ValueError, match="A_ref"):
        fact.solve(np.ones(n, np.float32), refine_tol=1e-6)
    with pytest.raises(ValueError, match="max_refine_iters"):
        plan(n, device="cpu").execute(np.eye(n, dtype=np.float32)).solve(
            np.ones(n, np.float32), refine_tol=1e-6, max_refine_iters=1.5)


# --------------------------------------------------------------------------
# End to end in the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["bfloat16", "float16"])
@pytest.mark.parametrize("B", [None, 2])
def test_low_precision_plans_converge_on_a_well_conditioned_matrix(compute, B):
    """Refinement converges while cond(A) * eps(compute) < 1: here cond(A) =
    10 by construction and eps is 2^-8 (bf16) or 2^-11 (f16)."""
    n = 128
    A = np.stack([_conditioned(n, 10.0, seed) for seed in range(B or 1)]).astype(np.float32)
    b = np.random.default_rng(5).standard_normal((B or 1, n)).astype(np.float32)
    if B is None:
        A, b = A[0], b[0]
    cond = float(np.linalg.cond(A.reshape(-1, n, n)[0].astype(np.float64)))
    assert cond * torch.finfo(LOW[compute][0]).eps < 0.1, cond
    fact = plan(n if B is None else (B, n), SolverConfig(compute_dtype=compute),
                device="cpu").execute(A)
    rs = fact.solve(b, refine_tol=1e-6)
    assert rs.x.dtype == torch.float32
    assert bool(torch.as_tensor(rs.converged).all()), (cond, rs.final_residual)
    for i in range(B or 1):
        Ai, bi = A.reshape(-1, n, n)[i], b.reshape(-1, n)[i]
        assert _relres(Ai.astype(np.float64), np.asarray(rs).reshape(-1, n)[i], bi) <= 2e-6


def test_hopeless_condition_reports_unconverged_without_nan():
    n, cap = 64, 5
    A = _conditioned(n, 1e14, 7)
    b = np.random.default_rng(7).standard_normal(n)
    fact = plan(n, SolverConfig(dtype="float64", compute_dtype="float32", v=8),
                device="cpu").execute(A)
    rs = fact.solve(b, refine_tol=1e-14, max_refine_iters=cap)
    assert not rs.converged and rs.refinement_iters == cap
    assert np.isfinite(rs.final_residual) and np.isfinite(np.asarray(rs)).all()


def test_zero_iteration_cap_returns_the_first_solve():
    n = 32
    A = _conditioned(n, 10.0, 8)
    b = np.random.default_rng(8).standard_normal(n)
    fact = plan(n, SolverConfig(dtype="float64", compute_dtype="float32", v=8),
                device="cpu").execute(A)
    rs = fact.solve(b, refine_tol=1e-30, max_refine_iters=0)
    assert rs.refinement_iters == 0 and not rs.converged
    x0 = fact.solve(b.astype(np.float32)).double()
    assert torch.equal(rs.x, x0)


def test_plain_solve_over_narrow_factors_computes_in_f32():
    """Over bf16/f16 factors the plain solve runs in f32 (PyTorch has no
    2-byte triangular solve): a mixed plan returns that f32 result, a plain
    f16 plan rounds it back to f16.  An RHS wider than the result warns,
    with the hint of the reference."""
    n = 64
    A = (np.random.default_rng(1).standard_normal((n, n)) + 8 * np.eye(n)).astype(np.float32)
    b = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    fact = plan(n, SolverConfig(compute_dtype="bfloat16"), device="cpu").execute(A)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = fact.solve(b)
    assert x.dtype == torch.float32
    assert torch.equal(x, lu_solve(fact.F.float(), fact.rows, torch.from_numpy(b)))
    plain16 = plan(n, SolverConfig(dtype="float16"), device="cpu").execute(A.astype(np.float16))
    with pytest.warns(UserWarning, match="SolverConfig.dtype"):
        x16 = plain16.solve(b)
    assert x16.dtype == torch.float16
    mixed64 = plan(n, SolverConfig(dtype="float64", compute_dtype="float32"),
                   device="cpu").execute(A)
    with pytest.warns(UserWarning, match="refine_tol"):
        assert mixed64.solve(b.astype(np.float64)).dtype == torch.float32


# --------------------------------------------------------------------------
# F1: slogdet's sign of a NaN determinant; F2: pivots on non-finite input
# --------------------------------------------------------------------------


def _nan_matrix(n: int = 64, seed: int = 0) -> np.ndarray:
    A = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    A[5, 7] = np.nan
    return A


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_slogdet_keeps_the_nan_sign(backend):
    """F1: torch.sign(nan) is 0; the sign of a NaN determinant is NaN, as
    jnp.sign and numpy.sign give it.  Lane by lane on a batched plan."""
    cfg = SolverConfig(backend=backend)
    fact = plan(64, cfg, device="cpu").execute(_nan_matrix())
    sign, logdet = fact.slogdet()
    assert np.isnan(float(sign)) and np.isnan(float(logdet)) and np.isnan(float(fact.det()))
    A2 = np.stack([_nan_matrix(), np.random.default_rng(4).standard_normal((64, 64))]).astype(
        np.float32)
    fb = plan((2, 64), cfg, device="cpu").execute(A2)
    sign, logdet = fb.slogdet()
    d = np.diagonal(np.take_along_axis(fb.F.numpy(), fb.rows.numpy()[:, :, None], 1),
                    axis1=1, axis2=2)
    perm = tseq.permutation_signs(fb.rows).numpy()
    np.testing.assert_array_equal(sign.numpy(), perm * np.prod(np.sign(d), axis=-1))
    assert np.isnan(float(sign[0]))
    assert float(sign[1]) == np.linalg.slogdet(A2[1].astype(np.float64))[0]


def test_nonfinite_input_pivots_are_a_stated_difference():
    """F2, pinned: the reference gathers pivot rows with one-hot products,
    which spread a NaN to every row, the port with index_select.  On F1's
    matrix with v = 8 both end with F all NaN and NaN solves and
    determinants; the port's backends pick the same rows, the JAX ones the
    same as each other, and the two packages first differ at pivot 8."""
    A = _nan_matrix()
    v = 8
    j = {bk: jseq.lu_masked_sequential(jnp.asarray(A), v=v, backend=bk)
         for bk in ("ref", "pallas")}
    t = {bk: tseq.lu_masked_sequential(torch.from_numpy(A), v, bk, device="cpu")
         for bk in ("cuda", "ref")}
    for F, _ in j.values():
        assert np.isnan(np.asarray(F)).all()
    for F, _ in t.values():
        assert torch.isnan(F).all()
    np.testing.assert_array_equal(np.asarray(j["ref"][1]), np.asarray(j["pallas"][1]))
    assert torch.equal(t["cuda"][1], t["ref"][1])
    first = np.nonzero(t["cuda"][1].numpy() != np.asarray(j["ref"][1]))[0]
    assert len(first) and first[0] == 8
    b = np.ones(64, np.float32)
    _, L, U = jseq.unpack_factors(*j["ref"])
    y = jax.scipy.linalg.solve_triangular(L, jnp.asarray(b)[j["ref"][1]], lower=True,
                                          unit_diagonal=True)
    assert np.isnan(np.asarray(jax.scipy.linalg.solve_triangular(U, y, lower=False))).all()
    assert np.isnan(np.prod(np.diagonal(np.asarray(U))))
    fact = plan(64, SolverConfig(v=v), device="cpu").execute(A)
    assert torch.isnan(fact.solve(b)).all() and torch.isnan(fact.det())


# --------------------------------------------------------------------------
# Serving: per-request refinement on a bf16 plan
# --------------------------------------------------------------------------


def _requests(n: int, count: int, seed: int):
    return [(_conditioned(n, 10.0, seed + i).astype(np.float32),
             np.random.default_rng(seed + i).standard_normal(n).astype(np.float32))
            for i in range(count)]


BF16 = SolverConfig(compute_dtype="bfloat16", v=8)
REFINE = (1e-6, None, 1e-5, None, 1e-6)  # per request; None: the plain solve


def _plain_batched(requests, n: int) -> torch.Tensor:
    """The plain batched solve of the bucket the engine flushes."""
    slot = 1 << (len(requests) - 1).bit_length()
    A = np.stack([A for A, _ in requests] + [np.eye(n, dtype=np.float32)] *
                 (slot - len(requests)))
    b = np.stack([b for _, b in requests] + [np.zeros(n, np.float32)] * (slot - len(requests)))
    return plan((slot, n), BF16, device="cpu").execute(A).solve(b)


def test_engine_refines_only_the_lanes_that_ask():
    n = 32
    reqs = _requests(n, len(REFINE), 20)
    eng = SolveEngine(n, BF16, device="cpu")
    tickets = [eng.submit_system(A, b, refine_tol=tol) for (A, b), tol in zip(reqs, REFINE)]
    xs = eng.flush_systems()
    plain = _plain_batched(reqs, n)
    iters = 0
    for t, (A, b), tol in zip(tickets, reqs, REFINE):
        if tol is None:
            assert torch.equal(xs[t], plain[t])
            assert _relres(A.astype(np.float64), xs[t], b) > 1e-5  # bf16 factors alone
        else:
            assert _relres(A.astype(np.float64), xs[t], b) <= 2 * tol
            one = plan(n, BF16, device="cpu").execute(A).solve(b, refine_tol=tol)
            iters += one.refinement_iters
    st = eng.stats()
    assert st["refined_systems"] == 3 and st["refine_nonconverged"] == 0
    assert st["refine_iters_total"] == iters


def test_async_engine_carries_refine_tol_through_the_batch_slots():
    n = 32
    reqs = _requests(n, len(REFINE), 40)
    clock = [0.0]
    eng = AsyncSolveEngine(n, BF16, device="cpu", max_batch=8, max_delay_ms=1.0, start=False,
                           clock=lambda: clock[0])
    futs = [eng.submit(A, b, refine_tol=tol) for (A, b), tol in zip(reqs, REFINE)]
    clock[0] = 1.0
    assert eng.pump() == len(reqs)
    plain = _plain_batched(reqs, n)
    for i, (f, (A, b), tol) in enumerate(zip(futs, reqs, REFINE)):
        x = f.result(timeout=0)
        if tol is None:
            assert torch.equal(x, plain[i])
        else:
            assert _relres(A.astype(np.float64), x, b) <= 2 * tol
    st = eng.stats()
    assert st["refined_systems"] == 3 and st["refine_nonconverged"] == 0
    assert st["async"]["served"] == len(reqs)
    # a spilled request refines too
    spill = AsyncSolveEngine(n, BF16, device="cpu", max_queue=1, overload="spill", start=False,
                             clock=lambda: 0.0)
    spill.submit(*reqs[0])
    (A, b), tol = reqs[2], 1e-6
    fut = spill.submit(A, b, refine_tol=tol)
    assert fut.done() and _relres(A.astype(np.float64), fut.result(), b) <= 2 * tol
    spill.close()
    eng.close()


def test_mixed_engine_plain_lanes_skip_the_downcast_warning():
    n = 16
    eng = SolveEngine(n, SolverConfig(dtype="float64", compute_dtype="float32", v=8),
                      device="cpu")
    A, b = _requests(n, 1, 60)[0]
    eng.submit_system(A.astype(np.float64), b.astype(np.float64))
    eng.submit_system(A.astype(np.float64), b.astype(np.float64), refine_tol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x_plain, x_ref = eng.flush_systems()
    assert x_plain.dtype == torch.float32 and x_ref.dtype == torch.float64
    assert _relres(A.astype(np.float64), x_ref, b) <= 1e-11
