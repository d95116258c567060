"""The port's solver API, end to end on the CPU, against the JAX package.

`repro.api` does not import on this jax (it needs
`jax.experimental.enable_x64`), so the JAX side is the factorization core
plus `api/result.py::_psolve`'s composition, written out here.  Inputs come
from a seed with numpy.  Solutions agree within 1e-3 of their largest entry:
f32 factors of these matrices (condition numbers ~1e2-1e3) lose about that
much in any summation order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu.grid as jgrid
import repro.core.lu.sequential as jseq
from repro_torch import interop
from repro_torch.api import (
    Factorization,
    GridConfig,
    SolverConfig,
    clear_plan_cache,
    factor,
    plan,
    plan_cache_stats,
    resolve,
    set_plan_cache_capacity,
)
from repro_torch.kernels.backend import CudaBackend, RefBackend


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _system(N, k=None, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N,) if k is None else (N, k)).astype(np.float32)
    return A, b


def _jax_solve(A, b, v):
    """JAX factors pushed through `_psolve`'s composition."""
    F, rows = jseq.lu_masked_sequential(jnp.asarray(A), v=v, backend="ref")
    _, L, U = jseq.unpack_factors(F, rows)
    pb = jnp.asarray(b)[rows]
    y = jax.scipy.linalg.solve_triangular(L, pb, lower=True, unit_diagonal=True)
    x = jax.scipy.linalg.solve_triangular(U, y, lower=False)
    return np.array(F), np.array(rows), np.asarray(x)


@pytest.mark.parametrize("N,k", [(64, None), (128, None), (128, 3)])
def test_plan_execute_solve_matches_jax(N, k):
    A, b = _system(N, k, seed=N)
    fact = plan(N, SolverConfig(), device="cpu").execute(A)
    x = fact.solve(b)
    _, jrows, jx = _jax_solve(A, b, v=32)
    assert fact.backend == "cuda" and fact.strategy == "sequential"
    np.testing.assert_array_equal(fact.rows.numpy(), jrows)
    assert x.shape == b.shape
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-3 * np.abs(jx).max())
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-3 * np.abs(b).max() * N)


def test_slogdet_det_reconstruct():
    A, _ = _system(64, seed=3)
    A /= 4  # keeps det(A) inside the f32 range
    fact = factor(A, device="cpu")
    sign, logdet = fact.slogdet()
    nsign, nlogdet = np.linalg.slogdet(A.astype(np.float64))
    assert float(sign) == nsign
    np.testing.assert_allclose(float(logdet), nlogdet, rtol=1e-4)
    np.testing.assert_allclose(float(fact.det()), np.linalg.det(A.astype(np.float64)),
                               rtol=1e-3)
    np.testing.assert_allclose(fact.reconstruct().numpy(), A, atol=1e-4 * np.abs(A).max())
    P, L, U = fact.unpack()
    np.testing.assert_allclose((P @ torch.from_numpy(A)).numpy(), (L @ U).numpy(),
                               atol=1e-4 * np.abs(A).max())
    assert "single-device" in fact.comm_report()


def test_plan_cache_hits_counts_and_lru():
    p = plan(64, device="cpu")
    assert plan(64, SolverConfig(), device=torch.device("cpu")) is p
    assert (p.trace_count, p.execute_count) == (0, 0)
    A, _ = _system(64)
    p.execute(A)
    p.execute(A)
    assert (p.trace_count, p.execute_count) == (1, 2)
    assert plan_cache_stats()["hits"] == 1 and plan_cache_stats()["misses"] == 1
    assert plan(64, SolverConfig(backend="ref"), device="cpu") is not p
    prev = set_plan_cache_capacity(2)
    try:
        plan(128, device="cpu")  # evicts the least recently used: p
        stats = plan_cache_stats()
        assert stats["evictions"] == 1 and stats["size"] == 2
        assert plan(64, device="cpu") is not p
    finally:
        set_plan_cache_capacity(prev)


def test_plan_without_device_targets_cuda():
    if torch.cuda.is_available():
        assert plan(64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan(64)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factor(np.eye(64, dtype=np.float32))


@pytest.mark.parametrize("fields,match", [
    (dict(backend="pallas"), "'cuda'"),
    (dict(strategy="conflux", pivot="none"), "Cholesky-only"),
    (dict(B=4, strategy="cholesky25d"), "does not support batched plans"),
    (dict(strategy="sequential_chol", dtype="bfloat16"), "compute_dtype='bfloat16'"),
    (dict(strategy="sequential_chol", compute_dtype="float64"), "wider than the working"),
    (dict(v=256), "panel widths"),
    (dict(grid=GridConfig(2, 2, 1, 8, 64)), "needs 4 ranks but the process group has 1"),
])
def test_unported_or_unsupported_configs_raise(fields, match):
    with pytest.raises(ValueError, match=match):
        resolve(256 if "v" in fields else 64, SolverConfig(**fields))


def test_unported_results_and_primitives_raise():
    A, b = _system(64)
    fact = factor(A, device="cpu")
    # refined solves are ported (ROADMAP.md module item 7); a bad cap raises
    with pytest.raises(ValueError, match="max_refine_iters"):
        fact.solve(b, refine_tol=1e-6, max_refine_iters=-1)
    with pytest.raises(ValueError, match="'lu' or 'cholesky'"):
        Factorization(F=fact.F, rows=fact.rows, kind="qr")
    chol = Factorization(F=torch.eye(8), rows=torch.arange(8), kind="cholesky")
    assert torch.equal(chol.solve(torch.ones(8)), torch.ones(8))
    eye = torch.eye(8)
    for bk in (CudaBackend(), RefBackend()):
        # the left-lower solves are ported: a unit solve ignores the diagonal
        assert torch.equal(bk.trsm_left_lower(3 * eye, 2 * eye), 2 * eye)
        assert torch.equal(bk.trsm_left_lower(2 * eye, 2 * eye, unit=False), eye)
        assert torch.equal(bk.trsm_left_lower_batched(2 * eye[None], 2 * eye[None], unit=False),
                           eye[None])
        # the Cholesky primitives are ported
        assert torch.equal(bk.panel_chol(4 * eye), 2 * eye)
        assert torch.equal(bk.panel_chol_batched(4 * eye[None]), 2 * eye[None])
        assert torch.equal(bk.trsm_right_upper(eye, 2 * eye), eye / 2)
        assert torch.equal(bk.trsm_right_upper_batched(eye[None], 2 * eye[None]), eye[None] / 2)
        assert torch.equal(bk.schur_update(eye, eye, eye), 0 * eye)
        assert torch.equal(bk.schur_update_batched(eye[None], eye[None], eye[None]),
                           0 * eye[None])


def test_batched_sequential_chol_resolves():
    cfg = resolve(64, SolverConfig(B=4, strategy="sequential_chol", pivot="partial"))
    assert (cfg.strategy, cfg.pivot, cfg.v, cfg.B) == ("sequential_chol", "none", 32, 4)


def test_config_validation_and_cache_key():
    cfg = SolverConfig(dtype=np.float32)
    assert cfg.dtype == "float32" and cfg.backend == "cuda"
    assert SolverConfig(compute_dtype="float32").compute_dtype is None
    assert resolve(64, cfg).cache_key(64) == resolve(64, SolverConfig()).cache_key(64)
    for bad in (dict(dtype="int32"), dict(dtype="complex64"), dict(pivot="x"),
                dict(hotloop="x"), dict(B=0), dict(compute_dtype="float64")):
        with pytest.raises(ValueError):
            SolverConfig(**bad)
    # bfloat16 is a compute dtype only, as in the JAX package (F3); float16
    # stays a working dtype
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        SolverConfig(dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        SolverConfig(dtype=torch.bfloat16)
    assert SolverConfig(dtype="float16").dtype == "float16"


def test_interop_factors_solve_to_jax_solution():
    A, b = _system(64, seed=9)
    F, rows, jx = _jax_solve(A, b, v=16)
    fact = interop.factorization_from_numpy(F, rows, device="cpu", A_ref=A)
    np.testing.assert_allclose(fact.solve(b).numpy(), jx, rtol=0,
                               atol=1e-4 * np.abs(jx).max())
    assert fact.A_ref.dtype == torch.float32


def test_interop_config_from_jax():
    grid = jgrid.GridConfig(2, 2, 1, 8, 64)
    fields = {f.name: getattr(SolverConfig(), f.name) for f in dataclasses.fields(SolverConfig)}
    fields.update(backend="pallas", grid=grid, v=16)
    cfg = interop.config_from_jax(fields)
    assert cfg.backend == "cuda" and cfg.v == 16
    assert (cfg.grid.Px, cfg.grid.Py, cfg.grid.c, cfg.grid.v, cfg.grid.N) == (2, 2, 1, 8, 64)
    assert interop.config_from_jax({"backend": "ref"}).backend == "ref"
    with pytest.raises(ValueError, match="no counterpart"):
        interop.config_from_jax({"backend": "tpu"})



# --------------------------------------------------------------------------
# F6: input that is not a tensor goes through numpy, as in the reference
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


def _downcast_warning(dtype):
    return pytest.warns(UserWarning, match="downcast") if dtype == "float32" else _no_warning()


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_list_input_equals_ndarray_input(backend, dtype):
    """Nested lists read as float64 (numpy's reading) and are then cast to the
    plan's working dtype: the same bits as the float64 ndarray, factors,
    pivots, plain and refined solves."""
    rng = np.random.default_rng(26)
    A, b = rng.standard_normal((64, 64)), rng.standard_normal(64)
    p = plan(64, SolverConfig(dtype=dtype, backend=backend, v=16), device="cpu")
    with _downcast_warning(dtype):  # the reference warns for both too
        f_arr = p.execute(A)
    with _downcast_warning(dtype):
        f_list = p.execute(A.tolist())
    assert f_list.A_ref.dtype == f_arr.A_ref.dtype == getattr(torch, dtype)
    for name in ("A_ref", "F", "rows"):
        assert torch.equal(getattr(f_list, name), getattr(f_arr, name)), name
    with _no_warning():  # lists state no dtype: no downcast warning, as in the reference
        x_list = f_list.solve(b.tolist())
    with _downcast_warning(dtype):  # an array states its dtype
        x_arr = f_arr.solve(b)
    assert x_list.dtype == getattr(torch, dtype)
    assert torch.equal(x_list, x_arr)
    r_list = f_list.solve(b.tolist(), refine_tol=1e-12, max_refine_iters=3)
    r_arr = f_arr.solve(b, refine_tol=1e-12, max_refine_iters=3)
    assert torch.equal(r_list.x, r_arr.x)
    assert r_list.refinement_iters == r_arr.refinement_iters


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_factor_of_lists_resolves_float64(backend):
    A = np.random.default_rng(27).standard_normal((32, 32))
    fact = factor(A.tolist(), backend=backend, v=8, device="cpu")
    assert fact.dtype == torch.float64 and fact.A_ref.dtype == torch.float64
    assert torch.equal(fact.F, factor(A, backend=backend, v=8, device="cpu").F)
    assert factor(A.astype(np.float32).tolist(), device="cpu").dtype == torch.float64
    assert factor(torch.from_numpy(A).float(), device="cpu").dtype == torch.float32


@pytest.fixture(scope="module")
def jax_lists(tmp_path_factory):
    return _jax_costmodel_cases().run(tmp_path_factory.mktemp("lists"))[1]["refined"]


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("name", ["f64", "f64_over_f32"])
def test_refined_f64_solve_from_lists_matches_reference(backend, name, jax_lists):
    """`plan(N, dtype="float64").execute(A.tolist()).solve(b.tolist(),
    refine_tol=1e-12)` within 1e-12 of the reference's (through the shim);
    before the repair the lists were rounded to float32 first and the
    answer was 5e-8 away."""
    cases = _jax_costmodel_cases()
    N, compute = cases.REFINED_CASES[name]
    A, b = cases.refined_inputs(name)
    cfg = SolverConfig(dtype="float64", compute_dtype=compute, backend=backend, v=16)
    rs = plan(N, cfg, device="cpu").execute(A.tolist()).solve(b.tolist(), refine_tol=1e-12)
    want = jax_lists[name]
    x_ref = np.asarray(want["x"])
    assert want["x_dtype"] == "float64" and want["converged"]
    assert rs.x.dtype == torch.float64 and rs.converged
    assert rs.final_residual <= 1e-12
    assert np.abs(rs.x.numpy() - x_ref).max() <= 1e-12 * np.abs(x_ref).max()


def _jax_costmodel_cases():
    import sys
    from pathlib import Path

    path = str(Path(__file__).resolve().parent / "multidev")
    sys.path.insert(0, path)
    try:
        import jax_costmodel_cases
    finally:
        sys.path.remove(path)
    return jax_costmodel_cases
