"""The port's solver API, end to end on the CPU, against the JAX package.

`repro.api` does not import on this jax (it needs
`jax.experimental.enable_x64`), so the JAX side is the factorization core
plus `api/result.py::_psolve`'s composition, written out here.  Inputs come
from a seed with numpy.  Solutions agree within 1e-3 of their largest entry:
f32 factors of these matrices (condition numbers ~1e2-1e3) lose about that
much in any summation order.
"""

from __future__ import annotations

import dataclasses

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
