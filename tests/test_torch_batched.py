"""The port's batched many-small-systems path against the JAX package, on the CPU.

The same seeded stacks (numpy) go through the port's plain batched kernels,
its `lu_masked_sequential_batched` and its `plan((B, N))` API, and through
the JAX package's Pallas kernels (interpret mode), its "ref" backend (vmap
of the single primitives) and `repro.core.lu.sequential.
lu_masked_sequential_batched`.  Pivot orders must be equal.  Factors agree
within atol 1e-4 * max|A| (whole factorizations) or rtol = atol = 2e-4
(kernels): the sums run in another order than XLA's.  Within the port, a
batch lane equals the single-system call bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu.sequential as jseq  # must precede repro.kernels: import cycle
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jax_backend
from repro_torch import interop
from repro_torch.api import (
    GridConfig,
    SolverConfig,
    clear_plan_cache,
    factor,
    plan,
    plan_cache_stats,
    resolve,
)
from repro_torch.core.lu import sequential as tseq
from repro_torch.kernels import fused_schur as fs_mod
from repro_torch.kernels import lu_panel as lp_mod
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _stack(B, N, seed):
    return np.random.default_rng(seed).standard_normal((B, N, N)).astype(np.float32)


def _panels(B, R, v, seed):
    rng = np.random.default_rng(seed)
    panel = rng.standard_normal((B, R, v)).astype(np.float32)
    w = (rng.random((B, R)) > 0.2).astype(np.float32)
    return panel, w


# --------------------------------------------------------------------------
# the plain batched kernels
# --------------------------------------------------------------------------


# The first three are the original shapes; the rest are the edges on which
# the CUDA bodies branch (R = 1, R < 32, v = 1, v = 33, R not a multiple of 128).
@pytest.mark.parametrize("B,R,v", [(3, 64, 8), (2, 128, 16), (4, 32, 32), (2, 1, 8), (3, 20, 1),
                                   (2, 96, 33), (2, 200, 16)])
def test_lu_panel_batched_matches_jax(B, R, v):
    panel, w = _panels(B, R, v, seed=B * R + v)
    F, order, ok = ops.lu_panel_batched(torch.from_numpy(panel), torch.from_numpy(w))
    assert F.shape == (B, R, v) and order.dtype == torch.int32 and ok.dtype == torch.bool
    jp, jw = jnp.asarray(panel), jnp.asarray(w)
    for jF, jorder, jok in (jops.lu_panel_batched(jp, jw),
                            jax_backend("ref").panel_lup_batched(jp, jw, v)):
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok) != 0)
        np.testing.assert_allclose(F.numpy(), np.asarray(jF), **TOL)
    untouched = w == 0
    np.testing.assert_array_equal(F.numpy()[untouched], panel[untouched])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lu_panel_batched_lanes_equal_single_bitwise(dtype):
    panel, w = _panels(5, 96, 12, seed=21)
    P, W = torch.from_numpy(panel).to(dtype), torch.from_numpy(w)
    F, order, ok = ref.lu_panel_batched(P, W)
    for b in range(5):
        F1, o1, k1 = ref.lu_panel(P[b], W[b])
        assert torch.equal(F1, F[b]) and torch.equal(o1, order[b]) and torch.equal(k1, ok[b])


def test_lu_panel_batched_special_values_match_jax_and_single():
    """Lanes with NaN at two rows of a column, inf in a row of weight 0, an
    all-NaN column and a finite tie: the Pallas kernel's pivots and validity
    (its F agrees where both are finite; XLA spreads NaN into fewer columns,
    see test_torch_kernels.py::test_lu_panel_special_values_match_jax), and
    every lane equal to the single call, NaN at the same places."""
    B, R, v = 4, 64, 8
    panel, w = _panels(B, R, v, seed=31)
    panel[0, [7, 20], 0] = np.nan
    w[1, 10] = 0.0
    panel[1, 10, 0] = np.inf
    panel[2, :, 0] = np.nan
    w[3] = 1.0
    panel[3, [0, R - 1], 0] = [-9.0, 9.0]
    P, W = torch.from_numpy(panel), torch.from_numpy(w)
    F, order, ok = ops.lu_panel_batched(P, W)
    jF, jorder, jok = (np.asarray(a) for a in jops.lu_panel_batched(
        jnp.asarray(panel), jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(ok.numpy(), jok != 0)
    finite = torch.isfinite(F).numpy() & np.isfinite(jF)
    np.testing.assert_allclose(F.numpy()[finite], jF[finite], **TOL)
    assert not (np.isnan(jF) & ~F.isnan().numpy()).any()
    assert order[0, 0] == 7 and order[1, 0] == 10 and order[3, 0] == 0
    for b in range(B):
        F1, o1, k1 = ref.lu_panel(P[b], W[b])
        assert torch.equal(F1.isnan(), F[b].isnan())
        assert torch.equal(F1.view(torch.int32)[~F1.isnan()], F[b].view(torch.int32)[~F1.isnan()])
        assert torch.equal(o1, order[b]) and torch.equal(k1, ok[b])


def _fused_inputs(B, M, C, v, unit, seed):
    rng = np.random.default_rng(seed)
    # 0.3x off-diagonal keeps the forward substitution well-conditioned
    L00 = (0.3 * np.tril(rng.standard_normal((B, v, v)), -1)
           + (1.0 if unit else 2.0) * np.eye(v)).astype(np.float32)
    A = rng.standard_normal((B, M, C)).astype(np.float32)
    R01 = rng.standard_normal((B, v, C)).astype(np.float32)
    L10 = rng.standard_normal((B, M, v)).astype(np.float32)
    return A, L00, R01, L10


# The first two are the original shapes; the rest are the edges of the CUDA
# body, as in test_torch_kernels.py: v = 1, 31 and 33, C off its 256-column
# stripes, M = 1.
@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("B,M,C,v", [(3, 64, 64, 8), (2, 128, 96, 16), (2, 64, 300, 1),
                                     (2, 96, 260, 31), (2, 64, 96, 33), (3, 1, 300, 32)])
def test_fused_trsm_schur_batched_matches_jax(B, M, C, v, unit):
    A, L00, R01, L10 = _fused_inputs(B, M, C, v, unit, seed=B + M + C + v)
    out, U01 = ops.fused_trsm_schur_batched(*map(torch.from_numpy, (A, L00, R01, L10)),
                                            unit=unit)
    args = tuple(map(jnp.asarray, (A, L00, R01, L10)))
    for jout, jU in (jops.fused_trsm_schur_batched(*args, unit=unit),
                     jax_backend("ref").fused_trsm_schur_batched(*args, unit=unit)):
        np.testing.assert_allclose(U01.numpy(), np.asarray(jU), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_cpu_batched_wrappers_run_the_plain_version_and_count_no_launch():
    panel, w = map(torch.from_numpy, _panels(2, 64, 8, seed=3))
    A, L00, R01, L10 = map(torch.from_numpy, _fused_inputs(2, 64, 64, 8, True, seed=3))
    before = (lp_mod.lu_panel_batched.launches, fs_mod.fused_trsm_schur_batched.launches)
    got = lp_mod.lu_panel_batched(panel, w)
    assert all(torch.equal(g, h) for g, h in zip(got, ref.lu_panel_batched(panel, w)))
    got = fs_mod.fused_trsm_schur_batched(A, L00, R01, L10, bm=64, bc=64)
    want = ref.fused_trsm_schur_batched(A, L00, R01, L10)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert (lp_mod.lu_panel_batched.launches,
            fs_mod.fused_trsm_schur_batched.launches) == before


def test_batched_wrappers_raise_for_non_cuda_devices_and_bad_shapes():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lp_mod.lu_panel_batched(torch.empty((2, 64, 8), **meta), torch.empty((2, 64), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        fs_mod.fused_trsm_schur_batched(
            torch.empty((2, 64, 64), **meta), torch.empty((2, 8, 8), **meta),
            torch.empty((2, 8, 64), **meta), torch.empty((2, 64, 8), **meta), bm=64, bc=64)
    # shapes are checked before the device
    with pytest.raises(ValueError, match=r"\[B, R\]"):
        lp_mod.lu_panel_batched(torch.empty((2, 64, 8), **meta), torch.empty((2, 63), **meta))
    with pytest.raises(ValueError, match="65535 systems"):
        fs_mod.fused_trsm_schur_batched(
            *(torch.empty((65536, 8, 8), **meta) for _ in range(4)), bm=8, bc=8)
    with pytest.raises(ValueError, match=r"\[B, M, C\]"):
        fs_mod.fused_trsm_schur_batched(
            torch.empty((2, 64, 64), **meta), torch.empty((2, 8, 8), **meta),
            torch.empty((2, 8, 64), **meta), torch.empty((3, 64, 8), **meta), bm=64, bc=64)


# --------------------------------------------------------------------------
# lu_masked_sequential_batched
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,v,jax_backend_name", [
    (3, 64, 8, "ref"), (2, 128, 32, "ref"), (2, 64, 8, "pallas"),
])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_lu_batched_matches_jax(B, N, v, jax_backend_name, backend):
    A = _stack(B, N, seed=B + N + v)
    F, rows = tseq.lu_masked_sequential_batched(torch.from_numpy(A), v, backend, device="cpu")
    jF, jrows = jseq.lu_masked_sequential_batched(jnp.asarray(A), v=v,
                                                  backend=jax_backend_name)
    assert rows.dtype == torch.int64 and rows.shape == (B, N)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=0,
                               atol=1e-4 * np.abs(A).max())


def _onehot_lu_batched(A: torch.Tensor, v: int):
    """The JAX reference's batched step body, one-hot gathers and scatters."""
    B, N = A.shape[0], A.shape[1]
    F, active = A.clone(), torch.ones(B, N)
    rows = torch.zeros(B, N, dtype=torch.int64)
    eye, cols = torch.eye(v), torch.arange(N)
    for c0 in range(0, N, v):
        Fp, order, _ = ref.lu_panel_batched(F[:, :, c0:c0 + v], active)
        F[:, :, c0:c0 + v] = Fp
        rows[:, c0:c0 + v] = order.long()
        piv = torch.nn.functional.one_hot(order.long(), N).float()  # [B, v, N]
        active = active * (1.0 - piv.sum(1))
        colmask = (cols >= c0 + v).float()
        L10 = Fp * active[:, :, None]
        L00 = torch.tril(piv @ Fp, -1) + eye
        R01 = (piv @ F) * colmask
        F, U01 = ref.fused_trsm_schur_batched(F, L00, R01, L10 * active[:, :, None])
        F = (F * (1.0 - piv.sum(1)[:, :, None] * colmask)
             + piv.transpose(1, 2) @ (U01 * colmask))
    return F, rows


@pytest.mark.parametrize("B,N,v", [(3, 64, 8), (2, 96, 32)])
def test_batched_gather_scatter_equals_onehot_bitwise(B, N, v):
    A = torch.from_numpy(_stack(B, N, seed=5 * N + v))
    F, rows = tseq.lu_masked_sequential_batched(A, v, "ref", device="cpu")
    oF, orows = _onehot_lu_batched(A, v)
    assert torch.equal(rows, orows)
    assert torch.equal(F, oF)


def test_batch_lanes_match_the_single_system_path():
    A = torch.from_numpy(_stack(4, 64, seed=8))
    F, rows = tseq.lu_masked_sequential_batched(A, 16, "cuda", device="cpu")
    for b in range(4):
        F1, rows1 = tseq.lu_masked_sequential(A[b], 16, "cuda", device="cpu")
        assert torch.equal(rows1, rows[b])
        torch.testing.assert_close(F[b], F1, rtol=0, atol=1e-6 * float(A.abs().max()))


def test_lu_batched_leaves_input_untouched_and_rejects_bad_shapes():
    A = torch.from_numpy(_stack(2, 32, seed=2))
    before = A.clone()
    tseq.lu_masked_sequential_batched(A, 8, device="cpu")
    assert torch.equal(A, before)
    with pytest.raises(ValueError, match="multiple"):
        tseq.lu_masked_sequential_batched(torch.zeros(2, 32, 32), 12, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, N, N\]"):
        tseq.lu_masked_sequential_batched(torch.zeros(32, 32), 8, device="cpu")


# --------------------------------------------------------------------------
# the plan((B, N)) API
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_plan_batched_pivots_equal_jax(backend):
    A = _stack(3, 64, seed=13)
    fact = plan((3, 64), SolverConfig(backend=backend), device="cpu").execute(A)
    _, jrows = jseq.lu_masked_sequential_batched(jnp.asarray(A), v=32, backend="ref")
    assert fact.batched and fact.B == 3 and fact.N == 64
    assert fact.strategy == "sequential" and fact.backend == backend
    np.testing.assert_array_equal(fact.rows.numpy(), np.asarray(jrows))


def test_plan_tuple_and_execute_shape_errors():
    p = plan((4, 32), device="cpu", v=8)
    assert p.B == 4 and p.N == 32 and p.config.B == 4 and "B=4" in repr(p)
    with pytest.raises(ValueError, match="B=4"):
        p.execute(_stack(1, 32, seed=0)[0])
    with pytest.raises(ValueError, match="B=4"):
        p.execute(_stack(3, 32, seed=0))
    with pytest.raises(ValueError, match="conflicts"):
        plan((4, 32), SolverConfig(B=8), device="cpu")
    with pytest.raises(ValueError, match="length 3"):
        plan((1, 4, 32), device="cpu")


def test_factor_routes_stacks_and_reconstructs():
    A = _stack(4, 32, seed=1)
    f = factor(A, SolverConfig(v=8), device="cpu")
    assert f.batched and f.B == 4 and f.N == 32
    np.testing.assert_allclose(f.reconstruct().numpy(), A, atol=1e-4 * np.abs(A).max())
    for rows in f.rows.numpy():
        assert sorted(rows.tolist()) == list(range(32))
    assert factor(A[0], SolverConfig(v=8), device="cpu").B is None


def test_batched_cache_keys_are_distinct_from_single():
    cfg = SolverConfig(v=8)
    assert cfg.with_(B=4).cache_key(32) != cfg.cache_key(32)
    assert cfg.with_(B=4).cache_key(32) != cfg.with_(B=8).cache_key(32)
    p1 = plan(32, cfg, device="cpu")
    p2 = plan((4, 32), cfg, device="cpu")
    p3 = plan((8, 32), cfg, device="cpu")
    assert p1 is not p2 and p2 is not p3
    assert plan((4, 32), cfg, device="cpu") is p2 and plan(32, cfg, device="cpu") is p1
    assert plan_cache_stats()["misses"] == 3 and plan_cache_stats()["hits"] == 2


def test_auto_with_batch_resolves_to_sequential_and_rejects_a_grid():
    r = resolve(32, SolverConfig(strategy="auto", B=4))
    assert r.strategy == "sequential" and r.B == 4 and r.v == 32
    with pytest.raises(ValueError, match="sequential-only"):
        resolve(32, SolverConfig(B=4, grid=GridConfig(2, 2, 1, 8, 32)))
    with pytest.raises(ValueError, match="does not support batched plans"):
        resolve(32, SolverConfig(strategy="conflux", B=4))
    with pytest.raises(ValueError, match="65535"):
        resolve(32, SolverConfig(B=65536))
    assert resolve(32, SolverConfig(B=65536, backend="ref")).B == 65536


def test_batched_entry_points_without_device_target_cuda():
    if torch.cuda.is_available():
        assert plan((2, 32)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan((2, 32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factor(_stack(2, 32, seed=0))


# --------------------------------------------------------------------------
# the batched Factorization, on the JAX package's factors (interop)
# --------------------------------------------------------------------------


def _jax_batched(B=3, N=32, v=8, seed=17):
    A = _stack(B, N, seed) / 4  # keeps det(A) inside the f32 range
    jF, jrows = jseq.lu_masked_sequential_batched(jnp.asarray(A), v=v, backend="ref")
    return A, np.array(jF), np.array(jrows)


def _jax_psolve(F, rows, b):
    """`api/result.py::_psolve`, vmapped as the JAX batched Factorization does."""
    def one(F, rows, b):
        _, L, U = jseq.unpack_factors(F, rows)
        y = jax.scipy.linalg.solve_triangular(L, b[rows], lower=True, unit_diagonal=True)
        return jax.scipy.linalg.solve_triangular(U, y, lower=False)

    return np.asarray(jax.vmap(one)(jnp.asarray(F), jnp.asarray(rows), jnp.asarray(b)))


@pytest.mark.parametrize("k", [None, 2])
def test_batched_solve_matches_jax(k):
    A, F, rows = _jax_batched()
    rng = np.random.default_rng(4)
    b = rng.standard_normal((3, 32) if k is None else (3, 32, k)).astype(np.float32)
    fact = interop.factorization_from_numpy(F, rows, device="cpu", A_ref=A)
    x = fact.solve(b)
    assert fact.batched and x.shape == b.shape
    want = _jax_psolve(F, rows, b)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_batched_solve_rejects_wrong_shapes():
    _, F, rows = _jax_batched()
    fact = interop.factorization_from_numpy(F, rows, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        fact.solve(np.zeros(32, np.float32))
    with pytest.raises(ValueError, match="batched"):
        fact.solve(np.zeros((2, 32), np.float32))


def test_batched_slogdet_det_against_jax_and_numpy():
    A, F, rows = _jax_batched()
    fact = interop.factorization_from_numpy(F, rows, device="cpu")
    sign, logdet = fact.slogdet()
    assert sign.shape == (3,) and logdet.shape == (3,)
    jsigns = [jseq.permutation_sign(r) for r in rows]
    np.testing.assert_array_equal(tseq.permutation_signs(torch.from_numpy(rows)).numpy(),
                                  jsigns)
    nsign, nlogdet = np.linalg.slogdet(A.astype(np.float64))
    np.testing.assert_array_equal(sign.numpy(), nsign)
    np.testing.assert_allclose(logdet.numpy(), nlogdet, rtol=1e-4)
    np.testing.assert_allclose(fact.det().numpy(), np.linalg.det(A.astype(np.float64)),
                               rtol=1e-3)


def test_batched_reconstruct_and_unpack_match_jax_per_system():
    A, F, rows = _jax_batched()
    fact = interop.factorization_from_numpy(F, rows, device="cpu")
    rec = fact.reconstruct().numpy()
    P, L, U = fact.unpack()
    for b in range(3):
        np.testing.assert_allclose(
            rec[b], np.asarray(jseq.reconstruct(jnp.asarray(F[b]), jnp.asarray(rows[b]))),
            rtol=1e-5, atol=1e-5)
        for got, want in zip((P[b], L[b], U[b]),
                             jseq.unpack_factors(jnp.asarray(F[b]), jnp.asarray(rows[b]))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(rec, A, atol=1e-4 * np.abs(A).max())


@pytest.mark.parametrize("seed", range(3))
def test_permutation_signs_match_jax(seed):
    perms = np.stack([np.random.default_rng(seed * 10 + i).permutation(29) for i in range(6)])
    got = tseq.permutation_signs(torch.from_numpy(perms))
    assert got.tolist() == [jseq.permutation_sign(p) for p in perms]
    assert tseq.permutation_signs(torch.from_numpy(perms[0])).item() == \
        tseq.permutation_sign(perms[0])
