"""The port's kernels (plain versions, as run for CPU tensors) against the JAX
package's Pallas kernels (interpret mode) and their jnp references.

Inputs are made from a seed with numpy and fed to both packages.  F, A_new
and U01 agree within rtol = atol = 2e-4 in f32: the sums run in another
order than XLA's.  Pivot orders and validity flags must be equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_schur as fs_mod
from repro_torch.kernels import lu_panel as lp_mod
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


def _panel(R, v, seed):
    rng = np.random.default_rng(seed)
    panel = rng.standard_normal((R, v)).astype(np.float32)
    w = (rng.random(R) > 0.2).astype(np.float32)
    return panel, w


# The first three are the original shapes; the rest are the edges on which
# the CUDA bodies branch: R = 1, R = v = 32, R < 32, v = 1, v = 33 and 128
# (the generic bodies), R not a multiple of 128.
@pytest.mark.parametrize("R,v", [(64, 8), (256, 16), (128, 32), (1, 1), (1, 32), (32, 32),
                                 (20, 8), (64, 1), (96, 33), (160, 128), (200, 16),
                                 (300, 32)])
def test_lu_panel_matches_jax(R, v):
    panel, w = _panel(R, v, seed=R + v)
    F, order, ok = ops.lu_panel(torch.from_numpy(panel), torch.from_numpy(w))
    assert order.dtype == torch.int32 and ok.dtype == torch.bool
    for jF, jorder, jok in (jops.lu_panel(jnp.asarray(panel), jnp.asarray(w)),
                            jref.lu_panel(jnp.asarray(panel), jnp.asarray(w))):
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok) != 0)
        np.testing.assert_allclose(F.numpy(), np.asarray(jF), **TOL)


def test_lu_panel_weight0_rows_untouched_and_exhausted():
    panel, _ = _panel(32, 8, seed=3)
    w = np.zeros(32, np.float32)
    w[[1, 4, 9]] = 1.0  # three candidates for eight pivots
    F, order, ok = ops.lu_panel(torch.from_numpy(panel), torch.from_numpy(w))
    untouched = np.setdiff1d(np.arange(32), [1, 4, 9])
    np.testing.assert_array_equal(F.numpy()[untouched], panel[untouched])
    assert ok.tolist() == [True] * 3 + [False] * 5
    jF, jorder, jok = jops.lu_panel(jnp.asarray(panel), jnp.asarray(w))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok) != 0)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), **TOL)


def test_lu_panel_ties_pick_lowest_index():
    panel, _ = _panel(16, 4, seed=7)
    panel[:, 0] *= 0.1
    panel[[2, 5, 11], 0] = [-2.0, 2.0, 2.0]  # |.| ties in the first round
    F, order, _ = ops.lu_panel(torch.from_numpy(panel), torch.ones(16))
    _, jorder, _ = jops.lu_panel(jnp.asarray(panel), jnp.ones(16, jnp.float32))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert order[0] == 2


def _special_panel(case, R, v, seed):
    """A panel with NaN or infinite entries, or a tie between the first and
    the last row; the plain version and the Pallas kernel both let a NaN
    candidate |F[i, k]| * w[i] win, at the lowest index (inf * 0 = NaN for
    a row of weight 0), and spread non-finite pivot rows to every row."""
    panel, w = _panel(R, v, seed)
    if case == "nan_two_rows":
        panel[[7, 20], 0] = np.nan
    elif case == "inf_in_weight0_row":
        w[10] = 0.0
        panel[10, 0] = np.inf
    elif case == "nan_column":
        panel[:, 0] = np.nan
    elif case == "inf_later_column":
        w[[3, 5]] = [0.0, 1.0]
        panel[3, 2] = -np.inf
        panel[5, v - 1] = np.inf
    elif case == "tie_first_last":
        w[:] = 1.0
        panel[:, 0] *= 0.1
        panel[[0, R - 1], 0] = [-3.0, 3.0]
    return panel, w


def _ieee_masked_lup(panel, w):
    """The plain version's rounds in numpy float32, term by term as IEEE
    arithmetic gives them: every row takes F - m * (F[p, :] * colmask), so a
    non-finite entry of a pivot row reaches every row (0 * inf = NaN), and
    np.argmax, like torch.argmax, lets the first NaN win."""
    F = panel.astype(np.float32).copy()
    w = w.astype(np.float32).copy()
    R, v = F.shape
    order = np.zeros(v, np.int32)
    ok = np.zeros(v, bool)
    with np.errstate(all="ignore"):
        for k in range(v):
            col = np.abs(F[:, k]) * w
            p = int(np.argmax(col))
            order[k], ok[k] = p, col[p] > 0
            w[p] = 0
            safe = F[p, k] if abs(F[p, k]) > 0 else np.float32(1)
            active = w > 0
            mult = np.where(active, F[:, k] / safe, F[:, k])
            F[:, k] = mult
            colmask = (np.arange(v) > k).astype(np.float32)
            F = F - np.where(active, mult, np.float32(0))[:, None] * (F[p, :] * colmask)[None, :]
    return F, order, ok


def _same_bits(a, b):
    """NaN at the same places and the same bits everywhere else."""
    nan = np.isnan(a)
    return (nan == np.isnan(b)).all() and (a.view(np.int32)[~nan] == b.view(np.int32)[~nan]).all()


@pytest.mark.parametrize("R,v", [(64, 8), (32, 32)])
@pytest.mark.parametrize("case", ["nan_two_rows", "inf_in_weight0_row", "nan_column",
                                  "inf_later_column", "tie_first_last"])
def test_lu_panel_special_values_match_jax(case, R, v):
    """Pivots and validity as the Pallas kernel (interpret mode) picks them.
    XLA evaluates the kernel's F[p, :] * colmask as a select, so a non-finite
    pivot entry spreads NaN into fewer columns there: the Pallas kernel's NaN
    are a subset of the port's, and the entries finite in both agree within
    TOL.  The port's F is the IEEE rounds' bit for bit."""
    panel, w = _special_panel(case, R, v, seed=R * v + len(case))
    F, order, ok = ops.lu_panel(torch.from_numpy(panel), torch.from_numpy(w))
    jF, jorder, jok = (np.asarray(a) for a in
                       jops.lu_panel(jnp.asarray(panel), jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(ok.numpy(), jok != 0)
    F = F.numpy()
    finite = np.isfinite(F) & np.isfinite(jF)
    np.testing.assert_allclose(F[finite], jF[finite], **TOL)
    assert not (np.isnan(jF) & ~np.isnan(F)).any()
    iF, iorder, iok = _ieee_masked_lup(panel, w)
    assert _same_bits(F, iF)
    np.testing.assert_array_equal(order.numpy(), iorder)
    np.testing.assert_array_equal(ok.numpy(), iok)
    if case == "tie_first_last":
        assert order[0] == 0 and np.isfinite(F).all()
    if case == "nan_column":
        assert not ok.any()


def _fused_inputs(M, C, v, unit, seed):
    rng = np.random.default_rng(seed)
    # 0.3x off-diagonal keeps the forward substitution well-conditioned
    L00 = (0.3 * np.tril(rng.standard_normal((v, v)), -1)
           + (1.0 if unit else 2.0) * np.eye(v)).astype(np.float32)
    A = rng.standard_normal((M, C)).astype(np.float32)
    R01 = rng.standard_normal((v, C)).astype(np.float32)
    L10 = rng.standard_normal((M, v)).astype(np.float32)
    return A, L00, R01, L10


# The first three are the original shapes; the rest are the edges of the
# CUDA body: v = 1, 31 and 33 (its plain loads: v < 4, an odd row stride,
# more than one chunk), C off its 256-column stripes, M = 1.
@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("M,C,v", [(128, 128, 8), (256, 128, 16), (256, 256, 32), (64, 300, 1),
                                   (96, 260, 31), (64, 96, 33), (1, 300, 32)])
def test_fused_trsm_schur_matches_jax(M, C, v, unit):
    A, L00, R01, L10 = _fused_inputs(M, C, v, unit, seed=M + C + v)
    out, U01 = ops.fused_trsm_schur(*map(torch.from_numpy, (A, L00, R01, L10)), unit=unit)
    args = tuple(map(jnp.asarray, (A, L00, R01, L10)))
    for jout, jU in (jops.fused_trsm_schur(*args, unit=unit),
                     jref.fused_trsm_schur(*args, unit=unit)):
        np.testing.assert_allclose(U01.numpy(), np.asarray(jU), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("v", [8, 32, 33])
def test_fused_trsm_schur_special_values_match_jax(v):
    """NaN and inf in L10 and A, with R01 zero before a column as the LU
    paths pass it: an active row with an infinite entry, and a row of weight
    0 whose panel entry was infinite (L10 = F * 0 gives NaN there).  Every
    column is updated, so such a row is non-finite across the whole output,
    the zero columns included (inf * 0 = NaN), as in the JAX package's kernel
    (interpret mode) and ref backend; the rest agrees within TOL."""
    M, C = 40, 96
    A, L00, R01, L10 = _fused_inputs(M, C, v, True, seed=700 + v)
    R01[:, :C // 3] = 0.0
    L10[3, v // 2] = np.inf
    L10[7] = 0.0
    L10[7, v - 1] = np.nan
    A[9, 10] = np.nan
    A[11, 12] = -np.inf
    out, U01 = fs_mod.fused_trsm_schur(*map(torch.from_numpy, (A, L00, R01, L10)), bm=M, bc=C)
    out, U01 = out.numpy(), U01.numpy()
    assert not np.isfinite(out[3]).any() and np.isnan(out[7]).all()
    assert np.isnan(out[9, 10]) and np.isneginf(out[11, 12])
    args = tuple(map(jnp.asarray, (A, L00, R01, L10)))
    for jout, jU in (jops.fused_trsm_schur(*args), jref.fused_trsm_schur(*args)):
        jout = np.asarray(jout)
        np.testing.assert_allclose(U01, np.asarray(jU), **TOL)
        np.testing.assert_array_equal(np.isnan(out), np.isnan(jout))
        np.testing.assert_array_equal(np.isinf(out), np.isinf(jout))
        fin = np.isfinite(jout)
        np.testing.assert_allclose(out[fin], jout[fin], **TOL)


def test_fused_trsm_schur_is_out_of_place():
    A, L00, R01, L10 = map(torch.from_numpy, _fused_inputs(64, 64, 8, True, seed=5))
    before = A.clone()
    ops.fused_trsm_schur(A, L00, R01, L10)
    assert torch.equal(A, before)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    panel, w = _panel(64, 8, seed=11)
    A, L00, R01, L10 = map(torch.from_numpy, _fused_inputs(64, 64, 8, True, seed=11))
    n_panel, n_fused = lp_mod.lu_panel.launches, fs_mod.fused_trsm_schur.launches
    got = lp_mod.lu_panel(torch.from_numpy(panel), torch.from_numpy(w))
    want = ref.lu_panel(torch.from_numpy(panel), torch.from_numpy(w))
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    got = fs_mod.fused_trsm_schur(A, L00, R01, L10, bm=64, bc=64)
    want = ref.fused_trsm_schur(A, L00, R01, L10)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert (lp_mod.lu_panel.launches, fs_mod.fused_trsm_schur.launches) == (n_panel, n_fused)


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    panel = torch.empty((64, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lp_mod.lu_panel(panel, torch.empty(64, device="meta"))
    A = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fs_mod.fused_trsm_schur(A, torch.empty((8, 8), device="meta"),
                                torch.empty((8, 64), device="meta"),
                                torch.empty((64, 8), device="meta"), bm=64, bc=64)


@pytest.mark.parametrize("block,dim", [(128, 96), (128, 100), (1024, 16384), (64, 7), (8, 3)])
def test_fit_matches_jax(block, dim):
    assert ops._fit(block, dim) == jops._fit(block, dim)


def test_bf16_plain_version_rounds_in_f32():
    panel, w = _panel(64, 8, seed=13)
    F16, order16, _ = ref.lu_panel(torch.from_numpy(panel).bfloat16(), torch.from_numpy(w))
    F32, order32, _ = ref.lu_panel(torch.from_numpy(panel).bfloat16().float(),
                                   torch.from_numpy(w))
    assert F16.dtype == torch.bfloat16
    assert torch.equal(order16, order32)
    assert torch.equal(F16, F32.bfloat16())
