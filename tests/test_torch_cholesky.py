"""The port's Cholesky path against the JAX package, on the CPU.

The same seeded SPD matrices (numpy, A = G G^T / n + I) go through the
port's plain Cholesky kernels, its `chol_blocked_sequential[_batched]` and
its `plan(N, strategy="sequential_chol")` API, and through the JAX
package's Pallas kernels (interpret mode), its `repro.kernels.ref` oracles,
its "ref" and "pallas" backends and `repro.core.cholesky.sequential`.
Kernels agree within rtol = atol = 2e-4 in f32 (sums in another order than
XLA's); whole factors within atol 1e-4 * max|L|, and solves within
1e-4 * max|x| (these systems have condition numbers below 10).  Within the
port, a batch lane equals the single-system call bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
import repro.core.cholesky.sequential as jchol
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.backend import get_backend as jax_backend
from repro_torch import interop
from repro_torch.api import SolverConfig, clear_plan_cache, plan, resolve
from repro_torch.core.cholesky import sequential as tchol
from repro_torch.kernels import chol_panel as cp_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import schur_update as su_mod
from repro_torch.kernels import trsm as tr_mod

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _spd(shape, seed, dtype=np.float32):
    """G G^T / n + I for standard normal G [..., n, n]: eigenvalues in ~[1, 5]."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    G = rng.standard_normal(shape)
    return (G @ np.swapaxes(G, -1, -2) / n + np.eye(n)).astype(dtype)


def _upper(shape, seed):
    """Well-conditioned upper-triangular U [..., v, v]: the transposed lower
    factor of an SPD block, as the Cholesky step passes L00^T."""
    return np.swapaxes(np.linalg.cholesky(_spd(shape, seed, np.float64)), -1, -2).astype(
        np.float32)


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------
# the six plain versions against the Pallas kernels and the JAX oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("v", [8, 16, 32])
def test_chol_panel_matches_jax(v):
    A = _spd((v, v), seed=v)
    L = ops.chol_panel(torch.from_numpy(A))
    assert L.shape == (v, v) and L.dtype == torch.float32
    for jL in (jops.chol_panel(jnp.asarray(A)), jref.chol_panel(jnp.asarray(A))):
        np.testing.assert_allclose(L.numpy(), _np(jL), **TOL)
    assert np.all(np.triu(L.numpy(), 1) == 0)


@pytest.mark.parametrize("B,v", [(3, 8), (2, 16), (4, 32)])
def test_chol_panel_batched_matches_jax(B, v):
    A = _spd((B, v, v), seed=B * v)
    L = ops.chol_panel_batched(torch.from_numpy(A))
    for jL in (jops.chol_panel_batched(jnp.asarray(A)),
               jax_backend("ref").panel_chol_batched(jnp.asarray(A))):
        np.testing.assert_allclose(L.numpy(), _np(jL), **TOL)


@pytest.mark.parametrize("v", [1, 7, 31, 33, 64])
def test_chol_panel_edges_of_the_kernel_bodies_match_jax(v):
    """v = 1, 7 and 31 run the kernel's register body on the card, 33 and 64
    its shared-memory body.  On the CPU the wrappers give their plain
    version bit for bit (the version each body is held to bit for bit on the
    card), a batched lane equals the single call, and both agree with the
    JAX package's Pallas kernel (interpret mode) and its oracle within TOL;
    a block that is not SPD gives NaN where the Pallas kernel does."""
    A = _spd((3, v, v), seed=100 + v)
    At = torch.from_numpy(A)
    L = cp_mod.chol_panel(At[0])
    Lb = cp_mod.chol_panel_batched(At)
    assert torch.equal(L, ref.chol_panel(At[0]))
    assert torch.equal(Lb, ref.chol_panel_batched(At))
    assert torch.equal(Lb[0], L)
    for jL in (jops.chol_panel(jnp.asarray(A[0])), jref.chol_panel(jnp.asarray(A[0]))):
        np.testing.assert_allclose(L.numpy(), _np(jL), **TOL)
    np.testing.assert_allclose(Lb.numpy(), _np(jops.chol_panel_batched(jnp.asarray(A))), **TOL)
    bad = A.copy()
    p = min(5, v - 1)
    bad[:, p, p] = -1.0  # the pivot of round p goes negative
    Lbad = cp_mod.chol_panel_batched(torch.from_numpy(bad)).numpy()
    jbad = _np(jops.chol_panel_batched(jnp.asarray(bad)))
    assert np.isnan(Lbad).any()
    np.testing.assert_array_equal(np.isnan(Lbad), np.isnan(jbad))


# R = 1 and R off the register body's 128-row blocks; v = 1, 31 and 32 run
# the register body on the card, 33 the shared-memory one.
@pytest.mark.parametrize("R,v", [(64, 8), (256, 16), (128, 32), (1, 32), (130, 32), (97, 31),
                                 (100, 1), (200, 33)])
def test_trsm_right_upper_matches_jax(R, v):
    U = _upper((v, v), seed=R + v)
    Bm = np.random.default_rng(R).standard_normal((R, v)).astype(np.float32)
    X = ops.trsm_right_upper(torch.from_numpy(Bm), torch.from_numpy(U))
    for jX in (jops.trsm_right_upper(jnp.asarray(Bm), jnp.asarray(U)),
               jref.trsm_right_upper(jnp.asarray(Bm), jnp.asarray(U))):
        np.testing.assert_allclose(X.numpy(), _np(jX), **TOL)


@pytest.mark.parametrize("Bb,R,v", [(3, 64, 8), (2, 128, 16), (2, 96, 32), (1, 130, 32),
                                    (2, 1, 32), (3, 100, 1), (2, 97, 31), (2, 65, 33)])
def test_trsm_right_upper_batched_matches_jax(Bb, R, v):
    U = _upper((Bb, v, v), seed=Bb * R + v)
    Bm = np.random.default_rng(R).standard_normal((Bb, R, v)).astype(np.float32)
    X = ops.trsm_right_upper_batched(torch.from_numpy(Bm), torch.from_numpy(U))
    for jX in (jops.trsm_right_upper_batched(jnp.asarray(Bm), jnp.asarray(U)),
               jax_backend("ref").trsm_right_upper_batched(jnp.asarray(Bm), jnp.asarray(U))):
        np.testing.assert_allclose(X.numpy(), _np(jX), **TOL)


@pytest.mark.parametrize("v", [1, 31, 32, 33])
def test_trsm_right_upper_transposed_view_matches_jax(v):
    """U as the Cholesky step passes it, L00.mT (a view with strides (1, v)),
    gives the bits of the same U made contiguous, and agrees with the JAX
    package's Pallas kernel (interpret mode) and its ref backend within TOL;
    a batched lane equals the single call."""
    L = torch.from_numpy(np.linalg.cholesky(_spd((2, v, v), seed=300 + v, dtype=np.float64))
                         .astype(np.float32))
    U = L.mT
    assert U.stride() == (v * v, 1, v)
    Bm = torch.from_numpy(np.random.default_rng(v).standard_normal((2, 130, v)).astype(np.float32))
    X = tr_mod.trsm_right_upper(Bm[0], U[0])
    assert torch.equal(X, tr_mod.trsm_right_upper(Bm[0], U[0].contiguous()))
    Xb = tr_mod.trsm_right_upper_batched(Bm, U)
    assert torch.equal(Xb, tr_mod.trsm_right_upper_batched(Bm, U.contiguous()))
    assert torch.equal(Xb[0], X)
    jB, jU = jnp.asarray(Bm.numpy()), jnp.asarray(U.contiguous().numpy())
    for jX in (jops.trsm_right_upper(jB[0], jU[0]),
               jax_backend("ref").trsm_right_upper(jB[0], jU[0])):
        np.testing.assert_allclose(X.numpy(), _np(jX), **TOL)
    np.testing.assert_allclose(Xb.numpy(), _np(jops.trsm_right_upper_batched(jB, jU)), **TOL)


def _special_rows(Bm: np.ndarray) -> np.ndarray:
    """A copy of B [..., R, v] with a NaN, a +inf, a -inf and a zero row."""
    B = Bm.copy()
    v = B.shape[-1]
    B[..., 3, 0] = np.nan
    B[..., 5, min(2, v - 1)] = np.inf
    B[..., 7, v - 1] = -np.inf
    B[..., 9, :] = 0.0
    return B


@pytest.mark.parametrize("v", [1, 31, 32, 33])
def test_trsm_right_upper_special_values_match_jax(v):
    """NaN and inf in B: the port's solve has NaN and inf where the JAX ref
    backend's has them (and the Pallas kernel's, interpret mode), agrees
    within TOL elsewhere, and solves a zero row to zero; a batched lane
    equals the single call."""
    U = _upper((2, v, v), seed=400 + v)
    B = _special_rows(np.random.default_rng(v).standard_normal((2, 40, v)).astype(np.float32))
    Xb = tr_mod.trsm_right_upper_batched(torch.from_numpy(B), torch.from_numpy(U)).numpy()
    X = tr_mod.trsm_right_upper(torch.from_numpy(B[1]), torch.from_numpy(U[1])).numpy()
    np.testing.assert_array_equal(Xb[1], X)
    jX = _np(jax_backend("ref").trsm_right_upper_batched(jnp.asarray(B), jnp.asarray(U)))
    pX = _np(jops.trsm_right_upper_batched(jnp.asarray(B), jnp.asarray(U)))
    assert np.isnan(Xb).any() and np.isinf(Xb).any()
    for other in (jX, pX):
        np.testing.assert_array_equal(np.isnan(Xb), np.isnan(other))
        np.testing.assert_array_equal(np.isinf(Xb), np.isinf(other))
        fin = np.isfinite(other)
        np.testing.assert_allclose(Xb[fin], other[fin], **TOL)
    assert np.all(Xb[:, 9] == 0)


def _schur_inputs(lead, M, N, K, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(lead + s).astype(np.float32)
                 for s in ((M, N), (M, K), (K, N)))


# K = 1, 16 and 33 (one chunk, half of one in f32, two), and M, N off the
# kernel's 32 x 256 tiles.
@pytest.mark.parametrize("M,N,K", [(64, 64, 8), (128, 96, 16), (256, 128, 32), (64, 64, 1),
                                   (96, 300, 33), (33, 258, 16)])
def test_schur_update_matches_jax(M, N, K):
    A, Lm, Um = _schur_inputs((), M, N, K, seed=M + N + K)
    out = ops.schur_update(*map(torch.from_numpy, (A, Lm, Um)))
    args = tuple(map(jnp.asarray, (A, Lm, Um)))
    for jout in (jops.schur_update(*args), jref.schur_update(*args)):
        np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)


@pytest.mark.parametrize("B,M,N,K", [(3, 64, 64, 8), (2, 128, 96, 16), (2, 64, 128, 32),
                                     (1, 64, 128, 32), (2, 33, 258, 33), (3, 50, 70, 1)])
def test_schur_update_batched_matches_jax(B, M, N, K):
    A, Lm, Um = _schur_inputs((B,), M, N, K, seed=B + M + N + K)
    out = ops.schur_update_batched(*map(torch.from_numpy, (A, Lm, Um)))
    args = tuple(map(jnp.asarray, (A, Lm, Um)))
    for jout in (jops.schur_update_batched(*args),
                 jax_backend("ref").schur_update_batched(*args)):
        np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)


@pytest.mark.parametrize("K", [16, 32])
def test_schur_update_on_a_window_of_a_wider_matrix_matches_jax(K):
    """A as the conflux step passes it: a window of a wider matrix (row
    stride > N, base 32 columns in), single and batched, against the JAX
    package's kernel and ref backend on the window's values."""
    A_big, Lm, Um = _schur_inputs((2,), 96 + 32, 160 + 64, K, seed=500 + K)
    A = torch.from_numpy(A_big)[:, 32:, 64:]
    Lm, Um = Lm[:, 32:], Um[:, :, 64:]
    assert A.stride(1) == 160 + 64
    out = su_mod.schur_update(A[0], torch.from_numpy(Lm[0]), torch.from_numpy(Um[0]))
    outb = su_mod.schur_update_batched(A, torch.from_numpy(Lm), torch.from_numpy(Um))
    assert torch.equal(outb[0], out)
    args = tuple(map(jnp.asarray, (A.contiguous().numpy(), Lm, Um)))
    for jout in (jops.schur_update_batched(*args),
                 jax_backend("ref").schur_update_batched(*args)):
        np.testing.assert_allclose(outb.numpy(), _np(jout), **TOL)


@pytest.mark.parametrize("K", [1, 16, 33])
def test_schur_update_special_values_match_jax(K):
    """NaN and inf in A and L: NaN and inf where the JAX ref backend's output
    (and the Pallas kernel's, interpret mode) has them, the rest within TOL;
    a batched lane equals the single call."""
    A, Lm, Um = _schur_inputs((2,), 70, 300, K, seed=600 + K)
    A[:, 2, 3] = np.nan
    A[:, 4, 5] = np.inf
    Lm[:, 6, 0] = np.nan
    Lm[:, 8, K - 1] = -np.inf
    out = su_mod.schur_update_batched(*map(torch.from_numpy, (A, Lm, Um))).numpy()
    one = su_mod.schur_update(*(torch.from_numpy(x[1]) for x in (A, Lm, Um))).numpy()
    np.testing.assert_array_equal(out[1], one)
    args = tuple(map(jnp.asarray, (A, Lm, Um)))
    assert np.isnan(out).any() and np.isinf(out).any()
    for other in (_np(jax_backend("ref").schur_update_batched(*args)),
                  _np(jops.schur_update_batched(*args))):
        np.testing.assert_array_equal(np.isnan(out), np.isnan(other))
        np.testing.assert_array_equal(np.isinf(out), np.isinf(other))
        fin = np.isfinite(other)
        np.testing.assert_allclose(out[fin], other[fin], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_kernels_lanes_equal_single_bitwise(dtype):
    A = torch.from_numpy(_spd((5, 12, 12), seed=4)).to(dtype)
    L = ref.chol_panel_batched(A)
    U = L.mT
    Bm = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 40, 12))).to(dtype)
    X = ref.trsm_right_upper_batched(Bm, U)
    S = ref.schur_update_batched(Bm, X, U)
    for b in range(5):
        assert torch.equal(ref.chol_panel(A[b]), L[b])
        assert torch.equal(ref.trsm_right_upper(Bm[b], U[b]), X[b])
        assert torch.equal(ref.schur_update(Bm[b], X[b], U[b]), S[b])


def test_plain_chol_panel_is_lower_and_not_spd_gives_nan_without_raising():
    A = torch.from_numpy(_spd((16, 16), seed=1))
    L = ref.chol_panel(A)
    assert torch.equal(L, torch.tril(L))
    torch.testing.assert_close(L @ L.T, A, rtol=0, atol=1e-5)
    bad = A.clone()
    bad[5, 5] = -1.0  # the pivot of round 5 goes negative
    Lb = ops.chol_panel(bad)
    lower = torch.ones(16, 16, dtype=torch.bool).tril()
    assert torch.isnan(Lb[5, 5]) and torch.isnan(Lb[6:][lower[6:]]).all()  # every row below
    assert torch.equal(Lb[:5], L[:5])  # rows above it were final before round 5
    assert torch.equal(Lb[5, :5], L[5, :5])
    Lbb = ops.chol_panel_batched(torch.stack([A, bad]))
    assert torch.equal(Lbb[0], L) and torch.isnan(Lbb[1]).any()


# --------------------------------------------------------------------------
# the wrappers: CPU tensors run the plain versions; bad input raises
# --------------------------------------------------------------------------


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    A = torch.from_numpy(_spd((2, 8, 8), seed=3))
    Bm = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 8)).astype(np.float32))
    U = ref.chol_panel_batched(A).mT
    wrappers = (cp_mod.chol_panel, cp_mod.chol_panel_batched, tr_mod.trsm_right_upper,
                tr_mod.trsm_right_upper_batched, su_mod.schur_update,
                su_mod.schur_update_batched)
    before = [w.launches for w in wrappers]
    assert torch.equal(cp_mod.chol_panel(A[0]), ref.chol_panel(A[0]))
    assert torch.equal(cp_mod.chol_panel_batched(A), ref.chol_panel_batched(A))
    assert torch.equal(tr_mod.trsm_right_upper(Bm[0], U[0]), ref.trsm_right_upper(Bm[0], U[0]))
    assert torch.equal(tr_mod.trsm_right_upper_batched(Bm, U), ref.trsm_right_upper(Bm, U))
    assert torch.equal(su_mod.schur_update(Bm[0], Bm[0], U[0]),
                       ref.schur_update(Bm[0], Bm[0], U[0]))
    assert torch.equal(su_mod.schur_update_batched(Bm, Bm, U), ref.schur_update(Bm, Bm, U))
    assert [w.launches for w in wrappers] == before


_NO_BUILD_SCRIPT = """
from repro_torch.kernels import _build

def refuse(*args, **kwargs):
    raise AssertionError("a CPU call or an import reached the kernel build")

_build.function = _build.build = refuse
import torch
from repro_torch.kernels import chol_panel, trsm

A = 2.0 * torch.eye(8, dtype=torch.float64) + 0.1
L = torch.tril(torch.ones(8, 8)) + torch.eye(8)
B = torch.ones(8, 5)
chol_panel.chol_panel(A)
chol_panel.chol_panel_batched(A[None])
trsm.trsm_left_lower(L, B)
trsm.trsm_left_lower_batched(L[None], B[None], unit=False)
trsm.trsm_right_upper(B.T, L.T)
trsm.trsm_right_upper_batched(B.T[None], L.T[None])
print("no build")
"""


def test_cpu_calls_and_imports_never_reach_the_kernel_build():
    """The wrappers resolve their CUDA entry points at the first CUDA call:
    importing chol_panel and trsm and calling them on CPU tensors, in a
    fresh process with `_build.function` and `_build.build` raising, never
    builds (this host has no nvcc)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    done = subprocess.run([sys.executable, "-c", _NO_BUILD_SCRIPT], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "no build"


def test_wrappers_raise_for_non_cuda_devices_and_bad_shapes():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cp_mod.chol_panel(torch.empty((8, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        cp_mod.chol_panel_batched(torch.empty((2, 8, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tr_mod.trsm_right_upper(torch.empty((64, 8), **meta), torch.empty((8, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tr_mod.trsm_right_upper_batched(torch.empty((2, 64, 8), **meta),
                                        torch.empty((2, 8, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        su_mod.schur_update(torch.empty((64, 32), **meta), torch.empty((64, 8), **meta),
                            torch.empty((8, 32), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        su_mod.schur_update_batched(torch.empty((2, 64, 32), **meta),
                                    torch.empty((2, 64, 8), **meta),
                                    torch.empty((2, 8, 32), **meta))
    # shapes are checked before the device
    with pytest.raises(ValueError, match=r"\[v, v\]"):
        cp_mod.chol_panel(torch.empty((8, 9), **meta))
    with pytest.raises(ValueError, match="v <= 128"):
        cp_mod.chol_panel_batched(torch.empty((2, 129, 129), **meta))
    with pytest.raises(ValueError, match=r"U \[Bb, v, v\]"):
        tr_mod.trsm_right_upper_batched(torch.empty((2, 64, 8), **meta),
                                        torch.empty((3, 8, 8), **meta))
    with pytest.raises(ValueError, match="65535 systems"):
        tr_mod.trsm_right_upper_batched(torch.empty((65536, 8, 8), **meta),
                                        torch.empty((65536, 8, 8), **meta))
    with pytest.raises(ValueError, match=r"L \[M, K\]"):
        su_mod.schur_update(torch.empty((64, 32), **meta), torch.empty((63, 8), **meta),
                            torch.empty((8, 32), **meta))
    with pytest.raises(ValueError, match="unit column stride"):
        su_mod.schur_update(torch.empty((64, 32), **meta), torch.empty((64, 8), **meta),
                            torch.empty((32, 8), **meta).mT)


# --------------------------------------------------------------------------
# chol_blocked_sequential[_batched] against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N,v,jax_backend_name", [
    (64, 8, "ref"), (128, 32, "ref"), (96, 16, "ref"), (64, 16, "pallas"),
])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_chol_sequential_matches_jax(N, v, jax_backend_name, backend):
    A = _spd((N, N), seed=N + v)
    L = tchol.chol_blocked_sequential(torch.from_numpy(A), v, backend, device="cpu")
    jL = _np(jchol.chol_blocked_sequential(jnp.asarray(A), v=v, backend=jax_backend_name))
    assert L.shape == (N, N) and torch.equal(L, torch.tril(L))
    np.testing.assert_allclose(L.numpy(), jL, rtol=0, atol=1e-4 * np.abs(jL).max())


@pytest.mark.parametrize("B,N,v,jax_backend_name", [
    (3, 64, 8, "ref"), (2, 128, 32, "ref"), (2, 64, 16, "pallas"),
])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_chol_batched_matches_jax(B, N, v, jax_backend_name, backend):
    A = _spd((B, N, N), seed=B + N + v)
    L = tchol.chol_blocked_sequential_batched(torch.from_numpy(A), v, backend, device="cpu")
    jL = _np(jchol.chol_blocked_sequential_batched(jnp.asarray(A), v=v,
                                                    backend=jax_backend_name))
    assert L.shape == (B, N, N)
    np.testing.assert_allclose(L.numpy(), jL, rtol=0, atol=1e-4 * np.abs(jL).max())


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_chol_batch_lanes_equal_the_single_path_bitwise(backend):
    A = torch.from_numpy(_spd((4, 64, 64), seed=8))
    L = tchol.chol_blocked_sequential_batched(A, 16, backend, device="cpu")
    for b in range(4):
        assert torch.equal(tchol.chol_blocked_sequential(A[b], 16, backend, device="cpu"), L[b])


def test_chol_sequential_leaves_input_untouched_and_rejects_bad_shapes():
    A = torch.from_numpy(_spd((32, 32), seed=2))
    before = A.clone()
    tchol.chol_blocked_sequential(A, 8, device="cpu")
    assert torch.equal(A, before)
    with pytest.raises(ValueError, match="multiple"):
        tchol.chol_blocked_sequential(A, 12, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, N, N\]"):
        tchol.chol_blocked_sequential_batched(A, 8, device="cpu")
    with pytest.raises(ValueError, match=r"\[N, N\]"):
        tchol.chol_blocked_sequential(torch.zeros(32, 16), 8, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tchol.chol_blocked_sequential(A, 8, device="meta")


def test_not_spd_factorization_gives_nan_and_does_not_raise():
    A = _spd((64, 64), seed=6)
    A[40, 40] = -50.0  # the pivot of column 40 goes negative
    for backend in ("cuda", "ref"):
        L = tchol.chol_blocked_sequential(torch.from_numpy(A), 16, backend, device="cpu")
        assert torch.isfinite(L[:40, :40]).all()
        assert torch.isnan(L[40:, 40:]).any()
    fact = plan(64, strategy="sequential_chol", device="cpu").execute(A)
    assert torch.isnan(fact.solve(np.ones(64, np.float32))).any()


def test_chol_solve_and_reconstruct_match_jax():
    A = _spd((64, 64), seed=12)
    b = np.random.default_rng(12).standard_normal((64, 3)).astype(np.float32)
    jL = jchol.chol_blocked_sequential(jnp.asarray(A), v=16, backend="ref")
    L = torch.tensor(_np(jL))
    jx = _np(jchol.chol_solve(jL, jnp.asarray(b)))
    np.testing.assert_allclose(tchol.chol_solve(L, torch.from_numpy(b)).numpy(), jx,
                               rtol=0, atol=1e-4 * np.abs(jx).max())
    np.testing.assert_allclose(tchol.chol_reconstruct(L).numpy(),
                               _np(jchol.chol_reconstruct(jL)), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# plan(N, strategy="sequential_chol") and its Factorization
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N,k", [(64, None), (128, None), (128, 3)])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_plan_chol_solve_matches_jax_and_scipy(N, k, backend):
    A = _spd((N, N), seed=N)
    rng = np.random.default_rng(N + 1)
    b = rng.standard_normal((N,) if k is None else (N, k)).astype(np.float32)
    fact = plan(N, SolverConfig(strategy="sequential_chol", backend=backend),
                device="cpu").execute(A)
    assert (fact.kind, fact.strategy, fact.backend) == ("cholesky", "sequential_chol", backend)
    assert torch.equal(fact.rows, torch.arange(N))
    x = fact.solve(b)
    assert x.shape == b.shape
    jL = jchol.chol_blocked_sequential(jnp.asarray(A), v=32, backend="ref")
    jx = _np(jchol.chol_solve(jL, jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
    sx = scipy.linalg.cho_solve(scipy.linalg.cho_factor(A.astype(np.float64)),
                                b.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), sx, rtol=0, atol=1e-4 * np.abs(sx).max())


def test_plan_chol_slogdet_det_reconstruct_unpack():
    A = _spd((64, 64), seed=3)
    fact = plan(64, strategy="sequential_chol", device="cpu").execute(A)
    sign, logdet = fact.slogdet()
    nsign, nlogdet = np.linalg.slogdet(A.astype(np.float64))
    assert float(sign) == nsign == 1.0
    np.testing.assert_allclose(float(logdet), nlogdet, rtol=1e-5)
    np.testing.assert_allclose(float(fact.det()), np.exp(nlogdet), rtol=1e-4)
    np.testing.assert_allclose(fact.reconstruct().numpy(), A, atol=1e-5 * np.abs(A).max())
    L = fact.unpack()
    assert torch.equal(L, fact.F) and torch.equal(L, torch.tril(L))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A.astype(np.float64)),
                               atol=1e-5)
    assert "kind=cholesky" in fact.comm_report()
    # refined solves are ported (ROADMAP.md module item 7)
    rs = fact.solve(np.ones(64, np.float32), refine_tol=1e-6)
    assert rs.converged and rs.final_residual <= 1e-6 and rs.x.dtype == torch.float32


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_plan_chol_batched_solve_slogdet_reconstruct(backend):
    A = _spd((3, 64, 64), seed=21)
    b = np.random.default_rng(21).standard_normal((3, 64)).astype(np.float32)
    fact = plan((3, 64), SolverConfig(strategy="sequential_chol", backend=backend),
                device="cpu").execute(A)
    assert fact.batched and fact.B == 3 and fact.kind == "cholesky"
    assert torch.equal(fact.rows, torch.arange(64).expand(3, 64))
    x = fact.solve(b)
    jL = jchol.chol_blocked_sequential_batched(jnp.asarray(A), v=32, backend="ref")
    for i in range(3):
        jx = _np(jchol.chol_solve(jL[i], jnp.asarray(b[i])))
        np.testing.assert_allclose(x[i].numpy(), jx, rtol=0, atol=1e-4 * np.abs(jx).max())
        sx = scipy.linalg.cho_solve(scipy.linalg.cho_factor(A[i].astype(np.float64)),
                                    b[i].astype(np.float64))
        np.testing.assert_allclose(x[i].numpy(), sx, rtol=0, atol=1e-4 * np.abs(sx).max())
    sign, logdet = fact.slogdet()
    nsign, nlogdet = np.linalg.slogdet(A.astype(np.float64))
    np.testing.assert_array_equal(sign.numpy(), nsign)
    np.testing.assert_allclose(logdet.numpy(), nlogdet, rtol=1e-5)
    np.testing.assert_allclose(fact.reconstruct().numpy(), A, atol=1e-5 * np.abs(A).max())
    assert torch.equal(fact.unpack(), fact.F)
    X = fact.solve(np.stack([b, b], axis=-1))
    assert X.shape == (3, 64, 2) and torch.equal(X[..., 0], X[..., 1])


def test_plan_chol_batched_lanes_equal_single_plans_bitwise():
    A = _spd((3, 64, 64), seed=22)
    facts = plan((3, 64), strategy="sequential_chol", device="cpu").execute(A)
    single = plan(64, strategy="sequential_chol", device="cpu")
    for i in range(3):
        assert torch.equal(single.execute(A[i]).F, facts.F[i])


def test_pivot_normalises_to_one_cache_key():
    keys = {resolve(64, SolverConfig(strategy="sequential_chol", pivot=p)).cache_key(64)
            for p in ("tournament", "partial", "none")}
    assert len(keys) == 1
    p = plan(64, SolverConfig(strategy="sequential_chol"), device="cpu")
    assert p.config.pivot == "none" and p.config.v == 32
    for piv in ("partial", "none"):
        assert plan(64, SolverConfig(strategy="sequential_chol", pivot=piv), device="cpu") is p
    assert plan(64, device="cpu") is not p  # the LU plan has its own key
    assert plan((2, 64), strategy="sequential_chol", device="cpu") is not p
    with pytest.raises(ValueError, match="panel width"):
        resolve(64, SolverConfig(strategy="sequential_chol", v=12))


def test_plan_chol_without_device_targets_cuda():
    if torch.cuda.is_available():
        assert plan(64, strategy="sequential_chol").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan(64, strategy="sequential_chol")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tchol.chol_blocked_sequential(np.eye(32, dtype=np.float32), 8)


def test_factorization_from_numpy_cholesky_round_trips_a_jax_factor():
    A = _spd((64, 64), seed=9)
    b = np.random.default_rng(9).standard_normal(64).astype(np.float32)
    jL = jchol.chol_blocked_sequential(jnp.asarray(A), v=16, backend="ref")
    jx = _np(jchol.chol_solve(jL, jnp.asarray(b)))
    fact = interop.factorization_from_numpy(np.array(jL), np.arange(64), device="cpu",
                                            kind="cholesky", A_ref=A)
    assert fact.kind == "cholesky" and torch.equal(fact.rows, torch.arange(64))
    np.testing.assert_allclose(fact.solve(b).numpy(), jx, rtol=0, atol=1e-5 * np.abs(jx).max())
    np.testing.assert_allclose(fact.reconstruct().numpy(), A, atol=1e-5 * np.abs(A).max())
    sign, logdet = fact.slogdet()
    assert float(sign) == 1.0
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(A.astype(np.float64))[1],
                               rtol=1e-5)
    jLb = jchol.chol_blocked_sequential_batched(jnp.asarray(np.stack([A, A])), v=16)
    factb = interop.factorization_from_numpy(np.array(jLb), np.stack([np.arange(64)] * 2),
                                             device="cpu", kind="cholesky")
    assert factb.batched and torch.equal(factb.F[1], fact.F)
    np.testing.assert_allclose(factb.solve(np.stack([b, b]))[1].numpy(), jx, rtol=0,
                               atol=1e-5 * np.abs(jx).max())
