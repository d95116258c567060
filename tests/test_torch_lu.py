"""The port's sequential masked LU against the JAX package's, on the CPU.

The same seeded matrix goes through `repro_torch.core.lu.lu_masked_sequential`
(either port backend; on CPU tensors both run plain PyTorch) and through
`repro.core.lu.sequential.lu_masked_sequential` on the JAX "ref" backend and
on "pallas" (interpret mode, kept to N <= 128 since it is slow).  Pivot
orders must be equal; packed factors agree within atol 1e-4 * max|A|.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lu.sequential as jseq
from repro_torch.core.lu import sequential as tseq


def _matrix(N, seed):
    return np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)


@pytest.mark.parametrize("N,v,jax_backend", [
    (64, 8, "ref"), (128, 16, "ref"), (256, 32, "ref"),
    (64, 8, "pallas"), (128, 32, "pallas"),
])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_lu_matches_jax(N, v, jax_backend, backend):
    A = _matrix(N, seed=N + v)
    F, rows = tseq.lu_masked_sequential(torch.from_numpy(A), v, backend, device="cpu")
    jF, jrows = jseq.lu_masked_sequential(jnp.asarray(A), v=v, backend=jax_backend)
    assert rows.dtype == torch.int64
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=0,
                               atol=1e-4 * np.abs(A).max())


def test_lu_leaves_the_input_untouched():
    A = torch.from_numpy(_matrix(64, seed=1))
    before = A.clone()
    tseq.lu_masked_sequential(A, 16, device="cpu")
    assert torch.equal(A, before)


def test_lu_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple"):
        tseq.lu_masked_sequential(torch.zeros(64, 64), 24, device="cpu")
    with pytest.raises(ValueError, match="square"):
        tseq.lu_masked_sequential(torch.zeros(64, 32), 8, device="cpu")


def _onehot_lu(A: torch.Tensor, v: int):
    """The JAX reference's step body, one-hot gathers and scatters and all."""
    from repro_torch.kernels import ref

    N = A.shape[0]
    F, active = A.clone(), torch.ones(N)
    rows = torch.zeros(N, dtype=torch.int64)
    eye, cols = torch.eye(v), torch.arange(N)
    for c0 in range(0, N, v):
        Fp, order, _ = ref.lu_panel(F[:, c0:c0 + v], active)
        F[:, c0:c0 + v] = Fp
        rows[c0:c0 + v] = order.long()
        piv = torch.nn.functional.one_hot(order.long(), N).float()  # [v, N]
        active = active * (1.0 - piv.sum(0))
        colmask = (cols >= c0 + v).float()
        L10 = Fp * active[:, None]
        L00 = torch.tril(piv @ Fp, -1) + eye
        R01 = (piv @ F) * colmask[None, :]
        F, U01 = ref.fused_trsm_schur(F, L00, R01, L10 * active[:, None])
        F = F * (1.0 - piv.sum(0)[:, None] * colmask[None, :]) + piv.T @ (U01 * colmask[None, :])
    return F, rows


@pytest.mark.parametrize("N,v", [(64, 8), (128, 32)])
def test_gather_scatter_equals_onehot_bitwise(N, v):
    A = torch.from_numpy(_matrix(N, seed=2 * N + v))
    F, rows = tseq.lu_masked_sequential(A, v, "ref", device="cpu")
    oF, orows = _onehot_lu(A, v)
    assert torch.equal(rows, orows)
    assert torch.equal(F, oF)


def _jax_factors(N=64, v=16, seed=4):
    A = _matrix(N, seed)
    jF, jrows = jseq.lu_masked_sequential(jnp.asarray(A), v=v, backend="ref")
    return A, np.array(jF), np.array(jrows)


def test_unpack_factors_matches_jax():
    _, F, rows = _jax_factors()
    P, L, U = tseq.unpack_factors(torch.from_numpy(F), torch.from_numpy(rows).long())
    jP, jL, jU = jseq.unpack_factors(jnp.asarray(F), jnp.asarray(rows))
    for got, want in ((P, jP), (L, jL), (U, jU)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reconstruct_matches_jax_and_input():
    A, F, rows = _jax_factors()
    got = tseq.reconstruct(torch.from_numpy(F), torch.from_numpy(rows).long()).numpy()
    np.testing.assert_allclose(got, np.asarray(jseq.reconstruct(jnp.asarray(F), jnp.asarray(rows))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, A, atol=1e-4 * np.abs(A).max())


@pytest.mark.parametrize("seed", range(4))
def test_permutation_sign_matches_jax(seed):
    perm = np.random.default_rng(seed).permutation(37)
    assert tseq.permutation_sign(torch.from_numpy(perm)) == jseq.permutation_sign(perm)
    assert tseq.permutation_sign(perm) == round(np.linalg.det(np.eye(37)[perm]))
