"""bf16 and f16 on the Cholesky kernels and the 2.5D schedules, against the JAX package, on the CPU.

- Kernels: the 2-byte plain versions of `chol_panel[_batched]`,
  `trsm_right_upper[_batched]`, `trsm_left_lower[_batched]` and
  `schur_update[_batched]` (the wrappers' path for CPU tensors) against the
  JAX package's Pallas kernels (interpret mode) and its `ref` oracles.  Both
  sides widen to f32, compute, and round once; the f32 results differ by the
  order of their sums (within the f32 tests' rtol = atol = 2e-4,
  tests/test_torch_cholesky.py), and one storage ulp more where that
  difference straddles a rounding boundary.  A batched lane equals the
  single call bit for bit.
- `chol_blocked_sequential[_batched]` in bf16 and f16 against the JAX
  package's on both its backends: bit for bit in bf16, within `_low_tol`
  in f16.
- 1x1x1 grids (conflux, baseline2d, cholesky25d): the flat hot loop against
  the JAX package's flat local program on "ref", the windowed one against
  its windowed program on "pallas" (the JAX "ref" fused step rounds U01
  first; see `tests/test_torch_mixed_precision.py`).  Pivots equal and F
  within `_low_tol`, except where the test below explains why not.
- In 2-byte storage the windowed hot loop keeps U01 in f32 for the update
  and the flat one stores it rounded: a stated difference, and the whole
  difference between them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core.lu  # noqa: F401  (must precede repro.kernels: import cycle)
import repro.core.cholesky.sequential as jchol_seq
import repro.core.lu.conflux as jconflux
import repro.core.lu.grid as jgrid
from repro.core.cholesky import conflux25d as jchol
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan
from repro_torch.core.cholesky import sequential as tchol
from repro_torch.core.collectives import LuMesh
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
# f16 partial pivoting against XLA, pivots equal (see the 1x1x1 test): the
# largest reading over its 16 cases is 51.6 * eps * max|F| at N = 128, v = 32
# (0.40 * N); the limit, N / 2 * eps * max|F|, stands 1.24x above it.
F16_PARTIAL_TOL_FACTOR = 0.5
# The f32 kernels against XLA's (tests/test_torch_cholesky.py): sums in another order.
F32_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _spd(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    G = rng.standard_normal(shape)
    return (G @ np.swapaxes(G, -1, -2) / n + np.eye(n)).astype(np.float32)


def _upper(shape, seed):
    """The transposed lower factor of an SPD block, as the Cholesky step passes L00^T."""
    return np.swapaxes(np.linalg.cholesky(_spd(shape, seed).astype(np.float64)),
                       -1, -2).astype(np.float32)


def _lower(shape, unit: bool, seed: int):
    rng = np.random.default_rng(seed)
    v = shape[-1]
    L = 0.3 * np.tril(rng.standard_normal(shape), -1)
    return (L + (np.eye(v) if unit else 2 * np.eye(v))).astype(np.float32)


def _ulp(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """One ulp of the 2-byte dtype at |x| (in f32); the subnormal spacing below."""
    fi = torch.finfo(dt)
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - 1 - MANTISSA[dt]).clamp_min(fi.tiny * fi.eps)


def _within_one_ulp(got: torch.Tensor, want, dt: torch.dtype) -> None:
    """|got - want| within one ulp of `dt` at the larger value plus the f32
    tolerance F32_TOL."""
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(jnp.float32)))
    got = got.float()
    assert got.shape == want.shape
    bound = (_ulp(torch.maximum(got.abs(), want.abs()), dt)
             + F32_TOL["atol"] + F32_TOL["rtol"] * want.abs())
    assert bool(((got - want).abs() <= bound).all()), float(((got - want).abs() / bound).max())


def _low_tol(dtype: torch.dtype, N: int, F_ref: np.ndarray) -> float:
    """As in tests/test_torch_mixed_precision.py: a sum in another order that
    lands beside a 2-byte rounding boundary rounds one ulp apart, and later
    steps carry it."""
    return N / 8 * torch.finfo(dtype).eps * float(np.abs(F_ref).max())


def _to(x: np.ndarray, dtype: str):
    tdt, jdt = LOW[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


# --------------------------------------------------------------------------
# The 2-byte plain versions of rows 5-12 against the Pallas kernels and oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("v", [8, 16, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chol_panel_2byte_matches_jax(dtype, v):
    tA, jA = _to(_spd((v, v), seed=v), dtype)
    L = ops.chol_panel(tA)
    assert L.dtype == tA.dtype and torch.equal(L, torch.tril(L))
    for jL in (jops.chol_panel(jA), jref.chol_panel(jA)):
        _within_one_ulp(L, jL, tA.dtype)
    tB, jB = _to(_spd((3, v, v), seed=10 + v), dtype)
    Lb = ops.chol_panel_batched(tB)
    _within_one_ulp(Lb, jops.chol_panel_batched(jB), tB.dtype)
    for b in range(3):
        assert torch.equal(Lb[b].view(torch.int16), ops.chol_panel(tB[b]).view(torch.int16))


@pytest.mark.parametrize("R,v", [(64, 8), (256, 16), (128, 32), (97, 31)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_trsm_right_upper_2byte_matches_jax(dtype, R, v):
    rng = np.random.default_rng(R + v)
    tB, jB = _to(rng.standard_normal((R, v)).astype(np.float32), dtype)
    tU, jU = _to(_upper((v, v), seed=v), dtype)
    X = ops.trsm_right_upper(tB, tU)
    assert X.dtype == tB.dtype
    for jX in (jops.trsm_right_upper(jB, jU), jref.trsm_right_upper(jB, jU)):
        _within_one_ulp(X, jX, tB.dtype)
    tB3, jB3 = _to(rng.standard_normal((2, R, v)).astype(np.float32), dtype)
    tU3, jU3 = _to(_upper((2, v, v), seed=v + 1), dtype)
    X3 = ops.trsm_right_upper_batched(tB3, tU3)
    _within_one_ulp(X3, jops.trsm_right_upper_batched(jB3, jU3), tB.dtype)
    for b in range(2):
        assert torch.equal(X3[b].view(torch.int16),
                           ops.trsm_right_upper(tB3[b], tU3[b]).view(torch.int16))


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("v,C", [(8, 64), (16, 256), (32, 96), (33, 65)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_trsm_left_lower_2byte_matches_jax(dtype, v, C, unit):
    rng = np.random.default_rng(v + C)
    tL, jL = _to(_lower((v, v), unit, seed=v), dtype)
    tB, jB = _to(rng.standard_normal((v, C)).astype(np.float32), dtype)
    X = ops.trsm_left_lower(tL, tB, unit=unit)
    assert X.dtype == tB.dtype
    for jX in (jops.trsm_left_lower(jL, jB, unit=unit), jref.trsm_left_lower(jL, jB, unit=unit)):
        _within_one_ulp(X, jX, tB.dtype)
    tL3, jL3 = _to(_lower((2, v, v), unit, seed=v + 1), dtype)
    tB3, jB3 = _to(rng.standard_normal((2, v, C)).astype(np.float32), dtype)
    X3 = ops.trsm_left_lower_batched(tL3, tB3, unit=unit)
    _within_one_ulp(X3, jops.trsm_left_lower_batched(jL3, jB3, unit=unit), tB.dtype)
    for b in range(2):
        assert torch.equal(X3[b].view(torch.int16),
                           ops.trsm_left_lower(tL3[b], tB3[b], unit=unit).view(torch.int16))


@pytest.mark.parametrize("M,N,K", [(64, 64, 8), (128, 96, 16), (256, 128, 32), (33, 300, 1),
                                   (64, 64, 48), (128, 64, 64), (200, 320, 32)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_schur_update_2byte_matches_jax(dtype, M, N, K):
    rng = np.random.default_rng(M + N + K)
    (tA, jA), (tL, jL), (tU, jU) = (_to(rng.standard_normal(s).astype(np.float32), dtype)
                                    for s in ((M, N), (M, K), (K, N)))
    out = ops.schur_update(tA, tL, tU)
    assert out.dtype == tA.dtype
    for jo in (jops.schur_update(jA, jL, jU), jref.schur_update(jA, jL, jU)):
        _within_one_ulp(out, jo, tA.dtype)
    (tA3, jA3), (tL3, jL3), (tU3, jU3) = (_to(rng.standard_normal(s).astype(np.float32), dtype)
                                          for s in ((2, M, N), (2, M, K), (2, K, N)))
    out3 = ops.schur_update_batched(tA3, tL3, tU3)
    _within_one_ulp(out3, jops.schur_update_batched(jA3, jL3, jU3), tA.dtype)
    for b in range(2):
        assert torch.equal(out3[b].view(torch.int16),
                           ops.schur_update(tA3[b], tL3[b], tU3[b]).view(torch.int16))


@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_schur_update_2byte_on_a_window_of_a_wider_matrix_matches_jax(dtype, K):
    """A as the conflux step passes it: a window of a wider matrix (row
    stride > N, base 64 columns in, 128 bytes), single and batched, against
    the JAX package's kernel and ref oracle on the window's values, within
    one ulp; the batched lane equals the single call bit for bit."""
    rng = np.random.default_rng(700 + K)
    big = rng.standard_normal((2, 96 + 32, 160 + 64)).astype(np.float32)
    tbig, _ = _to(big, dtype)
    A = tbig[:, 32:, 64:]
    assert A.stride(1) == 160 + 64
    assert A.data_ptr() - tbig.data_ptr() == 2 * (32 * (160 + 64) + 64)
    jA = jnp.asarray(big[:, 32:, 64:]).astype(LOW[dtype][1])
    (tL, jL), (tU, jU) = (_to(rng.standard_normal(s).astype(np.float32), dtype)
                          for s in ((2, 96, K), (2, K, 160)))
    out = ops.schur_update(A[0], tL[0], tU[0])
    outb = ops.schur_update_batched(A, tL, tU)
    assert outb.dtype == A.dtype
    assert torch.equal(outb[0].view(torch.int16), out.view(torch.int16))
    for jo in (jops.schur_update_batched(jA, jL, jU), jref.schur_update(jA, jL, jU)):
        _within_one_ulp(outb, jo, A.dtype)


# The body the schur_update kernel takes for operands at each edge, by element
# size (2, 4, 8 bytes): the wgmma stream for bf16 / f16 and the TMA stream for
# f32 where every operand has a 16-byte aligned base, row and batch strides
# of whole 16-byte runs and rows of at least 16 bytes, and K is at most one
# chunk (64 in 2 bytes, 32 in f32); else, and always in f64, the plain loads.
_STREAM_EDGES = {
    "aligned": ("wgmma", "tma", "plain"),
    "odd_row_stride": ("plain", "plain", "plain"),
    "base_one_element_in": ("plain", "plain", "plain"),
    "base_eight_elements_in": ("wgmma", "tma", "plain"),
    "K=1": ("plain", "plain", "plain"),
    "K=8": ("wgmma", "tma", "plain"),
    "K=33": ("plain", "plain", "plain"),
    "K=64": ("wgmma", "plain", "plain"),
    "K=65": ("plain", "plain", "plain"),
    "odd_batch_stride": ("plain", "plain", "plain"),
    "one_system_odd_batch_stride": ("wgmma", "tma", "plain"),
    "N=4": ("plain", "tma", "plain"),
    "N=100": ("plain", "tma", "plain"),
    "empty": ("plain", "plain", "plain"),
}


def _stream_operands(edge: str, dtype: torch.dtype):
    B, M, N, K = 2, 96, 256, 32
    if edge.startswith("K="):
        K = int(edge[2:])
    elif edge.startswith("N="):
        N = int(edge[2:])
    elif edge == "empty":
        M = 0
    elif edge == "one_system_odd_batch_stride":
        B = 1

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype)

    A, L, U = zeros(B, M, N), zeros(B, M, K), zeros(B, K, N)
    if edge == "odd_row_stride":
        A = zeros(B, M, N + 1)[..., :N]
    elif edge == "base_one_element_in":
        A = zeros(B, M, N + 8)[..., 1:N + 1]
    elif edge == "base_eight_elements_in":
        A = zeros(B, M, N + 8)[..., 8:]
    elif edge.endswith("odd_batch_stride"):
        A = zeros(B * (M * N + 1)).as_strided((B, M, N), (M * N + 1, N, 1))
    return A, L, U


@pytest.mark.parametrize("edge", list(_STREAM_EDGES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.float64])
def test_schur_update_stream_mode_follows_the_alignment_rule(dtype, edge):
    """`stream_mode` on CPU tensors: the rule alone (the kernel that follows
    it is held to its plain version on the card).  A single system predicts
    as a batch of one."""
    from repro_torch.kernels.schur_update import stream_mode

    A, L, U = _stream_operands(edge, dtype)
    want = _STREAM_EDGES[edge][{2: 0, 4: 1, 8: 2}[A.element_size()]]
    assert stream_mode(A, L, U) == want
    if A.shape[0] == 1:
        assert stream_mode(A[0], L[0], U[0]) == want


def test_f16_results_past_the_range_overflow_to_inf_as_in_jax():
    """A result over 65504 rounds to inf on store, in the port's plain
    versions as in the Pallas kernels."""
    A = np.zeros((64, 64), np.float32)
    L = np.zeros((64, 8), np.float32)
    U = np.zeros((8, 64), np.float32)
    L[:, 0] = 300.0
    U[0, :] = -300.0  # A - L U = 90000 > 65504
    (tA, jA), (tL, jL), (tU, jU) = (_to(x, "float16") for x in (A, L, U))
    out = ops.schur_update(tA, tL, tU)
    jo = np.asarray(jops.schur_update(jA, jL, jU).astype(jnp.float32))
    assert torch.isinf(out).all() and np.isinf(jo).all()
    B = np.full((16, 8), 60000.0, np.float32)
    Uu = np.eye(8, dtype=np.float32) * 0.5  # B / 0.5 = 120000
    (tB, jB), (tUu, jUu) = _to(B, "float16"), _to(Uu, "float16")
    X = ops.trsm_right_upper(tB, tUu)
    assert torch.isinf(X).all() and np.isinf(np.asarray(jops.trsm_right_upper(jB, jUu))).all()


# --------------------------------------------------------------------------
# chol_blocked_sequential[_batched] in bf16 and f16
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N,v", [(64, 16), (128, 32)])
@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chol_sequential_2byte_matches_jax(dtype, backend, jax_backend, N, v):
    """Every primitive widens, computes in f32 and rounds once, in both
    packages.  In bf16 no f32 sum of these inputs lands near enough to a
    rounding boundary for its order to show: the factors equal the JAX
    package's bit for bit on both its backends.  f16 keeps three more bits,
    so such sums round one ulp apart now and then (4 and 22 of 2080 entries
    at N = 64, v = 16 against "ref" and "pallas", none at N = 128, v = 32)
    and the later steps carry them: held to `_low_tol`."""
    tA, jA = _to(_spd((N, N), seed=N + v), dtype)
    L = tchol.chol_blocked_sequential(tA, v, backend, device="cpu")
    jL = np.asarray(jchol_seq.chol_blocked_sequential(jA, v=v, backend=jax_backend)
                    .astype(jnp.float32))
    assert L.dtype == tA.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(L.float().numpy(), jL)
    else:
        assert np.abs(L.float().numpy() - jL).max() <= _low_tol(tA.dtype, N, jL)


@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chol_sequential_batched_2byte_matches_jax(dtype, jax_backend):
    """As the single path, lane by lane; a lane equals the single call bit for bit."""
    B, N, v = 2, 64, 16
    tA, jA = _to(_spd((B, N, N), seed=7), dtype)
    L = tchol.chol_blocked_sequential_batched(tA, v, "cuda", device="cpu")
    jL = np.asarray(jchol_seq.chol_blocked_sequential_batched(jA, v=v, backend=jax_backend)
                    .astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(L.float().numpy(), jL)
    else:
        assert np.abs(L.float().numpy() - jL).max() <= _low_tol(tA.dtype, N, jL)
    for b in range(B):
        L1 = tchol.chol_blocked_sequential(tA[b], v, "cuda", device="cpu")
        assert torch.equal(L1.view(torch.int16), L[b].view(torch.int16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_chol_plan_2byte_refines_to_f32_accuracy(dtype):
    """plan(N, strategy="sequential_chol", compute_dtype=...) factors in the
    2-byte dtype and `solve(b, refine_tol=1e-6)` converges on an SPD matrix
    with eigenvalues in about [1, 5]."""
    N = 128
    A = _spd((N, N), seed=3)
    b = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    fact = plan(N, SolverConfig(strategy="sequential_chol", compute_dtype=dtype),
                device="cpu").execute(A)
    assert fact.kind == "cholesky" and fact.F.dtype == LOW[dtype][0]
    rs = fact.solve(b, refine_tol=1e-6)
    assert rs.converged and rs.x.dtype == torch.float32
    x = np.asarray(rs, np.float64)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 2e-6


# --------------------------------------------------------------------------
# 1x1x1 grids in bf16 and f16 against the JAX package's local programs
# --------------------------------------------------------------------------


def _inputs(N: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)).astype(np.float32)
    G = rng.standard_normal((N, N)).astype(np.float32)
    return A, G @ G.T / np.float32(N) + np.eye(N, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _reference_1x1x1(kind: str, pivot: str, N: int, v: int, dtype: str, hotloop: str):
    """The JAX package's local program on one CPU device, in `dtype`: the flat
    one on "ref", the windowed one on "pallas".  Returns (F as f32, rows)."""
    A, A_spd = _inputs(N, N + v)
    g = jgrid.GridConfig(1, 1, 1, v, N)
    mesh = jconflux.make_lu_mesh(g, devices=jax.devices()[:1])
    spec = P("px", "py", None, None)
    backend = "ref" if hotloop == "flat" else "pallas"
    if kind == "cholesky":
        body, outs, Ain = ((lambda b: jchol._local_chol(g, backend, b, hotloop=hotloop)),
                           spec, A_spd)
    else:
        body, outs, Ain = ((lambda b: jconflux._local_lu(g, pivot, backend, b, hotloop=hotloop)),
                           (spec, P()), A)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=outs, check_vma=False))
    got = fn(jnp.asarray(jconflux.block_cyclic_scatter(Ain, 1, 1, v)).astype(LOW[dtype][1]))
    blocks, rows = (got, np.arange(N)) if kind == "cholesky" else got
    F = jconflux.block_cyclic_gather(np.asarray(blocks.astype(jnp.float32)), N, v)
    return F, np.asarray(rows)


def _finalized_at(rows: np.ndarray, v: int) -> np.ndarray:
    """The step at which each entry of the packed LU factor is final: a pivot
    row's U part at its own step, every other entry (a multiplier) at the
    step of its column block."""
    N = len(rows)
    pos = np.empty(N, np.int64)
    pos[rows] = np.arange(N)
    return np.minimum((pos // v)[:, None], (np.arange(N) // v)[None, :])


def _tournament_candidates(panel: torch.Tensor, weights: torch.Tensor, r: int) -> torch.Tensor:
    """|F[i, r]| * w[i] at round r of the plain panel LUP (f32 rounds on the
    widened panel, as `masked_lup` and the tournament's `panel_lup`)."""
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


def _partial_candidates(panel: torch.Tensor, weights: torch.Tensor, r: int) -> torch.Tensor:
    """The same at round r of the schedules' partial pivoting on one rank
    (`conflux.partial_pivot`: elementwise ops in the storage dtype)."""
    F, w = panel.clone(), weights.clone()
    cols = torch.arange(F.shape[1])
    for k in range(r):
        p = int(torch.argmax(F[:, k].abs() * w))
        prow = F[p].clone()
        w[p] = 0
        safe = torch.where(prow[k].abs() > 0, prow[k], 1.0)
        active = w > 0
        mult = torch.where(active, F[:, k] / safe, F[:, k])
        F[:, k] = mult
        F = F - torch.outer(torch.where(active, mult, 0.0), prow * (cols > k).to(F.dtype))
    return (F[:, r].abs() * w).float()


def _record_panels(monkeypatch) -> list:
    """Keep every panel the schedules reduce over pz (step 1): on one rank it
    is the step's panel block column as the step reads it."""
    panels = []
    psum = LuMesh.psum

    def recording(self, x, axes):
        if axes == "pz" and x.ndim == 2:
            panels.append(x.clone())
        return psum(self, x, axes)

    monkeypatch.setattr(LuMesh, "psum", recording)
    return panels


def test_xla_fuses_the_f16_pivot_update_and_not_bf16():
    """The mechanism behind the f16 partial-pivoting exception above: XLA on
    the CPU evaluates F - outer(m, p) in f16 as one rounding of the f32
    result, and in bf16 as PyTorch does, rounding the product first."""
    rng = np.random.default_rng(0)
    F, m, p = (rng.standard_normal(s).astype(np.float32) for s in ((256, 16), (256,), (16,)))
    for dtype in ("float16", "bfloat16"):
        (tF, jF), (tm, jm), (tp, jp) = (_to(x, dtype) for x in (F, m, p))
        jx = jax.jit(lambda F, m, p: F - jnp.outer(m, p))(jF, jm, jp)
        jx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tF.dtype)
        eager = tF - torch.outer(tm, tp)
        fused = (tF.float() - torch.outer(tm.float(), tp.float())).to(tF.dtype)
        assert not torch.equal(eager, fused)
        assert torch.equal(jx, fused if dtype == "float16" else eager), dtype


class _U01Rounded(tbackend.RefBackend):
    """The plain backend with U01 rounded to the storage dtype before the
    update, as the flat hot loop's `trsm_left_lower` stores it."""

    name = "ref_u01_rounded"

    def fused_trsm_schur(self, A, L00, R01, L10, *, unit=True):
        U01 = tref.trsm_left_lower(L00, R01, unit=unit)
        return tref.schur_update(A, L10, U01), U01


@pytest.mark.parametrize("strategy,pivot", [("conflux", "tournament"), ("conflux", "partial"),
                                            ("cholesky25d", "none")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_2byte_windowed_differs_from_flat_only_by_rounding_u01(dtype, strategy, pivot):
    """A stated difference: in 2-byte storage the windowed hot loop's fused
    step keeps U01 in f32 for A - L10 U01, the flat one stores U01 rounded by
    `trsm_left_lower` and updates with that, so their factors differ (in f32
    they are equal bit for bit, tests/test_torch_distributed.py).  A windowed
    run whose fused step rounds U01 first gives the flat run's bits."""
    N, v = 128, 16
    A, A_spd = _inputs(N, N + v)
    Ain = A_spd if strategy == "cholesky25d" else A
    tbackend.register_backend(_U01Rounded.name, _U01Rounded(), overwrite=True)
    cfg = SolverConfig(strategy=strategy, pivot=pivot, grid=GridConfig(1, 1, 1, v, N),
                       compute_dtype=dtype)
    facts = {(hl, bk): plan(N, cfg.with_(hotloop=hl, backend=bk), device="cpu").execute(Ain)
             for hl, bk in (("windowed", "cuda"), ("flat", "cuda"),
                            ("windowed", _U01Rounded.name))}
    flat = facts["flat", "cuda"]
    assert not torch.equal(facts["windowed", "cuda"].F, flat.F)
    rounded = facts["windowed", _U01Rounded.name]
    assert torch.equal(rounded.rows, flat.rows)
    assert torch.equal(rounded.F.view(torch.int16), flat.F.view(torch.int16))


@pytest.mark.parametrize("hotloop", ["windowed", "flat"])
@pytest.mark.parametrize("pivot", ["tournament", "partial"])
def test_2byte_pivot_ids_past_the_dtypes_exact_integers(pivot, hotloop):
    """F5: the schedules carry pivot ids beside the panel's values; in bf16,
    which holds no integer above 256 exactly, they ride widened to f32.  At
    N = 512 the pivot order is a permutation and the bf16 factors refine to
    1e-6 on a well-conditioned A (G / sqrt(N) + 2 I)."""
    N, v = 512, 32
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2 * np.eye(N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    cfg = SolverConfig(strategy="conflux", pivot=pivot, grid=GridConfig(1, 1, 1, v, N),
                       hotloop=hotloop, compute_dtype="bfloat16")
    fact = plan(N, cfg, device="cpu").execute(A)
    assert sorted(fact.rows.tolist()) == list(range(N))
    rs = fact.solve(b, refine_tol=1e-6)
    assert rs.converged


def test_cholesky_engines_on_a_2byte_plan_refine_the_lanes_that_ask():
    """SolveEngine and AsyncSolveEngine over sequential_chol with a bf16
    compute dtype: the lanes that pass refine_tol reach it, the others keep
    the plain batched solve bit for bit."""
    from repro_torch.serving import AsyncSolveEngine, SolveEngine

    n = 32
    cfg = SolverConfig(strategy="sequential_chol", compute_dtype="bfloat16", v=8)
    reqs = [(_spd((n, n), seed=70 + i), np.random.default_rng(70 + i).standard_normal(n)
             .astype(np.float32)) for i in range(5)]
    tols = (1e-6, None, 1e-5, None, 1e-6)
    slot = 8
    A = np.stack([a for a, _ in reqs] + [np.eye(n, dtype=np.float32)] * (slot - len(reqs)))
    b = np.stack([b for _, b in reqs] + [np.zeros(n, np.float32)] * (slot - len(reqs)))
    plain = plan((slot, n), cfg, device="cpu").execute(A).solve(b)

    def check(xs):
        for i, ((Ai, bi), tol) in enumerate(zip(reqs, tols)):
            if tol is None:
                assert torch.equal(xs[i], plain[i])
            else:
                x = np.asarray(xs[i], np.float64)
                assert np.linalg.norm(Ai @ x - bi) / np.linalg.norm(bi) <= 2 * tol

    eng = SolveEngine(n, cfg, device="cpu")
    tickets = [eng.submit_system(Ai, bi, refine_tol=t) for (Ai, bi), t in zip(reqs, tols)]
    out = eng.flush_systems()
    check([out[t] for t in tickets])
    st = eng.stats()
    assert st["refined_systems"] == 3 and st["refine_nonconverged"] == 0
    clock = [0.0]
    aeng = AsyncSolveEngine(n, cfg, device="cpu", max_batch=8, max_delay_ms=1.0, start=False,
                            clock=lambda: clock[0])
    futs = [aeng.submit(Ai, bi, refine_tol=t) for (Ai, bi), t in zip(reqs, tols)]
    clock[0] = 1.0
    assert aeng.pump() == len(reqs)
    check([f.result(timeout=0) for f in futs])
    assert aeng.stats()["refined_systems"] == 3
    aeng.close()


def _f16_partial_readings() -> None:
    """Print |F - F_jax|max / (eps * max|F_jax|) and whether the pivots agree
    for every f16 partial-pivoting case of the 1x1x1 test: the readings that
    F16_PARTIAL_TOL_FACTOR stands above."""
    for strategy in ("conflux", "baseline2d"):
        for N, v in ((64, 16), (64, 32), (128, 16), (128, 32)):
            for hotloop in ("flat", "windowed"):
                clear_plan_cache()
                A, _ = _inputs(N, N + v)
                cfg = SolverConfig(strategy=strategy, pivot="partial", hotloop=hotloop,
                                   grid=GridConfig(1, 1, 1, v, N), compute_dtype="float16")
                fact = plan(N, cfg, device="cpu").execute(A)
                F_ref, rows_ref = _reference_1x1x1("lu", "partial", N, v, "float16", hotloop)
                ratio = (np.abs(fact.F.float().numpy() - F_ref).max()
                         / (torch.finfo(torch.float16).eps * np.abs(F_ref).max()))
                print(strategy, N, v, hotloop, "rows_equal",
                      bool((fact.rows.numpy() == rows_ref).all()), "eps_maxF", float(ratio),
                      "per_N", float(ratio / N), flush=True)


if __name__ == "__main__":  # PYTHONPATH=src JAX_PLATFORMS=cpu python <this file>
    _f16_partial_readings()
