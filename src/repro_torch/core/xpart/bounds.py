"""I/O lower bounds for a single DAAP statement (paper §3).

The optimization problem (3):

    max  prod_t |R^t|            over |R^t| >= 1
    s.t. sum_j c_j * prod_{k in phi_j} |R^k|  <=  X

is a geometric program: with x_t = log|R^t| it becomes

    max  sum_t x_t    s.t.  sum_j c_j exp(a_j . x) <= X,   x >= 0

— a linear objective over a convex feasible set.  We solve it by Lagrangian
dual bisection: for a multiplier lam, the inner problem
`max_x sum_t x_t - lam * sum_j c_j exp(a_j.x)` is smooth and concave; the map
lam -> constraint value at the inner optimum is monotone, so we bisect lam
until the dominator budget X is met.  Dimensions are tiny (l <= 6), so this is
exact to ~1e-9 and costs microseconds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.xpart.daap import Statement

_BIG = 1e30


@dataclass(frozen=True)
class PsiResult:
    """psi(X) = |V_max| and the maximizing extents |R^t|."""

    value: float
    extents: dict[str, float]

    def access_sizes(self, stmt: Statement) -> dict[str, float]:
        return {a.array: math.prod(self.extents[v] for v in a.vars) for a in stmt.inputs}


def _inner_max(
    A: np.ndarray, c: np.ndarray, lam: float, caps: np.ndarray, x0: np.ndarray | None = None
) -> np.ndarray:
    """max_x  sum(x) - lam * sum_j c_j exp(A_j . x)   s.t. 0 <= x <= caps.

    Projected gradient ascent with backtracking; concave, tiny dims.  Supports
    warm starts (x0) so the outer lam-bisection converges in a few steps each.
    """
    l = A.shape[1]
    x = np.zeros(l) if x0 is None else np.clip(x0, 0.0, caps)

    def val_grad(x):
        e = c * np.exp(np.minimum(A @ x, 700.0))
        v = x.sum() - lam * e.sum()
        g = np.ones(l) - lam * (A.T @ e)
        return v, g

    step = 1.0
    v, g = val_grad(x)
    for _ in range(400):
        # Projected-gradient fixed point: stop when no clipped coordinate moves.
        x_new = np.clip(x + step * g, 0.0, caps)
        if np.max(np.abs(x_new - x)) < 1e-12:
            break
        v_new, g_new = val_grad(x_new)
        if v_new > v + 1e-15:
            x, v, g = x_new, v_new, g_new
            step = min(step * 1.5, 1e6)
        else:
            step *= 0.5
            if step < 1e-13:
                break
    return x


def psi(stmt: Statement, X: float, _cap_scale: float = 1e12) -> PsiResult:
    """psi(X) = |V_max| for statement `stmt` under dominator budget X (Lemma 3 + (3))."""
    lv = list(stmt.loop_vars)
    idx = {v: i for i, v in enumerate(lv)}
    l = len(lv)
    rows, coeffs = [], []
    for a in stmt.inputs:
        row = np.zeros(l)
        for v in a.vars:
            row[idx[v]] = 1.0
        rows.append(row)
        coeffs.append(a.coeff)
    A = np.asarray(rows) if rows else np.zeros((0, l))
    c = np.asarray(coeffs)
    # Effective-zero coefficients (rho_producer -> inf) impose no constraint.
    keep = c > 1e-300
    A, c = A[keep], c[keep]

    caps = np.array(
        [math.log(min(stmt.var_caps.get(v, _cap_scale), _cap_scale)) for v in lv]
    )

    if A.size == 0 or not A.any(axis=0).all():
        # Some variable appears in no (weighted) input access: psi is capped only
        # by var_caps.  Solve over constrained vars; uncovered vars take their cap.
        pass  # handled uniformly below — uncovered columns have zero gradient from lam.

    # Bisection on lam: constraint g(lam) = sum_j c_j exp(A x(lam)) is decreasing.
    lo, hi = 1e-14, 1e14
    x = None
    for _ in range(60):
        lam = math.sqrt(lo * hi)
        x = _inner_max(A, c, lam, caps, x0=x)
        g = float(np.sum(c * np.exp(A @ x))) if len(c) else 0.0
        if g > X:
            lo = lam
        else:
            hi = lam
        if hi / lo < 1 + 1e-12:
            break
    x = _inner_max(A, c, hi, caps, x0=x)  # final feasible point
    # Polish: scale along uncovered coords is already at caps; ensure feasibility.
    g = float(np.sum(c * np.exp(A @ x))) if len(c) else 0.0
    if g > X * (1 + 1e-9):
        # back off uniformly on covered coords
        covered = A.any(axis=0)
        scale = math.log(X / g) / max(np.sum(A @ (x * 0 + 1.0)), 1.0)
        x[covered] = np.maximum(x[covered] + scale, 0.0)
    extents = {v: float(math.exp(x[idx[v]])) for v in lv}
    return PsiResult(value=float(math.exp(np.sum(x))), extents=extents)


@dataclass(frozen=True)
class IntensityResult:
    """rho = computational intensity at the bound-maximizing X0 (Lemma 2).

    `bound` is the full Lemma-1 form  Q >= n*(X0-M)/psi(X0) - (X0-M): the
    -(X0-M) slack keeps the bound valid even when psi(X) saturates at |V|
    (whole domain in one subcomputation) — in the paper's regime psi << |V|
    it is negligible and Q ~= |V|/rho.
    """

    rho: float
    X0: float
    psi0: PsiResult
    bound: float
    clamped_by_out_degree_one: bool = False


def max_computational_intensity(
    stmt: Statement, M: float, X_max: float | None = None, n_grid: int = 20
) -> IntensityResult:
    """Find X0 = argmax_X [n(X-M)/psi(X) - (X-M)] and rho(X0) (Lemma 2 + Lemma 6).

    Numerics: psi is solved to ~1e-3 relative tolerance; the returned bound
    inherits that tolerance (tests compare against closed forms with rtol=1e-2).
    """
    if X_max is None:
        X_max = 4096.0 * M
    n = stmt.domain_size

    cache: dict[float, tuple[float, float, PsiResult]] = {}

    def eval_at(X: float) -> tuple[float, float, PsiResult]:
        """(bound, rho, psi) at X; we maximize `bound`."""
        if X not in cache:
            p = psi(stmt, X)
            rho = p.value / (X - M)
            q = (X - M) * (n / p.value - 1.0)
            cache[X] = (q, rho, p)
        return cache[X]

    # Log grid scan, then golden-section refinement around the best X.
    Xs = np.exp(np.linspace(math.log(M * (1 + 1e-3)), math.log(X_max), n_grid))
    vals = [eval_at(float(X))[0] for X in Xs]
    i = int(np.argmax(vals))
    lo = float(Xs[max(i - 1, 0)])
    hi = float(Xs[min(i + 1, n_grid - 1)])
    gr = (math.sqrt(5) - 1) / 2
    a, b = lo, hi
    c_, d_ = b - gr * (b - a), a + gr * (b - a)
    fc, fd = eval_at(c_)[0], eval_at(d_)[0]
    for _ in range(24):
        if fc > fd:
            b, d_, fd = d_, c_, fc
            c_ = b - gr * (b - a)
            fc = eval_at(c_)[0]
        else:
            a, c_, fc = c_, d_, fd
            d_ = a + gr * (b - a)
            fd = eval_at(d_)[0]
    X0 = (a + b) / 2
    q, rho, p0 = eval_at(X0)

    clamped = False
    u = stmt.u_out_degree_one
    if u > 0 and rho > 1.0 / u:  # Lemma 6
        rho = 1.0 / u
        q = n * u  # each vertex consumes u out-degree-1 inputs: no X slack needed
        clamped = True
    return IntensityResult(rho=rho, X0=X0, psi0=p0, bound=max(q, 0.0),
                           clamped_by_out_degree_one=clamped)


def sequential_io_lower_bound(stmt: Statement, M: float, **kw) -> float:
    """Q >= |V|*(X0-M)/psi(X0) - (X0-M)  (Lemma 1 / Lemma 2)."""
    return max_computational_intensity(stmt, M, **kw).bound


def parallel_io_lower_bound(stmt: Statement, M: float, P: int, **kw) -> float:
    """Q_P >= |V| / (P * rho)  (Lemma 9: at least one processor computes |V|/P)."""
    return sequential_io_lower_bound(stmt, M, **kw) / P
