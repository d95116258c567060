"""Factorization — the result type every strategy returns.

`kind="lu"`: packed masked factors (rows never move, paper §7.3) and the
pivot order.  `kind="cholesky"`: F holds the lower factor L with
A = L L^T, and rows is the identity order.  Besides, the grid the
factorization ran on and the instrumented per-processor communication
volume of the schedule.  Solves, determinants and reconstruction are
methods.  Everything stays on the factors' device.

A batched plan's result holds B factorizations, F [B, N, N] and rows
[B, N]; every method then works per system along the leading axis.

Mixed precision: a plan built with `SolverConfig(compute_dtype=...)`
factors in the compute dtype and keeps the working-precision input on the
result as `A_ref`.  `solve(b, refine_tol=...)` then runs iterative
refinement: residuals `r = b - A x` in the working dtype, correction solves
on the low-precision factors, until the relative residual passes the
tolerance or the iteration cap.  It returns a `RefinedSolve` with the
refined x and `refinement_iters` / `final_residual` / `converged`.  f64 is
native in torch, so a float64 working dtype needs no special mode.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.api.config import as_tensor
from repro_torch.core.cholesky.sequential import chol_reconstruct, chol_solve
from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.lu.sequential import (
    gather_rows,
    permutation_signs,
    reconstruct,
    unpack_factors,
)
from repro_torch.core.solve import lu_solve


def _solve_dtype(factor_dtype: torch.dtype) -> torch.dtype:
    """The dtype the triangular solves run in: f32 over factors narrower
    than f32 (PyTorch has no bf16 or f16 triangular solve, and such solves
    would add their own noise to the factors' error), else the factors'."""
    return torch.float32 if factor_dtype.itemsize < 4 else factor_dtype


# ---------------------------------------------------------------------------
# iterative refinement: low-precision correction solves, working-precision
# residuals (classic LP-factor IR; converges while cond(A) * eps_factor < 1)
# ---------------------------------------------------------------------------


def _refine_core(F, rows, A, b, tol, max_iters: int, *, chol: bool):
    """The refine loop of B systems at once, on the factors' device.

    F [B, N, N] low-precision factors and rows [B, N]; A [B, N, N] and
    b [B, N, k] in the working dtype; tol [B] one tolerance per system.
    Returns (x [B, N, k], iters [B] int32, final relative residual [B],
    converged [B] bool).  The relative residual of a system is the maximum
    over its RHS columns of ||b_j - A x_j||_2 / max(||b_j||_2, tiny).
    The correction solves run in f32 over factors narrower than f32.  A
    non-finite first solve restarts that system from x = 0 (residual b,
    relative residual 1).  A non-finite correction step is rejected (the
    system keeps its last finite iterate), so a broken low-precision
    factorization reports `converged=False` with a finite residual instead
    of NaN.  Each system iterates only while its own residual is above its
    own tolerance and its count below `max_iters`; the count of a system
    whose step was rejected still rises.

    The reference runs this as one `lax.while_loop` on the device.  Here the
    loop is on the host: each iteration makes one host read, "is any system
    still active?", and nothing else leaves the device.
    """
    wd = A.dtype
    sd = _solve_dtype(F.dtype)
    Fs = F.to(sd)

    def lowsolve(r):
        rs = r.to(sd)
        y = chol_solve(Fs, rs) if chol else lu_solve(Fs, rows, rs)
        return y.to(wd)

    den = torch.linalg.vector_norm(b, dim=-2).clamp_min(torch.finfo(wd).tiny)  # [B, k]

    def residual(x):
        r = b - A @ x
        return r, (torch.linalg.vector_norm(r, dim=-2) / den).amax(-1)

    x = lowsolve(b)
    finite0 = torch.isfinite(x).flatten(1).all(1)
    x = torch.where(finite0[:, None, None], x, torch.zeros_like(x))
    r, res = residual(x)
    it = torch.zeros(res.shape, dtype=torch.int32, device=res.device)
    for _ in range(max_iters):  # every active system's count rises each time
        active = (res > tol) & (it < max_iters)
        if not bool(active.any()):  # the loop's one host read
            break
        xn = x + lowsolve(r)
        rn, resn = residual(xn)
        take = active & torch.isfinite(resn)
        x = torch.where(take[:, None, None], xn, x)
        r = torch.where(take[:, None, None], rn, r)
        res = torch.where(take, resn, res)
        it = it + active.to(it.dtype)
    return x, it, res, res <= tol


@dataclass
class RefinedSolve:
    """A refined solve: the working-precision solution and how it converged.

    x:                the refined solution in the working dtype ([N] or
                      [N, k]; a leading B axis on batched factorizations),
                      on the factors' device.
    refinement_iters: correction iterations taken (int; [B] tensor batched).
    final_residual:   the maximum over columns of ||b - A x|| / ||b|| at
                      exit (float; [B] tensor batched).
    converged:        final_residual <= refine_tol (bool; [B] tensor
                      batched).  False means the cap was hit: x is still the
                      best finite iterate, never NaN.
    """

    x: torch.Tensor
    refinement_iters: int | torch.Tensor
    final_residual: float | torch.Tensor
    converged: bool | torch.Tensor

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.x.detach().cpu().numpy(), dtype=dtype)

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype


@dataclass
class Factorization:
    """Factors (packed masked LU, or a lower Cholesky factor) plus everything
    needed to consume them."""

    # LU: packed factors in original row positions; Cholesky: L.  [N, N] or [B, N, N]
    F: torch.Tensor
    rows: torch.Tensor  # pivot order (global row ids) [N] or [B, N], int64
    grid: GridConfig | None = None
    comm: dict = field(default_factory=dict)
    strategy: str = ""
    backend: str = ""  # KernelBackend that ran the local compute ("cuda"/"ref")
    kind: str = "lu"  # "lu" or "cholesky"
    # the working-precision input matrix, retained by plan.execute (None on
    # hand-built results)
    A_ref: torch.Tensor | None = None
    # the working dtype the caller asked for; None = the factors' dtype
    work_dtype: torch.dtype | None = None
    # per-primitive hot-loop wall times (us), when the plan was profiled
    # with FactorizationPlan.profile_hotloop()
    hotloop: dict = field(default_factory=dict)
    # the calibrated-auto decision and this execute's measured wall
    # (predicted_wall_us / measured_wall_us / wall_residual); None unless
    # the plan came from the calibrated `strategy="auto"`
    autotune: dict | None = None

    def __post_init__(self):
        if self.kind not in ("lu", "cholesky"):
            raise ValueError(f"Factorization kind must be 'lu' or 'cholesky', got {self.kind!r}")

    @property
    def N(self) -> int:
        return int(self.F.shape[-1])

    @property
    def batched(self) -> bool:
        """True when this holds B independent factorizations ([B, N, N])."""
        return self.F.ndim == 3

    @property
    def B(self) -> int | None:
        """Batch size, or None for a single-system factorization."""
        return int(self.F.shape[0]) if self.batched else None

    @property
    def device(self) -> torch.device:
        return self.F.device

    @property
    def dtype(self) -> torch.dtype:
        return self.F.dtype

    def _check_rhs(self, b: torch.Tensor) -> None:
        if self.batched:
            if b.ndim not in (2, 3) or tuple(b.shape[:2]) != (self.B, self.N):
                raise ValueError(
                    f"batched factorization: b must be [B, N] or [B, N, k] with "
                    f"B={self.B}, N={self.N}, got shape {tuple(b.shape)}"
                )
        elif b.ndim not in (1, 2) or b.shape[0] != self.N:
            raise ValueError(f"b must be [N] or [N, k] with N={self.N}, got shape {tuple(b.shape)}")

    def solve(self, b, *, refine_tol=None, max_refine_iters: int = 25):
        """Solve A x = b.  b: [N] single RHS or [N, k] multi-RHS batch.

        On a batched factorization b is [B, N] (one RHS per system) or
        [B, N, k], and each system solves against its own factors.

        With `refine_tol=None` (the default) this is the plain solve on the
        factors, returning x on their device in their dtype.  Over factors
        narrower than f32 the solve computes in f32; on a mixed-precision
        factorization (working dtype wider than the factors) it then returns
        that f32 result, as the reference does.  An RHS wider than the
        result warns that it is downcast, with the reference's hint.

        With `refine_tol=<float>` it runs iterative refinement against the
        retained `A_ref` (see `_refine_core`) and returns a `RefinedSolve`
        whose x is in the working dtype (f32 at least).  On a batched
        factorization `refine_tol` may be a [B] array, one tolerance per
        system; `max_refine_iters` is shared.
        """
        # Only a tensor or an array states its dtype: nested lists read as
        # float64 and keep it, and are not warned about as a downcast.
        has_dtype = isinstance(b, torch.Tensor) or hasattr(b, "dtype")
        b = as_tensor(b)
        if b.is_complex():
            raise ValueError(
                f"complex RHS dtype {b.dtype} is not supported (factors are "
                f"{self.dtype}); solve against b.real and b.imag separately"
            )
        if refine_tol is not None:
            return self._solve_refined(b, refine_tol, max_refine_iters)
        wd = self.work_dtype or self.dtype
        sd = _solve_dtype(self.dtype)
        out = sd if wd != self.dtype else self.dtype  # a plain narrow plan keeps its dtype
        if has_dtype and b.is_floating_point() and b.dtype.itemsize > out.itemsize:
            hint = ("pass solve(..., refine_tol=...) to recover working precision"
                    if wd.itemsize >= b.dtype.itemsize
                    else "set SolverConfig.dtype to keep precision")
            warnings.warn(
                f"factors are {self.dtype}; RHS {b.dtype} will be downcast ({hint})",
                stacklevel=2,
            )
        F = self.F.to(sd)
        b = b.to(device=self.device, dtype=sd)
        self._check_rhs(b)
        x = chol_solve(F, b) if self.kind == "cholesky" else lu_solve(F, self.rows, b)
        return x.to(out)

    def _solve_refined(self, b: torch.Tensor, tol, max_iters: int) -> RefinedSolve:
        """Iterative refinement against the retained working-precision A_ref."""
        if self.A_ref is None:
            raise ValueError(
                "refined solve needs the original matrix for residuals, but "
                "this Factorization carries no A_ref; execute through "
                "repro_torch.api.plan (which retains it) or set fact.A_ref"
            )
        if (not isinstance(max_iters, (int, np.integer)) or isinstance(max_iters, bool)
                or max_iters < 0):
            raise ValueError(f"max_refine_iters must be a non-negative int, got {max_iters!r}")
        wd = self.work_dtype or self.dtype
        if wd.itemsize < 4:
            wd = torch.float32  # the floor of residual accumulation
        b = b.to(device=self.device, dtype=wd)
        self._check_rhs(b)
        lead = 1 if self.batched else 0
        vec = b.ndim == lead + 1
        bm = b[..., None] if vec else b
        A = self.A_ref.to(device=self.device, dtype=wd)
        F, rows = self.F, self.rows
        if not self.batched:
            bm, A, F, rows = bm[None], A[None], F[None], rows[None]
        B = F.shape[0]
        tols = torch.as_tensor(tol, dtype=torch.float64).to(device=self.device, dtype=wd)
        if tols.ndim > 1 or (tols.ndim == 1 and not self.batched):
            raise ValueError(f"refine_tol must be a number, or [B] on a batched "
                             f"factorization; got shape {tuple(tols.shape)}")
        x, it, res, conv = _refine_core(F, rows, A, bm, tols.expand(B), int(max_iters),
                                        chol=self.kind == "cholesky")
        if vec:
            x = x[..., 0]
        if self.batched:
            return RefinedSolve(x=x, refinement_iters=it, final_residual=res, converged=conv)
        return RefinedSolve(x=x[0], refinement_iters=int(it[0]), final_residual=float(res[0]),
                            converged=bool(conv[0]))

    def slogdet(self):
        """(sign, log|det|) — overflow-safe; 0-d tensors, or [B] per system
        on a batched factorization.  The permutation signs are computed on
        the factors' device, so a batch costs no host copy.  Cholesky:
        det(A) = prod(diag L)^2 > 0, so (1, 2 sum log diag L)."""
        if self.kind == "cholesky":
            d = torch.diagonal(self.F, dim1=-2, dim2=-1)
            return torch.ones_like(d[..., 0]), 2.0 * torch.sum(torch.log(d), dim=-1)
        d = torch.diagonal(gather_rows(self.F, self.rows), dim1=-2, dim2=-1)
        # torch.sign(nan) is 0; keep NaN, as jnp.sign and numpy.sign do
        dsign = torch.where(torch.isnan(d), d, torch.sign(d))
        sign = permutation_signs(self.rows).to(d.dtype) * torch.prod(dsign, dim=-1)
        return sign, torch.sum(torch.log(torch.abs(d)), dim=-1)

    def det(self):
        s, ld = self.slogdet()
        return s * torch.exp(ld)

    def reconstruct(self) -> torch.Tensor:
        """Rebuild A (original row order) from the factors, per system when
        batched."""
        if self.kind == "cholesky":
            return chol_reconstruct(self.F)
        return reconstruct(self.F, self.rows)

    def unpack(self):
        """LU: (P, L, U) with P @ A = L @ U.  Cholesky: the lower factor L.
        Batched factorizations unpack per system (leading B axis)."""
        if self.kind == "cholesky":
            return self.F
        return unpack_factors(self.F, self.rows)

    def comm_report(self) -> str:
        """Instrumented communication volume, elements and bytes per proc."""
        wd = self.work_dtype or self.dtype
        prec = f"dtype={self.dtype}" + (f" (working {wd})" if wd != self.dtype else "")
        head = (f"strategy={self.strategy or '?'} backend={self.backend or '?'} "
                f"kind={self.kind} grid={self.grid} "
                f"{'' if self.B is None else f'B={self.B} '}N={self.N} {prec} "
                f"device={self.device}")
        if not self.comm:
            lines = [f"{head}\n  single-device: no inter-processor communication"]
        else:
            itemsize = self.dtype.itemsize
            lines = [head, f"  {'':20s} {'elements/proc':>14s} {'bytes/proc':>16s}"]
            for k, val in self.comm.items():
                if isinstance(val, (int, float)):
                    lines.append(f"  {k:20s} {val:14,.0f} {val * itemsize:16,.0f}")
        if self.hotloop:
            lines.append("  hot-loop primitives (us, profiled local shapes):")
            for k, val in self.hotloop.items():
                if isinstance(val, (int, float)):
                    lines.append(f"    {k:18s} {val:12,.1f}")
        if self.autotune:
            pred = self.autotune.get("predicted_wall_us")
            meas = self.autotune.get("measured_wall_us")
            resid = self.autotune.get("wall_residual")
            lines.append(
                f"  autotune ({self.autotune.get('source', '?')}, calibration "
                f"{self.autotune.get('calibration_version', '?')}):"
            )
            if pred is not None and meas is not None:
                line = f"    predicted {pred:12,.1f} us   measured {meas:12,.1f} us"
                if resid is not None:
                    line += f"   residual {resid:+.1%}"
                lines.append(line)
        return "\n".join(lines)
