"""Factorization — the result type every strategy returns.

`kind="lu"`: packed masked factors (rows never move, paper §7.3) and the
pivot order.  `kind="cholesky"`: F holds the lower factor L with
A = L L^T, and rows is the identity order.  Besides, the grid the
factorization ran on and the instrumented per-processor communication
volume of the schedule.  Solves, determinants and reconstruction are
methods.  Everything stays on the factors' device.

A batched plan's result holds B factorizations, F [B, N, N] and rows
[B, N]; every method then works per system along the leading axis.

Refined solves raise until their slice lands (ROADMAP.md module item 7).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import torch

from repro_torch.core.cholesky.sequential import chol_reconstruct, chol_solve
from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.lu.sequential import (
    gather_rows,
    permutation_signs,
    reconstruct,
    unpack_factors,
)
from repro_torch.core.solve import lu_solve


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

    def solve(self, b, *, refine_tol=None, max_refine_iters: int = 25) -> torch.Tensor:
        """Solve A x = b.  b: [N] single RHS or [N, k] multi-RHS batch.

        On a batched factorization b is [B, N] (one RHS per system) or
        [B, N, k], and each system solves against its own factors.

        Returns x on the factors' device, in the factors' dtype.
        `refine_tol` (iterative refinement) is not ported yet.
        """
        if refine_tol is not None:
            raise NotImplementedError(
                "refined solves are not ported yet: ROADMAP.md module item 7 "
                "(mixed precision and refinement)"
            )
        b = torch.as_tensor(b)
        if b.is_complex():
            raise ValueError(
                f"complex RHS dtype {b.dtype} is not supported (factors are "
                f"{self.dtype}); solve against b.real and b.imag separately"
            )
        if b.is_floating_point() and b.dtype.itemsize > self.dtype.itemsize:
            warnings.warn(
                f"factors are {self.dtype}; RHS {b.dtype} will be downcast "
                f"(set SolverConfig.dtype to keep precision)",
                stacklevel=2,
            )
        b = b.to(device=self.device, dtype=self.dtype)
        if self.batched:
            if b.ndim not in (2, 3) or tuple(b.shape[:2]) != (self.B, self.N):
                raise ValueError(
                    f"batched factorization: b must be [B, N] or [B, N, k] with "
                    f"B={self.B}, N={self.N}, got shape {tuple(b.shape)}"
                )
        elif b.ndim not in (1, 2) or b.shape[0] != self.N:
            raise ValueError(f"b must be [N] or [N, k] with N={self.N}, got shape {tuple(b.shape)}")
        if self.kind == "cholesky":
            return chol_solve(self.F, b)
        return lu_solve(self.F, self.rows, b)

    def slogdet(self):
        """(sign, log|det|) — overflow-safe; 0-d tensors, or [B] per system
        on a batched factorization.  The permutation signs are computed on
        the factors' device, so a batch costs no host copy.  Cholesky:
        det(A) = prod(diag L)^2 > 0, so (1, 2 sum log diag L)."""
        if self.kind == "cholesky":
            d = torch.diagonal(self.F, dim1=-2, dim2=-1)
            return torch.ones_like(d[..., 0]), 2.0 * torch.sum(torch.log(d), dim=-1)
        d = torch.diagonal(gather_rows(self.F, self.rows), dim1=-2, dim2=-1)
        sign = permutation_signs(self.rows).to(d.dtype) * torch.prod(torch.sign(d), dim=-1)
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
            return f"{head}\n  single-device: no inter-processor communication"
        itemsize = self.dtype.itemsize
        lines = [head, f"  {'':20s} {'elements/proc':>14s} {'bytes/proc':>16s}"]
        for k, val in self.comm.items():
            if isinstance(val, (int, float)):
                lines.append(f"  {k:20s} {val:14,.0f} {val * itemsize:16,.0f}")
        return "\n".join(lines)
