"""Factorization — the result type every strategy returns.

Packed masked factors (rows never move, paper §7.3), the pivot order, the
grid the factorization ran on, and the instrumented per-processor
communication volume of the schedule.  Solves, determinants and
reconstruction are methods.  Everything stays on the factors' device.

This slice carries `kind="lu"`; Cholesky results and refined solves raise
until their slices land (ROADMAP.md module items 6 and 7).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import torch

from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.lu.sequential import permutation_sign, reconstruct, unpack_factors
from repro_torch.core.solve import lu_solve


@dataclass
class Factorization:
    """Packed masked LU factors plus everything needed to consume them."""

    F: torch.Tensor  # packed factors, original row positions [N, N]
    rows: torch.Tensor  # pivot order (global row ids) [N], int64
    grid: GridConfig | None = None
    comm: dict = field(default_factory=dict)
    strategy: str = ""
    backend: str = ""  # KernelBackend that ran the local compute ("cuda"/"ref")
    kind: str = "lu"
    # the working-precision input matrix, retained by plan.execute (None on
    # hand-built results)
    A_ref: torch.Tensor | None = None
    # the working dtype the caller asked for; None = the factors' dtype
    work_dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.kind != "lu":
            raise NotImplementedError(
                f"Factorization kind={self.kind!r} is not ported yet: Cholesky "
                f"arrives with ROADMAP.md module item 6"
            )
        if self.F.ndim != 2:
            raise NotImplementedError(
                "batched factorizations are not ported yet: ROADMAP.md module item 5"
            )

    @property
    def N(self) -> int:
        return int(self.F.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.F.device

    @property
    def dtype(self) -> torch.dtype:
        return self.F.dtype

    def solve(self, b, *, refine_tol=None, max_refine_iters: int = 25) -> torch.Tensor:
        """Solve A x = b.  b: [N] single RHS or [N, k] multi-RHS batch.

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
        if b.ndim not in (1, 2) or b.shape[0] != self.N:
            raise ValueError(f"b must be [N] or [N, k] with N={self.N}, got shape {tuple(b.shape)}")
        return lu_solve(self.F, self.rows, b)

    def slogdet(self):
        """(sign, log|det|) as 0-d tensors — overflow-safe."""
        d = self.F[self.rows, torch.arange(self.N, device=self.device)]
        sign = permutation_sign(self.rows) * torch.prod(torch.sign(d))
        return sign, torch.sum(torch.log(torch.abs(d)))

    def det(self):
        s, ld = self.slogdet()
        return s * torch.exp(ld)

    def reconstruct(self) -> torch.Tensor:
        """Rebuild A (original row order) from the factors."""
        return reconstruct(self.F, self.rows)

    def unpack(self):
        """(P, L, U) with P @ A = L @ U."""
        return unpack_factors(self.F, self.rows)

    def comm_report(self) -> str:
        """Instrumented communication volume, elements and bytes per proc."""
        wd = self.work_dtype or self.dtype
        prec = f"dtype={self.dtype}" + (f" (working {wd})" if wd != self.dtype else "")
        head = (f"strategy={self.strategy or '?'} backend={self.backend or '?'} "
                f"kind={self.kind} grid={self.grid} N={self.N} {prec} "
                f"device={self.device}")
        if not self.comm:
            return f"{head}\n  single-device: no inter-processor communication"
        itemsize = self.dtype.itemsize
        lines = [head, f"  {'':20s} {'elements/proc':>14s} {'bytes/proc':>16s}"]
        for k, val in self.comm.items():
            if isinstance(val, (int, float)):
                lines.append(f"  {k:20s} {val:14,.0f} {val * itemsize:16,.0f}")
        return "\n".join(lines)
