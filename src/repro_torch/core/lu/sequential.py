"""Sequential LU with row masking — the single-device main path.

COnfLUX never swaps rows (paper §7.3): pivot rows are *masked* and the pivot
order is tracked as an index vector.  The packed factor matrix F keeps every
row in its original position; row r that was chosen as the k-th pivot holds
U[k, k:] in its trailing columns and L multipliers in columns < k.
`unpack_factors` reorders into the classic PA = LU triple.

`masked_lup` is the plain panel primitive (the "ref" backend's, and the
plain version of the `lu_panel` kernel); `lu_masked_sequential` routes its
panel LUP and fused TRSM -> Schur update through the named backend.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def masked_lup(panel: torch.Tensor, weights: torch.Tensor, v: int):
    """Masked LU with partial pivoting of a panel (R x v), selecting v pivot rows.

    panel:   [R, v] values (rows in original positions).
    weights: [R] candidate weights — 1 for selectable rows, 0 for rows that
             must keep their values (already pivoted, padding, or remote
             rows).  Rows with weight 0 receive no updates.

    Returns (F, order, ok):
      F:     [R, v] packed factors in original row positions.
      order: [v] int32 — local row index chosen as pivot for each column
             (lowest index on ties, as torch.argmax).
      ok:    [v] bool — False when no admissible pivot remained.

    Every step stays on the panel's device (no host synchronisation).
    """
    F = panel.clone()
    w = weights.to(panel.dtype).clone()
    order = torch.zeros(v, dtype=torch.int32, device=panel.device)
    ok = torch.zeros(v, dtype=torch.bool, device=panel.device)
    cols = torch.arange(v, device=panel.device)
    for k in range(v):
        col = F[:, k].abs() * w
        p = torch.argmax(col)
        ok[k] = col[p] > 0
        order[k] = p
        w[p] = 0
        pivval = F[p, k]
        # The divisor stays a device tensor: CUDA divides by a host scalar
        # through its reciprocal, which would round differently.
        safe = torch.where(pivval.abs() > 0, pivval, torch.ones_like(pivval))
        active = w > 0
        mult = torch.where(active, F[:, k] / safe, F[:, k])
        F[:, k] = mult
        colmask = (cols > k).to(F.dtype)
        F = F - torch.outer(torch.where(active, mult, 0.0), F[p, :] * colmask)
    return F, order, ok


def lu_masked_sequential(A, v: int = 32, backend: str = "cuda", *, device=None):
    """Full masked LU of A [N, N] in panels of width v.

    The local compute (panel LUP, fused TRSM -> Schur update) goes through
    the named `KernelBackend`: "cuda" (the hand-written kernels on a CUDA
    tensor, their plain versions on a CPU one) or "ref" (plain PyTorch).
    `device=None` runs on the CUDA card.

    Returns (F, rows): packed factors in original row positions and the
    pivot order `rows` (int64, global row index of the k-th pivot).

    Memory: F is a copy of A.  The panel write-back and the write of U01
    into the pivot rows happen in place on F, and each step's update
    returns a fresh F, so the peak is about three [N, N] matrices (A, F and
    the step's output).  Pivot rows are gathered with `index_select` and
    written with an indexed copy, where the JAX reference multiplies by a
    one-hot matrix; for finite inputs the values are the same bit for bit.
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import this module

    bk = get_backend(backend)
    dev = resolve_device(device)
    F = torch.as_tensor(A, device=dev).clone()
    if F.ndim != 2 or F.shape[0] != F.shape[1]:
        raise ValueError(f"A must be square [N, N], got shape {tuple(F.shape)}")
    N = F.shape[0]
    if v < 1 or N % v:
        raise ValueError(f"N must be a multiple of the panel width v: N={N}, v={v}")
    active = torch.ones(N, dtype=F.dtype, device=dev)
    rows = torch.empty(N, dtype=torch.int64, device=dev)
    eye = torch.eye(v, dtype=F.dtype, device=dev)
    cols = torch.arange(N, device=dev)
    for c0 in range(0, N, v):
        Fp, order, _ = bk.panel_lup(F[:, c0:c0 + v], active, v)
        order = order.long()
        F[:, c0:c0 + v] = Fp
        rows[c0:c0 + v] = order
        active[order] = 0
        # Trailing update: A11 -= L10 @ U01 (R01 pre-masked to the trailing
        # columns, so U01 comes out masked columnwise).
        colmask = (cols >= c0 + v).to(F.dtype)
        L10 = Fp * active[:, None]
        L00 = torch.tril(Fp.index_select(0, order), -1) + eye
        R01 = F.index_select(0, order) * colmask
        F, U01 = bk.fused_trsm_schur(F, L00, R01, L10, unit=True)
        F[order, c0 + v:] = U01[:, c0 + v:]
    return F, rows


def unpack_factors(F: torch.Tensor, rows: torch.Tensor):
    """Packed masked factors -> (P, L, U) with P @ A = L @ U (P = row selection)."""
    n = F.shape[0]
    Fp = F[rows]
    L = torch.tril(Fp, -1) + torch.eye(n, dtype=F.dtype, device=F.device)
    U = torch.triu(Fp)
    P = torch.nn.functional.one_hot(rows, n).to(F.dtype)
    return P, L, U


def permutation_sign(perm) -> float:
    """Sign of the permutation `perm` (e.g. the pivot order `rows`), +1 or -1.

    sign = (-1)^(n - #cycles).  Pointer-doubling label propagation reaches
    the minimum of every cycle in ceil(log2 n) vectorized rounds, and a cycle
    is counted where that minimum labels itself.
    """
    if isinstance(perm, torch.Tensor):
        perm = perm.cpu().numpy()
    p = np.asarray(perm, dtype=np.int64)
    n = p.size
    if n == 0:
        return 1.0
    labels = np.arange(n)
    jump = p.copy()
    for _ in range(max(int(n - 1).bit_length(), 1)):
        labels = np.minimum(labels, labels[jump])
        jump = jump[jump]
    ncycles = int(np.count_nonzero(labels == np.arange(n)))
    return -1.0 if (n - ncycles) % 2 else 1.0


def reconstruct(F: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rebuild A (in original row order) from packed masked factors."""
    Fp = F[rows]
    L = torch.tril(Fp, -1) + torch.eye(F.shape[0], dtype=F.dtype, device=F.device)
    A = torch.empty_like(F)
    A[rows] = L @ torch.triu(Fp)
    return A
