"""Sequential LU with row masking — the single-device main path.

COnfLUX never swaps rows (paper §7.3): pivot rows are *masked* and the pivot
order is tracked as an index vector.  The packed factor matrix F keeps every
row in its original position; row r that was chosen as the k-th pivot holds
U[k, k:] in its trailing columns and L multipliers in columns < k.
`unpack_factors` reorders into the classic PA = LU triple.

`masked_lup` is the plain panel primitive (the "ref" backend's, and the
plain version of the `lu_panel` kernel); `lu_masked_sequential` routes its
panel LUP and fused TRSM -> Schur update through the named backend.  The
`_batched` forms do the same for B independent systems [B, N, N] at once
(the many-small-systems path), each step one backend call for all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def masked_lup_batched(panel: torch.Tensor, weights: torch.Tensor, v: int):
    """`masked_lup` of B panels [B, R, v] with weights [B, R] at once.

    v rounds of: the weighted argmax of column k picks the pivot row p
    (`torch.argmax` takes the lowest index on ties), p's weight drops to 0,
    the active rows' column k is divided by the pivot (a zero pivot divides
    by 1; the divisor stays a device tensor, since CUDA divides by a host
    scalar through its reciprocal, which would round differently), and
    their columns k+1.. take the rank-1 update.  The kernels round the same
    operations in the same order, so they match this bit for bit.

    Returns (F [B, R, v], order [B, v] int32, ok [B, v] bool).
    """
    B = panel.shape[0]
    F = panel.clone()
    w = weights.to(panel.dtype).clone()
    order = torch.zeros(B, v, dtype=torch.int32, device=panel.device)
    ok = torch.zeros(B, v, dtype=torch.bool, device=panel.device)
    cols = torch.arange(v, device=panel.device)
    lanes = torch.arange(B, device=panel.device)
    for k in range(v):
        col = F[:, :, k].abs() * w
        p = torch.argmax(col, dim=1)
        ok[:, k] = col[lanes, p] > 0
        order[:, k] = p
        w[lanes, p] = 0
        pivval = F[lanes, p, k]
        safe = torch.where(pivval.abs() > 0, pivval, torch.ones_like(pivval))
        active = w > 0
        mult = torch.where(active, F[:, :, k] / safe[:, None], F[:, :, k])
        F[:, :, k] = mult
        colmask = (cols > k).to(F.dtype)
        F = F - torch.where(active, mult, 0.0)[:, :, None] * (F[lanes, p, :] * colmask)[:, None, :]
    return F, order, ok


def masked_lup(panel: torch.Tensor, weights: torch.Tensor, v: int):
    """Masked LU with partial pivoting of a panel (R x v), selecting v pivot rows.

    panel:   [R, v] values (rows in original positions).
    weights: [R] candidate weights — 1 for selectable rows, 0 for rows that
             must keep their values (already pivoted, padding, or remote
             rows).  Rows with weight 0 receive no updates: only the
             terms 0 * F[p, j], which change nothing unless the pivot row
             holds inf or NaN (then NaN spreads to them).

    Returns (F, order, ok):
      F:     [R, v] packed factors in original row positions.
      order: [v] int32 — local row index chosen as pivot for each column
             (lowest index on ties, as torch.argmax).
      ok:    [v] bool — False when no admissible pivot remained.

    The batch of one of `masked_lup_batched`.  Every step stays on the
    panel's device (no host synchronisation).
    """
    F, order, ok = masked_lup_batched(panel[None], weights[None], v)
    return F[0], order[0], ok[0]


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


def lu_masked_sequential_batched(A, v: int = 32, backend: str = "cuda", *, device=None):
    """Masked LU of B independent systems A [B, N, N] in panels of width v.

    The step body of `lu_masked_sequential` with a leading batch axis: each
    step is one `panel_lup_batched` and one `fused_trsm_schur_batched` call
    of the named backend for all B systems ("cuda" = one launch of each
    kernel per step).  Pivot rows are gathered and U01 written back with
    batched indexing (`F[lanes, order]`), where the JAX reference multiplies
    by a [B, v, N] one-hot matrix; for finite inputs the values are the same
    bit for bit.  No step synchronises with the host.  `device=None` runs on
    the CUDA card.

    Returns (F [B, N, N], rows [B, N] int64).

    Memory: as for one system, about three [B, N, N] stacks at the peak (A,
    F and the step's output).
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import this module

    bk = get_backend(backend)
    dev = resolve_device(device)
    F = torch.as_tensor(A, device=dev).clone()
    if F.ndim != 3 or F.shape[1] != F.shape[2]:
        raise ValueError(f"A must be a stack of square systems [B, N, N], got {tuple(F.shape)}")
    B, N = F.shape[0], F.shape[1]
    if v < 1 or N % v:
        raise ValueError(f"N must be a multiple of the panel width v: N={N}, v={v}")
    active = torch.ones(B, N, dtype=F.dtype, device=dev)
    rows = torch.empty(B, N, dtype=torch.int64, device=dev)
    eye = torch.eye(v, dtype=F.dtype, device=dev)
    cols = torch.arange(N, device=dev)
    lanes = torch.arange(B, device=dev)[:, None]
    for c0 in range(0, N, v):
        Fp, order, _ = bk.panel_lup_batched(F[:, :, c0:c0 + v], active, v)
        order = order.long()
        F[:, :, c0:c0 + v] = Fp
        rows[:, c0:c0 + v] = order
        active[lanes, order] = 0
        colmask = (cols >= c0 + v).to(F.dtype)
        L10 = Fp * active[:, :, None]
        L00 = torch.tril(Fp[lanes, order], -1) + eye
        R01 = F[lanes, order] * colmask
        F, U01 = bk.fused_trsm_schur_batched(F, L00, R01, L10, unit=True)
        F[lanes, order, c0 + v:] = U01[:, :, c0 + v:]
    return F, rows


def unpack_factors(F: torch.Tensor, rows: torch.Tensor):
    """Packed masked factors -> (P, L, U) with P @ A = L @ U (P = row selection).

    F [N, N] and rows [N], or a batch F [B, N, N] and rows [B, N]."""
    n = F.shape[-1]
    Fp = gather_rows(F, rows)
    L = torch.tril(Fp, -1) + torch.eye(n, dtype=F.dtype, device=F.device)
    U = torch.triu(Fp)
    P = torch.nn.functional.one_hot(rows, n).to(F.dtype)
    return P, L, U


def gather_rows(X: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """X[rows] for one system, X[b, rows[b]] for each system of a batch."""
    if rows.ndim == 1:
        return X[rows]
    return X[torch.arange(rows.shape[0], device=rows.device)[:, None], rows]


def permutation_signs(perms: torch.Tensor) -> torch.Tensor:
    """Signs of permutations along the last axis (e.g. a batch's rows [B, N]).

    sign = (-1)^(n - #cycles).  Pointer-doubling label propagation reaches
    the minimum of every cycle in ceil(log2 n) vectorized rounds, and a cycle
    is counted where that minimum labels itself.  It runs over the leading
    axes at once and on the tensor's device, so a batch costs no host copy.
    Returns int64 +1 / -1 of shape perms.shape[:-1].
    """
    n = perms.shape[-1]
    if n == 0:
        return torch.ones(perms.shape[:-1], dtype=torch.int64, device=perms.device)
    ident = torch.arange(n, device=perms.device).expand_as(perms)
    labels = ident
    jump = perms.long()
    for _ in range(max(int(n - 1).bit_length(), 1)):
        labels = torch.minimum(labels, torch.gather(labels, -1, jump))
        jump = torch.gather(jump, -1, jump)
    ncycles = (labels == ident).sum(-1)
    return 1 - 2 * ((n - ncycles) % 2)


def permutation_sign(perm) -> float:
    """Sign of the permutation `perm` (e.g. the pivot order `rows`), +1 or -1.

    sign = (-1)^(n - #cycles), counted by `permutation_signs`.
    """
    return float(permutation_signs(torch.as_tensor(np.asarray(perm), dtype=torch.int64)))


def reconstruct(F: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rebuild A (in original row order) from packed masked factors; F and
    rows may carry a leading batch axis."""
    Fp = gather_rows(F, rows)
    L = torch.tril(Fp, -1) + torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    A = torch.empty_like(F)
    if rows.ndim == 1:
        A[rows] = L @ torch.triu(Fp)
    else:
        A[torch.arange(rows.shape[0], device=rows.device)[:, None], rows] = L @ torch.triu(Fp)
    return A
