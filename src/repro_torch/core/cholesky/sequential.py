"""Blocked sequential Cholesky — the single-device SPD path.

A = L L^T for SPD A, right-looking in panels of width v, with every local
primitive routed through the named `KernelBackend`:

    L00 = panel_chol(A00)                         (diagonal block)
    L10 = A10 (L00^T)^-1  via trsm_right_upper    (panel below the diagonal)
    A   = A - L10 L10^T   via schur_update        (symmetric rank-v update)

The step keeps the JAX reference's full shape: the panel and L10 span all
N rows with the rows above the trailing block masked to zero, and the
update runs over the whole [N, N] matrix.  No step synchronises with the
host.  The `_batched` form does the same for B independent systems
[B, N, N], each step one backend call of each primitive for all of them.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _prepare(A, v: int, device, ndim: int):
    dev = resolve_device(device)
    A = torch.as_tensor(A, device=dev)
    if A.ndim != ndim or A.shape[-1] != A.shape[-2]:
        want = "square [N, N]" if ndim == 2 else "a stack of square systems [B, N, N]"
        raise ValueError(f"A must be {want}, got shape {tuple(A.shape)}")
    N = A.shape[-1]
    if v < 1 or N % v:
        raise ValueError(f"N must be a multiple of the panel width v: N={N}, v={v}")
    return A, N, dev


def chol_blocked_sequential(A, v: int = 32, backend: str = "cuda", *, device=None):
    """Lower Cholesky factor of SPD A [N, N] in panels of width v.

    The local compute goes through the named `KernelBackend`: "cuda" (the
    hand-written kernels on a CUDA tensor, their plain versions on a CPU
    one) or "ref" (plain PyTorch).  `device=None` runs on the CUDA card.
    A matrix that is not SPD gives non-finite factors, never an exception.

    Returns L [N, N] lower-triangular with A = L @ L^T.  A is not modified.

    Memory: L, and the matrix being updated together with the step's
    output, about three [N, N] matrices beside the caller's A.
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import core

    bk = get_backend(backend)
    A, N, dev = _prepare(A, v, device, 2)
    L = torch.zeros_like(A)
    idx = torch.arange(N, device=dev)
    for c0 in range(0, N, v):
        L00 = bk.panel_chol(A[c0:c0 + v, c0:c0 + v])
        below = (idx >= c0 + v).to(A.dtype)
        panel = A[:, c0:c0 + v] * below[:, None]
        L10 = bk.trsm_right_upper(panel, L00.mT) * below[:, None]
        L[:, c0:c0 + v] = L10
        L[c0:c0 + v, c0:c0 + v] = L00
        A = bk.schur_update(A, L10, L10.mT.contiguous() * below)
    return L


def chol_blocked_sequential_batched(A, v: int = 32, backend: str = "cuda", *, device=None):
    """Lower Cholesky factors of B independent SPD systems A [B, N, N].

    The step body of `chol_blocked_sequential` with a leading batch axis:
    each step is one `panel_chol_batched`, one `trsm_right_upper_batched`
    and one `schur_update_batched` call of the named backend for all B
    systems ("cuda" = one launch of each kernel per step).  `device=None`
    runs on the CUDA card.

    Returns L [B, N, N] with A_b = L_b @ L_b^T.  A is not modified.
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import core

    bk = get_backend(backend)
    A, N, dev = _prepare(A, v, device, 3)
    L = torch.zeros_like(A)
    idx = torch.arange(N, device=dev)
    for c0 in range(0, N, v):
        L00 = bk.panel_chol_batched(A[:, c0:c0 + v, c0:c0 + v])
        below = (idx >= c0 + v).to(A.dtype)
        panel = A[:, :, c0:c0 + v] * below[:, None]
        L10 = bk.trsm_right_upper_batched(panel, L00.mT) * below[:, None]
        L[:, :, c0:c0 + v] = L10
        L[:, c0:c0 + v, c0:c0 + v] = L00
        A = bk.schur_update_batched(A, L10, L10.mT.contiguous() * below)
    return L


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b from the lower Cholesky factor (A = L L^T).

    One system: L [N, N], b [N] or [N, k].  A batch: L [B, N, N], b [B, N]
    or [B, N, k], each system against its own factor.
    """
    vector = b.ndim == L.ndim - 1
    rhs = b[..., None] if vector else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vector else x


def chol_reconstruct(L: torch.Tensor) -> torch.Tensor:
    """Rebuild A = L L^T from its lower Cholesky factor (per system when
    batched)."""
    return L @ L.mT
