"""2.5D near-communication-optimal Cholesky (follow-up paper arXiv:2108.09337).

The SPD specialization of the COnfLUX schedule (`repro_torch.core.lu.conflux`):
same P = Px*Py*c (px, py, pz) mesh, same v x v tile-block-cyclic layout,
same 2.5D replication (layer 0 stores the base matrix, layer t % c absorbs
step t's Schur update, the current value of any entry is the sum over pz).
What SPD removes is the whole pivoting apparatus — the tournament, the row
masking, the pivot-order vector — and what symmetry halves is the trailing
update: U01 is L10^T, so the rank-v update only has to cover the lower
triangle of the Schur complement.

Schedule per step t:
  1. reduce the panel block-column over pz                        (psum 'pz')
  2. gather the diagonal block to every processor                 (psum 'px','py')
  3. L00 := panel_chol(A00), replicated local compute             (local)
  4. L10 := A10 (L00^T)^-1 on the owner column; broadcast         (psum 'py')
  5. gather the diagonal block-row; U01 := L00^-1 A01 (= L10^T)   (psum 'px','pz')
  6. Schur update A11 -= L10 @ U01 on layer t % c                 (local)
  7. write L10 / L00 into the output factor                       (local)

The same notes as the LU schedule apply: every rank joins every collective
with masked payloads, and `chol_comm_volume` counts the exact schedule — for
the symmetric trailing update, L10/U01 fragments only toward the processors
whose lower-triangle share needs them, which is where the ~2x saving over LU
shows up at equal (N, grid).  The diagonal block moves by slicing where the
JAX package multiplies by one-hot matrices.
"""

from __future__ import annotations

import torch

from repro_torch.core.collectives import LuMesh
from repro_torch.core.lu.conflux import (
    block_cyclic_gather,
    global_ids,
    local_block,
    window_width,
)
from repro_torch.core.lu.cost_models import chol_model
from repro_torch.core.lu.grid import GridConfig


def _local_chol(cfg: GridConfig, backend: str, Aloc: torch.Tensor, mesh: LuMesh, *,
                hotloop: str = "windowed") -> torch.Tensor:
    """Local program for rank (px, py, pz).  Aloc: [R, C] local block.

    Returns the local block of the lower Cholesky factor L (A = L L^T).
    backend: registered KernelBackend name supplying panel_chol /
    trsm_right_upper / trsm_left_lower / schur_update / fused_trsm_schur.
    hotloop: "windowed" (the default — SPD retires rows in gid order, so
    both the row *and* column dimensions shrink with t, and steps 5+6 run
    through the fused TRSM -> Schur primitive) or "flat" (the full-block
    body, the bit-parity oracle of the windowed one).  Aloc is not modified.

    Memory: the windowed body carries only the live trailing window of the
    local block, rows and columns; the factor is written in place.
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import core

    bk = get_backend(backend)
    Px, Py, c, v, N = cfg.Px, cfg.Py, cfg.c, cfg.v, cfg.N
    px, py, pz = mesh.px, mesh.py, mesh.pz
    R, C = Aloc.shape
    dtype, dev = Aloc.dtype, Aloc.device
    nsteps = N // v
    row_gid, col_gid = global_ids(cfg, mesh, R, C, dev)

    # Layer pz == 0 holds the base matrix; other layers accumulate partials only.
    if pz != 0:
        Aloc = torch.zeros_like(Aloc)
    Floc = torch.zeros_like(Aloc)

    def step(t, A, r_off, c_off, wr, wc):
        """One step on the window A[R - wr:, C - wc:] of the carried block
        A (local rows r_off.., columns c_off..).  The flat body is the
        window of the whole block, without the fused kernel."""
        r_start, c_start = R - wr, C - wc
        Awin = A[r_start - r_off:, c_start - c_off:]
        rg, cg = row_gid[r_start:], col_gid[c_start:]
        lc0 = (t // Py) * v  # local tile-column index of the panel (owner py)
        lc0w = min(max(lc0 - c_start, 0), wc - v)  # owner never clips
        owner = py == t % Py
        own_diag = px == t % Px
        lr0w = min(max((t // Px) * v - r_start, 0), wr - v)  # owner exact

        # -- 1. Reduce the panel block-column over pz (window rows). ----------
        panel = mesh.psum(Awin[:, lc0w:lc0w + v], "pz")
        # -- 2. Diagonal block: contiguous rows on px == t % Px. --------------
        A00 = panel[lr0w:lr0w + v] if own_diag and owner else panel.new_zeros(v, v)
        A00 = mesh.psum(A00, ("px", "py"))
        # -- 3. Factorize the diagonal block (replicated local compute). ------
        L00 = bk.panel_chol(A00)
        # -- 4. L10 on the owner column, broadcast along py. ------------------
        below = (rg >= (t + 1) * v).to(dtype)[:, None]  # [wr, 1]
        L10 = bk.trsm_right_upper(panel * below, L00.mT) if owner else panel.new_zeros(wr, v)
        L10 = mesh.psum(L10, "py")
        # -- 5. Diagonal block-row over (px, pz); TRSM -> U01.  By symmetry ----
        #    A01 = L00 @ L10^T, so U01 is L10^T, computed from the gathered
        #    row values like LU's step 5 (unit=False: L00 has its diagonal).
        R01 = Awin[lr0w:lr0w + v] if own_diag else Awin.new_zeros(v, wc)
        R01 = mesh.psum(R01, ("px", "pz"))  # [v, wc] current values
        trailing = (cg >= (t + 1) * v).to(dtype)
        on_layer = pz == t % c
        if hotloop == "windowed":
            # -- 6. Fused TRSM -> Schur on layer t % c. -----------------------
            Awin, _ = bk.fused_trsm_schur(Awin, L00, R01 * trailing,
                                          L10 * (below * float(on_layer)), unit=False)
        else:
            U01 = bk.trsm_left_lower(L00, R01, unit=False) * trailing
            if on_layer:  # -- 6. Symmetric rank-v Schur update. ---------------
                Awin = bk.schur_update(Awin, L10 * below, U01)
        # -- 7. Write the factor panel: L10 below the diagonal, L00 on it. ----
        if owner:
            Fpanel = L10 * below
            if own_diag:
                Fpanel[lr0w:lr0w + v] += L00
            Floc[r_start:, lc0:lc0 + v] = Fpanel
        return Awin

    r_off = c_off = 0
    for t in range(nsteps):
        if hotloop == "windowed":
            wr = window_width(t, nsteps, Px, R, v)
            wc = window_width(t, nsteps, Py, C, v)
        else:
            wr, wc = R, C
        Aloc = step(t, Aloc, r_off, c_off, wr, wc)
        r_off, c_off = R - wr, C - wc
    return Floc


def distributed_cholesky(A: torch.Tensor, grid: GridConfig, mesh: LuMesh, *,
                         backend: str = "cuda", hotloop: str = "windowed") -> torch.Tensor:
    """Lower Cholesky factor L [N, N] of SPD A (the same on every rank) on
    the mesh; every rank of the default group, idle ones too, gets all of L."""
    Lloc = None
    if mesh.active:
        Lloc = _local_chol(grid, backend, local_block(A, grid, mesh.px, mesh.py), mesh,
                           hotloop=hotloop)
    blocks = mesh.gather_blocks(Lloc, (grid.N // grid.Px, grid.N // grid.Py), A.dtype, A.device)
    return block_cyclic_gather(blocks, grid.N, grid.v)


# ---------------------------------------------------------------------------
# Instrumented communication volume of the schedule (elements, per processor).
# ---------------------------------------------------------------------------


def chol_comm_volume(N: int, grid: GridConfig) -> dict:
    """Exact per-collective accounting of the 2.5D Cholesky schedule.

    Same counting rules as `lu_comm_volume` (ring all-reduce 2*S*(g-1)/g per
    member, masked broadcast payload per receiver), with the SPD savings made
    explicit: no tournament, the L00 broadcast carries only the lower
    triangle, and the L10 broadcast / U01 gather count each fragment only
    toward the processors whose *lower-triangle* share of the trailing
    update consumes it — on average half of the py (resp. px) groups — which
    is what puts the total at roughly half of LU's at equal (N, grid).
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    Ptot = Px * Py * c
    vol = dict.fromkeys(("panel_reduce", "l00_bcast", "l10_bcast", "u01_gather"), 0.0)
    for t in range(N // v):
        rem = max(N - (t + 1) * v, 0)  # trailing size
        rloc = (N - t * v) / Px  # panel rows per owner-column proc
        cloc = rem / Py  # trailing cols per proc
        # 1. panel reduce over pz: owner column only (Px procs x c layers).
        vol["panel_reduce"] += Px * c * (2 * rloc * v * (c - 1) / c)
        # 2/3. lower triangle of L00 to every proc (no pivot ids to ship).
        vol["l00_bcast"] += Ptot * v * (v + 1) / 2
        # 4. L10 to the Schur layer — only the py groups whose lower-triangle
        #    columns sit at or below each row fragment: half of Py on average.
        vol["l10_bcast"] += Px * Py * (rem / Px) * v / 2
        # 5. diagonal-row gather + U01 (= L10^T) to the Schur layer — only the
        #    px groups whose rows sit at or below each column: half of Px.
        vol["u01_gather"] += Px * Py * v * cloc / 2
    out = {k: val / Ptot for k, val in vol.items()}
    out["total"] = sum(out.values())
    out["model_chol"] = chol_model(N, Ptot, M=max(N * N * c / Ptot, 4.0), v=v)
    return out
