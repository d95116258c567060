"""COnfLUX — near-communication-optimal 2.5D LU factorization (paper §7).

Layout.  P = Px*Py*c processes form a (px, py, pz) mesh
(`repro_torch.core.collectives.LuMesh`).  A is distributed v x v
tile-block-cyclically over (px, py): global tile (bi, bj) lives on
(bi % Px, bj % Py) at local tile (bi // Px, bj // Py).  The pz axis holds the
2.5D replication layers: layer 0 stores the base matrix, and each layer
accumulates the Schur updates of the steps t with t % c == layer.  The true
current value of any entry is therefore the *sum over pz* of the local
partials — materialized lazily (the paper's "Reduce next block column").

Schedule per step t (Algorithm 1):
  1. reduce the panel block-column over pz                       (psum 'pz')
  2. tournament pivoting along px: local masked LUP -> butterfly (exchange 'px')
  3. broadcast factored A00 + pivot ids to all py                (psum 'py')
  4. L10 := A10 U00^-1 on the owner column; broadcast along py   (psum 'py')
  5. gather pivot rows over (px, pz); U01 := L00^-1 R01          (psum 'px','pz')
  6. Schur update A11 -= L10 @ U01 on layer t % c                (local)
  7. write L10 / A00 / U01 into the output factors               (local)

Row masking: no row is ever moved; `active` weights mask pivoted rows and
the pivot order is tracked as an index vector (paper §7.3).

Every rank runs every step's collectives, as the JAX package does: the
schedule needs the step-1/4/5 collectives only on the ranks it involves
(py == t % Py or pz == t % c), and the others join with masked (zero)
payloads, so the executed volume exceeds the schedule's.  The reported
volume is `lu_comm_volume`, which counts the exact schedule (payload x
group per collective call site) the way the paper instruments MPI with
Score-P.  The step runs as a Python loop over t; the step counter decides
every branch that changes which collectives run, so all ranks join the same
collectives in the same order.  Local work whose result a rank would only
mask away (L10 off the owner column, the flat body's Schur update off its
layer) is skipped; its collective still runs.

Pivot rows move by index (`index_select`, `index_add_`) where the JAX
package multiplies by one-hot matrices (`S.T @ Aloc`, `S @ A00`,
`S @ U01`); for finite values the results are the same bit for bit, and the
flat body saves the O(v*R*C) products per step.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.collectives import LuMesh
from repro_torch.core.lu.cost_models import conflux_model
from repro_torch.core.lu.grid import GridConfig
from repro_torch.core.windows import window_bucket_index, window_buckets

# ---------------------------------------------------------------------------
# Block-cyclic layout helpers (shared with the tests and the 2D baseline).
# ---------------------------------------------------------------------------


def block_cyclic_scatter(A: torch.Tensor, Px: int, Py: int, v: int) -> torch.Tensor:
    """A [N, N] -> blocks [Px, Py, R, C] with v x v tile-cyclic ownership.

    Global tile (bi, bj) = (li*Px + px, lj*Py + py), so splitting each tile
    axis into (local, owner) and hoisting the owner axes is the whole layout.
    """
    N = A.shape[0]
    nbi = N // v
    T = A.reshape(nbi // Px, Px, v, nbi // Py, Py, v)  # [li, px, r, lj, py, c]
    return T.permute(1, 4, 0, 2, 3, 5).reshape(Px, Py, (nbi // Px) * v, (nbi // Py) * v)


def block_cyclic_gather(blocks: torch.Tensor, N: int, v: int) -> torch.Tensor:
    """Inverse of block_cyclic_scatter."""
    Px, Py = blocks.shape[:2]
    nbi = N // v
    T = blocks.reshape(Px, Py, nbi // Px, v, nbi // Py, v)  # [px, py, li, r, lj, c]
    return T.permute(2, 0, 3, 4, 1, 5).reshape(N, N)


def local_block(A: torch.Tensor, grid: GridConfig, px: int, py: int) -> torch.Tensor:
    """Process (px, py)'s block [R, C] of A, without scattering the others
    (a view when Px = Py = 1)."""
    nbi = grid.N // grid.v
    T = A.reshape(nbi // grid.Px, grid.Px, grid.v, nbi // grid.Py, grid.Py, grid.v)
    return T[:, px, :, :, py, :].reshape(grid.N // grid.Px, grid.N // grid.Py)


def _block_cyclic_scatter_loop(A: torch.Tensor, Px: int, Py: int, v: int) -> torch.Tensor:
    """Loop-form scatter kept as the oracle for the vectorized layout."""
    N = A.shape[0]
    nbi = N // v
    R, C = (nbi // Px) * v, (nbi // Py) * v
    out = torch.zeros((Px, Py, R, C), dtype=A.dtype, device=A.device)
    for bi in range(nbi):
        for bj in range(nbi):
            li, lj = bi // Px, bj // Py
            out[bi % Px, bj % Py, li * v:(li + 1) * v, lj * v:(lj + 1) * v] = \
                A[bi * v:(bi + 1) * v, bj * v:(bj + 1) * v]
    return out


def _block_cyclic_gather_loop(blocks: torch.Tensor, N: int, v: int) -> torch.Tensor:
    """Loop-form gather kept as the oracle for the vectorized layout."""
    Px, Py = blocks.shape[:2]
    A = torch.zeros((N, N), dtype=blocks.dtype, device=blocks.device)
    nbi = N // v
    for bi in range(nbi):
        for bj in range(nbi):
            li, lj = bi // Px, bj // Py
            A[bi * v:(bi + 1) * v, bj * v:(bj + 1) * v] = blocks[
                bi % Px, bj % Py, li * v:(li + 1) * v, lj * v:(lj + 1) * v
            ]
    return A


def global_ids(grid: GridConfig, mesh: LuMesh, R: int, C: int, device):
    """Global row ids of this rank's R local rows and column ids of its C
    local columns (tile-cyclic), int64."""
    v = grid.v
    lrow = torch.arange(R, device=device)
    lcol = torch.arange(C, device=device)
    row_gid = (lrow // v * grid.Px + mesh.px) * v + lrow % v
    col_gid = (lcol // v * grid.Py + mesh.py) * v + lcol % v
    return row_gid, col_gid


def window_width(t: int, nsteps: int, P: int, L: int, v: int) -> int:
    """Local rows (or columns) of the trailing window at step t, on an axis of
    P processes holding L local rows: the bucket's worst case, at most L."""
    cap = window_buckets(nsteps)[window_bucket_index(t, nsteps)]
    return min(-(-cap // P), L // v) * v


# ---------------------------------------------------------------------------
# The distributed factorization: each rank's local program.
# ---------------------------------------------------------------------------


def _local_lu(cfg: GridConfig, pivot: str, backend: str, Aloc: torch.Tensor, mesh: LuMesh, *,
              hotloop: str = "windowed"):
    """Local program for rank (px, py, pz).  Aloc: [R, C] local block.

    pivot: "tournament" (COnfLUX, butterfly merge along px) or "partial"
    (ScaLAPACK-style column-by-column global argmax — the 2D baseline).
    backend: registered KernelBackend name ("cuda" / "ref") supplying the
    local compute primitives (panel LUP, TRSMs, Schur update).
    hotloop: "windowed" (shrinking trailing-column windows, fused TRSM ->
    Schur — the default) or "flat" (the full-block step body, the bit-parity
    oracle of the windowed one).

    Returns (Floc [R, C] packed factors in the local layout, rows [N] int64
    pivot order).  Aloc is not modified.

    Memory: the windowed body carries only the live trailing window of the
    local block (its leading columns are never read again), so the
    carry shrinks with t; Floc is written in place.
    """
    from repro_torch.kernels.backend import get_backend  # the kernels import core

    bk = get_backend(backend)
    Px, Py, c, v, N = cfg.Px, cfg.Py, cfg.c, cfg.v, cfg.N
    px, py, pz = mesh.px, mesh.py, mesh.pz
    R, C = Aloc.shape
    dtype, dev = Aloc.dtype, Aloc.device
    # Pivot ids ride beside the values in the collectives, as floats of the
    # panel's dtype widened to at least f32: exact below 2^24 rows, where
    # bf16 (f16) holds no integer above 256 (2048) exactly.  The values
    # widen and narrow back exactly.
    idt = torch.promote_types(dtype, torch.float32)
    nsteps = N // v
    rounds = max(int(math.log2(Px)), 0)
    row_gid, col_gid = global_ids(cfg, mesh, R, C, dev)
    eye = torch.eye(v, dtype=dtype, device=dev)
    cols = torch.arange(v, device=dev)

    # Layer pz == 0 holds the base matrix; other layers accumulate partials only.
    if pz != 0:
        Aloc = torch.zeros_like(Aloc)
    Floc = torch.zeros_like(Aloc)

    def tournament(panel, weights):
        """Local masked LUP -> butterfly merge along px.  Returns packed A00
        factors [v, v] (in elimination order) and winners' global ids [v].

        Ids travel beside the values as a column of `idt`."""
        _, order, ok = bk.panel_lup(panel, weights, v)
        order = order.long()
        cand_vals = panel.index_select(0, order)  # original values of local winners
        valid = ok & (weights[order] > 0)
        cand_gids = torch.where(valid, row_gid[order], -1)
        for r in range(rounds):
            mine = torch.cat([cand_vals.to(idt), cand_gids[:, None].to(idt)], 1)
            other = mesh.gather_px(mine)[px ^ (1 << r)]
            vals2 = torch.cat([cand_vals, other[:, :v].to(dtype)])  # [2v, v]
            gids2 = torch.cat([cand_gids, other[:, v].long()])
            _, order2, ok2 = bk.panel_lup(vals2, (gids2 >= 0).to(dtype), v)
            order2 = order2.long()
            cand_vals = vals2.index_select(0, order2)
            cand_gids = torch.where(ok2, gids2[order2], -1)
        A00p, order_f, ok_f = bk.panel_lup(cand_vals, (cand_gids >= 0).to(dtype), v)
        order_f = order_f.long()
        return A00p.index_select(0, order_f), torch.where(ok_f, cand_gids[order_f], -1)

    def partial_pivot(panel, weights):
        """ScaLAPACK-style panel factorization: per column, the largest
        candidate over px is the pivot (ties: the larger global id); its row
        is broadcast and eliminated.  Same (A00, gids) interface as
        `tournament`.  Each rank's candidate — its column maximum, that row's
        global id and the row itself — rides in one all-gather along px, so a
        column costs one collective."""
        F = panel.clone()
        w = weights.clone()
        A00 = torch.zeros((v, v), dtype=dtype, device=dev)
        gids = torch.full((v,), -1, dtype=torch.int64, device=dev)
        for k in range(v):
            col = F[:, k].abs() * w
            larg = torch.argmax(col)
            lmax = col[larg]
            cand = torch.where(lmax > 0, row_gid[larg], -1).to(idt)
            slab = mesh.gather_px(torch.cat([lmax[None].to(idt), cand[None],
                                             F[larg].to(idt)]))  # [Px, v+2]
            lm = slab[:, 0]
            cands = torch.where((lm == lm.max()) & (lm > 0), slab[:, 1], -1.0)
            win = torch.argmax(cands)
            g = cands[win].long()
            prow = torch.where(g >= 0, slab[win, 2:], 0.0).to(dtype)
            mine = (row_gid == g).to(dtype)  # [R] one-hot (zero if remote)
            pv = prow[k]
            safe = torch.where(pv.abs() > 0, pv, 1.0)
            w = w * (1.0 - mine)
            active = w > 0
            mult = torch.where(active, F[:, k] / safe, F[:, k])
            F[:, k] = mult
            F = F - torch.outer(torch.where(active, mult, 0.0), prow * (cols > k).to(dtype))
            A00[k] = prow
            gids[k] = g
        return A00, gids

    def pivot_panel(t, panel, active):
        """Steps 2+3: pivot along px, broadcast A00 + ids from the owner
        column — shared by the flat and windowed bodies (the windowed path
        must keep the pivot order bit-identical).  Returns (A00, gids, owner)."""
        owner = py == t % Py
        A00, gids = (tournament if pivot == "tournament" else partial_pivot)(panel, active)
        packed = torch.cat([A00.to(idt), gids[:, None].to(idt)], 1)
        packed = mesh.psum(packed if owner else torch.zeros_like(packed), "py")
        return packed[:, :v].to(dtype), packed[:, v].long(), owner

    def pivot_local_rows(piv_gids):
        """Local row index + ownership weight of each pivot gid on this px."""
        tile = piv_gids // v
        lr = ((tile // Px) * v + piv_gids % v).clamp(0, R - 1)
        own = ((tile % Px == px) & (piv_gids >= 0)).to(dtype)
        return lr, own

    def factor_panel(t, panel, active):
        """Steps 2-4, common to both bodies.  Returns what steps 5-7 need."""
        A00, piv_gids, owner = pivot_panel(t, panel, active)
        L00 = torch.tril(A00, -1) + eye
        U00 = torch.triu(A00)
        lr, own = pivot_local_rows(piv_gids)
        is_new_piv = torch.zeros(R, dtype=dtype, device=dev).index_add_(0, lr, own)
        new_active = active * (1.0 - is_new_piv)
        # -- 4. L10 on the owner column, broadcast along py. ------------------
        L10 = (bk.trsm_right_upper(panel * new_active[:, None], U00) if owner
               else panel.new_zeros(R, v))
        L10 = mesh.psum(L10, "py")
        return A00, piv_gids, owner, L00, lr, own, new_active, L10

    def write_panel(t, owner, Floc, A00, L10, lr, own, active, new_active):
        """Step 7's panel column block, on the owner column: still-active rows
        get multipliers, new pivot rows their packed A00 rows, rows pivoted
        in earlier steps keep the U01 values written back then."""
        if owner:
            lc0 = (t // Py) * v
            prev = Floc[:, lc0:lc0 + v]
            SA00 = torch.zeros((R, v), dtype=dtype, device=dev).index_add_(
                0, lr, A00 * own[:, None])
            Floc[:, lc0:lc0 + v] = (L10 * new_active[:, None] + SA00
                                    + prev * (1.0 - active)[:, None])

    def step_flat(t, Aloc, Floc, active, rows):
        lc0 = (t // Py) * v  # local tile-column index of the panel (owner py)
        # -- 1. Reduce the panel block-column over pz. ------------------------
        panel = mesh.psum(Aloc[:, lc0:lc0 + v], "pz")  # base + all pending partials
        # -- 2-4. Pivoting, A00 + ids to all py, L10. -------------------------
        A00, piv_gids, owner, L00, lr, own, new_active, L10 = factor_panel(t, panel, active)
        # -- 5. Pivot rows gathered over (px, pz); local TRSM -> U01. ---------
        R01 = mesh.psum(Aloc.index_select(0, lr) * own[:, None], ("px", "pz"))
        trailing = (col_gid >= (t + 1) * v).to(dtype)
        U01 = bk.trsm_left_lower(L00, R01, unit=True) * trailing
        # -- 6. Schur update on layer t % c (2.5D update partitioning). -------
        if pz == t % c:
            Aloc = bk.schur_update(Aloc, L10 * new_active[:, None], U01)
        # -- 7. Write factors (identical on every pz layer). ------------------
        write_panel(t, owner, Floc, A00, L10, lr, own, active, new_active)
        Floc.index_add_(0, lr, U01 * own[:, None])  # new pivot rows' trailing columns
        rows[t * v:(t + 1) * v] = piv_gids
        return Aloc, new_active

    # -- Windowed stepping (paper Lemma 10): at step t only columns with ------
    # gid >= t*v are read or written, and those are a *suffix* of the local
    # columns (tile-cyclic ownership is monotone in the local tile index), so
    # each bucketed body works on the window Aloc[:, C - wc:].  Rows cannot be
    # windowed under pivoting — active rows stay scattered over the whole
    # local block (§7.3 row masking) — so the row dimension stays R.
    def step_windowed(t, A, a_off, Floc, active, rows):
        """A: the carried window, local columns a_off..C-1."""
        wc = window_width(t, nsteps, Py, C, v)
        c_start = C - wc
        Awin = A[:, c_start - a_off:]
        lc0w = min(max((t // Py) * v - c_start, 0), wc - v)  # owner never clips
        # -- 1. Reduce the panel block-column over pz (window slice). ---------
        panel = mesh.psum(Awin[:, lc0w:lc0w + v], "pz")
        # -- 2-4. As in the flat body. ----------------------------------------
        A00, piv_gids, owner, L00, lr, own, new_active, L10 = factor_panel(t, panel, active)
        # -- 5. Pivot rows gathered by index over (px, pz). -------------------
        R01 = mesh.psum(Awin.index_select(0, lr) * own[:, None], ("px", "pz"))
        trailing = (col_gid[c_start:] >= (t + 1) * v).to(dtype)
        R01 = R01 * trailing  # columnwise: same U01 as masking after
        # -- 6. Fused TRSM -> Schur on layer t % c: U01 never leaves the ------
        #    kernel between the solve and the trailing update.
        on_layer = 1.0 if pz == t % c else 0.0
        Awin, U01 = bk.fused_trsm_schur(Awin, L00, R01, L10 * (on_layer * new_active)[:, None],
                                        unit=True)
        # -- 7. Factor write-back: one v-wide panel slab + an indexed row -----
        #    scatter for the pivot rows' trailing columns.
        write_panel(t, owner, Floc, A00, L10, lr, own, active, new_active)
        Floc[:, c_start:].index_add_(0, lr, U01 * own[:, None])
        rows[t * v:(t + 1) * v] = piv_gids
        return Awin, c_start, new_active

    active = torch.ones(R, dtype=dtype, device=dev)
    rows = torch.zeros(N, dtype=torch.int64, device=dev)
    a_off = 0
    for t in range(nsteps):
        if collectives.RECORDER is not None:
            collectives.RECORDER.step(t)
        if hotloop == "windowed":
            Aloc, a_off, active = step_windowed(t, Aloc, a_off, Floc, active, rows)
        else:
            Aloc, active = step_flat(t, Aloc, Floc, active, rows)
    return Floc, rows


def make_lu_mesh(grid: GridConfig) -> LuMesh:
    """The mesh of `grid` over the default process group, built on every rank
    of it (or the trivial mesh of a one-process grid when there is none).
    Ranks beyond P_used stay idle.  Raises when the group is too small."""
    return LuMesh(grid)


def distributed_lu(A: torch.Tensor, grid: GridConfig, mesh: LuMesh, *,
                   pivot: str = "tournament", backend: str = "cuda",
                   hotloop: str = "windowed"):
    """Factor A [N, N] (the same on every rank) on the mesh.

    Each rank takes its block-cyclic block and runs `_local_lu`; every rank
    of the default group, idle ones too, gets the whole packed F [N, N] and
    the pivot order rows [N].
    """
    N, v = grid.N, grid.v
    Floc = rows = None
    if mesh.active:
        Floc, rows = _local_lu(grid, pivot, backend, local_block(A, grid, mesh.px, mesh.py),
                               mesh, hotloop=hotloop)
    blocks = mesh.gather_blocks(Floc, (N // grid.Px, N // grid.Py), A.dtype, A.device)
    if mesh.size > grid.P_used:  # idle ranks take rank 0's (identical) order
        if rows is None:
            rows = torch.empty(N, dtype=torch.int64, device=A.device)
        mesh.broadcast_from_first(rows)
    return block_cyclic_gather(blocks, N, v), rows


# ---------------------------------------------------------------------------
# Instrumented communication volume of the schedule (elements, per processor).
# ---------------------------------------------------------------------------


def lu_comm_volume(N: int, grid: GridConfig, pivot: str = "tournament") -> dict:
    """Exact per-collective accounting of the COnfLUX schedule.

    For each collective call site we count the elements each *participating*
    processor transfers (ring all-reduce of payload S over g members:
    2*S*(g-1)/g per member; butterfly round: payload per member; masked
    broadcast: payload to each receiver), per step, summed over the schedule
    and averaged over all P — the paper's "communication volume per node".
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    Ptot = Px * Py * c
    rounds = max(int(math.log2(Px)), 0)
    vol = dict.fromkeys(
        ("panel_reduce", "pivot_tournament", "a00_bcast", "l10_bcast", "u01_gather"), 0.0
    )
    for t in range(N // v):
        rem = max(N - (t + 1) * v, 0)  # trailing size
        rloc = (N - t * v) / Px  # panel rows per owner-column proc
        cloc = rem / Py  # trailing cols per proc
        # 1. panel reduce over pz: owner column only (Px procs x c layers).
        vol["panel_reduce"] += Px * c * (2 * rloc * v * (c - 1) / c)
        # 2. tournament butterfly on the owner column (values + ids per round).
        if pivot == "tournament":
            vol["pivot_tournament"] += Px * c * rounds * (v * v + v)
        else:  # partial pivoting: per column, argmax reduce + pivot-row psum
            vol["pivot_tournament"] += Px * c * v * (v + 2) * 2.0 * (Px - 1) / max(Px, 1)
        # 3. A00 + pivot ids broadcast to every proc.
        vol["a00_bcast"] += Ptot * (v * v + v)
        # 4. L10 broadcast along py — but only to layer t % c (the Schur
        #    owner), so Px * Py procs receive their rows' multipliers.
        vol["l10_bcast"] += Px * Py * rloc * v
        # 5. pivot-row gather + U01 to the Schur layer: v x cloc per proc.
        vol["u01_gather"] += Px * Py * v * cloc
    out = {k: val / Ptot for k, val in vol.items()}
    out["total"] = sum(out.values())
    out["model_lemma10"] = conflux_model(N, Ptot, M=max(N * N * c / Ptot, 4.0), v=v)
    return out
