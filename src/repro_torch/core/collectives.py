"""The processor mesh of the 2.5D schedules on `torch.distributed`.

The JAX package runs its schedules under `shard_map` over a mesh with the
named axes ``px``, ``py`` and ``pz``; the port runs one process per
processor and this module is the counterpart of those axes.  `LuMesh`
maps a rank of the default process group to its coordinates (px, py, pz),
in the rank order of the JAX package's ``make_lu_mesh`` (devices reshaped
to [Px, Py, c], so rank = (px * Py + py) * c + pz), and holds one process
group for each set of axes the schedules reduce over: ``px``, ``py``,
``pz``, (``px``, ``pz``) and (``px``, ``py``).

Only two collectives are used, `all_reduce(SUM)` and `broadcast`, which
both NCCL and gloo (on CPU and on CUDA tensors) take:

- `psum(x, axes)` sums x over the ranks that share this rank's
  coordinates off `axes`;
- `gather_px(x)` is an all-gather along px written as the all-reduce of a
  zeroed [Px, ...] slab in which each rank fills its own slot; the
  tournament's butterfly exchange with partner px ^ (1 << r) and the
  partial-pivoting candidates ride on it;
- `gather_blocks` hands every rank of the default group, idle ones too, the
  whole block-cyclic result, one broadcast per (px, py) block.

Adding a zero is exact, so an all-reduce that stands in for an all-gather
or an exchange returns the sender's values bit for bit.

Volume.  Like the JAX package (see `repro_torch.core.lu.conflux`), every
rank joins every collective of the schedule with a masked payload, and the
slab all-gather moves Px times an exchange's payload, so the executed volume
exceeds the schedule's.  The reported volume is the schedule's own count,
`lu_comm_volume` / `chol_comm_volume`.

Tracing.  While `repro_torch.analysis.trace.recording` is active, each
collective that a rank issues, and nothing else, is recorded on `RECORDER`:
its kind, site, axes, the group's ranks and the payload (shape, dtype,
bytes), and the broadcasts' root.  With no recorder the cost is one
`is None` test per call.

Ranks beyond the grid's P_used (when `optimize_grid` leaves some idle) join
the group creation and the final gather, and run nothing else.  A grid of
one processor with no process group is the trivial mesh: every collective
returns its input.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:  # importing it would run core/lu/__init__, which imports this module
    from repro_torch.core.lu.grid import GridConfig

AXIS_SETS = (("px",), ("py",), ("pz",), ("px", "pz"), ("px", "py"))

# The active trace recorder (`repro_torch.analysis.trace.Recorder`), or None.
# The kernel wrappers and the step loops record on it too.
RECORDER = None

# The schedules' call site of a reduction, for the trace, by the axes it
# reduces over; the LU's A00 (with its column of pivot ids) and L10 both
# reduce over py (`LuMesh._site`).
_SITES = {("pz",): "panel", ("px", "pz"): "r01", ("px", "py"): "a00"}


def record_kernel(name: str, body: str, *operands: torch.Tensor) -> None:
    """Record a kernel-wrapper call on `RECORDER`: the wrapper's name, the body
    its launch took (its `.mode`; "kernel" for a wrapper with one body, "cpu"
    for the plain version on CPU tensors) and its operands' shapes and dtypes."""
    RECORDER.kernel(name=name, body=body, shapes=[list(t.shape) for t in operands],
                    dtypes=[str(t.dtype).removeprefix("torch.") for t in operands])


def world_size() -> int:
    """Ranks in the default process group, or 1 when there is none."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def group_key():
    """Identifies the default process group, for the plan cache: a plan built
    over one group never serves another (or none)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return (id(dist.group.WORLD), dist.get_rank(), dist.get_world_size())


class LuMesh:
    """This rank's place in a [Px, Py, c] grid over the default process group.

    Build it (`repro_torch.core.lu.conflux.make_lu_mesh`) on every rank of
    the default group, in the same order (`torch.distributed.new_group`'s
    rule).
    """

    def __init__(self, grid: GridConfig):
        self.grid = grid
        need = grid.P_used
        distributed = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size() if distributed else 1
        self.rank = dist.get_rank() if distributed else 0
        if self.size < need:
            where = (f"the process group has {self.size}" if distributed else
                     "there is no process group (call torch.distributed."
                     "init_process_group on every rank first)")
            raise ValueError(f"grid {grid} needs P_used={need} ranks, but {where}")
        self.active = self.rank < need
        Py, c = grid.Py, grid.c
        r = self.rank
        # an idle rank has no place in the grid
        self.px, self.py, self.pz = ((r // (Py * c), (r // c) % Py, r % c) if self.active
                                     else (None, None, None))
        self._groups: dict[tuple, object] = {}
        self._ranks: dict[tuple, list[int]] = {}  # this rank's group of each axis set
        if self.size == 1:
            return
        coords = [(q // (Py * c), (q // c) % Py, q % c) for q in range(need)]
        for axes in AXIS_SETS:
            idx = [("px", "py", "pz").index(a) for a in axes]
            members: dict[tuple, list[int]] = {}
            for q, co in enumerate(coords):
                rest = tuple(x for i, x in enumerate(co) if i not in idx)
                members.setdefault(rest, []).append(q)
            for ranks in members.values():
                if len(ranks) == 1:
                    continue  # a one-rank axis needs no group
                g = dist.new_group(ranks=ranks)
                if self.rank in ranks:
                    self._groups[axes] = g
                    self._ranks[axes] = ranks

    def __repr__(self):
        return (f"LuMesh({self.grid}, rank={self.rank}/{self.size}, "
                f"(px, py, pz)=({self.px}, {self.py}, {self.pz}), active={self.active})")

    def _record(self, kind: str, site: str, axes, ranks, x: torch.Tensor, root=None) -> None:
        RECORDER.collective(kind=kind, site=site, axes=list(axes), ranks=list(ranks),
                            shape=list(x.shape), dtype=str(x.dtype).removeprefix("torch."),
                            nbytes=x.numel() * x.element_size(), root=root)

    def _site(self, axes: tuple, x: torch.Tensor) -> str:
        """The schedule's call site of a reduction of x over `axes`."""
        if axes == ("py",):
            return "a00" if x.shape[-1] == self.grid.v + 1 else "l10"
        return _SITES.get(axes, "psum")

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of x over the ranks along `axes` (a name or a tuple of names).

        Over a one-rank axis this is x itself, so callers never write into
        the result."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        g = self._groups.get(axes)
        if g is None:
            return x
        y = x.contiguous().clone()
        if RECORDER is not None:
            self._record("all_reduce", self._site(axes, y), axes, self._ranks[axes], y)
        dist.all_reduce(y, group=g)
        return y

    def gather_px(self, x: torch.Tensor) -> torch.Tensor:
        """[Px, *x.shape]: every px rank's x, along this rank's px axis (the
        pivot search's exchange; site "pivot" in a trace)."""
        g = self._groups.get(("px",))
        if g is None:
            return x[None]
        slab = torch.zeros((self.grid.Px, *x.shape), dtype=x.dtype, device=x.device)
        slab[self.px] = x
        if RECORDER is not None:
            self._record("all_reduce", "pivot", ("px",), self._ranks[("px",)], slab)
        dist.all_reduce(slab, group=g)
        return slab

    def gather_blocks(self, block: torch.Tensor | None, shape, dtype, device) -> torch.Tensor:
        """[Px, Py, R, C] of the layer-0 blocks, on every rank of the group.

        block: this rank's [R, C] result (None on an idle rank); layer pz = 0
        of each (px, py) sends its block, every other rank receives."""
        Px, Py, c = self.grid.Px, self.grid.Py, self.grid.c
        if self.size == 1:
            return block[None, None]
        out = torch.empty((Px, Py, *shape), dtype=dtype, device=device)
        for px in range(Px):
            for py in range(Py):
                src = (px * Py + py) * c
                if self.rank == src:
                    out[px, py] = block
                if RECORDER is not None:
                    self._record("broadcast", "gather", ("world",), range(self.size),
                                 out[px, py], root=src)
                dist.broadcast(out[px, py], src)
        return out

    def broadcast_from_first(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x on every rank (idle ranks pass a buffer of its shape)."""
        if self.size > 1:
            if RECORDER is not None:
                self._record("broadcast", "gather", ("world",), range(self.size), x, root=0)
            dist.broadcast(x, 0)
        return x
