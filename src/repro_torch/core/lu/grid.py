"""Processor Grid Optimization (paper §8 'Implementation').

COnfLUX decomposes P processors into [Px, Py, c] with c ~= P*M/N^2 replication
layers.  Like the paper, the optimizer may *disable* a minor fraction of
processors when that lowers the communication volume ("other implementations,
which greedily try to utilize all resources, often find communication-
suboptimal decompositions").

Constraints of the port's block-cyclic layout:
  * Px, Py powers of two (butterfly tournament partners are px XOR 2^r);
  * v*Px | N and v*Py | N (static block-cyclic layout, no ragged tiles).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class GridConfig:
    Px: int
    Py: int
    c: int
    v: int
    N: int

    @property
    def P_used(self) -> int:
        return self.Px * self.Py * self.c

    def __str__(self):
        return f"[{self.Px}x{self.Py}x{self.c}] v={self.v} (P_used={self.P_used})"


def validate_layout(N: int, grid: GridConfig, pivot: str = "tournament") -> None:
    """Check the static block-cyclic layout constraints up front.

    Raises ValueError with an actionable message instead of letting the
    violation surface as a shape error deep inside the block-cyclic scatter.
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    if min(Px, Py, c, v) < 1:
        raise ValueError(f"grid {grid}: Px, Py, c, v must all be >= 1")
    if grid.N != N:
        raise ValueError(
            f"grid {grid} was built for N={grid.N} but the matrix has N={N}; "
            f"rebuild the grid (or the plan) for this problem size"
        )
    if pivot == "tournament" and Px & (Px - 1):
        raise ValueError(
            f"grid {grid}: Px={Px} must be a power of two — the tournament "
            f"butterfly pairs ranks px XOR 2^r; use Px in "
            f"{{{', '.join(str(2**k) for k in range(4))}, ...}} or pivot='partial'"
        )
    for axis, p in (("Px", Px), ("Py", Py)):
        if N % (v * p):
            raise ValueError(
                f"grid {grid}: N={N} must be divisible by v*{axis}={v * p} for the "
                f"static v x v tile-block-cyclic layout (no ragged tiles); pick a "
                f"panel width v dividing {N // p if N % p == 0 else N} or pad N"
            )


def _pow2_divisors_leq(n: int, cap: int):
    d = 1
    while d <= cap:
        if n % d == 0:
            yield d
        d *= 2


def enumerate_grids(
    N: int, P: int, M: float, v: int | None = None, max_waste: float = 0.5,
) -> list[GridConfig]:
    """Every [Px, Py, c] x v satisfying the layout + memory constraints.

    The feasibility rules are the search space of `optimize_grid`: power-of-
    two axes, Px*Py*c within [(1-max_waste)*P, P], local share N^2*c/P_used
    fitting in M, v*axis dividing N.
    """
    out: list[GridConfig] = []
    c_max = max(min(int(P * M / N**2), P), 1)
    v_candidates = [v] if v else [8, 16, 32, 64, 128, 256]
    c = 1
    cs = []
    while c <= c_max:
        cs.append(c)
        c *= 2
    for c in cs:
        p2 = P // c
        for Px in _pow2_divisors_leq(N, p2):
            Py = min(2 ** int(math.log2(max(p2 // Px, 1))), p2 // Px if p2 // Px else 1)
            while Py >= 1 and N % Py:
                Py //= 2
            if Py < 1:
                continue
            used = Px * Py * c
            if used < (1 - max_waste) * P or used > P:
                continue
            if N * N * c / used > M:  # local share must fit in fast memory
                continue
            for vv in v_candidates:
                if N % (vv * Px) or N % (vv * Py) or vv * max(Px, Py) > N:
                    continue
                out.append(GridConfig(Px=Px, Py=Py, c=c, v=vv, N=N))
    return out


# optimize_grid memo: resolve() re-enters the search on every plan() call for
# unresolved configs (their cache key can't know the grid), so the pure
# search is memoized.  Failures are cached too: an infeasible (N, P, M, v)
# stays infeasible.
_SEARCH_CACHE: dict[tuple, GridConfig | ValueError] = {}
_SEARCH_STATS = {"searches": 0, "hits": 0}
_SEARCH_LOCK = threading.Lock()


def grid_search_stats() -> dict:
    with _SEARCH_LOCK:
        return dict(_SEARCH_STATS)


def clear_grid_search_cache() -> None:
    with _SEARCH_LOCK:
        _SEARCH_CACHE.clear()
        _SEARCH_STATS.update(searches=0, hits=0)


def optimize_grid(
    N: int, P: int, M: float, v: int | None = None, max_waste: float = 0.5,
    volume=None,
) -> GridConfig:
    """Search [Px, Py, c] x v minimizing the instrumented per-proc volume.

    Mirrors the paper's Processor Grid Optimization: tries all power-of-two
    grids with Px*Py*c <= P (allowing up to `max_waste` of P to idle),
    block sizes v aligned to the layout, and scores with the exact schedule
    counter.  The replication factor is memory-bounded: the local matrix
    share N^2*c/P must fit in M, i.e. c <= P*M/N^2.

    volume: the schedule counter to score with, ``(N, grid) -> {"total": ...}``;
    defaults to the COnfLUX LU counter.  The Cholesky resolve hook passes
    `chol_comm_volume`.

    Results are memoized per (N, P, M, v, max_waste, volume counter); see
    `grid_search_stats` / `clear_grid_search_cache`.
    """
    if volume is None:
        from repro_torch.core.lu.conflux import lu_comm_volume  # conflux imports this module

        volume = lu_comm_volume

    key = (N, P, M, v, max_waste,
           f"{getattr(volume, '__module__', '?')}.{getattr(volume, '__qualname__', repr(volume))}")
    with _SEARCH_LOCK:
        cached = _SEARCH_CACHE.get(key)
        if cached is not None:
            _SEARCH_STATS["hits"] += 1
            if isinstance(cached, ValueError):
                raise cached
            return cached
        _SEARCH_STATS["searches"] += 1

    best: tuple[float, GridConfig] | None = None
    for cfg in enumerate_grids(N, P, M, v=v, max_waste=max_waste):
        cost = volume(N, cfg)["total"]
        if best is None or cost < best[0]:
            best = (cost, cfg)
    if best is None:
        hint = (
            f" with fixed v={v} (no power-of-two grid satisfies N % (v*Px) == 0 "
            f"and N % (v*Py) == 0; drop the v override or pick a divisor of {N})"
            if v
            else f" (the local share N^2*c/P must fit in M={M:g}; raise M or P)"
        )
        err = ValueError(f"no feasible grid for N={N}, P={P}, M={M:g}{hint}")
        with _SEARCH_LOCK:
            _SEARCH_CACHE[key] = err
        raise err
    with _SEARCH_LOCK:
        _SEARCH_CACHE[key] = best[1]
    return best[1]
