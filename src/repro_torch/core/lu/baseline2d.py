"""ScaLAPACK/LibSci-style 2D baseline (paper §8 comparison target).

Same block-cyclic machinery as COnfLUX but with the 2D configuration the
vendor libraries use: no replication (c = 1), square-ish grid, and classic
column-by-column partial pivoting instead of the tournament.  Its
per-processor volume is N^2/sqrt(P) leading order (Table 2) — the counter in
`lu_comm_volume` recovers that term exactly from the same call sites that
give COnfLUX its N^3/(P sqrt(M)).
"""

from __future__ import annotations

import math

from repro_torch.core.lu.grid import GridConfig


def scalapack2d_grid(N: int, P: int, v: int = 32) -> GridConfig:
    """Largest power-of-two square-ish 2D grid with layout-compatible v."""
    Px = 2 ** int(math.log2(max(int(math.sqrt(P)), 1)))
    Py = 2 ** int(math.log2(max(P // Px, 1)))
    while Px > 1 and (N % (v * Px)):
        Px //= 2
    while Py > 1 and (N % (v * Py)):
        Py //= 2
    return GridConfig(Px=Px, Py=Py, c=1, v=v, N=N)
