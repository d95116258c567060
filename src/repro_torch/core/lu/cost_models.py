"""Parallel I/O cost models of LU implementations (paper Table 2).

All models return *elements communicated per processor* (multiply by the
element size for bytes).  Leading-order terms from Table 2:

    LibSci / ScaLAPACK (2D):  N^2 / sqrt(P)
    SLATE (2D):               N^2 / sqrt(P)
    CANDMC (2.5D):            5 N^3 / (P sqrt(M))
    COnfLUX (this paper):     N^3 / (P sqrt(M))
"""

from __future__ import annotations

import math

from repro_torch.core.xpart.lu_bound import conflux_io_cost


def scalapack2d_model(N: float, P: int, M: float | None = None, nb: int = 64) -> float:
    """Cray LibSci / ScaLAPACK 2D block-cyclic with partial pivoting:
    N^2/sqrt(P) leading term with an O(N^2/P) correction."""
    return N**2 / math.sqrt(P) + N**2 / P


def slate_model(N: float, P: int, M: float | None = None, nb: int = 16) -> float:
    """SLATE: 2D block decomposition; same leading term as ScaLAPACK."""
    return N**2 / math.sqrt(P) + N**2 / P


def candmc_model(N: float, P: int, M: float) -> float:
    """CANDMC 2.5D LU [Solomonik & Demmel]: 5 N^3/(P sqrt(M)) leading term."""
    return 5 * N**3 / (P * math.sqrt(M)) + N**2 / (P * math.sqrt(M))


def conflux_model(N: float, P: int, M: float, v: float | None = None) -> float:
    """COnfLUX (Lemma 10): N^3/(P sqrt(M)) + O(N^2/P); see `conflux_io_cost`."""
    return conflux_io_cost(N, P, M, v=v)


def chol_model(N: float, P: int, M: float, v: float | None = None) -> float:
    """2.5D Cholesky (follow-up paper arXiv:2108.09337): ~N^3/(2 P sqrt(M)).

    The SPD specialization of the COnfLUX accounting: the symmetric rank-v
    update halves the panel-broadcast leading term, the tournament term
    disappears (no pivoting), and the diagonal-block scatter carries only
    the lower triangle.  Lower-order c-layer reduction terms are unchanged.
    """
    c = max(P * M / N**2, 1.0)
    if v is None:
        v = max(c, 1.0)
    steps = N / v
    q = 0.0
    for t in range(1, int(steps) + 1):
        rem = N - t * v
        if rem <= 0:
            break
        q += N * v * rem / (P * math.sqrt(M))  # L10/U01 broadcasts (half of LU's)
        q += 2 * rem * v * M / (N**2)  # c-layer reductions
        q += v * (v + 1) / 2 + rem * v / P  # L00 lower triangle + panel scatter
    return q


COMM_MODELS = {
    "LibSci": scalapack2d_model,
    "SLATE": slate_model,
    "CANDMC": candmc_model,
    "COnfLUX": conflux_model,
}
