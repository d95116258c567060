"""The COnfLUX upper bound (paper §7.4, Lemma 10).

COnfLUX attains  Q = N^3/(P sqrt(M)) + O(N^2/P)  elements communicated per
processor — 3/2 of the parallel lower bound's leading term 2N^3/(3 P sqrt(M))
(paper §6).  Only the upper bound is needed by the port's cost models; the
lower-bound machinery stays with the JAX package.
"""

from __future__ import annotations

import math


def conflux_io_cost(N: float, P: int, M: float, v: float | None = None) -> float:
    """COnfLUX upper bound (Lemma 10): per-processor communicated elements.

    Leading term N^3/(P sqrt(M)); the O(N^2/P) term collects pivot broadcast,
    A00 scatter, and block-column reductions (Algorithm 1 steps 1-6).
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
        q += 2 * N * v * rem / (P * math.sqrt(M))  # steps 7/9: panel broadcasts
        q += 2 * rem * v * M / (N**2)  # steps 4/11: c-layer reductions
        q += v**2 * max(math.log2(max(N / math.sqrt(M), 2.0)), 1.0)  # step 1 tournament
        q += v**2 + v + 2 * rem * v / P  # steps 2,3,5: A00 + pivots scatter
    return q
