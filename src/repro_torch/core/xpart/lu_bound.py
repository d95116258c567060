"""End-to-end parallel I/O lower bound for LU factorization (paper §6), and the
COnfLUX upper bound (paper §7.4, Lemma 10).

    S1: A[i,k] = A[i,k] / A[k,k]            rho_S1 = 1  (Lemma 6, u = 1)
    S2: A[i,j] = A[i,j] - A[i,k] * A[k,j]   rho_S2 = sqrt(M)/2

    Q_LU >= (2N^3 - 6N^2 + 4N) / (3 sqrt(M)) + N(N-1)/2         (sequential)
    Q_P,LU >= 2N^3/(3 P sqrt(M)) + O(N^2/P)                     (parallel)

COnfLUX attains  Q = N^3/(P sqrt(M)) + O(N^2/P)  — 3/2 of the leading term
(the paper phrases this as "only a factor 1/3 over the lower bound").
"""

from __future__ import annotations

import math

from repro_torch.core.xpart.daap import Access, Statement


def lu_statements(N: float, M: float) -> tuple[Statement, Statement]:
    """The two LU statements with Case-II coefficients already applied.

    S2's A[i,k] input is S1's output; rho_S1 = 1 so its dominator coefficient
    stays 1/rho_S1 = 1 (recomputing is no cheaper than loading — paper §6).
    """
    s1 = Statement(
        name="S1",
        loop_vars=("k", "i"),
        output=Access("A_ik", ("i", "k")),
        inputs=(
            Access("A_ik", ("i", "k"), out_degree_one=True),
            Access("A_kk", ("k",)),
        ),
        domain_size=N * (N - 1) / 2,
        var_caps={"k": N, "i": N},
    )
    s2 = Statement(
        name="S2",
        loop_vars=("k", "i", "j"),
        output=Access("A_ij", ("i", "j")),
        inputs=(
            Access("A_ij", ("i", "j")),
            Access("A_ik", ("i", "k"), coeff=1.0),  # output reuse from S1, rho_S1 = 1
            Access("A_kj", ("k", "j")),
        ),
        domain_size=N**3 / 3 - N**2 + 2 * N / 3,
        var_caps={"k": N, "i": N, "j": N},
    )
    return s1, s2


def lu_sequential_lower_bound(N: float, M: float) -> float:
    """Closed form of §6:  (2N^3 - 6N^2 + 4N)/(3 sqrt(M)) + N(N-1)/2."""
    return (2 * N**3 - 6 * N**2 + 4 * N) / (3 * math.sqrt(M)) + N * (N - 1) / 2


def lu_parallel_lower_bound(N: float, P: int, M: float) -> float:
    """Q_P,LU >= Q_LU / P  (Lemma 9)."""
    return lu_sequential_lower_bound(N, M) / P


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
