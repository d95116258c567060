"""Inter-statement data reuse (paper §4).

Case I  (input overlap, Lemma 7):  Q_tot >= sum_i Q_i - sum_j Reuse(A_j), with
    Reuse(A_j) = min over sharing statements of |A_j(R_max(X0))| * |V| / |V_max|.

Case II (output overlap, Lemma 8 / Corollary 1): an input produced by statement
    S with intensity rho_S contributes only 1/rho_S of its access size to the
    consumer's dominator set — expressed as Access.coeff = 1/rho_S.
"""

from __future__ import annotations

from repro_torch.core.xpart.bounds import max_computational_intensity, sequential_io_lower_bound
from repro_torch.core.xpart.daap import Program, Statement


def input_reuse(statements: list[Statement], array: str, M: float) -> float:
    """Reuse(array) across `statements` that share it as an input (Eq. 6)."""
    per_stmt = []
    for s in statements:
        if not any(a.array == array for a in s.inputs):
            continue
        r = max_computational_intensity(s, M)
        access = r.psi0.access_sizes(s)[array]
        n_sub = s.domain_size / max(r.psi0.value, 1.0)  # >= number of subcomputations
        per_stmt.append(access * n_sub)
    if len(per_stmt) < 2:
        return 0.0
    return min(per_stmt)


def output_reuse_coefficient(producer: Statement, M: float) -> float:
    """1/rho_S for Corollary 1 (0.0 when recomputation is free, rho -> inf)."""
    r = max_computational_intensity(producer, M)
    if r.rho > 1e12:
        return 0.0
    return 1.0 / r.rho


def program_io_lower_bound(program: Program, M: float) -> float:
    """Q_tot for a multi-statement program: sum of per-statement bounds minus
    Case-I reuse on the declared shared inputs.  Case-II is already folded into
    the statements' Access.coeff values by the caller."""
    q = sum(sequential_io_lower_bound(s, M) for s in program.statements)
    for arr in program.shared_inputs:
        q -= input_reuse(list(program.statements), arr, M)
    return q
