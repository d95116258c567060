"""Disjoint Array Access Program (DAAP) representation (paper §2.2).

A statement `S: A0[phi0(r)] <- f(A1[phi1(r)], ..., Am[phim(r)])` is modeled by the
*access dimensions* of each array reference: the set of distinct iteration
variables appearing in its access-function vector.  That is all the lower-bound
machinery needs — individual vertices are never materialized (the cDAG stays
parametric, which is the paper's key generalization over explicit pebbling).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Access:
    """One array reference `A_j[phi_j(r)]`.

    vars:  distinct iteration variables in phi_j — `dim(A_j(phi_j))` (§2.2 item 7).
    coeff: dominator-set weight of this access.  1.0 for graph inputs; for an
           input produced by an earlier statement with computational intensity
           rho_S, Lemma 8 lowers it to 1/rho_S (output reuse, §4.2).
    out_degree_one: the access is a graph input consumed by exactly one compute
           vertex (Lemma 6 — e.g. A[i,k] in LU's S1).
    """

    array: str
    vars: tuple[str, ...]
    coeff: float = 1.0
    out_degree_one: bool = False

    def __post_init__(self):
        if len(set(self.vars)) != len(self.vars):
            # `A[k,k]` contributes the variable once: dedupe but keep order.
            object.__setattr__(self, "vars", tuple(dict.fromkeys(self.vars)))


@dataclass(frozen=True)
class Statement:
    """One DAAP statement inside a loop nest with variables `loop_vars`.

    domain_size: |V| — total number of statement evaluations (vertices), as a
        number (may be a float for symbolic N³/3-style counts).
    var_caps: optional per-variable upper bounds on |R^t| (extent of the loop);
        used to keep psi(X) bounded when a variable appears in no input access.
    """

    name: str
    loop_vars: tuple[str, ...]
    output: Access
    inputs: tuple[Access, ...]
    domain_size: float
    var_caps: dict[str, float] = field(default_factory=dict, hash=False)

    def __post_init__(self):
        for a in self.inputs + (self.output,):
            missing = set(a.vars) - set(self.loop_vars)
            if missing:
                raise ValueError(f"{self.name}: access {a.array} uses unknown vars {missing}")

    @property
    def u_out_degree_one(self) -> int:
        """u of Lemma 6: inputs that are out-degree-1 graph inputs."""
        return sum(1 for a in self.inputs if a.out_degree_one)

    def access_size(self, array: str, extents: dict[str, float]) -> float:
        """|A_j(R_h)| = prod of |R^k| over the access's variables (Lemma 5)."""
        for a in self.inputs:
            if a.array == array:
                return math.prod(extents[v] for v in a.vars)
        raise KeyError(array)


@dataclass(frozen=True)
class Program:
    """A sequence of statements.  `shared_inputs` lists arrays for Case-I input
    reuse (§4.1); output reuse (Case II) is expressed through Access.coeff."""

    statements: tuple[Statement, ...]
    shared_inputs: tuple[str, ...] = ()
