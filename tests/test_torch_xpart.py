"""The port's X-partitioning lower-bound machinery (`repro_torch.core.xpart`)
against the JAX package's (`repro.core.xpart`, plain Python and numpy).

Each function is held to its JAX counterpart exactly (`==`, the same floats)
on a seeded grid of N, M and P, and the cases of tests/test_xpart_bounds.py
and tests/test_xpart_program.py run again with the port's module in place of
the JAX package's.
"""

from __future__ import annotations

import ast
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.xpart as jx
import repro.core.xpart.reuse as jreuse
import repro_torch.core.xpart as tx
import repro_torch.core.xpart.reuse as treuse

ROOT = Path(__file__).resolve().parents[1]

# (N, M, P) drawn from a seed: N and P over the paper's range (§8), M
# between a few tiles and the whole local share.
_rng = np.random.default_rng(27)
GRID = [(float(2 ** int(_rng.integers(8, 15))), float(2 ** int(_rng.integers(8, 20))),
         int(2 ** int(_rng.integers(0, 11)))) for _ in range(3)]


def test_the_port_exports_the_references_names():
    assert tx.__all__ == jx.__all__
    assert len(tx.__all__) == 14


@pytest.mark.parametrize("N,M,P", GRID)
def test_closed_forms_equal_jax(N, M, P):
    assert tx.lu_sequential_lower_bound(N, M) == jx.lu_sequential_lower_bound(N, M)
    assert tx.lu_parallel_lower_bound(N, P, M) == jx.lu_parallel_lower_bound(N, P, M)
    assert tx.conflux_io_cost(N, P, M) == jx.conflux_io_cost(N, P, M)
    assert tx.conflux_io_cost(N, P, M, v=16) == jx.conflux_io_cost(N, P, M, v=16)
    assert repr(tx.lu_statements(N, M)) == repr(jx.lu_statements(N, M))


def _mmm(mod, domain=1e9):
    return mod.Statement("T", ("i", "j", "k"), mod.Access("C", ("i", "j")),
                         (mod.Access("C", ("i", "j")), mod.Access("A", ("i", "k")),
                          mod.Access("B", ("k", "j"))), domain_size=domain)


def _statements(mod, N, M):
    return [*mod.lu_statements(N, M), _mmm(mod)]


@pytest.mark.parametrize("N,M,P", GRID)
def test_psi_and_intensity_equal_jax(N, M, P):
    for ts, js in zip(_statements(tx, N, M), _statements(jx, N, M)):
        for X in (2 * M, 8 * M):
            tp, jp = tx.psi(ts, X), jx.psi(js, X)
            assert tp.value == jp.value and tp.extents == jp.extents
            assert tp.access_sizes(ts) == jp.access_sizes(js)
    # The intensity search takes about a second a statement: S2's at every
    # point (S1's in test_program_level_reuse_equals_jax).
    ts, js = tx.lu_statements(N, M)[1], jx.lu_statements(N, M)[1]
    tr, jr = tx.max_computational_intensity(ts, M), jx.max_computational_intensity(js, M)
    assert (tr.rho, tr.X0, tr.bound, tr.clamped_by_out_degree_one) == (
        jr.rho, jr.X0, jr.bound, jr.clamped_by_out_degree_one)
    assert tr.psi0.value == jr.psi0.value and tr.psi0.extents == jr.psi0.extents


def test_io_lower_bounds_equal_jax():
    N, M, P = GRID[0]
    ts, js = _mmm(tx), _mmm(jx)
    assert tx.sequential_io_lower_bound(ts, M) == jx.sequential_io_lower_bound(js, M)
    assert tx.parallel_io_lower_bound(ts, M, P) == jx.parallel_io_lower_bound(js, M, P)


@pytest.mark.parametrize("N,M,P", [(1024.0, 2.0**16, 8)])
def test_program_level_reuse_equals_jax(N, M, P):
    def program(mod):
        s = _mmm(mod, N ** 3)
        t = mod.Statement("U", ("i", "j", "k"), mod.Access("E", ("i", "j", "k")),
                          (mod.Access("D", ("i", "k")), mod.Access("B", ("k", "j"))), N ** 3)
        return mod.Program((s, t), shared_inputs=("B",)), [s, t]

    tp, tst = program(tx)
    jp, jst = program(jx)
    assert tx.input_reuse(tst, "B", M) == jx.input_reuse(jst, "B", M)
    assert treuse.output_reuse_coefficient(tst[0], M) == jreuse.output_reuse_coefficient(
        jst[0], M)
    s1t, s1j = tx.lu_statements(N, M)[0], jx.lu_statements(N, M)[0]
    assert treuse.output_reuse_coefficient(s1t, M) == jreuse.output_reuse_coefficient(s1j, M)
    assert tx.program_io_lower_bound(tp, M) == jx.program_io_lower_bound(jp, M)


# --- The JAX package's own cases, against the port. ---------------------------

def _ported_cases(name: str):
    """The test functions of tests/<name>, compiled with `repro.core.xpart`
    read as `repro_torch.core.xpart`: [(id, callable)]."""
    src = (ROOT / "tests" / name).read_text().replace("repro.core.xpart", "repro_torch.core.xpart")
    mod = types.ModuleType(f"ported_{name[:-3]}")
    mod.__file__ = str(ROOT / "tests" / name)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    cases = []
    for node in ast.parse(src).body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            cls = getattr(mod, node.name)
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name.startswith("test"):
                    cases.append((f"{name}::{node.name}::{item.name}",
                                  (lambda c=cls, n=item.name: getattr(c(), n)())))
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            cases.append((f"{name}::{node.name}", getattr(mod, node.name)))
    return cases


PORTED = _ported_cases("test_xpart_bounds.py") + _ported_cases("test_xpart_program.py")


def test_the_ported_cases_are_the_twenty_of_the_jax_files():
    assert len(PORTED) == 20
    for _, fn in PORTED:
        glb = getattr(fn, "__globals__", {})
        assert all(getattr(v, "__module__", "").startswith(("repro_torch", "ported_", "builtins"))
                   or not getattr(v, "__module__", "").startswith("repro.")
                   for v in glb.values())


@pytest.mark.parametrize("case", [fn for _, fn in PORTED], ids=[i for i, _ in PORTED])
def test_jax_packages_xpart_cases_hold_for_the_port(case):
    case()
