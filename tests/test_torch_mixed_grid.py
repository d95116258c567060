"""The 2-byte distributed schedules on 1x1x1 grids against the JAX package's
local programs, on the CPU.  Split from `tests/test_torch_mixed_schedules.py`
for run time (its docstring states the tolerances); the case keeps its test
name, parameters and assertions, and takes its helpers and its autouse
plan-cache fixture from there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import GridConfig, SolverConfig, plan
from test_torch_mixed_schedules import (  # noqa: F401  (_fresh_cache: an autouse fixture)
    F16_PARTIAL_TOL_FACTOR,
    LOW,
    _finalized_at,
    _fresh_cache,
    _inputs,
    _low_tol,
    _partial_candidates,
    _record_panels,
    _reference_1x1x1,
    _tournament_candidates,
)


@pytest.mark.parametrize("hotloop", ["flat", "windowed"])
@pytest.mark.parametrize("N,v", [(64, 16), (64, 32), (128, 16), (128, 32)])
@pytest.mark.parametrize("strategy,pivot", [("conflux", "tournament"), ("conflux", "partial"),
                                            ("baseline2d", "partial"), ("cholesky25d", "none")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_grid_1x1x1_2byte_matches_reference(dtype, strategy, pivot, N, v, hotloop, monkeypatch):
    """Pivots equal and F within `_low_tol` of the JAX package's, except in
    two ways, each checked here:

    - a flipped pivot: the two candidates the packages chose lie within
      `_low_tol` of each other in the port's own state at that round (its
      recorded panel, with its own arithmetic): a near-tie that a one-ulp
      difference of an earlier rounding decides either way;
    - f16 partial pivoting, pivots equal but F beyond `_low_tol`: the
      difference starts at step 0, in the pivot panel's elementwise update
      `F - outer(mult, prow)`, which XLA on the CPU evaluates in f16 with the
      product kept in f32 where the port rounds it as written (in bf16 XLA
      rounds it too, see `test_xla_fuses_the_f16_pivot_update_and_not_bf16`).
      From there the two are two roundings of the same elimination, held to
      F16_PARTIAL_TOL_FACTOR * N * eps * max|F|, just above the largest
      reading of all these cases.
    """
    tdt = LOW[dtype][0]
    kind = "cholesky" if strategy == "cholesky25d" else "lu"
    A, A_spd = _inputs(N, N + v)
    panels = _record_panels(monkeypatch)
    cfg = SolverConfig(strategy=strategy, pivot=pivot, grid=GridConfig(1, 1, 1, v, N),
                       hotloop=hotloop, compute_dtype=dtype)
    fact = plan(N, cfg, device="cpu").execute(A_spd if kind == "cholesky" else A)
    assert fact.F.dtype == tdt and fact.kind == kind and fact.backend == "cuda"
    F, rows = fact.F.float().numpy(), fact.rows.numpy()
    F_ref, rows_ref = _reference_1x1x1(kind, pivot, N, v, dtype, hotloop)
    tol = _low_tol(tdt, N, F_ref)
    flips = np.nonzero(rows != rows_ref)[0]
    if len(flips):
        k = int(flips[0])
        t, r = divmod(k, v)
        weights = torch.ones(N, dtype=tdt)
        weights[torch.from_numpy(rows[:t * v])] = 0
        cand = (_partial_candidates if pivot == "partial" else _tournament_candidates)(
            panels[t], weights, r)
        gap = float((cand[int(rows[k])] - cand[int(rows_ref[k])]).abs())
        assert gap <= tol, f"pivot {k}: candidates {gap} apart, beyond the tolerance {tol}"
        return
    err = float(np.abs(F - F_ref).max())
    if err <= tol:
        return
    assert dtype == "float16" and pivot == "partial", f"F {err} apart, beyond {tol}"
    differs = np.abs(F - F_ref) > 0
    assert _finalized_at(rows, v)[differs].min() == 0
    assert err <= F16_PARTIAL_TOL_FACTOR * N * torch.finfo(tdt).eps * np.abs(F_ref).max()
