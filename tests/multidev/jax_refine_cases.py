"""The JAX package's mixed-precision plans and refined solves, for the port's tests.

    python tests/multidev/jax_refine_cases.py OUT.npz

Runs every case of `CASES` through `repro.api.plan(...).execute(A).solve(b,
refine_tol=...)` and writes each case's factors, pivot order and refined
solve (x, iterations, final residual, converged) to OUT.npz;
`tests/test_torch_mixed_precision.py` runs it and refines the same factors
with the port.  Both make their inputs with `inputs(name)` from numpy seeds.

`repro.api` imports `jax.experimental.enable_x64`, which jax 0.9.0 calls
`jax.enable_x64`; this process sets that name before the import.  It runs
in a process of its own so that the shim never reaches the test process,
whose JAX test files import `repro.api` as it stands.
"""

from __future__ import annotations

import sys

import numpy as np

# name -> (strategy, B, N, v, working dtype, compute dtype, matrix, tol, max_iters, k)
#   matrix: ("cond", c) A with the singular values logspace(0, -log10 c);
#           ("spd", c) Q diag(logspace(0, -log10 c)) Q^T; ("gauss",) standard
#           normal; a tuple of c per system on batched plans.
#   tol: one tolerance, or one per system; k: RHS columns (None: a vector).
# Each tolerance lies at least 1.4x away from every relative residual of its
# system's iterations (measured), or far below the rounding floor where the
# residual stalls, so that rounding differences between the packages cannot
# move a convergence decision.
CASES = {
    "lu_f64_f32": ("sequential", None, 128, 16, "float64", "float32", ("cond", 1e3), 1e-12, 25,
                   None),
    "lu_f64_f32_k3": ("sequential", None, 64, 16, "float64", "float32", ("cond", 1e2), 1e-12, 25,
                      3),
    "lu_f32_bf16": ("sequential", None, 64, 16, "float32", "bfloat16", ("cond", 10.0), 1e-6, 25,
                    None),
    "lu_f32_f16": ("sequential", None, 64, 16, "float32", "float16", ("cond", 10.0), 1e-6, 25,
                   None),
    "lu_f64_bf16": ("sequential", None, 64, 16, "float64", "bfloat16", ("cond", 30.0), 1e-11, 40,
                    None),
    "chol_f64_f32": ("sequential_chol", None, 64, 16, "float64", "float32", ("spd", 1e3), 1e-12,
                     25, None),
    "chol_f32_bf16": ("sequential_chol", None, 64, 16, "float32", "bfloat16", ("spd", 10.0), 1e-6,
                      25, None),
    "lu_batched_f64_f32": ("sequential", 3, 64, 16, "float64", "float32",
                           ("cond", (1e1, 1e3, 1e5)), (1e-4, 1e-12, 1e-13), 25, None),
    "lu_batched_f32_bf16": ("sequential", 4, 64, 16, "float32", "bfloat16", ("gauss",),
                            (1e-5, 2e-2, 1e-7, 6e-4), 25, None),
    "chol_batched_f64_f32": ("sequential_chol", 3, 64, 16, "float64", "float32",
                             ("spd", (1e1, 1e3, 1e5)), (1e-12, 1e-6, 1e-9), 25, None),
    "lu_zero_cap": ("sequential", None, 64, 16, "float64", "float32", ("cond", 10.0), 1e-30, 0,
                    None),
    "lu_hopeless": ("sequential", None, 64, 16, "float64", "float32", ("cond", 1e14), 1e-14, 5,
                    None),
    # The port factors this one itself (plan(128) end to end, device="cpu").
    "e2e_lu_f64_f32": ("sequential", None, 128, 32, "float64", "float32", ("gauss",), 1e-12, 25,
                       None),
}


def _matrix(kind: str, c, n: int, rng) -> np.ndarray:
    if kind == "gauss":
        return rng.standard_normal((n, n))
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0.0, -np.log10(c), n)
    if kind == "spd":
        return (u * s) @ u.T
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * s) @ v.T


def inputs(name: str):
    """(A, b) of a case in float64: A [N, N] or [B, N, N], b [N], [N, k],
    [B, N] or [B, N, k]."""
    _, B, N, _, _, _, matrix, _, _, k = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    kind, *args = matrix
    if B is None:
        A = _matrix(kind, args[0] if args else None, N, rng)
    else:
        conds = args[0] if args else (None,) * B
        A = np.stack([_matrix(kind, c, N, rng) for c in conds])
    shape = (N,) if B is None else (B, N)
    b = rng.standard_normal(shape if k is None else shape + (k,))
    return A, b


def main(out: str) -> None:
    import jax

    jax.experimental.enable_x64 = jax.enable_x64  # jax 0.9.0's name for it
    import jax.numpy as jnp

    from repro.api import SolverConfig, plan
    from repro.api.result import Factorization

    res = {}
    for name, (strategy, B, N, v, dtype, compute, _, tol, cap, _) in CASES.items():
        A, b = inputs(name)
        cfg = SolverConfig(strategy=strategy, dtype=dtype, compute_dtype=compute,
                           backend="ref", v=v)
        fact = plan(N if B is None else (B, N), cfg).execute(A)
        rs = fact.solve(b, refine_tol=np.asarray(tol) if B else tol, max_refine_iters=cap)
        F = np.asarray(fact.F)
        res[f"{name}_F"] = F.view(np.uint16) if F.dtype == jnp.bfloat16 else F
        res[f"{name}_F_dtype"] = np.asarray(F.dtype.name)
        res[f"{name}_rows"] = np.asarray(fact.rows)
        res[f"{name}_x"] = np.asarray(rs.x)
        res[f"{name}_iters"] = np.asarray(rs.refinement_iters)
        res[f"{name}_res"] = np.asarray(rs.final_residual)
        res[f"{name}_conv"] = np.asarray(rs.converged)
    # A hand-built result without A_ref refuses a refined solve.
    fact = Factorization(F=res["lu_f64_f32_F"], rows=res["lu_f64_f32_rows"])
    try:
        fact.solve(np.zeros(128), refine_tol=1e-6)
        res["missing_a_ref_raises"] = np.asarray(False)
    except ValueError as e:
        res["missing_a_ref_raises"] = np.asarray("A_ref" in str(e))
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
