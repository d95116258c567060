"""State carried across from the JAX package.

A solver has no weights: its state is the factorization and the config.  An
LM's state is its parameters.  These functions take what the JAX package
produced, as numpy arrays and plain field values, and build the port's
objects, so both packages can be shown to compute the same thing from the
same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.config import SolverConfig
from repro_torch.api.result import Factorization
from repro_torch.core.lu.grid import GridConfig
from repro_torch.device import resolve_device

_BACKENDS = {"pallas": "cuda", "ref": "ref"}


def factorization_from_numpy(F, rows, *, device, kind: str = "lu", A_ref=None,
                             grid=None, comm: dict | None = None,
                             strategy: str = "") -> Factorization:
    """The port's `Factorization` from packed factors F [N, N] and the pivot
    order rows [N], as the JAX package's `Factorization.F` / `.rows` hold
    them, or from a batch F [B, N, N] and rows [B, N] (a batched JAX plan's
    result).  With `kind="cholesky"`, F is the lower factor L and rows the
    identity order, as a JAX Cholesky `Factorization` holds them.  `device`
    is where the result lives (None = the CUDA card).

    A distributed run's gathered factors carry the grid they ran on (a
    GridConfig-like object or a dict of its fields) and the schedule's
    volume (`comm`, elements per processor), as its `Factorization.grid`
    and `.comm` hold them.

    F may be the JAX package's bfloat16 factors of a mixed-precision plan
    (numpy arrays of ml_dtypes' bfloat16), with A_ref in the working dtype;
    the result then refines as the JAX one does."""
    dev = resolve_device(device)
    F_t = _tensor(F, dev, None)
    A_t = None if A_ref is None else _tensor(A_ref, dev, None)
    return Factorization(
        F=F_t,
        rows=torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev),
        grid=None if grid is None else _grid(grid),
        comm={k: float(x) for k, x in (comm or {}).items()},
        strategy=strategy,
        kind=kind,
        A_ref=A_t,
        work_dtype=None if A_t is None else A_t.dtype,
    )


def _grid(grid) -> GridConfig:
    if isinstance(grid, GridConfig):
        return grid
    g = grid if isinstance(grid, dict) else vars(grid)
    return GridConfig(**{k: int(g[k]) for k in ("Px", "Py", "c", "v", "N")})


def config_from_jax(fields: dict) -> SolverConfig:
    """The port's `SolverConfig` from a JAX `SolverConfig`'s fields (for
    example `dataclasses.asdict(cfg)` or `vars(cfg)`).

    The backend maps "pallas" -> "cuda" (the TPU kernels' counterparts) and
    "ref" -> "ref".  A grid may come as a GridConfig-like object or a dict.
    """
    out = dict(fields)
    backend = out.get("backend", "ref")
    if backend not in _BACKENDS:
        raise ValueError(
            f"JAX backend {backend!r} has no counterpart; known: {sorted(_BACKENDS)}"
        )
    out["backend"] = _BACKENDS[backend]
    if out.get("grid") is not None:
        out["grid"] = _grid(out["grid"])
    return SolverConfig(**out)


def _tensor(a, device, dtype) -> torch.Tensor:
    """A tensor of the numpy array (or array-like) `a`, on `device`, cast to
    `dtype` (None keeps a's).  ml_dtypes' bfloat16 (numpy kind 'V', as the
    JAX package's arrays come) arrives through its bits, a 16-bit integer
    view, so that neither side needs ml_dtypes."""
    a = np.asarray(a)
    a = np.array(a, copy=None if a.flags.writeable else True, order="C")
    if a.dtype.kind == "V" and a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_numpy(cfg, params: dict, *, device, dtype=None) -> dict:
    """The port's model state (a `state_dict` for `Transformer.load_state_dict`)
    from the JAX package's parameter pytree as numpy arrays:
    `{"embed", "head" (unless tied), "blocks": {"pos{i}": {...}}, "final_norm"}`
    with every leaf of "blocks" stacked over the cfg.n_groups groups.

    Group g's leaf `blocks[pos][sub][name][g]` becomes
    `groups.{g}.{pos}.{sub}.{name}`.  `dtype` casts every leaf but the MoE
    router, which stays f32 as the JAX tree keeps it (None keeps each
    leaf's own); `load_state_dict` casts into the model's parameter dtypes
    in any case.  `device` None is the CUDA card."""
    dev = resolve_device(device)
    state = {"embed": _tensor(params["embed"], dev, dtype),
             "final_norm.scale": _tensor(params["final_norm"]["scale"], dev, dtype)}
    if "head" in params:
        state["head"] = _tensor(params["head"], dev, dtype)
    for pos, layer in params["blocks"].items():
        for sub, leaves in layer.items():
            for name, stacked in leaves.items():
                stacked = np.asarray(stacked)
                if stacked.shape[0] != cfg.n_groups:
                    raise ValueError(f"blocks.{pos}.{sub}.{name}: leading axis "
                                     f"{stacked.shape[0]} != n_groups {cfg.n_groups}")
                leaf_dtype = torch.float32 if (sub, name) == ("moe", "router") else dtype
                for g in range(cfg.n_groups):
                    state[f"groups.{g}.{pos}.{sub}.{name}"] = _tensor(stacked[g], dev, leaf_dtype)
    return state
