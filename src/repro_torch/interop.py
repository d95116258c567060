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


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t`; bf16 (which numpy lacks) widens exactly to f32."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for key, x in flat.items():
        *parents, last = key.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of `_nest`: {"a": {"b": x}} -> {"a/b": x}."""
    out = {}
    for k, x in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(x, key) if isinstance(x, dict) else {key: x})
    return out


def lm_params_to_numpy(cfg, params) -> dict:
    """The JAX package's parameter pytree, as numpy arrays, from a port model
    or from any dict keyed by its parameter names (its gradients, say): the
    inverse of `lm_params_from_numpy`.  Each per-group leaf is stacked over
    the cfg.n_groups groups into "blocks"; bf16 leaves come as f32 (exact)."""
    from repro_torch.models.transformer import param_leaves

    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    flat = {}
    for key, names in param_leaves(named).items():
        if key.startswith("blocks/"):
            if len(names) != cfg.n_groups:
                raise ValueError(f"{key}: {len(names)} groups, the config has {cfg.n_groups}")
            flat[key] = np.stack([_numpy(named[n]) for n in names])
        else:
            flat[key] = _numpy(named[names[0]])
    return _nest(flat)


def train_state_from_numpy(cfg, params: dict, opt: dict, step, *, device):
    """The port's `TrainState` from a JAX `TrainState`'s fields as numpy
    arrays: the parameter pytree, the optimizer state ({"m", "v"} or
    {"vr", "vc"}, each a tree of the parameters' structure) and the step.
    The model is built on `device` (None = the CUDA card) in cfg.param_dtype
    and switched to training; the optimizer state keeps the arrays' dtypes
    (bf16 moments through their bits)."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training.train_step import TrainState

    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    model.load_state_dict(lm_params_from_numpy(cfg, params, device=dev))
    model.train().requires_grad_(True)
    state_opt = {part: {key: _tensor(x, dev, None) for key, x in _flatten(tree).items()}
                 for part, tree in opt.items()}
    return TrainState(params=model, opt=state_opt,
                      step=torch.as_tensor(np.asarray(step), dtype=torch.int32, device=dev))
