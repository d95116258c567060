"""Optimizers: AdamW (configurable moment dtype: bf16 moments halve the
optimizer's memory) and Adafactor (factored second moment), as the JAX
package's `repro/training/optimizer.py` computes them.

Parameters and gradients are dicts keyed by the model's parameter names
(`dict(model.named_parameters())`): on a sharded state the rank's blocks,
which AdamW updates element by element as it would the whole leaves, and
Adafactor with its row and column means summed over the axis that cuts
the leaf (`adafactor_update(sharding=...)`).  The
optimizer state is keyed by the JAX parameter tree's leaves
(`repro_torch.models.transformer.param_leaves`): each state tensor has the
JAX leaf's shape (on a sharded state, its block), stacked over the groups,
so that Adafactor factors a stacked leaf as the JAX package does (a
per-group [d] norm scale is a [G, d] matrix there, with a [G] row and a [d]
column statistic) and a checkpoint's leaves are the JAX `TrainState`'s.

The updates run in the JAX package's order of operations, in f32, and write
the results back into the parameters and the state in place, cast to their
dtypes (the JAX functions return new trees).  The learning rate and the bias
corrections are f32 tensors computed from the step, as JAX computes them.
`torch.optim.AdamW` is another function (it decays the weights before the
step, and keeps its moments in the parameters' dtype), so it is not used.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.transformer import param_leaves
from repro_torch.parallel import fsdp


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # bfloat16 halves optimizer memory
    warmup_steps: int = 100


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to cfg.lr over cfg.warmup_steps, as an f32 tensor."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _sum_squares(grads: dict, names_of: dict):
    """The f32 sum of squares of the gradients, leaf by leaf in the JAX
    tree's order (None for no leaf)."""
    total = None
    for names in names_of.values():
        s = sum(torch.sum(torch.square(grads[n].float())) for n in names)
        total = s if total is None else total + s
    return total


def _global_norm(grads: dict, sharding=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, summed leaf by
    leaf in the JAX tree's order.  With a `sharding`
    (`repro_torch.parallel.fsdp.Sharding`) the squares of the leaves cut
    along either axis are summed over the ranks, each block once (the
    blocks the rank `owns`), and the whole leaves counted once."""
    leaves = param_leaves(grads)
    if sharding is None:
        return torch.sqrt(_sum_squares(grads, leaves))
    cut = {k: ns for k, ns in leaves.items()
           if sharding.split(ns[0]) or sharding.model_split(ns[0])}
    whole = _sum_squares(grads, {k: ns for k, ns in leaves.items() if k not in cut})
    mine = _sum_squares(grads, {k: ns for k, ns in cut.items() if sharding.owns(ns[0])})
    if mine is None:  # no block of this rank's counts: a zero of the sums' kind
        mine = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    total = sharding.psum(mine)
    return torch.sqrt(total if whole is None else total + whole)


def clip_by_global_norm(grads: dict, max_norm: float,
                        sharding=None) -> tuple[dict, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), each in its dtype; norm).
    `sharding`: the gradients are a sharded state's blocks (`_global_norm`)."""
    norm = _global_norm(grads, sharding)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm


def _stacked_shape(params: dict, names: list[str]) -> tuple[int, ...]:
    """The JAX leaf's shape: a stacked leaf has the groups in front."""
    shape = tuple(params[names[0]].shape)
    return (len(names), *shape) if names[0].startswith("groups.") else shape


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """Zeroed state in cfg.moment_dtype: AdamW {"m", "v"} in each leaf's
    shape; Adafactor {"vr", "vc"} with the JAX package's factored shapes
    (for a leaf of 2 or more axes, vr drops the last axis and vc the one
    before it; else vr is the leaf's shape and vc a scalar)."""
    mdt = getattr(torch, cfg.moment_dtype)
    leaves = param_leaves(params)
    dev = {key: params[names[0]].device for key, names in leaves.items()}
    shapes = {key: _stacked_shape(params, names) for key, names in leaves.items()}

    def zeros(key, shape):
        return torch.zeros(shape, dtype=mdt, device=dev[key])

    if cfg.kind == "adamw":
        return {"m": {k: zeros(k, s) for k, s in shapes.items()},
                "v": {k: zeros(k, s) for k, s in shapes.items()}}
    if cfg.kind == "adafactor":
        return {"vr": {k: zeros(k, s[:-1] if len(s) >= 2 else s) for k, s in shapes.items()},
                "vc": {k: zeros(k, s[:-2] + s[-1:] if len(s) >= 2 else ()) for k, s in
                       shapes.items()}}
    raise ValueError(cfg.kind)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, step: torch.Tensor,
                 cfg: OptConfig, sharding=None) -> tuple[dict, dict]:
    """One AdamW step with the weight decay inside it:
    p - lr (m^ / (sqrt(v^) + eps) + wd p).  Updates `params` and `opt_state`
    in place and returns them.  Elementwise, so each group's parameter is
    updated against its slice of the stacked moments, and a large leaf in
    flat slices of ADAMW_SLICE elements (the same arithmetic per element;
    the f32 temporaries are a slice's, not the leaf's).  A sharded state's
    blocks need nothing more: `sharding` is taken, as `adafactor_update`
    takes it, and not read."""
    lr = schedule(cfg, step)
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for key, names in param_leaves(params).items():
        M, V = opt_state["m"][key], opt_state["v"][key]
        stacked = names[0].startswith("groups.")
        for g_idx, name in enumerate(names):
            m, v = (M[g_idx], V[g_idx]) if stacked else (M, V)
            for p, g, m, v in _slices(params[name], grads[name], m, v):
                _adamw_slice(p, g, m, v, lr, bc1, bc2, cfg)
    return params, opt_state


ADAMW_SLICE = 1 << 26  # elements: 256 MB of f32 a temporary


def _slices(*tensors: torch.Tensor):
    """The tensors (of one shape) in matching flat slices of ADAMW_SLICE
    elements where all are contiguous and larger than that, else whole."""
    n = tensors[0].numel()
    if n <= ADAMW_SLICE or not all(x.is_contiguous() for x in tensors):
        yield tensors
        return
    for i in range(0, n, ADAMW_SLICE):
        yield tuple(x.view(-1)[i:i + ADAMW_SLICE] for x in tensors)


def _adamw_slice(p, g, m, v, lr, bc1, bc2, cfg) -> None:
    g32 = g.float()
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
    step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    p32 = p.float()
    p32 = p32 - lr * (step_ + cfg.weight_decay * p32)
    p.copy_(p32.to(p.dtype))
    m.copy_(m32.to(m.dtype))
    v.copy_(v32.to(v.dtype))


def _stack(named: dict, names: list[str]) -> torch.Tensor:
    """The JAX leaf held by parameters `names`: a stacked leaf stacked."""
    return torch.stack([named[n] for n in names]) if names[0].startswith("groups.") \
        else named[names[0]]


def _leaf_shape(params: dict, names: list[str], sharding=None) -> tuple:
    """The whole JAX leaf's shape (a stacked leaf's groups in front) of the
    rank's blocks `params`."""
    if sharding is None:
        return _stacked_shape(params, names)
    shape = sharding.layout[names[0]].shape
    return (len(names), *shape) if names[0].startswith("groups.") else shape


def _cut_axis(sharding, names: list[str], dim: int) -> str | None:
    """The mesh axis that cuts dimension `dim` of the (stacked) leaf held by
    parameters `names`, or None where it is whole."""
    if sharding is None:
        return None
    shard, lead = sharding.layout[names[0]], int(names[0].startswith("groups."))
    for axis, at in (("data", shard.dim), ("model", shard.mdim)):
        if at is not None and at + lead == dim:
            return axis
    return None


def _psum(sharding, sums: list[tuple[str, torch.Tensor]]) -> None:
    """Each (axis, f32 tensor) of `sums` summed over its axis's ranks, in
    place: one all-reduce of a flat buffer an axis that has one, "data"
    then "model"."""
    if not sums:
        return
    for axis, group, ranks in (("data", sharding.data_group, sharding.parts),
                               ("model", sharding.model_group, sharding.model_parts)):
        mine = [t for ax, t in sums if ax == axis]
        if not mine:
            continue
        flat = torch.cat([t.reshape(-1) for t in mine])
        fsdp.all_reduce(flat, group, ranks, axis=axis)
        off = 0
        for t in mine:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def adafactor_update(params: dict, grads: dict, opt_state: dict, step: torch.Tensor,
                     cfg: OptConfig, sharding=None) -> tuple[dict, dict]:
    """One Adafactor step (no first moment), on each leaf stacked as the JAX
    tree holds it.  Updates `params` and `opt_state` in place and returns
    them.

    With a `sharding` (`repro_torch.parallel.fsdp.Sharding`) the leaves are
    the rank's blocks and `vr`, `vc` the blocks of the factored shapes
    (`fsdp.opt_leaf_shard`).  Of a leaf of 2 or more dimensions with whole
    extents r (dimension -2) and c (-1), a mean over a dimension that an
    axis cuts is the block's sum, summed over that axis's ranks, over the
    whole extent: `vr`'s new term where c is cut and `vc`'s where r is (the
    first round), then the normalizer `vr.mean(-1)` where r is (the second:
    it reads the new `vr`).  Each round is one all-reduce of a flat f32
    buffer an axis that needs one, "data" then "model" (`_psum`).  A mean
    over a whole dimension, a cut leading dimension and every other
    operation are the one-device code's, so a block of `vr` or `vc` whole
    along an axis is bit-alike across that axis's ranks."""
    lr = schedule(cfg, step)
    d = 1e-30
    leaves = param_leaves(params)

    # round 1: g^2 + d's row and column means (sums where an axis cuts)
    means, sums = {}, []
    for key, names in leaves.items():
        g32 = _stack(grads, names).float()
        if g32.ndim < 2:
            continue
        g2 = g32 * g32
        g2.add_(d)
        means[key] = []
        for dim in (g32.ndim - 1, g32.ndim - 2):
            axis = _cut_axis(sharding, names, dim)
            t = g2.mean(dim) if axis is None else g2.sum(dim)
            if axis is not None:
                sums.append((axis, t))
            means[key].append((t, axis))
        del g32, g2
    _psum(sharding, sums)

    # round 2: the new statistics; the normalizer (its sums where r is cut)
    stats, sums = {}, []
    for key, names in leaves.items():
        vr, vc = opt_state["vr"][key], opt_state["vc"][key]
        if key not in means:
            g32 = _stack(grads, names).float()
            stats[key] = (cfg.b2 * vr.float() + (1 - cfg.b2) * (g32 * g32 + d), vc.float(), None)
            continue
        (row, c_axis), (col, r_axis) = means.pop(key)
        r, c = _leaf_shape(params, names, sharding)[-2:]
        vr32 = cfg.b2 * vr.float() + (1 - cfg.b2) * (row if c_axis is None else row / c)
        vc32 = cfg.b2 * vc.float() + (1 - cfg.b2) * (col if r_axis is None else col / r)
        norm = vr32.mean(-1) if r_axis is None else vr32.sum(-1)
        if r_axis is not None:
            sums.append((r_axis, norm))
        stats[key] = (vr32, vc32, (norm, r_axis is None, r))
    _psum(sharding, sums)

    # the update p - lr (g / max(denom, eps) + wd p), each operation in
    # place on a tensor of the update's own where one is free (not on the
    # caller's gradient), so that a leaf holds three leaf-sized tensors at
    # most: the experts' leaves are GBs
    for key, names in leaves.items():
        vr32, vc32, normalizer = stats.pop(key)
        p = _stack(params, names)
        g32 = _stack(grads, names).float()
        if normalizer is None:
            denom = torch.sqrt(vr32)
        else:
            norm, is_mean, r = normalizer
            mean = norm if is_mean else norm / r
            denom = vr32[..., :, None] * vc32[..., None, :]
            denom.div_(torch.clamp(mean[..., None, None], min=d)).sqrt_()
        denom.clamp_(min=cfg.eps)
        u = g32 / denom if g32 is grads[names[0]] else g32.div_(denom)
        del g32, denom
        p32 = p.float()
        u.add_(cfg.weight_decay * p32).mul_(lr)
        p32 = p32 - u
        del u
        new = p32.to(p.dtype)
        for g_idx, name in enumerate(names):
            params[name].copy_(new[g_idx] if names[0].startswith("groups.") else new)
        opt_state["vr"][key].copy_(vr32.to(opt_state["vr"][key].dtype))
        opt_state["vc"][key].copy_(vc32.to(opt_state["vc"][key].dtype))
    return params, opt_state
