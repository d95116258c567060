"""Train step builder: gradient accumulation, optional gradient quantization
(compression), clipping and the optimizer update, with the loss and the
gradient norm as metrics, as the JAX package's
`repro/training/train_step.py`.

The state's parameters are the model's own (`TrainState.params` is the
model), updated in place by each step; the optimizer state is keyed by the
JAX tree's leaves (`repro_torch.training.optimizer`).

Data parallelism (`group`: a `torch.distributed` process group of R ranks)
computes the global program's math, the one-device step on the whole
global batch, as the JAX launcher's ("data", "model") = (R, 1) mesh does
under GSPMD:
- every rank is handed the same global batch; micro-batch i holds the rows
  it holds in a one-device step, and a rank takes its share of them
  (`repro_torch.parallel.rank_rows`: contiguous rows where R divides the
  micro-batch, else every row, as GSPMD replicates);
- a rank's loss divides its rows' sum by the whole micro-batch's mask count
  (read from the global batch every rank holds), so the ranks' losses and
  gradients sum to the one-device ones (a replicated micro-batch divides by
  R times it);
- the f32 gradients (and the loss) are summed over the group in a few flat
  buckets of at most BUCKET_BYTES each, one all-reduce a bucket, once a
  step after the micro-batches;
- then compression, clipping and the update run as on one device, on the
  same gradients on every rank.
An MoE layer dispatches the groups of the whole micro-batch as one device
does (`moe_forward(split=)`, through `loss_fn(data_split=)`, the rank's
`moe.data_split` of each micro-batch): the G / R groups its rows make where
R divides G, or, where G divides R, its share of a group whose rows lie on
a span of R / G ranks, dispatched with the whole group's choices, gathered
over the span.  A config whose groups the ranks cannot split (neither
divides the other) raises ValueError when the step is built (or, for a
batch whose token count halves G to such a split, at its first step:
`check_dispatch_split`, once a call of `accumulate_grads`).

The state stays whole on every rank unless it is sharded:
`init_train_state(rules=..., group=..., mesh=...)` gives each rank its
blocks of every parameter and of the optimizer state (AdamW's moments;
Adafactor's `vr` and `vc` on the factored shapes) by the JAX rules on a
("data", "model") mesh, (R, 1) by default: fsdp -> "data"
(`repro_torch.parallel.fsdp`) and tp, kv, ep -> "model"
(`repro_torch.parallel.tensor`; ep: the MoE experts, E / M a rank).  The step on a sharded state is the same
function of the same rows:
- the ranks along "data" take their share of the rows as above; the ranks
  along "model" take the same rows and compute one loss together (the
  layers run on their blocks, tensor-parallel), so only the ranks along
  "data" split the loss;
- the forward gathers each group's weights along "data" where the group
  runs, and the backward reduce-scatters their gradients onto the rank's
  blocks, in the parameters' dtype, once a micro-batch; a block's gradient
  stays on the block;
- the leaves whole along "data", and the loss, are summed over "data" in
  f32 buckets as above (over "pod" as well on the dry run's multi-pod
  mesh, whose ranks along "pod" also sum the blocks' gradients); then the
  leaves that a model region reads whole along "model"
  (`tensor.summed_over_model`: wk and wv where kv was dropped, q_norm and
  k_norm) are summed over "model"; every other leaf whole along "model" has
  its whole gradient on every rank of the row (the MoE router among them);
  a block along "model" (the experts' too) is never summed over "model";
- the global norm sums the squares of each block once over both axes
  (`Sharding.owns`; one scalar all-reduce an axis) and of each whole leaf
  once; compression takes each leaf's max |g| as a MAX over its blocks
  (one all-reduce of every leaf's max an axis), so a stacked leaf's groups
  still share one scale;
- AdamW runs per element on the blocks, its arithmetic unchanged;
  Adafactor sums its row and column means over the axis that cuts the
  leaf (`optimizer.adafactor_update(sharding=...)`: at most two rounds of
  one all-reduce an axis).
`make_rules(fsdp=False)` on a (R, 1) mesh splits no leaf and leaves the
state whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.models.layers.moe import DataSplit, check_dispatch_split, data_split
from repro_torch.models.transformer import param_leaves
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.sharding import Mesh, make_rules, rank_rows
from repro_torch.training.optimizer import (
    OptConfig,
    adafactor_update,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
)


@dataclass
class TrainState:
    params: torch.nn.Module  # the model: its parameters are the state's
    opt: dict
    step: torch.Tensor  # 0-d int32 on the model's device


def init_train_state(model, gen: torch.Generator, opt_cfg: OptConfig, *, rules=None,
                     group=None, place=None, mesh=None) -> TrainState:
    """Draw the model's parameters from `gen` (a generator on the model's
    device), switch it to training (train mode, every parameter requiring
    grad) and zero the optimizer state and the step.

    With `rules` and a `group` (on `mesh`, a ("data", "model") mesh of the
    group's ranks, (R, 1) by default; or `place` = (mesh, rank) on the meta
    device) the state is sharded by the rules (`fsdp.shard_model`): the rank
    draws the one-card values, a module whole at a time, and keeps its
    blocks; the optimizer state is zeroed on the blocks (AdamW's moments on
    the parameters' blocks, Adafactor's `vr` and `vc` on the factored
    shapes' blocks, `fsdp.opt_leaf_shard`)."""
    if rules is not None:
        fsdp.shard_model(model, rules, group=group, place=place, mesh=mesh)
    model.init_params(gen)
    model.train().requires_grad_(True)
    return TrainState(params=model, opt=init_opt_state(dict(model.named_parameters()), opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def _quantize_dequantize(g: torch.Tensor, bits: int, amax=None) -> torch.Tensor:
    """Symmetric per-tensor fake quantization to `bits` (the gradient
    compression model): round(g / s) s with s = max|g| / (2^(bits-1) - 1);
    `amax` replaces max|g| (a max over more than `g`)."""
    g32 = g.float()
    if amax is None:
        amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax, min=1e-12) / (2 ** (bits - 1) - 1)
    return (torch.round(g32 / scale) * scale).to(g.dtype)


def _compress(grads: dict, bits: int, sharding=None) -> dict:
    """`_quantize_dequantize` of each leaf of the JAX tree: a stacked leaf's
    groups share one scale, as the JAX package quantizes the stacked leaf.
    With a `sharding` each leaf's max |g| is the MAX over its blocks."""
    leaves = param_leaves(grads)
    amax = torch.stack([torch.stack([torch.max(torch.abs(grads[n].float())) for n in names]).max()
                        for names in leaves.values()])
    if sharding is not None:
        amax = sharding.pmax(amax)
    return {n: _quantize_dequantize(grads[n], bits, amax[i])
            for i, names in enumerate(leaves.values()) for n in names}


BUCKET_BYTES = 1 << 30  # the data-parallel gradient all-reduce's bucket


def buckets(numels: list[int], bucket_bytes: int) -> list[list[int]]:
    """The indices of f32 tensors of these sizes in each flat all-reduce
    bucket: in order, a bucket closed before it would pass `bucket_bytes`
    (a tensor larger than that is a bucket of its own)."""
    out, size = [], 0
    for i, n in enumerate(numels):
        if not out or size + 4 * n > bucket_bytes:
            out.append([])
            size = 0
        out[-1].append(i)
        size += 4 * n
    return out


def _all_reduce_sum(tensors: list[torch.Tensor], group, ranks: int | None = None,
                    axis: str = "data") -> None:
    """Sum f32 `tensors` over `group` in place, one all-reduce a bucket.
    Without a group, `ranks` ranks on the meta device (counted, not run:
    `fsdp.WIRE`); `axis` names the mesh axis the ranks lie along."""
    ranks = dist.get_world_size(group) if group is not None else ranks
    if ranks == 1 or not tensors:
        return
    for idx in buckets([t.numel() for t in tensors], BUCKET_BYTES):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        fsdp.all_reduce(flat, group, ranks, axis=axis)
        off = 0
        for i in idx:
            tensors[i].copy_(flat[off:off + tensors[i].numel()].view_as(tensors[i]))
            off += tensors[i].numel()


def _sharding(model, group, place):
    """The model's `Sharding`, checked against the step's group and place
    (a sharded model brings its own)."""
    sharding = getattr(model, "fsdp", None)
    if sharding is not None and (place is not None or group not in (None, sharding.group)):
        raise ValueError("a sharded model steps on its own group and place (model.fsdp)")
    return sharding


def _sum_sharded(sharding, loss: torch.Tensor, grads: dict) -> None:
    """The sums of a sharded step, in place (module docstring): the loss and
    the leaves whole along "data" over the ranks that take different rows
    ("data", and "pod"), the blocks' gradients over "pod", then the leaves
    a model region reads whole over "model"."""
    pod = sharding.mesh.shape.get("pod", 1)
    batch_group = sharding.data_group if pod == 1 else None  # "pod" runs on meta only
    _all_reduce_sum([loss, *(g for n, g in grads.items() if not sharding.split(n))], batch_group,
                    sharding.batch_ranks)
    _all_reduce_sum([g for n, g in grads.items() if sharding.split(n)], None, pod, "pod")
    _all_reduce_sum([grads[n] for n in tensor.summed_over_model(sharding.layout)],
                    sharding.model_group, sharding.model_parts, "model")


def accumulate_grads(model, batch: dict, *, accum: int = 1, remat: bool = True, group=None,
                     place=None):
    """(loss, grads) of `model` on `batch`, as a train step takes them before
    compression: the batch (a dict of tensors, on any device) is split into
    `accum` micro-batches along its first axis, their f32 gradients summed
    and divided by `accum`.  `grads` is keyed by the model's parameter
    names; a parameter the loss does not reach gets a zero gradient, as
    under `jax.grad`.  With `group`, `batch` is the global batch and the
    result is the one-device result on it, the same on every rank (module
    docstring); a gradient comes in its parameter's dtype where accum is 1,
    as on one device.

    `place` = (mesh, rank) runs rank's share of a data-parallel step on a
    `Mesh` without a process group and without the all-reduce: the rank
    takes `rank_rows` of each micro-batch on that mesh, and the ranks that
    hold the same rows (along "model" too: the model is whole) divide the
    loss between them.  The result is the rank's part of the sum, before
    the all-reduce.  With `group` the place is ((R, 1) ("data", "model"),
    the group rank).

    A sharded model (`model.fsdp`) brings its group and place: the ranks
    along "model" compute one loss on the same rows, and only the ranks
    along "data" divide it; the gradient of a sliced leaf is the rank's
    block of the sum, reduce-scattered along "data" in the backward; the
    leaves whole along "data" and the loss are summed over "data", and the
    leaves a model region reads whole are summed over "model" (module
    docstring).  On the meta device (the dry run, no group) those sums are
    counted and not run, so such a gradient is the rank's part."""
    params = dict(model.named_parameters())
    sharding = _sharding(model, group, place)

    def grads_of(mb: dict, denominator=None, split: DataSplit | None = None):
        loss = model.loss_fn(mb, remat=remat, denominator=denominator, data_split=split)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(params.items(), got)}

    if sharding is not None:
        group, place = sharding.group, (sharding.mesh, sharding.rank)
    elif group is not None:
        if place is not None:
            raise ValueError("pass a process group or a place, not both")
        place = (Mesh((dist.get_world_size(group), 1), ("data", "model")), dist.get_rank(group))
    batch = {k: v.to(model.device) for k, v in batch.items()}
    if place is None and accum == 1:
        return grads_of(batch)
    mb_rows = next(iter(batch.values())).shape[0] // accum
    copies, shard, split = 1, slice(None), DataSplit()
    if place is not None:
        mesh, rank = place
        mine = rank_rows(mb_rows, mesh, make_rules(mesh), rank)
        shard = slice(mine.start, mine.stop)
        # the ranks that hold these rows and split their loss
        holders = mesh.size if sharding is None else sharding.batch_ranks
        copies = holders * len(mine) // mb_rows
        # the rank's place among the ranks that share micro-batch i's rows
        split = data_split(model.cfg, mb_rows, batch["labels"].shape[1], mesh, rank, group)
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    grads = None  # the f32 sums, in place from the first micro-batch's gradients
    for i in range(accum):
        mb = {k: v.reshape(accum, mb_rows, *v.shape[1:])[i] for k, v in batch.items()}
        denominator = None
        if place is not None:
            mask = mb.get("loss_mask")
            count = (mask.float().sum() if mask is not None else
                     torch.tensor(float(mb["labels"].numel()), device=model.device))
            denominator = copies * torch.clamp(count, min=1.0)
        mb_loss, mb_grads = grads_of({k: v[shard] for k, v in mb.items()}, denominator, split)
        loss = loss + mb_loss
        if grads is None:
            grads = {n: g.float() for n, g in mb_grads.items()}
        else:
            for n, g in mb_grads.items():
                grads[n].add_(g)
        del mb_grads
    if sharding is not None:
        loss = loss.reshape(1)
        _sum_sharded(sharding, loss, grads)
        loss = loss[0]
    elif group is not None:
        loss = loss.reshape(1)
        _all_reduce_sum([loss, *grads.values()], group)
        loss = loss[0]
    elif place is not None and loss.device.type == "meta":  # a dry run's sum: counted only
        _all_reduce_sum([loss.reshape(1), *grads.values()], None, place[0].size)
    if accum == 1:
        return loss, {n: g.to(params[n].dtype) for n, g in grads.items()}
    return loss / accum, {n: g / accum for n, g in grads.items()}


def make_train_step(model, opt_cfg: OptConfig, *, accum: int = 1,
                    compress_bits: int | None = None, remat: bool = True, group=None,
                    place=None):
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm"}).

    The step takes the loss and the f32 gradient over `accum` micro-batches
    (`accumulate_grads`), quantizes the gradient to `compress_bits` (one
    scale per leaf of the JAX tree), clips it to opt_cfg.grad_clip and
    applies it.  `model` is the model the states hold; each step takes it
    from `state.params`.  With `group` (a process group; every rank builds
    the step and calls it with the same global batch) the step is
    data-parallel (module docstring).  `place` goes to `accumulate_grads`:
    one rank's step on a mesh, without its all-reduce (a dry run's).  A
    sharded state (`init_train_state(rules=...)`) steps on its own group
    and place, read from the model at each step."""
    update = adamw_update if opt_cfg.kind == "adamw" else adafactor_update
    if group is not None:  # the ranks along "model" of a sharded model share the rows
        sharding = getattr(model, "fsdp", None)
        check_dispatch_split(model.cfg, dist.get_world_size(group) if sharding is None
                             else sharding.batch_ranks)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        sharding = _sharding(model, group, place)
        loss, grads = accumulate_grads(model, batch, accum=accum, remat=remat, group=group,
                                       place=place)
        if compress_bits:
            grads = _compress(grads, compress_bits, sharding)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip, sharding)
        update(dict(model.named_parameters()), grads, state.opt, state.step, opt_cfg,
               sharding=sharding)
        return (TrainState(params=model, opt=state.opt, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step
