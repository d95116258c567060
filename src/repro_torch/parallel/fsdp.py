"""The training state sharded over the "data" axis, as the JAX rule
fsdp -> "data" shards it ("weight shards gathered at use", ZeRO-3 style).

A `Sharding` is one rank's place: its mesh, its rank, the process group of
its data axis (None on the meta device) and the part of every parameter it
holds (`repro_torch.parallel.sharding.leaf_shard`).  `shard_model` cuts a
model's parameters to the rank's slices (through `p.data`: the Parameter
objects stay) and attaches the sharding as `model.fsdp`; the model then
gathers each group's whole weights where the group runs, inside the region
that activation checkpointing recomputes, and the embedding and the head
where they are used (`repro_torch.models.transformer`).
`shard_train_state` also cuts the AdamW moments.

The collectives, each a plain `torch.distributed` call that gloo (CPU and
CUDA tensors) and NCCL both take:
- `Sharding.gather`: a `torch.autograd.Function` whose forward all-gathers
  the rank's slices (one `all_gather_into_tensor` of a flat buffer a call
  and dtype) and whose backward reduce-scatters, summing, the whole
  leaves' gradients back onto the slices (one `reduce_scatter_tensor`).
  Both take dimension 0; a slice along another dimension is moved to the
  front first (a copy) and the gathered leaf moved back (another).
- `all_reduce`: the whole leaves' f32 gradients and the loss, the global
  norm's squares (`Sharding.psum`), the compression's maxima
  (`Sharding.pmax`).

Without a process group the calls take meta tensors only (the dry run,
`repro_torch.launch.dryrun`): they run every local copy of the real call
and return empty tensors of the results' shapes.  Every call, real or
meta, adds the bytes a rank puts on the wire to `WIRE`, in the ring model:
(R - 1) / R of the whole payload for an all-gather (its output) and a
reduce-scatter (its input), 2 (R - 1) / R for an all-reduce, over the
call's R ranks.  A call over one rank moves nothing and is not made.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from math import prod

import torch
import torch.distributed as dist

from repro_torch.models.transformer import param_leaves
from repro_torch.parallel.sharding import Mesh, Shard, ShardingRules, leaf_shard

KINDS = ("all-gather", "reduce-scatter", "all-reduce")


class WireCount:
    """What the collectives of this module did since `reset`: bytes a rank
    put on the wire, calls and host seconds by kind, and the bytes of the
    largest set of leaves one `Sharding.gather` made whole.  With `sync`
    on, each call waits for the card before and after itself, so that its
    seconds are its own (a measurement's setting: it costs the overlap)."""

    def __init__(self):
        self.sync = False
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0.0)
        self.calls = dict.fromkeys(KINDS, 0)
        self.seconds = dict.fromkeys(KINDS, 0.0)
        self.largest_gather = 0

    @property
    def total(self) -> float:
        return sum(self.bytes.values())

    @contextlib.contextmanager
    def call(self, kind: str, nbytes: int, ranks: int, device: torch.device):
        self.bytes[kind] += (2 if kind == "all-reduce" else 1) * (ranks - 1) / ranks * nbytes
        self.calls[kind] += 1
        synced = self.sync and device.type == "cuda"
        if synced:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if synced:
            torch.cuda.synchronize(device)
        self.seconds[kind] += time.perf_counter() - t0


WIRE = WireCount()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, nbytes: int, ranks: int, group, t: torch.Tensor, run) -> None:
    if ranks == 1:
        return
    with WIRE.call(kind, nbytes, ranks, t.device):
        if t.device.type == "meta":
            return
        if group is None:
            raise ValueError(f"a {kind} over {ranks} ranks needs a process group; without "
                             f"one it takes meta tensors only, not {t.device}")
        run()


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group, ranks: int) -> None:
    """`out` [ranks * n] <- every rank's flat `x` [n], in rank order."""
    _collective("all-gather", _nbytes(out), ranks, group, x,
                lambda: dist.all_gather_into_tensor(out, x, group=group))


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group, ranks: int) -> None:
    """`out` [n] <- the sum over the ranks of their flat `x` [ranks * n]'s
    slice [rank * n, (rank + 1) * n)."""
    _collective("reduce-scatter", _nbytes(x), ranks, group, x,
                lambda: dist.reduce_scatter_tensor(out, x, group=group))


def all_reduce(x: torch.Tensor, group, ranks: int, op=dist.ReduceOp.SUM) -> None:
    """x <- its sum (or `op`) over the ranks, in place."""
    _collective("all-reduce", _nbytes(x), ranks, group, x,
                lambda: dist.all_reduce(x, op=op, group=group))


class _Gather(torch.autograd.Function):
    """Forward: the whole leaves of the rank's slices (an all-gather).
    Backward: the slices' gradients, the whole leaves' gradients summed
    over the ranks (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, sharding, shards, *slices):
        ctx.sharding, ctx.shards = sharding, shards
        return tuple(sharding._all_gather(slices, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.sharding._reduce_scatter(grads, ctx.shards))


@dataclass(eq=False)
class Sharding:
    """One rank's place in the sharded state (module docstring): `layout`
    maps every parameter name to its `Shard`.  `parts` ranks along "data"
    split a leaf; `copies` ranks (along "model" and "pod") hold the same
    slices."""
    layout: dict
    mesh: Mesh
    rank: int
    group: object = None

    @property
    def parts(self) -> int:
        return self.mesh.shape.get("data", 1)

    @property
    def copies(self) -> int:
        return self.mesh.size // self.parts

    def split(self, name: str) -> bool:
        """Whether parameter `name` is sliced (else whole on every rank)."""
        return self.layout[name].dim is not None

    # -- the collectives on slices ---------------------------------------

    def _all_gather(self, slices, shards, lead: int = 0) -> list[torch.Tensor]:
        R = self.parts
        flat = torch.cat([s.movedim(sh.dim + lead, 0).reshape(-1)
                          for s, sh in zip(slices, shards)])
        out = flat.new_empty(R * flat.numel())
        all_gather_into(out, flat, self.group, R)
        out = out.view(R, -1)
        whole, off = [], 0
        for s, sh in zip(slices, shards):
            d, n = sh.dim + lead, s.numel()
            shape = list(s.shape)
            shape[d] *= R
            # [R, slice moved to the front] -> the ranks' slices in place along
            # d, in one copy
            ranks = out[:, off:off + n].view(R, *s.movedim(d, 0).shape)
            whole.append(ranks.movedim((0, 1), (d, d + 1)).reshape(shape))
            off += n
        return whole

    def _reduce_scatter(self, grads, shards, lead: int = 0) -> list[torch.Tensor]:
        R = self.parts
        big = torch.cat([g.movedim(sh.dim + lead, 0).reshape(R, -1)
                         for g, sh in zip(grads, shards)], dim=1)
        out = big.new_empty(big.shape[1])
        reduce_scatter_into(out, big.reshape(-1), self.group, R)
        parts, off = [], 0
        for g, sh in zip(grads, shards):
            d = sh.dim + lead
            front = g.movedim(d, 0).shape
            front = (front[0] // R, *front[1:])
            n = prod(front)
            parts.append(out[off:off + n].view(front).movedim(0, d).contiguous())
            off += n
        return parts

    def gather(self, named: dict, prefix: str = "") -> dict:
        """{name: whole leaf} of the sliced tensors of `named` (parameter
        `prefix + name`'s slices), through `_Gather`: one call a dtype, the
        gradients reduce-scattered in the backward."""
        split = [(n, t) for n, t in named.items() if self.split(prefix + n)]
        by_dtype: dict = {}
        for n, t in split:
            by_dtype.setdefault(t.dtype, []).append((n, t))
        out = {}
        for items in by_dtype.values():
            shards = [self.layout[prefix + n] for n, _ in items]
            out.update(zip([n for n, _ in items],
                           _Gather.apply(self, shards, *[t for _, t in items])))
        WIRE.largest_gather = max(WIRE.largest_gather, sum(_nbytes(t) for t in out.values()))
        return out

    @torch.no_grad()
    def whole(self, t: torch.Tensor, shard: Shard, lead: int = 0) -> torch.Tensor:
        """The whole leaf of the rank's slice `t` (`lead` more leading
        dimensions than the parameter: 1 for a moment stacked over the
        groups), on every rank, outside autograd; `t` itself where whole."""
        return t if shard.dim is None else self._all_gather([t], [shard], lead)[0]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data axis' ranks (a new tensor)."""
        y = x.clone()
        all_reduce(y, self.group, self.parts)
        return y

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of x over the data axis' ranks (a new tensor)."""
        y = x.clone()
        all_reduce(y, self.group, self.parts, dist.ReduceOp.MAX)
        return y

    # -- drawing -----------------------------------------------------------

    @contextlib.contextmanager
    def drawn_whole(self, named: dict, prefix: str = ""):
        """While the block runs, the sliced parameters of `named` (parameter
        `prefix + name`) are whole and uninitialized; after it each keeps its
        slice of what the block wrote.  So a model draws the one-card values
        and holds the rank's part of them, one module whole at a time."""
        split = [(p, self.layout[prefix + n]) for n, p in named.items()
                 if self.split(prefix + n)]
        for p, sh in split:
            p.data = p.data.new_empty(sh.shape)
        try:
            yield
        finally:
            for p, sh in split:
                p.data = sh.cut(p.data).clone(memory_format=torch.contiguous_format)


def _placement(group=None, place=None) -> tuple[Mesh, int]:
    """(mesh, rank): the ("data", "model") = (R, 1) mesh of `group`'s R ranks
    and its rank, or `place` = (mesh, rank) without a group."""
    if (group is None) == (place is None):
        raise ValueError("pass a process group or a place (mesh, rank), one of them")
    if group is not None:
        return Mesh((dist.get_world_size(group), 1), ("data", "model")), dist.get_rank(group)
    return place


def shard_model(model, rules: ShardingRules, *, group=None, place=None) -> Sharding | None:
    """Cut `model`'s parameters to the slices that the rank (of `group`, or
    `place` = (mesh, rank) on the meta device) holds under `rules`, and set
    `model.fsdp` to its `Sharding`, which it returns.  Where the rules split
    no leaf (`make_rules(fsdp=False)`, a data axis of one rank) the model is
    left whole and replicated and None is returned.  A model sharded before
    keeps its sharding if the layout is the same, else ValueError."""
    mesh, rank = _placement(group, place)
    if group is not None and mesh.size != dist.get_world_size(group):
        raise ValueError(f"a process group of {dist.get_world_size(group)} ranks on a mesh "
                         f"of {mesh.size}")
    old = getattr(model, "fsdp", None)
    specs = model.param_specs()
    layout = {n: leaf_shard(n, old.layout[n].shape if old else tuple(p.shape), specs, mesh,
                            rules, rank)
              for n, p in model.named_parameters()}
    if old is not None:
        if layout != old.layout or old.group is not group:
            raise ValueError("the model is sharded already, on another layout or group")
        return old
    if not any(s.dim is not None for s in layout.values()):
        return None
    sharding = Sharding(layout, mesh, rank, group)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if sharding.split(n):
                p.data = layout[n].cut(p.data).clone(memory_format=torch.contiguous_format)
    model.fsdp = sharding
    return sharding


def opt_leaf_shard(sharding: Sharding, names: list[str]) -> tuple[Shard, int]:
    """(the Shard, its lead) of the optimizer-state leaf of the JAX tree
    leaf held by parameters `names` (`param_leaves`): a moment of a
    per-group parameter is stacked over the groups, one leading dimension
    more."""
    return sharding.layout[names[0]], int(names[0].startswith("groups."))


def shard_train_state(state, rules: ShardingRules, *, group=None, place=None):
    """`shard_model` of the state's model, and its AdamW moments cut to the
    same slices (each leaf stacked over the groups as the JAX tree holds
    it).  In place; returns the state.  Adafactor's factored statistics
    span the sliced dimensions: its state raises ValueError."""
    sharding = shard_model(state.params, rules, group=group, place=place)
    if sharding is None:
        return state
    check_optimizer("adamw" if "m" in state.opt else "adafactor")
    leaves = param_leaves(dict(state.params.named_parameters()))
    for part in state.opt.values():
        for key, t in part.items():
            shard, lead = opt_leaf_shard(sharding, leaves[key])
            # a whole moment is cut; one drawn on the slices already is not
            if shard.dim is not None and tuple(t.shape[lead:]) == shard.shape:
                part[key] = shard.cut(t, lead).clone(memory_format=torch.contiguous_format)
    return state


def check_optimizer(kind: str) -> None:
    """A sharded state steps with AdamW only: Adafactor's factored
    statistics span the sliced dimensions, so it raises ValueError."""
    if kind != "adamw":
        raise ValueError(f"{kind} on a sharded state is not ported: its factored statistics "
                         f"span the sliced dimensions (ROADMAP §1, slice 27); use AdamW or "
                         f"make_rules(fsdp=False)")


def whole_named(sharding: Sharding | None, named: dict) -> dict:
    """{name: whole tensor} of tensors keyed by parameter name (parameters
    or gradients, the rank's slices), gathered leaf by leaf on every rank."""
    if sharding is None:
        return dict(named)
    return {n: sharding.whole(t, sharding.layout[n]) for n, t in named.items()}
