"""The training state sharded over the ("data", "model") mesh by the JAX
rules: fsdp -> "data" ("weight shards gathered at use", ZeRO-3 style) and
tp, kv, ep -> "model" (Megatron tensor parallelism and the MoE experts
split across the ranks of a row, the block used where it lies:
`repro_torch.parallel.tensor`).

A `Sharding` is one rank's place: its mesh, its rank, its process groups
(the whole mesh's, its data axis's and its model axis's; None on the meta
device) and the block of every parameter it holds
(`repro_torch.parallel.sharding.leaf_shard`).  `shard_model` cuts a
model's parameters to the rank's blocks (through `p.data`: the Parameter
objects stay) and attaches the sharding as `model.fsdp`; the model then
gathers each group's weights along "data" where the group runs, inside
the region that activation checkpointing recomputes, and the embedding and
the head where they are used (`repro_torch.models.transformer`): a block
stays sliced along "model", and the layers run on it.  The serving passes
(`prefill`, `decode_step`) gather the same blocks once a call, with grad
off and no graph.
`shard_train_state` also cuts the optimizer state: AdamW's moments to
their parameters' blocks, and Adafactor's factored statistics `vr` and
`vc` to the blocks of the JAX rules applied to the factored shapes (the
leaf's spec with the dropped dimension's entry removed, `opt_leaf_shard`);
`repro_torch.training.optimizer.adafactor_update` sums their means over
the axis that cuts the leaf.

The collectives, each a plain `torch.distributed` call that gloo (CPU and
CUDA tensors) and NCCL both take:
- `Sharding.gather`: a `torch.autograd.Function` a leaf, whose forward
  all-gathers the rank's block along "data" (one `all_gather_into_tensor`
  over the data axis's group) and whose backward reduce-scatters, summing,
  the leaf's gradient back onto the block (one `reduce_scatter_tensor`;
  one a piece for a gradient over `SCATTER_PIECE_BYTES` sliced along a
  later dimension) once it is whole.  Both take dimension 0; a slice
  along another dimension is moved to the front first (a copy) and the
  gathered leaf moved back (another).
- `all_reduce`: the f32 gradients of the leaves whole along "data" and the
  loss, the global norm's squares (`Sharding.psum`), the compression's
  maxima (`Sharding.pmax`), and the model axis's sums
  (`repro_torch.parallel.tensor`).
- `Sharding.whole`: a leaf made whole along both axes, outside autograd
  (checkpoints, tests).

- `span_group`: the ranks of a data column whose rows share one MoE
  dispatch group (a span of consecutive batch shards,
  `repro_torch.models.layers.moe`), whose routing choices are all-gathered
  over it (site "moe-choices").

Without a process group the calls take meta tensors only (the dry run,
`repro_torch.launch.dryrun`): they run every local copy of the real call
and return empty tensors of the results' shapes.  Every call, real or
meta, adds the bytes a rank puts on the wire to `WIRE`, by kind and by
mesh axis, in the ring model: (R - 1) / R of the whole payload for an
all-gather (its output) and a reduce-scatter (its input), 2 (R - 1) / R
for an all-reduce, over the call's R ranks; a call made inside
`WIRE.at(site)` also adds them to that site's tally.  A call over one
rank moves nothing and is not made.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from math import prod

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (
    Mesh,
    Shard,
    ShardingRules,
    leaf_shard,
    make_rules,
    rank_rows,
)

KINDS = ("all-gather", "reduce-scatter", "all-reduce")
AXES = ("data", "model", "pod")


class WireCount:
    """What the collectives of this module did since `reset`, by mesh axis
    and kind (`axes[axis]["bytes" | "calls" | "seconds"][kind]`): bytes a
    rank put on the wire, calls and host seconds; `bytes`, `calls` and
    `seconds` sum them over the axes by kind; `sites[site]` holds the same
    three of the calls made inside `at(site)` (counted in their axis and
    kind too).  Also the bytes of the largest set of leaves one `Sharding.gather`
    made whole.  With `sync`
    on, each call waits for the card before and after itself, so that its
    seconds are its own (a measurement's setting: it costs the overlap)."""

    def __init__(self):
        self.sync = False
        self.site = None
        self.reset()

    def reset(self) -> None:
        self.axes = {a: {"bytes": dict.fromkeys(KINDS, 0.0), "calls": dict.fromkeys(KINDS, 0),
                         "seconds": dict.fromkeys(KINDS, 0.0)} for a in AXES}
        self.sites: dict = {}
        self.largest_gather = 0

    def _summed(self, field: str) -> dict:
        return {k: sum(v[field][k] for v in self.axes.values()) for k in KINDS}

    @property
    def bytes(self) -> dict:
        return self._summed("bytes")

    @property
    def calls(self) -> dict:
        return self._summed("calls")

    @property
    def seconds(self) -> dict:
        return self._summed("seconds")

    @property
    def total(self) -> float:
        return sum(self.bytes.values())

    def by_axis(self, field: str = "bytes") -> dict:
        """{axis: {kind: `field`}} of the axes that made a call."""
        return {a: dict(v[field]) for a, v in self.axes.items() if any(v["calls"].values())}

    def by_site(self) -> dict:
        """{site: {"bytes", "calls", "seconds"}} of the named sites that made
        a call."""
        return {k: dict(v) for k, v in self.sites.items()}

    @contextlib.contextmanager
    def at(self, site: str):
        """The calls made in the block also count at `site`."""
        outer, self.site = self.site, site
        try:
            yield
        finally:
            self.site = outer

    @contextlib.contextmanager
    def call(self, kind: str, nbytes: int, ranks: int, device: torch.device,
             axis: str = "data"):
        mine = self.axes[axis]
        wire = (2 if kind == "all-reduce" else 1) * (ranks - 1) / ranks * nbytes
        mine["bytes"][kind] += wire
        mine["calls"][kind] += 1
        tally = (None if self.site is None else
                 self.sites.setdefault(self.site, {"bytes": 0.0, "calls": 0, "seconds": 0.0}))
        if tally is not None:
            tally["bytes"] += wire
            tally["calls"] += 1
        synced = self.sync and device.type == "cuda"
        if synced:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if synced:
            torch.cuda.synchronize(device)
        mine["seconds"][kind] += time.perf_counter() - t0
        if tally is not None:
            tally["seconds"] += time.perf_counter() - t0


WIRE = WireCount()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, nbytes: int, ranks: int, group, t: torch.Tensor, run,
                axis: str = "data") -> None:
    if ranks == 1:
        return
    with WIRE.call(kind, nbytes, ranks, t.device, axis):
        if t.device.type == "meta":
            return
        if group is None:
            raise ValueError(f"a {kind} over {ranks} ranks needs a process group; without "
                             f"one it takes meta tensors only, not {t.device}")
        run()


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group, ranks: int,
                    axis: str = "data") -> None:
    """`out` [ranks * n] <- every rank's flat `x` [n], in rank order."""
    _collective("all-gather", _nbytes(out), ranks, group, x,
                lambda: dist.all_gather_into_tensor(out, x, group=group), axis)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group, ranks: int,
                        axis: str = "data") -> None:
    """`out` [n] <- the sum over the ranks of their flat `x` [ranks * n]'s
    slice [rank * n, (rank + 1) * n)."""
    _collective("reduce-scatter", _nbytes(x), ranks, group, x,
                lambda: dist.reduce_scatter_tensor(out, x, group=group), axis)


def all_reduce(x: torch.Tensor, group, ranks: int, op=dist.ReduceOp.SUM,
               axis: str = "data") -> None:
    """x <- its sum (or `op`) over the ranks, in place."""
    _collective("all-reduce", _nbytes(x), ranks, group, x,
                lambda: dist.all_reduce(x, op=op, group=group), axis)


def gather_blocks(blocks, dims, R: int, group, axis: str) -> list[torch.Tensor]:
    """Every rank's `blocks` (each sliced along its `dims` entry), whole
    along those dimensions, in rank order: one all-gather of a flat buffer
    over the axis' `R` ranks (a block's own storage where it is the only
    one and sliced along dimension 0)."""
    fronts = [b.movedim(d, 0).reshape(-1) for b, d in zip(blocks, dims)]
    flat = fronts[0] if len(fronts) == 1 else torch.cat(fronts)
    del fronts
    out = flat.new_empty(R * flat.numel())
    all_gather_into(out, flat, group, R, axis)
    del flat  # before the gathered leaves are laid out
    out = out.view(R, -1)
    whole, off = [], 0
    for b, d in zip(blocks, dims):
        n = b.numel()
        shape = list(b.shape)
        shape[d] *= R
        # [R, block moved to the front] -> the ranks' blocks in place along d,
        # in one copy
        ranks = out[:, off:off + n].view(R, *b.movedim(d, 0).shape)
        whole.append(ranks.movedim((0, 1), (d, d + 1)).reshape(shape))
        off += n
    return whole


SCATTER_PIECE_BYTES = 1 << 30


def scatter_sums(whole, dims, R: int, group, axis: str) -> list[torch.Tensor]:
    """Each tensor of `whole` summed over the axis' `R` ranks, and of the sum
    the rank's slice along its `dims` entry (R equal slices in rank order):
    one reduce-scatter of a flat buffer, the inverse layout of
    `gather_blocks`.  One tensor of more than SCATTER_PIECE_BYTES sliced
    along a dimension but the first is reduce-scattered in pieces along its
    first (`_scatter_pieces`)."""
    if len(whole) == 1 and dims[0] != 0 and _nbytes(whole[0]) > SCATTER_PIECE_BYTES:
        return [_scatter_pieces(whole[0], dims[0], R, group, axis)]
    return _scatter_flat(whole, dims, R, group, axis)


def _scatter_flat(whole, dims, R: int, group, axis: str) -> list[torch.Tensor]:
    fronts = [t.movedim(d, 0).reshape(R, -1) for t, d in zip(whole, dims)]
    big = fronts[0] if len(fronts) == 1 else torch.cat(fronts, dim=1)
    del fronts
    out = big.new_empty(big.shape[1])
    reduce_scatter_into(out, big.reshape(-1), group, R, axis)
    del big  # before the rank's slices are laid out
    parts, off = [], 0
    for t, d in zip(whole, dims):
        front = t.movedim(d, 0).shape
        front = (front[0] // R, *front[1:])
        n = prod(front)
        parts.append(out[off:off + n].view(front).movedim(0, d))
        off += n
    return parts


def _scatter_pieces(t: torch.Tensor, d: int, R: int, group, axis: str) -> torch.Tensor:
    """`scatter_sums` of one tensor `t` sliced along dimension d > 0, one
    reduce-scatter a piece of at most SCATTER_PIECE_BYTES along its first
    dimension: the same sums in more calls, whose staging copy (the slice
    moved to the front) is a piece's where it would be a copy of the whole
    tensor beside it (an expert layer's gradient is GBs)."""
    shape = list(t.shape)
    shape[d] //= R
    out = t.new_empty(shape)
    rows = max(1, SCATTER_PIECE_BYTES * t.shape[0] // _nbytes(t))
    for i in range(0, t.shape[0], rows):
        out[i:i + rows] = _scatter_flat([t[i:i + rows]], [d], R, group, axis)[0]
    return out


class _Gather(torch.autograd.Function):
    """Forward: the rank's blocks whole along "data" (an all-gather).
    Backward: the blocks' gradients, the gathered leaves' gradients summed
    over the data axis' ranks (a reduce-scatter)."""

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
    and `model_parts` along "model" split a leaf; ranks along "pod" (the
    dry run's multi-pod mesh) hold the same blocks.  `group` spans the
    mesh, `data_group` the rank's column (its ranks along "data") and
    `model_group` its row."""
    layout: dict
    mesh: Mesh
    rank: int
    group: object = None
    data_group: object = None
    model_group: object = None

    @property
    def parts(self) -> int:
        return self.mesh.shape.get("data", 1)

    @property
    def model_parts(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def batch_ranks(self) -> int:
        """The ranks that take different rows of a batch (along "pod" and
        "data"); the ranks along "model" take the same rows."""
        return self.mesh.size // self.model_parts

    @property
    def coords(self) -> dict:
        """{axis: the rank's index along it}."""
        out, index = {}, self.rank
        for name, n in reversed(list(zip(self.mesh.axis_names, self.mesh.axis_sizes))):
            out[name] = index % n
            index //= n
        return out

    def split(self, name: str) -> bool:
        """Whether parameter `name` is sliced along "data" (else whole along
        it, on every rank of the rank's column)."""
        return self.layout[name].dim is not None

    def model_split(self, name: str) -> bool:
        """Whether parameter `name` is sliced along "model"."""
        return self.layout[name].mdim is not None

    def owns(self, name: str) -> bool:
        """Whether the rank counts its block of parameter `name` in a sum
        over every rank's blocks (`psum`): along an axis that leaves the
        leaf whole, only the axis' first rank does."""
        c = self.coords
        return ((self.split(name) or c.get("data", 0) == 0)
                and (self.model_split(name) or c.get("model", 0) == 0))

    # -- the collectives on blocks -----------------------------------------

    def _all_gather(self, slices, shards, lead: int = 0) -> list[torch.Tensor]:
        return gather_blocks(slices, [sh.dim + lead for sh in shards], self.parts,
                             self.data_group, "data")

    def _reduce_scatter(self, grads, shards, lead: int = 0) -> list[torch.Tensor]:
        return [t.contiguous() for t in scatter_sums(grads, [sh.dim + lead for sh in shards],
                                                     self.parts, self.data_group, "data")]

    def gather(self, named: dict, prefix: str = "") -> dict:
        """{name: block whole along "data"} of the tensors of `named` that
        are sliced along "data" (parameter `prefix + name`'s blocks), each
        through a `_Gather` of its own: one all-gather a leaf, and in the
        backward one reduce-scatter a leaf as soon as its gradient is whole,
        so that a rank stages one leaf's gathered copy or whole gradient at
        a time, never the group's.  With grad off (serving) the all-gathers
        run alone and no graph is built."""
        out = {}
        for n, t in named.items():
            if not self.split(prefix + n):
                continue
            shards = [self.layout[prefix + n]]
            (out[n],) = (_Gather.apply(self, shards, t) if torch.is_grad_enabled()
                         else self._all_gather([t], shards))
        WIRE.largest_gather = max(WIRE.largest_gather, sum(_nbytes(t) for t in out.values()))
        return out

    @torch.no_grad()
    def whole(self, t: torch.Tensor, shard: Shard, lead: int = 0) -> torch.Tensor:
        """The whole leaf of the rank's block `t` (`lead` more leading
        dimensions than the parameter: 1 for a moment stacked over the
        groups), on every rank, outside autograd: gathered along "data",
        then along "model"; `t` itself where whole."""
        if shard.dim is not None:
            t = self._all_gather([t], [shard], lead)[0]
        if shard.mdim is not None:
            t = gather_blocks([t], [shard.mdim + lead], self.model_parts, self.model_group,
                              "model")[0]
        return t

    def _over_axes(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone()
        all_reduce(y, self.data_group, self.parts, op, "data")
        all_reduce(y, self.model_group, self.model_parts, op, "model")
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data axis' ranks, then over the model axis'
        (a new tensor): with `owns`, a sum over every block once."""
        return self._over_axes(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of x over the data and the model axes' ranks
        (a new tensor)."""
        return self._over_axes(x, dist.ReduceOp.MAX)

    # -- drawing -----------------------------------------------------------

    @contextlib.contextmanager
    def drawn_whole(self, named: dict, prefix: str = ""):
        """While the block runs, the cut parameters of `named` (parameter
        `prefix + name`) are whole and uninitialized; after it each keeps its
        block of what the block wrote.  So a model draws the one-card values
        and holds the rank's part of them, one module whole at a time."""
        cut = [(p, self.layout[prefix + n]) for n, p in named.items()
               if self.split(prefix + n) or self.model_split(prefix + n)]
        for p, sh in cut:
            p.data = p.data.new_empty(sh.shape)
        try:
            yield
        finally:
            for p, sh in cut:
                p.data = sh.cut(p.data).clone(memory_format=torch.contiguous_format)


_AXIS_GROUPS: dict = {}


def axis_groups(group, mesh: Mesh) -> tuple:
    """(data group, model group) of the calling rank of `group` on the
    ("data", "model") `mesh`: its column and its row of the mesh, ranks
    row-major.  An axis of one rank gets None and the mesh's other axis
    `group` itself; else every rank makes every column's group, then every
    row's, in order (`dist.new_group`, which every rank of the default group
    calls), once a (group, mesh)."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    if M == 1:
        return group, None
    if D == 1:
        return None, group
    key = (group, mesh.axis_sizes)
    if key not in _AXIS_GROUPS:
        world = [dist.get_global_rank(group, r) for r in range(mesh.size)]
        d, m = divmod(dist.get_rank(group), M)
        cols = [dist.new_group([world[i * M + j] for i in range(D)]) for j in range(M)]
        rows = [dist.new_group([world[i * M + j] for j in range(M)]) for i in range(D)]
        _AXIS_GROUPS[key] = (cols[m], rows[d])
    return _AXIS_GROUPS[key]


def span_ranks(mesh: Mesh, span: int) -> list[list[int]]:
    """The spans of `span` consecutive batch shards on `mesh`: each a list
    of the mesh ranks (row-major) that take those shards' rows at one place
    along "model", in batch-shard order (`rank_rows`: pod-major on a
    ("pod", "data", "model") mesh).  Spans are ordered by the place along
    "model", then by their first shard.  `span` must divide the batch
    ranks."""
    rules = make_rules(mesh)
    M = mesh.shape.get("model", 1)
    R = mesh.size // M
    if R % span:
        raise ValueError(f"a span of {span} batch shards does not divide the {R} batch ranks")
    by_place: dict = {}
    for r in range(mesh.size):
        by_place.setdefault(r % M, {})[rank_rows(R, mesh, rules, r).start] = r
    return [[shards[b] for b in range(j * span, (j + 1) * span)]
            for _, shards in sorted(by_place.items()) for j in range(R // span)]


_SPAN_GROUPS: dict = {}


def span_group(group, mesh: Mesh, span: int):
    """The process group of the calling rank's span (`span_ranks`): the
    `span` ranks of its data column whose rows make one MoE dispatch group,
    in batch-shard order, on the ("data", "model") `mesh` of `group`'s
    ranks.  The whole column where the span is the column (its axis group);
    else every rank makes every span's group, in `span_ranks`' order
    (`dist.new_group`, which every rank of the default group calls), once a
    (group, mesh, span)."""
    if span == mesh.shape["data"]:
        return axis_groups(group, mesh)[0]
    key = (group, mesh.axis_sizes, span)
    if key not in _SPAN_GROUPS:
        world = [dist.get_global_rank(group, r) for r in range(mesh.size)]
        me = dist.get_rank(group)
        mine = None
        for ranks in span_ranks(mesh, span):
            made = dist.new_group([world[r] for r in ranks])
            if me in ranks:
                mine = made
        _SPAN_GROUPS[key] = mine
    return _SPAN_GROUPS[key]


def _placement(group=None, place=None, mesh=None) -> tuple[Mesh, int]:
    """(mesh, rank): `mesh` (else the ("data", "model") = (R, 1) mesh of
    `group`'s R ranks) and the rank in `group`, or `place` = (mesh, rank)
    without a group."""
    if (group is None) == (place is None):
        raise ValueError("pass a process group or a place (mesh, rank), one of them")
    if group is None:
        if mesh is not None:
            raise ValueError("a place brings its mesh; pass a mesh with a process group")
        return place
    R = dist.get_world_size(group)
    if mesh is None:
        mesh = Mesh((R, 1), ("data", "model"))
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"ranks of a process group run on a (\"data\", \"model\") mesh, not "
                         f"{mesh.axis_names}")
    if mesh.size != R:
        raise ValueError(f"a process group of {R} ranks on a mesh of {mesh.size}")
    return mesh, dist.get_rank(group)


def shard_model(model, rules: ShardingRules, *, group=None, place=None,
                mesh: Mesh | None = None) -> Sharding | None:
    """Cut `model`'s parameters to the blocks that the rank (of `group` on
    `mesh`, a ("data", "model") mesh, (R, 1) by default; or `place` = (mesh,
    rank) on the meta device) holds under `rules`, and set `model.fsdp` to
    its `Sharding`, which it returns.  Where the rules split no leaf
    (`make_rules(fsdp=False)` on a (R, 1) mesh, a mesh of one rank) the
    model is left whole and replicated and None is returned.  A model
    sharded before keeps its sharding if the layout is the same, else
    ValueError."""
    mesh, rank = _placement(group, place, mesh)
    old = getattr(model, "fsdp", None)
    specs = model.param_specs()
    layout = {n: leaf_shard(n, old.layout[n].shape if old else tuple(p.shape), specs, mesh,
                            rules, rank)
              for n, p in model.named_parameters()}
    if old is not None:
        if layout != old.layout or old.group is not group:
            raise ValueError("the model is sharded already, on another layout or group")
        return old
    if not any(s.dim is not None or s.mdim is not None for s in layout.values()):
        return None
    data_group, model_group = (None, None) if group is None else axis_groups(group, mesh)
    sharding = Sharding(layout, mesh, rank, group, data_group, model_group)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if sharding.split(n) or sharding.model_split(n):
                p.data = layout[n].cut(p.data).clone(memory_format=torch.contiguous_format)
    model.fsdp = sharding
    return sharding


def opt_leaf_shard(sharding: Sharding, names: list[str], part: str) -> tuple[Shard, int]:
    """(the Shard, its lead) of the optimizer-state leaf of the JAX tree
    leaf held by parameters `names` (`param_leaves`); `part` is the state's
    part ("m", "v", "vr" or "vc").  A moment of a per-group parameter is
    stacked over the groups, one leading dimension more.  Adafactor's
    statistics of a leaf of 2 or more dimensions (stacked: the groups
    count) drop one: `vr` the last, `vc` the one before it.  Their Shard is
    the parameter's with the dropped dimension removed and every later one
    shifted down, so the rank holds the JAX rules' block of the factored
    shape; where `vc` drops the groups of a stacked [G, d] leaf it has no
    lead, and a stacked `vr` of it is all lead.  A 1-D leaf's `vr` has the
    leaf's block and its `vc` is a whole scalar."""
    shard, lead = sharding.layout[names[0]], int(names[0].startswith("groups."))
    if part in ("m", "v"):
        return shard, lead
    if part not in ("vr", "vc"):
        raise ValueError(f"no optimizer-state part {part!r}")
    ndim = lead + len(shard.shape)
    if ndim < 2:
        return (shard, lead) if part == "vr" else (Shard(()), 0)
    drop = ndim - (1 if part == "vr" else 2)  # in the stacked leaf
    new_lead = lead if drop >= lead else 0
    shape = list(shard.shape)
    if drop >= lead:
        del shape[drop - lead]

    def moved(d):
        if d is None or d + lead == drop:
            return None
        return d + lead - (d + lead > drop) - new_lead

    out = {}
    if moved(shard.dim) is not None:
        out.update(dim=moved(shard.dim), parts=shard.parts, index=shard.index)
    if moved(shard.mdim) is not None:
        out.update(mdim=moved(shard.mdim), mparts=shard.mparts, mindex=shard.mindex)
    return Shard(tuple(shape), **out), new_lead


def shard_train_state(state, rules: ShardingRules, *, group=None, place=None,
                      mesh: Mesh | None = None):
    """`shard_model` of the state's model, and its optimizer state cut to
    the matching blocks (`opt_leaf_shard`): AdamW's moments to their
    parameters' (each leaf stacked over the groups as the JAX tree holds
    it), Adafactor's `vr` and `vc` to the factored shapes'.  In place;
    returns the state."""
    from repro_torch.models.transformer import param_leaves  # the models import this module

    sharding = shard_model(state.params, rules, group=group, place=place, mesh=mesh)
    if sharding is None:
        return state
    leaves = param_leaves(dict(state.params.named_parameters()))
    for name, part in state.opt.items():
        for key, t in part.items():
            shard, lead = opt_leaf_shard(sharding, leaves[key], name)
            # a whole leaf is cut; one drawn on the blocks already is not
            if shard.block != shard.shape and tuple(t.shape[lead:]) == shard.shape:
                part[key] = shard.cut(t, lead).clone(memory_format=torch.contiguous_format)
    return state


def whole_named(sharding: Sharding | None, named: dict) -> dict:
    """{name: whole tensor} of tensors keyed by parameter name (parameters
    or gradients, the rank's blocks), gathered leaf by leaf on every rank."""
    if sharding is None:
        return dict(named)
    return {n: sharding.whole(t, sharding.layout[n]) for n, t in named.items()}
