"""Logical-axis sharding rules, as the JAX package's
`repro/parallel/sharding.py`: layers name their parameters' axes with
*logical* names, and the rules map them onto a mesh's axes:

    fsdp -> "data"             weight shards gathered at use (ZeRO-3 style)
    tp   -> "model"            Megatron tensor parallel (heads / ffn / vocab)
    ep   -> "model"            MoE expert parallel
    dp   -> ("pod", "data")    batch (the pod axis is pure data parallelism)
    sp   -> "model"            sequence-sharded KV caches (long-context decode)
    kv   -> "model"            GQA key/value heads, where n_kv divides the axis

These are pure functions of a mesh's shape and axis names.  The port's mesh
is `Mesh`, a frozen dataclass of the two, in the part of JAX's
`AbstractMesh`; a partition spec is `PartitionSpec`, a tuple whose entries
are None, an axis name or a tuple of names, in the part of
`jax.sharding.PartitionSpec`.

The port has no GSPMD.  Its trainer reads two of the rules:
- the batch's, through `rank_rows`: the rows of each micro-batch a rank
  takes (the ranks along "model" take the same rows);
- the parameters', through `leaf_shard`: a rank holds, of each parameter
  and of both AdamW moments, the block that the leaf's sanitized spec
  gives its coordinates: its slice along the dimension that names "data"
  (fsdp -> "data", `repro_torch.parallel.fsdp`, gathered where the leaf is
  used, ZeRO-3 style) and its slice along the dimension that names
  "model" (tp -> "model", and kv -> "model" where n_kv divides the axis:
  Megatron tensor parallelism, `repro_torch.parallel.tensor`, the block
  used where it lies; ep -> "model": the MoE experts split over the ranks
  of a row, each running its own experts' slots,
  `repro_torch.models.layers.moe`).  The ranks lie on the mesh row-major,
  as `rank_rows` lays them.  An axis dropped from a leaf (a dimension the
  axis does not divide, the norm scales, every "data" entry under
  `make_rules(fsdp=False)`, n_experts that the model axis does not divide)
  leaves the leaf whole along that axis, as GSPMD replicates it.
  `make_rules(fsdp=False)` on a (R, 1) mesh thus gives the replicated data
  parallelism of `repro_torch.training.make_train_step(group=...)`.
`activation_sharding_ctx` and `shard_activation`, the JAX package's
activation constraints, are the identity here, and no model code calls
them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from math import prod
from types import SimpleNamespace


@dataclass(frozen=True)
class Mesh:
    """A mesh's axis sizes and names: Mesh((2, 1), ("data", "model"))."""
    axis_sizes: tuple
    axis_names: tuple

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and axis names {self.axis_names} "
                             f"differ in length")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's `mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return prod(self.axis_sizes)


class PartitionSpec(tuple):
    """PartitionSpec("data", None) == ("data", None): one entry per
    dimension, None (replicated), an axis name, or a tuple of names.  As
    JAX's, a one-name tuple is that name and an empty one is None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


@dataclass(frozen=True)
class ShardingRules:
    rules: dict = field(
        default_factory=lambda: {
            None: None,
            "fsdp": "data",
            "tp": "model",
            "ep": "model",
            "dp": ("data",),
            "sp": "model",
        }
    )

    def axes(self, logical):
        return self.rules.get(logical, None)


def make_rules(mesh: Mesh, *, fsdp: bool = True, pod_strategy: str = "dp",
               model_cfg=None) -> ShardingRules:
    """Rules for a mesh; the pod axis (if present) extends data parallelism.

    The "kv" logical axis (GQA key/value heads) maps to the model axis only
    when n_kv divides it; otherwise the K/V projections replicate across the
    model axis (the Megatron GQA convention)."""
    has_pod = "pod" in mesh.axis_names
    dp = ("pod", "data") if (has_pod and pod_strategy == "dp") else ("data",)
    tp_size = mesh.shape.get("model", 1)
    kv = None
    if model_cfg is not None and getattr(model_cfg, "n_kv", 0) % max(tp_size, 1) == 0:
        kv = "model"
    return ShardingRules(
        rules={
            None: None,
            "fsdp": "data" if fsdp else None,
            "tp": "model",
            "ep": "model",
            "dp": dp,
            "sp": "model",
            "kv": kv,
        }
    )


def template_to_pspec(template: tuple, rules: ShardingRules) -> PartitionSpec:
    """("fsdp", "tp", None) -> PartitionSpec("data", "model", None)."""
    return PartitionSpec(*[rules.axes(t) for t in template])


def sanitize_pspec(spec, shape: tuple, mesh: Mesh) -> PartitionSpec:
    """Drop mesh axes from the dimensions they do not divide evenly (llama4's
    40 heads on a 16-way model axis, hubert's 504-token vocab, batch-1
    decode caches): such a dimension falls back to replication on that
    axis.  Within a tuple entry the axes are kept left to right while their
    product still divides the dimension."""
    sizes = mesh.shape
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        size = 1
        for ax in axes:
            if shape[i] % (size * sizes.get(ax, 1)) == 0:
                keep.append(ax)
                size *= sizes.get(ax, 1)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return PartitionSpec(*out)


def _is_template(x) -> bool:
    return isinstance(x, tuple) and all(t is None or isinstance(t, str) for t in x)


def tree_pspecs(template_tree, rules: ShardingRules):
    """A nested dict of templates -> the same dict of PartitionSpecs."""
    if _is_template(template_tree):
        return template_to_pspec(template_tree, rules)
    return {k: tree_pspecs(v, rules) for k, v in template_tree.items()}


@contextlib.contextmanager
def activation_sharding_ctx(mesh: Mesh, rules: ShardingRules):
    """The identity: the port has no GSPMD to constrain (module docstring)."""
    yield


def shard_activation(x, *logical):
    """The identity: the port has no GSPMD to constrain (module docstring)."""
    return x


def batch_pspecs(cfg, rules: ShardingRules, kind: str = "train") -> dict:
    """PartitionSpecs of the input batch's entries (train, prefill or decode)."""
    dp = rules.axes("dp")
    if kind == "decode":
        return {"tokens": PartitionSpec(dp)}
    specs = {}
    if cfg.input_mode == "frames":
        specs["frames"] = PartitionSpec(dp, None, None)
    else:
        specs["tokens"] = PartitionSpec(dp, None)
        if cfg.input_mode == "tokens+patches":
            specs["patch_embeds"] = PartitionSpec(dp, None, None)
    if kind == "train":
        specs["labels"] = PartitionSpec(dp, None)
    return specs


def rank_rows(batch_size: int, mesh: Mesh, rules: ShardingRules, rank: int) -> range:
    """The rows of a global batch of `batch_size` that `rank` takes: the
    first dimension of `sanitize_pspec(batch_pspecs(...)["tokens"], ...)`,
    with the ranks laid over the mesh in row-major order, as JAX lays
    devices.  Where the data axes do not divide the batch they drop out; with
    none left every rank takes every row, as GSPMD replicates."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is not on a mesh of {mesh.size}")
    spec = batch_pspecs(_TOKENS, rules)["tokens"]
    entry = sanitize_pspec(spec, (batch_size,), mesh)[0]
    axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    coords = dict(zip(mesh.axis_names, _unravel(rank, mesh.axis_sizes)))
    shard, n = 0, 1
    for ax in axes:
        shard = shard * mesh.shape[ax] + coords[ax]
        n *= mesh.shape[ax]
    per = batch_size // n
    return range(shard * per, (shard + 1) * per)


_TOKENS = SimpleNamespace(input_mode="tokens")  # every input mode's batch rule is dp first


@dataclass(frozen=True)
class Shard:
    """A rank's block of one port parameter: the whole (per-group) leaf has
    `shape`; the rank holds slice `index` of `parts` equal slices along
    `dim` (the "data" axis's) and slice `mindex` of `mparts` along `mdim`
    (the "model" axis's).  A dimension of None leaves the leaf whole along
    that axis (then its parts is 1)."""
    shape: tuple
    dim: int | None = None
    parts: int = 1
    index: int = 0
    mdim: int | None = None
    mparts: int = 1
    mindex: int = 0

    @property
    def block(self) -> tuple:
        """The shape of the rank's block."""
        out = list(self.shape)
        for d, n in ((self.dim, self.parts), (self.mdim, self.mparts)):
            if d is not None:
                out[d] //= n
        return tuple(out)

    def cut(self, whole, lead: int = 0):
        """The rank's block (a view) of `whole`, the leaf with `lead` more
        leading dimensions (1 for a moment stacked over the groups)."""
        for d, n, i in ((self.dim, self.parts, self.index), (self.mdim, self.mparts, self.mindex)):
            if d is not None:
                size = self.shape[d] // n
                whole = whole.narrow(d + lead, i * size, size)
        return whole


def _axis_dim(axis: str, spec, shape: tuple, mesh: Mesh) -> int | None:
    if mesh.shape.get(axis, 1) == 1:
        return None
    for i, entry in enumerate(sanitize_pspec(spec, shape, mesh)):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def data_dim(spec, shape: tuple, mesh: Mesh) -> int | None:
    """The dimension of a leaf of `shape` that the "data" axis splits under
    `spec` sanitized against `shape` and `mesh`; None where no dimension
    keeps "data" or the axis has one rank."""
    return _axis_dim("data", spec, shape, mesh)


def model_dim(spec, shape: tuple, mesh: Mesh) -> int | None:
    """`data_dim` of the "model" axis."""
    return _axis_dim("model", spec, shape, mesh)


def leaf_template(name: str, specs: dict) -> tuple:
    """The logical-axis template of port parameter `name`.  `specs` is the
    model's template tree (`Transformer.param_specs()`, the JAX tree's
    paths): a per-group parameter "groups.{g}.{path}" takes the template of
    leaf "blocks/{path}" without the stacked leading None."""
    stacked = name.startswith("groups.")
    template = specs
    for k in (["blocks", *name.split(".")[2:]] if stacked else name.split(".")):
        template = template[k]
    return template[1:] if stacked else template


def leaf_shard(name: str, shape: tuple, specs: dict, mesh: Mesh, rules: ShardingRules,
               rank: int) -> Shard:
    """The block of port parameter `name` (whole shape `shape`) that `rank`
    holds on `mesh` under `rules` (`leaf_template` reads `specs`).  The
    ranks lie on the mesh row-major, as `rank_rows` lays them.  A leaf
    whose "data" and "model" entries would split one dimension raises
    ValueError."""
    template, shape = leaf_template(name, specs), tuple(shape)
    spec = template_to_pspec(template, rules)
    dim, mdim = data_dim(spec, shape, mesh), model_dim(spec, shape, mesh)
    if dim is not None and dim == mdim:
        raise ValueError(f"{name} {shape}: \"data\" and \"model\" both split dimension {dim} "
                         f"under {template}; the port splits a dimension along one axis")
    coords = dict(zip(mesh.axis_names, _unravel(rank, mesh.axis_sizes)))
    out = {}
    if dim is not None:
        out.update(dim=dim, parts=mesh.shape["data"], index=coords["data"])
    if mdim is not None:
        out.update(mdim=mdim, mparts=mesh.shape["model"], mindex=coords["model"])
    return Shard(shape, **out)


def _unravel(index: int, sizes: tuple) -> tuple:
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return tuple(reversed(out))
