"""Tensor parallelism over the "model" axis, by the JAX rules tp -> "model"
("Megatron tensor parallel (heads / ffn / vocab)"), kv -> "model" (where
n_kv divides the axis), as Megatron-LM splits a layer, and ep -> "model"
("MoE expert parallel").

A model whose state is sharded on a mesh whose "model" axis has M > 1
ranks (`repro_torch.parallel.fsdp.shard_model`) holds, of each leaf the
rules split along "model", the rank's block; the ranks along "model" take
the same rows and compute one loss together.  Each layer reads its region
(`region(model.fsdp, prefix)`, a `ModelRegion`) and runs on its blocks:

- attention: wq column-parallel over the heads (and wk, wv where kv ->
  "model"), the flash kernel on the rank's heads, wo row-parallel;
- the MLP: w_in column-parallel over d_ff (gate and up by the same
  columns), w_out row-parallel;
- mamba: every leaf split over d_inner, the conv and the scan on the rank's
  channels; x_proj row-parallel, out_proj row-parallel;
- the embedding: a vocab-parallel lookup; the head (untied, or the tied
  embed) column-parallel over the vocab, and the cross entropy
  vocab-parallel (`ModelRegion.cross_entropy`);
- the MoE layer (ep -> "model"): the router reads the replicated tokens
  outside the region; the dispatch reads them through `copy`, each rank
  runs its E / M experts on their slots of the one-device slot buffer, and
  `gather` along the expert dimension makes the experts' outputs whole
  again for the combine (`repro_torch.models.layers.moe`).

Megatron's two operators carry the activations across a region's edges:
`copy` (identity forward, all-reduce over "model" backward) where a
replicated activation enters it, and `reduce` (all-reduce forward,
identity backward) where its partial sums leave it; `gather` (all-gather
along a dimension forward, the rank's slice of the gradient backward)
where the ranks' slices of an activation leave it whole.  With grad off
(the serving passes) each runs its forward alone, without an autograd
node.  Inside the groups' function they sit inside the region that
activation checkpointing recomputes, so the recompute runs the forward
all-reduces and all-gathers again, as the JAX body's collectives sit
inside its rematerialized scan body.  The serving passes also use
`gathered` (several tensors in one all-gather) and `scattered_sums` (a
sum over "model" of which each rank keeps its slice: one reduce-scatter),
which have no autograd node: the decode attention over a sequence split
along "model" and the prefill's cache blocks
(`repro_torch.models.layers.attention`).  Each call goes through
`repro_torch.parallel.fsdp`'s collectives and counts on `fsdp.WIRE` under
the axis "model"; on the meta device it counts and runs nothing.

A layer whose dimension the axis does not divide keeps its leaves whole
and runs whole on every rank of the row, outside any region.  Which
leaves a model rank gets only part of the gradient of, and which the
whole:
- summed over "model" by the train step (`summed_over_model`): leaves
  whole along "model" that a region reads, wk and wv where kv was dropped
  (each rank projects only the KV heads its query heads read) and the
  qk-norm scales q_norm and k_norm, of an attention whose heads are split;
- not summed (every rank gets the whole gradient): the leaves used outside
  any region, norm_mixer, norm_ffn, final_norm, the MoE router (which
  reads the replicated tokens outside the experts' region), and the leaves
  of a layer the axis does not divide (the experts where the axis does not
  divide n_experts).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel import fsdp

# The leaves an attention reads inside its heads' region that may stay
# whole along "model" (module docstring).
REGION_READERS = ("wk", "wv", "q_norm", "k_norm")


def summed_over_model(layout: dict) -> list[str]:
    """The parameters of `layout` (name -> `Shard`) whose gradient the train
    step sums over "model", in layout order: the `REGION_READERS` whole
    along "model" of an attention whose wq is split along it."""
    out = []
    for name, shard in layout.items():
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if (module.endswith("attn") and leaf in REGION_READERS and shard.mdim is None
                and layout[f"{module}.wq"].mdim is not None):
            out.append(name)
    return out


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over "model" backward."""

    @staticmethod
    def forward(ctx, x, region):
        ctx.region = region
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        ctx.region.all_reduce_(g)
        return g, None


class _Reduce(torch.autograd.Function):
    """x summed over "model" forward; identity backward."""

    @staticmethod
    def forward(ctx, x, region):
        y = x.clone(memory_format=torch.contiguous_format)
        region.all_reduce_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' slices along dimension `dim`, whole, forward; the rank's
    slice of the gradient backward.  The narrow is exact where the gathered
    activation is replicated along "model": every rank then receives the
    same gradient of it."""

    @staticmethod
    def forward(ctx, x, region, dim):
        ctx.region, ctx.dim, ctx.n = region, dim, x.shape[dim]
        return fsdp.gather_blocks([x.contiguous()], [dim], region.size, region.group,
                                  "model")[0]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.region.index * ctx.n, ctx.n), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class ModelRegion:
    """A rank's place along "model" for the parameters under `prefix`:
    the layout (name -> `Shard`), the model axis' group (None on the meta
    device), its size and the rank's index along it."""
    layout: dict
    group: object
    size: int
    index: int
    prefix: str = ""

    def at(self, prefix: str) -> ModelRegion:
        """The region of the parameters under `self.prefix + prefix`."""
        return dataclasses.replace(self, prefix=self.prefix + prefix)

    def split(self, leaf: str) -> bool:
        """Whether parameter `prefix + leaf` is sliced along "model"."""
        return self.layout[self.prefix + leaf].mdim is not None

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        """x <- its sum (or `op`) over the model axis' ranks, in place."""
        fsdp.all_reduce(x, self.group, self.size, op, "model")

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "copy to the model region": x, its gradient summed
        over "model".  With grad off (serving) x itself."""
        return _Copy.apply(x, self) if torch.is_grad_enabled() else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's "reduce from the model region": x summed over
        "model", its gradient passed through.  With grad off the all-reduce
        runs alone."""
        if torch.is_grad_enabled():
            return _Reduce.apply(x, self)
        y = x.clone(memory_format=torch.contiguous_format)
        self.all_reduce_(y)
        return y

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' slices of x along dimension `dim` (the last by
        default), whole, in rank order.  With grad off the all-gather runs
        alone."""
        if torch.is_grad_enabled():
            return _Gather.apply(x, self, dim % x.ndim)
        return self.gathered(x, dim=dim)[0]

    def gathered(self, *xs: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """The ranks' slices of each of `xs` along dimension `dim`, whole,
        in rank order: one all-gather of them all.  No autograd node (the
        serving passes)."""
        return fsdp.gather_blocks([x.contiguous() for x in xs], [dim % x.ndim for x in xs],
                                  self.size, self.group, "model")

    def scattered_sums(self, *xs: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """Each of `xs` summed over "model", and of the sum the rank's slice
        along dimension `dim` (`size` equal slices in rank order): one
        reduce-scatter of them all.  No autograd node (the serving
        passes)."""
        return fsdp.scatter_sums(list(xs), [dim % x.ndim for x in xs], self.size, self.group,
                                 "model")

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """logsumexp(logits) - the label's logit of every row, from the
        rank's vocab slice of f32 `logits` [..., V / M] (vocab ids [i n,
        (i + 1) n) on rank i), without gathering them: the row max (an
        all-reduce MAX, no gradient), then the sums of the exponentials
        and of the label's logit (all-reduce SUMs).  The backward is local:
        softmax less the one-hot label, on the rank's slice."""
        n = logits.shape[-1]
        with torch.no_grad():
            m = logits.amax(-1)
            self.all_reduce_(m, dist.ReduceOp.MAX)
        sumexp = self.reduce(torch.exp(logits - m[..., None]).sum(-1))
        local = labels - self.index * n
        mine = (local >= 0) & (local < n)
        picked = torch.take_along_dim(logits, local.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
        picked = self.reduce(torch.where(mine, picked, torch.zeros_like(picked)))
        return m + torch.log(sumexp) - picked


def region(sharding, prefix: str = "") -> ModelRegion | None:
    """The `ModelRegion` of the parameters under `prefix` of a model sharded
    by `sharding` (`model.fsdp`), or None where the mesh's "model" axis has
    one rank (or the model is whole)."""
    if sharding is None or sharding.model_parts == 1:
        return None
    return ModelRegion(sharding.layout, sharding.model_group, sharding.model_parts,
                       sharding.coords["model"], prefix)
