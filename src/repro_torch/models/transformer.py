"""The model: parameters, the scoring forward, prefill and decode over the
group stack.

Decode state layout (dict of tensors stacked over the G groups), as the JAX
package's:
    caches["pos{i}"] = {"k": [G, B, Smax, KV, hd], "v": ...}          attention mixers
                     = {"ssm": [G, B, di, N] f32, "conv": [G, B, dc-1, di]}  mamba mixers

The JAX package scans one jitted group body over the stacked parameters; here
the groups are an `nn.ModuleList` and a Python loop runs them.  `forward` and
`loss_fn` are the training and scoring passes (each group under activation
checkpointing with `remat`, as `jax.checkpoint` wraps the JAX group body);
`prefill` and `decode_step` serve without grad.  `decode_step` updates the
caches in place and returns the same dict.

The JAX parameter tree stacks each per-group leaf over the groups; here
group g's leaf is the parameter `groups.{g}.{pos}.{sub}.{name}`.
`param_leaves` maps the port's names onto the JAX tree's leaves, in
`jax.tree.flatten`'s order (sorted keys), for the optimizer state, the
checkpoint format and `repro_torch.interop`.

A model whose state is sharded (`model.fsdp`, set by
`repro_torch.parallel.fsdp.shard_model`) holds its rank's blocks.  Its
forward gathers each group's weights along "data" inside the group's
function, which `torch.utils.checkpoint` recomputes in the backward (the
recompute gathers again, as the JAX group body's all-gathers sit inside its
rematerialized scan body), and the embedding and the head where they are
used; a tied head uses the one gathered embedding.  The backward
reduce-scatters their gradients onto the blocks.  Where the mesh's "model"
axis has more than one rank, the layers run tensor-parallel on the blocks
(`repro_torch.parallel.tensor`): the group's function runs its layers in
their model regions (whose all-reduces the recompute runs again), the
lookup is vocab-parallel, the head gives the rank's vocab slice of the
logits, `loss_fn` takes the vocab-parallel cross entropy without gathering
them, and `forward` gathers them whole.  `init_params` draws the one-card
values a module at a time and keeps the blocks.  Serving takes a whole
model: `prefill` and `decode_step` raise on a sharded one.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.blocks import Group, group_specs
from repro_torch.models.layers.embeddings import (
    embed_inputs,
    embed_specs,
    head_split,
    init_embeddings,
    logits_out,
)
from repro_torch.models.layers.norms import RMSNorm, rms_norm, rms_specs
from repro_torch.parallel import tensor


def leaf_key(name: str) -> tuple[str, int | None]:
    """The JAX tree's leaf of port parameter `name`, its keys "/"-joined, and
    the group index along its stacked axis (None for an unstacked leaf):
    "groups.3.pos0.attn.wq" -> ("blocks/pos0/attn/wq", 3),
    "final_norm.scale" -> ("final_norm/scale", None)."""
    if name.startswith("groups."):
        _, g, rest = name.split(".", 2)
        return "blocks/" + rest.replace(".", "/"), int(g)
    return name.replace(".", "/"), None


def param_leaves(names) -> dict[str, list[str]]:
    """{leaf key: its port names (one per group in group order for a stacked
    leaf, else one)} in `jax.tree.flatten`'s leaf order."""
    out: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        key, g = leaf_key(name)
        out.setdefault(key, []).append((-1 if g is None else g, name))
    return {key: [n for _, n in sorted(out[key])]
            for key in sorted(out, key=lambda k: tuple(k.split("/")))}


def _stacked(tree: dict) -> dict:
    return {k: _stacked(v) if isinstance(v, dict) else (None, *v) for k, v in tree.items()}


def param_specs(cfg) -> dict:
    """Logical-axis templates of the parameters, keyed by the JAX tree's paths
    (a per-group leaf stacked over the groups gets a leading None), as the
    JAX package's `param_specs`: leaf "blocks/pos0/attn/wq" is
    `param_specs(cfg)["blocks"]["pos0"]["attn"]["wq"]`."""
    return {**embed_specs(cfg), "blocks": _stacked(group_specs(cfg)),
            "final_norm": rms_specs()}


def cache_specs(cfg) -> dict:
    """Logical-axis templates of the decode caches (the sequence sharded for
    sequence parallelism), as the JAX package's `cache_specs`."""
    specs = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer.startswith("attn"):
            t = (None, "dp", "sp", None, None)
            specs[f"pos{i}"] = {"k": t, "v": t}
        elif spec.mixer == "mamba":
            specs[f"pos{i}"] = {
                "ssm": (None, "dp", "tp", None),
                "conv": (None, "dp", None, "tp"),
            }
    return specs


def init_caches(cfg, batch_size: int, max_len: int, *, dtype, device) -> dict:
    """Zeroed decode caches for `batch_size` sequences of up to `max_len`."""
    G = cfg.n_groups
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer.startswith("attn"):
            shape = (G, batch_size, max_len, cfg.n_kv, cfg.head_dim)
            caches[f"pos{i}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        elif spec.mixer == "mamba":
            di, N, dc = cfg.d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
            caches[f"pos{i}"] = {
                "ssm": torch.zeros((G, batch_size, di, N), dtype=torch.float32, device=device),
                "conv": torch.zeros((G, batch_size, dc - 1, di), dtype=dtype, device=device),
            }
    return caches


class Transformer(nn.Module):
    """embed [V, d], head [d, V] (unless tied), `groups` (G x Group),
    final_norm.  `backend` picks the attention and scan kernels ("cuda") or
    their plain versions ("ref") for the full-sequence passes."""

    def __init__(self, cfg, *, device, dtype, backend: str = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.backend = backend
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, **kw))
        self.groups = nn.ModuleList(Group(cfg, **kw) for _ in range(cfg.n_groups))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.fsdp = None  # the rank's `Sharding` of a sharded state (module docstring)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def init_params(self, gen: torch.Generator) -> None:
        """Random parameters with the JAX package's distributions, drawn from
        `gen` (a generator on the model's device).  The draws are not JAX's.
        A sharded model draws the same values and keeps its slices."""
        top = {n: getattr(self, n) for n in ("embed", "head") if hasattr(self, n)}
        with self._whole(top):
            init_embeddings(self, self.cfg, gen)
        for g, group in enumerate(self.groups):
            with self._whole(dict(group.named_parameters()), f"groups.{g}."):
                group.reset_parameters(self.cfg, gen)
        with self._whole(dict(self.final_norm.named_parameters()), "final_norm."):
            self.final_norm.reset_parameters()

    def _whole(self, named: dict, prefix: str = ""):
        if self.fsdp is None:
            return contextlib.nullcontext()
        return self.fsdp.drawn_whole(named, prefix)

    def _gathered(self, *names) -> SimpleNamespace:
        """The named top-level parameters, whole (gathered where sharded)."""
        named = {n: getattr(self, n) for n in names}
        if self.fsdp is not None:
            named.update(self.fsdp.gather(named))
        return SimpleNamespace(**named)

    def _group_fn(self, g: int):
        """Group g's forward; on a sharded model, one that gathers the
        group's weights along "data" and runs the group on them, in its
        model region."""
        group = self.groups[g]
        if self.fsdp is None:
            return group
        tp = tensor.region(self.fsdp, f"groups.{g}.")

        def run(*args, **kw):
            whole = self.fsdp.gather(dict(group.named_parameters()), f"groups.{g}.")
            return torch.func.functional_call(group, whole, args, {**kw, "tp": tp})

        return run

    def _whole_only(self, what: str) -> None:
        if self.fsdp is not None:
            raise ValueError(f"{what} takes a whole model; serving on a sharded state is "
                             f"ROADMAP §1's slice 25")

    def param_specs(self) -> dict:
        """`param_specs(self.cfg)`, as the JAX `Model.param_specs()`."""
        return param_specs(self.cfg)

    def cache_specs(self) -> dict:
        """`cache_specs(self.cfg)`, as the JAX `Model.cache_specs()`."""
        return cache_specs(self.cfg)

    def init_caches(self, batch_size: int, max_len: int, dtype=None) -> dict:
        return init_caches(self.cfg, batch_size, max_len, dtype=dtype or self.dtype,
                           device=self.device)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return logits_out(self, self.cfg, rms_norm(x, self.final_norm.scale, self.cfg.norm_eps))

    def _logits(self, batch: dict, *, remat: bool = True, chunk: int = 1024,
                dispatch_ranks: int = 1):
        """(logits, tp): `forward`'s logits, the rank's vocab slice of them
        where the head is split along "model" (then `tp` is the model's
        `ModelRegion`, else None)."""
        cfg = self.cfg
        tp = tensor.region(self.fsdp)
        tied = cfg.tie_embeddings
        w_in = self if cfg.input_mode == "frames" and not tied else self._gathered("embed")
        x = embed_inputs(w_in, cfg, batch, tp)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = remat and torch.is_grad_enabled()
        for g in range(len(self.groups)):
            run = self._group_fn(g)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    run, cfg, x, positions, backend=self.backend, chunk=chunk,
                    dispatch_ranks=dispatch_ranks, use_reentrant=False)
            else:
                x = run(cfg, x, positions, backend=self.backend, chunk=chunk,
                        dispatch_ranks=dispatch_ranks)
        w_out = w_in if tied else self._gathered("head")
        logits = logits_out(w_out, cfg, rms_norm(x, self.final_norm.scale, cfg.norm_eps), tp)
        return logits, (tp if head_split(cfg, tp) else None)

    def forward(self, batch: dict, *, remat: bool = True, chunk: int = 1024,
                dispatch_ranks: int = 1) -> torch.Tensor:
        """batch -> logits [B, S, V], as the JAX `forward`.

        With grad on and `remat`, each group runs under
        `torch.utils.checkpoint.checkpoint` (non-reentrant): its activations
        are dropped after the forward and recomputed in the backward, so the
        attention and scan kernels run twice per layer a step.  `chunk` is
        `blocked_attention`'s KV chunk (the "ref" forward and the attention
        gradient).  `dispatch_ranks`: the data-parallel ranks that share the
        batch's rows, for the MoE layers' dispatch groups (`moe_forward`).
        Under tensor parallelism the ranks' vocab slices are gathered whole."""
        logits, tp = self._logits(batch, remat=remat, chunk=chunk, dispatch_ranks=dispatch_ranks)
        return logits if tp is None else tp.gather(logits)

    def loss_fn(self, batch: dict, *, denominator=None, **kw) -> torch.Tensor:
        """Mean next-token (or frame-label) cross entropy, as the JAX `loss_fn`:
        f32 logits, logsumexp less the label's logit, weighted by
        `batch["loss_mask"]` (ones by default) over max(mask sum, 1).  `kw`
        goes to `forward`.  `denominator` replaces max(mask sum, 1): a
        data-parallel rank divides its rows' sum by the whole batch's.  Under
        tensor parallelism the cross entropy is vocab-parallel
        (`ModelRegion.cross_entropy`): the logits are never gathered."""
        logits, tp = self._logits(batch, **kw)
        logits = logits.float()
        labels = batch["labels"]
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        else:
            nll = tp.cross_entropy(logits, labels)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        if denominator is None:
            denominator = torch.clamp(mask.sum(), min=1.0)
        return torch.sum(nll * mask) / denominator

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Run the prompt: (last-position logits [B, V], filled caches).

        The attention caches hold positions [0, S); mamba states carry the
        last recurrent state."""
        self._whole_only("prefill")
        x = embed_inputs(self, self.cfg, batch)
        B, S, _ = x.shape
        if S > max_len:
            raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
        positions = torch.arange(S, device=x.device)
        caches = self.init_caches(B, max_len)
        for g, group in enumerate(self.groups):
            x = group(self.cfg, x, positions, backend=self.backend, caches=caches, g=g)
        return self._final(x[:, -1:, :])[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, caches: dict, tokens: torch.Tensor, position: int):
        """tokens [B] at `position` -> (logits [B, V], caches updated in place)."""
        self._whole_only("decode_step")
        position = int(position)
        x = self.embed[tokens[:, None]]
        for g, group in enumerate(self.groups):
            x = group.decode(self.cfg, x, caches, g, position)
        return self._final(x)[:, 0, :], caches

