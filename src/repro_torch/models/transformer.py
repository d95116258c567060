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
values a module at a time and keeps the blocks.

A sharded model serves on its blocks too.  `prefill` and `decode_step`
take the rank's rows of a batch (`rank_rows`; every row where the data
axes do not divide the batch) and run without grad: each group's weights
are gathered along "data" once a call (no graph, no remat), the group runs
in its model region, the embedding and the head are gathered where they
are used, and the logits come back whole along "model" for the rank's
rows.  The caches are the rank's block (`init_caches`): its rows, the
attention's KV heads its query heads read ([G, B_r, S_max, KV_r, hd]: the
sequence whole, where the JAX `cache_specs` shard it along "model"), and
mamba's d_inner channels, as `cache_specs` splits them.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.blocks import Group, group_specs
from repro_torch.models.layers.attention import rank_kv_heads
from repro_torch.models.layers.embeddings import (
    embed_inputs,
    embed_specs,
    head_split,
    init_embeddings,
    logits_out,
    lookup,
)
from repro_torch.models.layers.moe import check_dispatch_split
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


def init_caches(cfg, batch_size: int, max_len: int, *, dtype, device,
                widths: dict | None = None) -> dict:
    """Zeroed decode caches for `batch_size` sequences of up to `max_len`.
    `widths`: {"pos{i}": the KV heads or d_inner channels a rank holds} of
    the positions whose caches a rank holds a block of (whole otherwise)."""
    G = cfg.n_groups
    widths = widths or {}
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        key = f"pos{i}"
        if spec.mixer.startswith("attn"):
            shape = (G, batch_size, max_len, widths.get(key, cfg.n_kv), cfg.head_dim)
            caches[key] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)}
        elif spec.mixer == "mamba":
            di, N, dc = widths.get(key, cfg.d_inner), cfg.mamba.d_state, cfg.mamba.d_conv
            caches[key] = {
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

    def param_specs(self) -> dict:
        """`param_specs(self.cfg)`, as the JAX `Model.param_specs()`."""
        return param_specs(self.cfg)

    def cache_specs(self) -> dict:
        """`cache_specs(self.cfg)`, as the JAX `Model.cache_specs()`."""
        return cache_specs(self.cfg)

    def init_caches(self, batch_size: int, max_len: int, dtype=None) -> dict:
        """Zeroed decode caches; on a sharded model the rank's block of them
        (module docstring) for its `batch_size` rows."""
        return init_caches(self.cfg, batch_size, max_len, dtype=dtype or self.dtype,
                           device=self.device, widths=self.cache_widths())

    def cache_widths(self) -> dict:
        """{"pos{i}": the KV heads (attention) or d_inner channels (mamba)
        of the rank's cache block} of the positions split along "model"."""
        out = {}
        for key, layer in self.groups[0].items():
            tp = tensor.region(self.fsdp, f"groups.0.{key}.")
            if tp is None:
                continue
            if hasattr(layer, "attn") and tp.at("attn.").split("wq"):
                kv = rank_kv_heads(layer.attn, tp.at("attn."))
                out[key] = len(range(layer.attn.wk.shape[1])[kv])
            elif hasattr(layer, "mamba") and tp.at("mamba.").split("in_proj"):
                out[key] = layer.mamba.in_proj.shape[2]
        return out

    def _head_logits(self, w_in, x: torch.Tensor, tp) -> torch.Tensor:
        """The final norm and the head (the tied `w_in.embed`, else the head
        gathered along "data"): the logits, or the rank's vocab slice of
        them where the head is split along "model"."""
        w_out = w_in if self.cfg.tie_embeddings else self._gathered("head")
        return logits_out(w_out, self.cfg, rms_norm(x, self.final_norm.scale, self.cfg.norm_eps),
                          tp)

    def _whole_logits(self, w_in, x: torch.Tensor) -> torch.Tensor:
        tp = tensor.region(self.fsdp)
        logits = self._head_logits(w_in, x, tp)
        return tp.gather(logits) if head_split(self.cfg, tp) else logits

    def _embed_in(self):
        """What `embed_inputs` reads: the embedding gathered along "data"
        (the model itself for frames with an untied head: no lookup)."""
        cfg = self.cfg
        if cfg.input_mode == "frames" and not cfg.tie_embeddings:
            return self
        return self._gathered("embed")

    def _check_dispatch(self, rows: int, S: int, dispatch_ranks: int) -> None:
        check_dispatch_split(self.cfg, dispatch_ranks, rows * dispatch_ranks, S)

    def _logits(self, batch: dict, *, remat: bool = True, chunk: int = 1024,
                dispatch_ranks: int = 1):
        """(logits, tp): `forward`'s logits, the rank's vocab slice of them
        where the head is split along "model" (then `tp` is the model's
        `ModelRegion`, else None)."""
        cfg = self.cfg
        tp = tensor.region(self.fsdp)
        w_in = self._embed_in()
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
        logits = self._head_logits(w_in, x, tp)
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
    def prefill(self, batch: dict, max_len: int, *, dispatch_ranks: int = 1):
        """Run the prompt: (last-position logits [B, V], filled caches).

        The attention caches hold positions [0, S); mamba states carry the
        last recurrent state.  On a sharded model `batch` is the rank's rows
        and the caches its block (module docstring).  `dispatch_ranks`: the
        data-parallel ranks that share the batch's rows, for the MoE
        dispatch groups (`moe_forward`); where they cannot split the groups,
        ValueError (`check_dispatch_split`)."""
        cfg = self.cfg
        B, S = next(iter(batch.values())).shape[:2]
        if S > max_len:
            raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
        self._check_dispatch(B, S, dispatch_ranks)  # before any collective
        w_in = self._embed_in()
        x = embed_inputs(w_in, cfg, batch, tensor.region(self.fsdp))
        positions = torch.arange(S, device=x.device)
        caches = self.init_caches(B, max_len)
        for g in range(len(self.groups)):
            x = self._group_fn(g)(cfg, x, positions, backend=self.backend, caches=caches, g=g,
                                  dispatch_ranks=dispatch_ranks)
        return self._whole_logits(w_in, x[:, -1:, :])[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, caches: dict, tokens: torch.Tensor, position: int, *,
                    dispatch_ranks: int = 1):
        """tokens [B] at `position` -> (logits [B, V], caches updated in place).
        On a sharded model the rank's rows and cache block (`prefill`)."""
        position = int(position)
        self._check_dispatch(tokens.shape[0], 1, dispatch_ranks)
        w_in = self._gathered("embed")
        x = lookup(w_in.embed, tokens[:, None], tensor.region(self.fsdp))
        for g in range(len(self.groups)):
            x = self._group_fn(g)(self.cfg, x, None, caches=caches, g=g, position=position,
                                  dispatch_ranks=dispatch_ranks)
        return self._whole_logits(w_in, x)[:, 0, :], caches
