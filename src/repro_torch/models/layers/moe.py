"""Mixture-of-Experts with capacity-based dispatch inside token groups.

Tokens are reshaped into `n_dispatch_groups` groups and slot assignment runs
within each group: every expert takes at most `cap` tokens of a group, and a
choice past its expert's capacity is dropped (its weight is zero).  The
expert products run on every expert's `cap` slots, full or not, as two
batched matrix products over the experts.

Two dispatch formulations compute the same function:

- `dispatch="sort"` (the default): argsort the flat choices by expert,
  locate each expert's run with `searchsorted`, and gather the slot buffer;
  the combine undoes the sort.  A choice's rank within its expert's run is
  its position among the group's choices in (token, k) order.
- `dispatch="scatter"`: one-hot prefix counts per k, then an accumulating
  `index_put_` into the slot buffer.  Its ranks count choice k of every
  token before choice k + 1, so under drops the two keep different choices.

The group split, the capacity and both rank orders are the JAX package's
(`repro/models/layers/moe.py`), so a prefill and a decode step drop the same
choices there and here.  The router's logits, softmax and top-k run in f32
whatever the model's dtype, and the router parameter is kept in f32.

Under data parallelism a rank holds 1/R of a batch's rows and is told its
place (`moe_forward(split=DataSplit(R, index, group))`, built by
`data_split`), so that each group, its capacity and each drop are the
one-device step's:
- where R divides G, the rank's rows make G / R whole groups of the whole
  batch's group size T, which it dispatches alone;
- where G divides R, each group's rows lie on a span of s = R / G
  consecutive batch shards (`index // s` is the rank's group, `index % s`
  its place in it, `group` the span's process group,
  `repro_torch.parallel.fsdp.span_group`).  The rank routes its T / s
  tokens, all-gathers the span's choices top_e [T / s, K] (integers, no
  gradient; `fsdp.WIRE` site "moe-choices", along "data") into the group's
  [T, K] in (token, k) order, and dispatches the whole group on them: the
  group's capacity, ranks and drops.  Its slot buffer holds only the slots
  whose token is its own (the others stay zero, as empty slots do), the
  expert products run on the whole buffer, and the rank combines its own
  tokens.  The experts' gradient on a rank comes from its tokens' slots,
  and the step sums it over "data" with the rest.  Gathering the choices
  moves T / s x K integers a layer where gathering the tokens would move
  T / s x d activations.  The remat recompute gathers them again and gets
  the same bits.
Where neither divides the other, `check_dispatch_split` raises
ValueError: no split falls back to gathering the whole batch.

Under expert parallelism (the JAX rule ep -> "model", `moe_forward(tp=)`
with the layer's `repro_torch.parallel.tensor.ModelRegion`) each of the M
ranks along "model" holds E / M experts, a contiguous range from
mindex * E / M, of w_in and w_out; the ranks of a row take the same rows.
The router reads the tokens outside the region and keeps its whole
gradient on every rank.  The dispatch reads them through `region.copy`
(their gradient summed over "model" backward) and builds the one-device
step's slot buffer [G, E, cap, d]: the same groups, capacity and drops.
`_expert_mm` narrows it to the rank's experts, runs their products and
all-gathers the outputs along the expert dimension (the JAX formulation's
replication of y across the expert axis before the combine), so the
combine runs on the whole y and sums the top-k terms in the one-device
order.  A local combine and a `region.reduce` would move fewer bytes (an
f32 [G, T, d] all-reduce against E * cap * d a group gathered) but sum the
top-k terms in another order, and depart from the JAX formulation that the
dry run counts against.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers.mlp import _act
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import make_rules, rank_rows

CHOICES_SITE = "moe-choices"  # the span's all-gather of the routing choices (`fsdp.WIRE`)


class MoE(nn.Module):
    """router [d, E] (f32), w_in [E, d, 2, F] (gate and up), w_out [E, F, d]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        self.router = nn.Parameter(torch.empty(d, m.n_experts, device=device,
                                               dtype=torch.float32))
        self.w_in = nn.Parameter(torch.empty(m.n_experts, d, 2, m.d_ff_expert, device=device,
                                             dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(m.n_experts, m.d_ff_expert, d, device=device,
                                              dtype=dtype))

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        d, ff = cfg.d_model, cfg.moe.d_ff_expert
        with torch.no_grad():
            self.router.normal_(generator=gen).mul_(d**-0.5)
            self.w_in.normal_(generator=gen).mul_(d**-0.5)
            self.w_out.normal_(generator=gen).mul_(ff**-0.5)


def moe_specs(cfg) -> dict:
    """Logical-axis templates of the MoE layer's parameters (`repro_torch.parallel`)."""
    return {
        "router": (None, None),
        "w_in": ("ep", "fsdp", None, None),
        "w_out": ("ep", None, "fsdp"),
    }


def dispatch_shape(cfg, B: int, S: int) -> tuple[int, int, int]:
    """(G, T, cap): dispatch groups, tokens per group, slots per expert.

    G starts at min(n_dispatch_groups, B * S) and halves until it divides
    B * S; cap = max(int(T * top_k / n_experts * capacity_factor), 1)."""
    G = min(cfg.moe.n_dispatch_groups, B * S)
    while (B * S) % G:
        G //= 2
    T = B * S // G
    return G, T, _capacity(cfg, T)


def _capacity(cfg, T: int) -> int:
    """Slots per expert of a group of T tokens."""
    m = cfg.moe
    return max(int(T * m.top_k / m.n_experts * m.capacity_factor), 1)


def check_dispatch_split(cfg, ranks: int, rows: int | None = None, S: int = 1) -> None:
    """Raise ValueError unless `ranks` data-parallel ranks, each holding
    rows / ranks of a batch of `rows` x S tokens, can dispatch its G groups:
    R divides G (whole groups a rank) or G divides R (each group on a span
    of R / G ranks).  With `rows` None, for every batch of n_dispatch_groups
    tokens or more (which makes n_dispatch_groups groups): the check a step
    makes when it is built."""
    if cfg.moe is None or ranks == 1:
        return
    n = cfg.moe.n_dispatch_groups
    G = n if rows is None else dispatch_shape(cfg, rows, S)[0]
    if _splits(G, ranks):
        return
    what = (f"every global batch of {n} tokens or more" if rows is None else
            f"a global (micro-)batch of {rows} x {S} tokens")
    fits = f"no global batch of {n} tokens or more would split (n_dispatch_groups = {n})"
    if rows is not None:
        first = ranks * (rows // ranks + 1)
        b = next((b for b in range(first, first + ranks * n, ranks)
                  if _splits(dispatch_shape(cfg, b, S)[0], ranks)), None)
        if b is not None:
            fits = f"a global (micro-)batch of {b} x {S} tokens would split"
    raise ValueError(f"{cfg.name}: {what} makes G = {G} MoE dispatch groups on R = {ranks} "
                     f"data-parallel ranks, and neither divides the other: the ranks can "
                     f"neither hold whole groups (R | G) nor share each group over a span of "
                     f"R / G ranks (G | R), and capacity drops depend on the split; {fits}")


def _splits(G: int, R: int) -> bool:
    return G % R == 0 or R % G == 0


@dataclass(frozen=True)
class DataSplit:
    """A data-parallel rank's place in a batch (module docstring): `ranks`
    (R) ranks take rows / R each, this rank batch shard `index` of them
    (`rank_rows`' order), and `group` is the process group of the ranks
    whose rows share its dispatch group, in batch-shard order (None where
    no group spans ranks, and on the meta device, where the gather is
    counted and not run)."""
    ranks: int = 1
    index: int = 0
    group: object = None


def data_split(cfg, rows: int, S: int, mesh, rank: int, group=None) -> DataSplit:
    """The `DataSplit` of `rank` on `mesh` for a global (micro-)batch of
    `rows` x S tokens, the rank taking its `rank_rows` (every row where the
    data axes do not divide the batch: R = 1).  Raises ValueError where the
    ranks cannot split the dispatch groups (`check_dispatch_split`).  Where
    a group spans ranks, `group` (the process group of `mesh`'s ranks, None
    on the meta device) gives the span's (`fsdp.span_group`, which every
    rank of the default group makes together)."""
    mine = rank_rows(rows, mesh, make_rules(mesh), rank)
    R = rows // len(mine)
    check_dispatch_split(cfg, R, rows, S)
    span = 1 if cfg.moe is None else max(R // dispatch_shape(cfg, rows, S)[0], 1)
    return DataSplit(R, mine.start // len(mine),
                     None if span == 1 or group is None else fsdp.span_group(group, mesh, span))


def _route(p, cfg, xt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Router: xt [G, T, d] -> (top_p, top_e) [G, T, K], in f32.

    Top-k is a stable descending sort, so tied probabilities rank the lower
    expert first, as `jax.lax.top_k` does (`torch.topk` promises no order
    on ties)."""
    m = cfg.moe
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :m.top_k], top_e[..., :m.top_k]
    if m.router_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_e


def _expert_mm(p, cfg, buf: torch.Tensor, tp=None) -> torch.Tensor:
    """[G, E, cap, d] -> [G, E, cap, d]: each expert's gated MLP on its slots,
    as two batched products over the experts.  With `tp` (a region whose
    experts are split along "model") the rank runs its experts, E / M of
    them as its w_in block holds, on their slots and all-gathers the
    outputs along the expert dimension.  An expert block that does not
    hold E / M of the slots' E experts raises ValueError."""
    G, E, cap, d = buf.shape
    n, ff = p.w_out.shape[0], p.w_out.shape[1]
    M = 1 if tp is None else tp.size
    if n * M != E or p.w_in.shape[0] != n:
        raise ValueError(f"MoE experts: blocks w_in {tuple(p.w_in.shape)} and w_out "
                         f"{tuple(p.w_out.shape)} on {M} rank(s) along \"model\" do not hold "
                         f"E / M experts of slot buffer {tuple(buf.shape)} (E = {E})")
    if tp is not None:
        buf = buf.narrow(1, tp.index * n, n)
    x = buf.transpose(0, 1).reshape(n, G * cap, d)
    gu = torch.bmm(x, p.w_in.reshape(n, d, 2 * ff)).unflatten(-1, (2, ff))
    h = _act(cfg.act, gu[..., 0, :]) * gu[..., 1, :]
    y = torch.bmm(h, p.w_out).reshape(n, G, cap, d)
    if tp is not None:
        y = tp.gather(y, 0)
    return y.transpose(0, 1)


def _dispatch_sort(top_e: torch.Tensor, T: int, E: int, cap: int):
    """Sort-based slot assignment.

    Returns (token_for_slot [G, E, cap], slot_valid [G, E, cap],
    slot_of_choice [G, T, K], keep [G, T, K])."""
    G, _, K = top_e.shape
    TK = T * K
    dev = top_e.device
    e_flat = top_e.reshape(G, TK)
    ar = torch.arange(TK, device=dev)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    tok_sorted = torch.gather((ar // K).expand(G, TK), 1, order)
    experts = torch.arange(E, device=dev)
    start = torch.searchsorted(e_sorted, experts.expand(G, E).contiguous())  # [G, E]
    rank = ar[None, :] - torch.gather(start, 1, e_sorted)  # position within the expert's run
    # slot -> token (gather side)
    pos = start[:, :, None] + torch.arange(cap, device=dev)[None, None, :]  # [G, E, cap]
    pos_c = pos.clamp_max(TK - 1).reshape(G, E * cap)
    e_at = torch.gather(e_sorted, 1, pos_c).reshape(G, E, cap)
    valid = (pos < TK) & (e_at == experts[None, :, None])
    token_for_slot = torch.where(valid, torch.gather(tok_sorted, 1, pos_c).reshape(G, E, cap), 0)
    # choice -> slot (combine side): undo the sort
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(G, TK))
    rank_tm = torch.gather(rank, 1, inv).reshape(G, T, K)
    keep = rank_tm < cap
    return token_for_slot, valid, torch.where(keep, rank_tm, cap - 1), keep


def _scatter_slots(top_e: torch.Tensor, E: int, cap: int):
    """The scatter formulation's slots: per k, (slot [G, T], keep [G, T]) of
    choice k of every token, counting choice k of every token before choice
    k + 1 (one-hot prefix counts)."""
    counts = torch.zeros(top_e.shape[0], E, dtype=torch.int64, device=top_e.device)
    out = []
    for k in range(top_e.shape[2]):
        e_k = top_e[:, :, k]  # [G, T]
        onehot = F.one_hot(e_k, E)  # [G, T, E]
        before = torch.cumsum(onehot, dim=1) - onehot  # exclusive prefix count
        slot = torch.gather(before, 2, e_k[..., None])[..., 0] + torch.gather(counts, 1, e_k)
        keep = slot < cap
        out.append((torch.where(keep, slot, cap - 1), keep))
        counts = counts + onehot.sum(dim=1)
    return out


def _keeps(cfg, top_e: torch.Tensor, T: int, cap: int) -> torch.Tensor:
    """keep [G, T, K]: which choices of groups of T tokens the config's
    dispatch keeps at capacity `cap`."""
    if cfg.moe.dispatch == "sort":
        return _dispatch_sort(top_e, T, cfg.moe.n_experts, cap)[3]
    return torch.stack([keep for _, keep in _scatter_slots(top_e, cfg.moe.n_experts, cap)], -1)


def _span_choices(top_e: torch.Tensor, span: int, group) -> torch.Tensor:
    """The span's choices [1, T, K], every rank's [1, T / s, K] in
    batch-shard order: one all-gather along "data" (site "moe-choices")."""
    _, Tl, K = top_e.shape
    out = top_e.new_empty(span * Tl * K)
    with fsdp.WIRE.at(CHOICES_SITE):
        fsdp.all_gather_into(out, top_e.contiguous().view(-1), group, span, "data")
    return out.view(1, span * Tl, K)


def moe_forward(p, cfg, x: torch.Tensor, split: DataSplit | None = None,
                tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] through the top-k routed experts, dropping
    the choices past an expert's capacity in each dispatch group.  `split`:
    the rank's place among the data-parallel ranks that hold a batch's
    rows, B each (None: one rank holds them all); x makes G / R of the
    groups of the whole batch of B * R rows, or its share of one group that
    spans R / G ranks (module docstring).  `tp`: the layer's `ModelRegion`
    under expert parallelism (module docstring); where it does not split
    the experts the layer runs whole."""
    m = cfg.moe
    split = split or DataSplit()
    B, S, d = x.shape
    G, T, cap = dispatch_shape(cfg, B * split.ranks, S)
    span = max(split.ranks // G, 1)  # the ranks that share one group
    G = max(G // split.ranks, 1)
    Tl = T // span  # the rank's tokens of each of its groups
    off = split.index % span * Tl  # where they start in the group
    E = m.n_experts
    xt = x.reshape(G, Tl, d)
    top_p, top_e = _route(p, cfg, xt)
    whole_e = top_e if span == 1 else _span_choices(top_e, span, split.group)
    if tp is not None and not tp.split("w_in"):
        tp = None
    xd = xt if tp is None else tp.copy(xt)  # the dispatch's input
    out = torch.zeros((G, Tl, d), dtype=torch.float32, device=x.device)

    if m.dispatch == "sort":
        token_for_slot, slot_valid, slot, keep = _dispatch_sort(whole_e, T, E, cap)
        if span > 1:  # the slots of the rank's own tokens, its choices' slots
            slot_valid = slot_valid & (token_for_slot >= off) & (token_for_slot < off + Tl)
            token_for_slot = torch.where(slot_valid, token_for_slot - off, 0)
            slot, keep = slot[:, off:off + Tl], keep[:, off:off + Tl]
        idx_in = token_for_slot.reshape(G, E * cap, 1).expand(G, E * cap, d)
        buf = torch.gather(xd, 1, idx_in).reshape(G, E, cap, d)
        buf = buf * slot_valid[..., None].to(buf.dtype)
        y_flat = _expert_mm(p, cfg, buf, tp).reshape(G, E * cap, d)
        for k in range(m.top_k):
            idx_out = (top_e[:, :, k] * cap + slot[:, :, k])[..., None].expand(G, Tl, d)
            gathered = torch.gather(y_flat, 1, idx_out)  # [G, Tl, d]
            w = (top_p[:, :, k] * keep[:, :, k])[..., None]
            out = out + w * gathered.float()
        return out.reshape(B, S, d).to(x.dtype)
    if m.dispatch != "scatter":
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}; known: sort, scatter")

    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tl)
    buf = torch.zeros((G, E, cap, d), dtype=x.dtype, device=x.device)
    # the group's slots, of the rank's own choices
    slots = [(slot[:, off:off + Tl], keep[:, off:off + Tl])
             for slot, keep in _scatter_slots(whole_e, E, cap)]
    for k, (slot, keep) in enumerate(slots):
        buf.index_put_((g_idx, top_e[:, :, k], slot),
                       torch.where(keep[..., None], xd, 0).to(buf.dtype), accumulate=True)
    y = _expert_mm(p, cfg, buf, tp)
    for k, (slot, keep) in enumerate(slots):
        gathered = y[g_idx, top_e[:, :, k], slot]  # [G, Tl, d]
        w = (top_p[:, :, k] * keep)[..., None]
        out = out + w * gathered.float()
    return out.reshape(B, S, d).to(x.dtype)
