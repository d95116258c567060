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

Under data parallelism a rank holds 1/R of a batch's rows and is told R
(`moe_forward(ranks=R)`): it dispatches its G / R groups of the whole
batch's group size T, so that each group, and each drop, is the one-device
step's.  The train step first checks that the rows make whole groups
(`check_dispatch_split`).

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

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers.mlp import _act


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
    m = cfg.moe
    G = min(m.n_dispatch_groups, B * S)
    while (B * S) % G:
        G //= 2
    T = B * S // G
    return G, T, max(int(T * m.top_k / m.n_experts * m.capacity_factor), 1)


def check_dispatch_split(cfg, ranks: int, rows: int | None = None, S: int = 1) -> None:
    """Raise ValueError unless each of `ranks` ranks, holding rows / ranks of
    a batch of `rows` x S tokens, holds whole dispatch groups of it.  With
    `rows` None, for every batch of n_dispatch_groups tokens or more (which
    makes n_dispatch_groups groups): the check a step makes when it is built."""
    if cfg.moe is None or ranks == 1:
        return
    n = cfg.moe.n_dispatch_groups
    G = n if rows is None else dispatch_shape(cfg, rows, S)[0]
    if G % ranks == 0:
        return
    what = (f"every global batch of {n} tokens or more" if rows is None else
            f"a global (micro-)batch of {rows} x {S} tokens")
    if n % ranks:
        fits = f"no global batch of {n} tokens or more would divide (n_dispatch_groups = {n})"
    else:
        # A batch of n tokens or more, a multiple of R rows, makes n groups.
        first = ranks * (rows // ranks + 1)
        b = next(b for b in range(first, first + ranks * n, ranks)
                 if dispatch_shape(cfg, b, S)[0] % ranks == 0)
        fits = f"a global (micro-)batch of {b} x {S} tokens would divide"
    raise ValueError(f"{cfg.name}: {what} makes G = {G} MoE dispatch groups, which R = {ranks} "
                     f"data-parallel ranks cannot split into whole groups (G % R != 0), and "
                     f"capacity drops depend on the split; {fits}")


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


def moe_forward(p, cfg, x: torch.Tensor, ranks: int = 1, tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] through the top-k routed experts, dropping
    the choices past an expert's capacity in each dispatch group.  `ranks`:
    the data-parallel ranks that hold a batch's rows, B each, whose split
    `check_dispatch_split` has passed; x makes G / ranks of the groups of
    the whole batch of B * ranks rows.  `tp`: the layer's `ModelRegion`
    under expert parallelism (module docstring); where it does not split
    the experts the layer runs whole."""
    m = cfg.moe
    B, S, d = x.shape
    G, T, cap = dispatch_shape(cfg, B * ranks, S)
    G //= ranks
    E = m.n_experts
    xt = x.reshape(G, T, d)
    top_p, top_e = _route(p, cfg, xt)
    if tp is not None and not tp.split("w_in"):
        tp = None
    xd = xt if tp is None else tp.copy(xt)  # the dispatch's input
    out = torch.zeros((G, T, d), dtype=torch.float32, device=x.device)

    if m.dispatch == "sort":
        token_for_slot, slot_valid, slot, keep = _dispatch_sort(top_e, T, E, cap)
        idx_in = token_for_slot.reshape(G, E * cap, 1).expand(G, E * cap, d)
        buf = torch.gather(xd, 1, idx_in).reshape(G, E, cap, d)
        buf = buf * slot_valid[..., None].to(buf.dtype)
        y_flat = _expert_mm(p, cfg, buf, tp).reshape(G, E * cap, d)
        for k in range(m.top_k):
            idx_out = (top_e[:, :, k] * cap + slot[:, :, k])[..., None].expand(G, T, d)
            gathered = torch.gather(y_flat, 1, idx_out)  # [G, T, d]
            w = (top_p[:, :, k] * keep[:, :, k])[..., None]
            out = out + w * gathered.float()
        return out.reshape(B, S, d).to(x.dtype)
    if m.dispatch != "scatter":
        raise ValueError(f"unknown MoE dispatch {m.dispatch!r}; known: sort, scatter")

    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, T)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    buf = torch.zeros((G, E, cap, d), dtype=x.dtype, device=x.device)
    slots, keeps = [], []
    for k in range(m.top_k):
        e_k = top_e[:, :, k]  # [G, T]
        onehot = F.one_hot(e_k, E)  # [G, T, E]
        ranks = torch.cumsum(onehot, dim=1) - onehot  # exclusive prefix count
        slot = torch.gather(ranks, 2, e_k[..., None])[..., 0] + torch.gather(counts, 1, e_k)
        keep = slot < cap
        slot = torch.where(keep, slot, cap - 1)
        buf.index_put_((g_idx, e_k, slot), torch.where(keep[..., None], xd, 0).to(buf.dtype),
                       accumulate=True)
        counts = counts + onehot.sum(dim=1)
        slots.append(slot)
        keeps.append(keep)
    y = _expert_mm(p, cfg, buf, tp)
    for k in range(m.top_k):
        gathered = y[g_idx, top_e[:, :, k], slots[k]]  # [G, T, d]
        w = (top_p[:, :, k] * keeps[k])[..., None]
        out = out + w * gathered.float()
    return out.reshape(B, S, d).to(x.dtype)
