"""GQA attention: the full-sequence forward for prefill and scoring, and a
cache-reading decode step.  RoPE, qk-norm, logit soft-capping and
sliding-window masking, as in the JAX package.

The full-sequence forward calls the hand-written kernel
(`repro_torch.kernels.ops.flash_attention`) where the JAX layer calls its
jnp analogue, `blocked_attention`, "the oracle and the XLA fallback path" of
the Pallas kernel: the function is the same.  `blocked_attention` is ported
too, and runs with `backend="ref"` as the model's plain version.  With grad
on, the kernel's gradient is `blocked_attention`'s
(`repro_torch.kernels.autograd.FlashAttentionFn`), as the JAX package
differentiates its training forward.

Under tensor parallelism (`tp`, a `repro_torch.parallel.tensor.ModelRegion`
whose "wq" is split along "model") the layer runs on the rank's heads:
wq column-parallel (and wk, wv where kv -> "model"), the kernel on the
rank's query heads and the KV heads they read, wo row-parallel, its output
summed over "model".  Its widths come from the blocks' shapes.  The rank's
block of the KV caches is JAX's `cache_specs` block: its rows and every KV
head, on its block of the sequence along "model" (sp -> "model") or the
whole sequence where the axis does not divide it.  The prefill keeps that
block of the prompt's k and v (`cache_block`); the decode step writes the
new token on the rank that holds its position and, over a split sequence,
scores every query head against the rank's block and combines the ranks'
partial softmaxes across the row (`decode_attention`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.autograd import FlashAttentionFn, needs_grad
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import BACKENDS
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.layers.rope import apply_rope


class Attention(nn.Module):
    """wq [d, H, hd], wk and wv [d, KV, hd], wo [H, hd, d]; q_norm and k_norm
    [hd] with qk-norm."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, KV, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, KV, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, d, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(hd, **kw))
            self.k_norm = nn.Parameter(torch.empty(hd, **kw))

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        s = cfg.d_model**-0.5
        with torch.no_grad():
            for w in (self.wq, self.wk, self.wv):
                w.normal_(generator=gen).mul_(s)
            self.wo.normal_(generator=gen).mul_((cfg.n_heads * cfg.head_dim) ** -0.5)
            if cfg.qk_norm:
                self.q_norm.zero_()
                self.k_norm.zero_()


def attn_specs(cfg) -> dict:
    """Logical-axis templates of the attention parameters (`repro_torch.parallel`):
    "kv" maps to the model axis only where n_kv divides it."""
    p = {
        "wq": ("fsdp", "tp", None),
        "wk": ("fsdp", "kv", None),
        "wv": ("fsdp", "kv", None),
        "wo": ("tp", None, "fsdp"),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, n, hd] -> [B, S, n, hd]."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).unflatten(-1, (n, hd))


def _q(p, cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] -> q [B, S, H, hd], with the optional qk-norm and RoPE."""
    q = _proj(x, p.wq)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def _kv(p, cfg, x: torch.Tensor, positions: torch.Tensor, kv: slice = slice(None)):
    """x [B, S, d] -> k and v [B, S, KV, hd] (the KV heads `kv` of wk and
    wv), k with the optional qk-norm and RoPE."""
    k, v = _proj(x, p.wk[:, kv]), _proj(x, p.wv[:, kv])
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta), v


def _qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor, kv: slice = slice(None)):
    """x [B, S, d] -> q [B, S, H, hd], k and v [B, S, KV, hd] (the KV heads
    `kv` of wk and wv), with RoPE and the optional qk-norm."""
    return (_q(p, cfg, x, positions), *_kv(p, cfg, x, positions, kv))


def rank_kv_heads(p, tp) -> slice:
    """The KV heads the rank's query heads read, of wk and wv as the rank
    holds them: where kv -> "model" split them, all of its block; where it
    was dropped (wk, wv whole), query head h reads KV head h // (H / KV), so
    the rank's H / M heads read a contiguous run of them.  A run the kernel
    cannot pair with the heads by its own grouping (the heads do not split
    evenly over it) raises ValueError naming the shapes."""
    if tp.split("wk"):
        return slice(None)
    H_rank, KV = p.wq.shape[1], p.wk.shape[1]
    H = H_rank * tp.size
    G = H // KV
    first = tp.index * H_rank
    kv0, kv1 = first // G, (first + H_rank - 1) // G + 1
    n = kv1 - kv0
    if H_rank % n or any((first + j) // G - kv0 != j // (H_rank // n) for j in range(H_rank)):
        raise ValueError(f"{H_rank} query heads a rank (wq {tuple(p.wq.shape)} of {H} heads) "
                         f"against the whole wk {tuple(p.wk.shape)}: rank {tp.index}'s heads "
                         f"read KV heads {kv0}..{kv1 - 1} unevenly")
    return slice(kv0, kv1)


def _mask_bias(q_pos, kv_pos, causal: bool, window: int | None) -> torch.Tensor:
    """[S_q, S_kv] additive mask in f32."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= kv_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _softcap(scores: torch.Tensor, cap) -> torch.Tensor:
    return scores if cap is None else cap * torch.tanh(scores / cap)


def blocked_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None, softcap=None,
                      chunk: int = 1024, score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Online-softmax attention over KV chunks, as the JAX layer's jnp path.

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] (H % KV == 0) -> [B, Sq, H, hd].
    The scores leave the product in the inputs' dtype and are taken to
    `score_dtype` (f32: f64 inputs stay f64); max and sum statistics are
    f32.  With bf16 scores the chunk's score buffers are bf16 as in the JAX
    function: the scaled, softcapped and masked score (the scale, the cap
    and the mask value are bf16 constants, as JAX takes a Python float
    against a bf16 array), s - m_new and p, and each chunk's sum of p (a
    bf16 sum, as `jnp.sum` of a bf16 array is); m, l and acc stay f32.
    Unlike the JAX function, the last chunk may be short (Skv need not be a
    multiple of `chunk`); where the JAX function runs, the two compute the
    same thing.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, Skv)
    work = torch.promote_types(q.dtype, torch.float32)  # f64 inputs stay f64
    sd, scale, cap = work, hd**-0.5, softcap
    if score_dtype != torch.float32:  # JAX's Python-float constants meet a bf16 array
        sd = score_dtype
        scale = torch.tensor(scale, dtype=sd, device=q.device)
        cap = None if softcap is None else torch.tensor(softcap, dtype=sd, device=q.device)
    qg = q.reshape(B, Sq, KV, G, hd)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=work, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=work, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=work, device=q.device)
    for c0 in range(0, Skv, chunk):
        kb, vb, pb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], kv_pos[c0:c0 + chunk]
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kb).to(sd) * scale
        s = _softcap(s, cap)
        s = s + _mask_bias(q_pos, pb, causal, window).to(sd)[None, :, None, None, :]
        m_new = torch.maximum(m, s.amax(-1).to(work))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None].to(sd))
        l = l * alpha + p.sum(-1).to(work)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p.to(vb.dtype), vb).to(work)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor, *, local: bool = False,
                      backend: str = "cuda", chunk: int = 1024, tp=None):
    """Full-sequence attention (prefill, scoring).  x [B, S, d], positions
    arange(S) (the kernel assumes query and key positions are both that).

    Returns (out [B, S, d], (k, v)) with k, v [B, S, KV, hd] for the cache.
    `backend="cuda"` runs the kernel (its plain version on CPU tensors),
    `"ref"` the ported jnp path, `blocked_attention`, in chunks of `chunk`.
    With grad on and an input that requires it, `"cuda"` keeps the kernel in
    the forward and takes `blocked_attention`'s gradient (chunks of `chunk`).
    `tp`: the layer's `ModelRegion` (module docstring); k and v are then the
    rank's KV heads.
    """
    score_dtype = getattr(torch, cfg.attn_score_dtype)
    heads = tp is not None and tp.split("wq")
    if heads:
        x = tp.copy(x)
    q, k, v = _qkv(p, cfg, x, positions, rank_kv_heads(p, tp) if heads else slice(None))
    window = cfg.window if local else None
    if backend == "cuda" and needs_grad(q, k, v):
        out = FlashAttentionFn.apply(q, k, v, cfg.causal, window, cfg.attn_softcap, chunk,
                                     score_dtype)
    elif backend == "cuda":
        out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                  softcap=cfg.attn_softcap, score_dtype=score_dtype)
    elif backend == "ref":
        pos1d = positions if positions.ndim == 1 else positions[0]
        out = blocked_attention(q, k, v, pos1d, pos1d, causal=cfg.causal, window=window,
                                softcap=cfg.attn_softcap, chunk=chunk, score_dtype=score_dtype)
    else:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    H, hd, d = p.wo.shape
    out = out.reshape(*out.shape[:2], H * hd) @ p.wo.reshape(H * hd, d)
    return (tp.reduce(out) if heads else out), (k, v)


def cache_kv_heads(p, tp) -> slice:
    """The KV heads of the caches (which hold every KV head) that the rank's
    query heads read: its block of wk's heads where kv -> "model", else the
    run `rank_kv_heads` gives (which raises on an uneven run)."""
    if tp.split("wk"):
        n = p.wk.shape[1]
        return slice(tp.index * n, (tp.index + 1) * n)
    return rank_kv_heads(p, tp)


def cache_block(p, cfg, x: torch.Tensor, positions: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, seq: range | None, tp=None):
    """The prefill's entries of the rank's block of the attention caches: k
    and v of every KV head at the prompt's positions in `seq` (the rank's
    block of the caches' sequence along "model"; None: the whole sequence),
    [B, n, KV, hd], n = 0 for a block beyond the prompt.

    x [B, S, d] and positions: `attention_forward`'s inputs; k and v
    [B, S, KV_r, hd]: its outputs, the rank's KV heads under `tp`.  Where
    kv -> "model" the ranks' KV heads are gathered along "model" (one
    all-gather of k and v, on every rank of the row whatever its block);
    where kv was dropped (wk and wv whole, k and v the run of KV heads the
    rank's query heads read) the rank projects every KV head at its block's
    positions; else k and v hold every KV head already."""
    S = k.shape[1]
    lo, hi = (0, S) if seq is None else (min(seq.start, S), min(seq.stop, S))
    heads = tp is not None and tp.split("wq")
    if heads and tp.split("wk"):
        k, v = tp.gathered(k, v, dim=2)
    elif heads:
        return _kv(p, cfg, x[:, lo:hi], positions[..., lo:hi])
    return k[:, lo:hi], v[:, lo:hi]


def decode_attention(p, cfg, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     position: int, *, local: bool = False, tp=None, seq: range | None = None):
    """One-token decode against a KV cache.

    x [B, 1, d]; cache_k and cache_v [B, S, KV, hd], every KV head: the
    positions of `seq` (the rank's block of the sequence along "model"), or
    the whole sequence where `seq` is None; position: index of the new
    token.  The rank whose caches hold `position` writes the token's k and v
    of every KV head there in place (the JAX function returns updated
    copies); returns (out [B, 1, d], cache_k, cache_v).  `tp`: the layer's
    `ModelRegion` (module docstring): q on the rank's heads, wo
    row-parallel, its output summed over "model"; where kv -> "model" each
    rank projects its KV heads and the ranks' are gathered for the write,
    where kv was dropped (wk, wv whole) the writing rank projects them all.

    The whole sequence: the rank's query heads read their KV heads of the
    caches (`cache_kv_heads`), as on one device.  A sequence split along
    "model": every rank scores every query head against its block, with
    the causal and window masks of the block's absolute positions, and the
    ranks' partial softmaxes are combined across the row.  The collectives,
    in order:
    1. one all-gather along "model" of the rank's q (and k, v where kv ->
       "model"): every query head on every rank;
    2. an all-reduce MAX of the rows' score maxima [B, H]: the global max
       M, taken before any exponential, so that a block the masks cover
       whole (every score NEG_INF, the finite -1e30) weighs exp(-1e30 - M)
       = 0 exactly;
    3. one reduce-scatter of the f32 partial sums [B, H] of exp(s - M) and
       [B, H, hd] of the weighted values: each rank keeps the sums of its
       own query heads (an all-reduce of them where wq is whole along
       "model") and divides.
    Each is a region operator counted on `fsdp.WIRE`; none builds a graph.
    The sums run in another order than one device's softmax: equal within
    rounding, not bit for bit.  The ranks of a row end bit-alike, through
    the all-reduce after wo (or of the sums, where wq is whole).
    """
    B, hd = x.shape[0], cache_k.shape[3]
    heads = tp is not None and tp.split("wq")
    kv_split = heads and tp.split("wk")
    if heads:
        x = tp.copy(x)
    pos = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    first = 0 if seq is None else seq.start
    mine = first <= position < first + cache_k.shape[1]
    q = _q(p, cfg, x, pos)
    k = v = None
    if kv_split or mine:
        k, v = _kv(p, cfg, x, pos)
    if seq is not None and heads:  # every query head on every rank
        q, *kv = tp.gathered(q, *((k, v) if kv_split else ()), dim=2)
        k, v = kv if kv_split else (k, v)
    elif kv_split:
        k, v = tp.gathered(k, v, dim=2)
    if mine:
        cache_k[:, position - first] = k[:, 0].to(cache_k.dtype)
        cache_v[:, position - first] = v[:, 0].to(cache_v.dtype)
    if seq is None:
        kv = cache_kv_heads(p, tp) if heads else slice(None)
        out = _decode_whole(cfg, q, cache_k[:, :, kv], cache_v[:, :, kv], position, local)
    else:
        out = _decode_block(cfg, q, cache_k, cache_v, position, local, seq, tp, heads)
    H_r = p.wo.shape[0]
    out = out.reshape(B, 1, H_r * hd) @ p.wo.reshape(H_r * hd, -1)
    return (tp.reduce(out) if heads else out), cache_k, cache_v


def _scores(cfg, q, cache_k, kv_pos, position: int, local: bool) -> torch.Tensor:
    """q [B, 1, H, hd] against cache_k [B, S, KV, hd] at positions `kv_pos`
    [S]: the f32 scaled, softcapped and masked scores [B, KV, G, S]."""
    B, _, H, hd = q.shape
    KV = cache_k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, cache_k).float() * hd**-0.5
    s = _softcap(s, cfg.attn_softcap)
    ok = kv_pos <= position
    if local and cfg.window is not None:
        ok &= kv_pos > (position - cfg.window)
    return s.masked_fill(~ok, NEG_INF)


def _decode_whole(cfg, q, cache_k, cache_v, position: int, local: bool) -> torch.Tensor:
    """Softmax attention of q [B, 1, H, hd] over the whole caches, as the JAX
    function: [B, KV, G, hd] in the caches' dtype."""
    kv_pos = torch.arange(cache_k.shape[1], device=q.device)
    prob = torch.softmax(_scores(cfg, q, cache_k, kv_pos, position, local), dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", prob.to(cache_v.dtype), cache_v)


def _decode_block(cfg, q, cache_k, cache_v, position: int, local: bool, seq: range, tp,
                  heads: bool) -> torch.Tensor:
    """Attention of every query head q [B, 1, H, hd] over the rank's block
    of the sequence, combined across the row (`decode_attention`'s steps 2
    and 3): the output of the rank's query heads ([B, H / M, hd]; all H
    where `heads` is False) in the caches' dtype."""
    B, _, H, hd = q.shape
    kv_pos = torch.arange(seq.start, seq.stop, device=q.device)
    s = _scores(cfg, q, cache_k, kv_pos, position, local)
    m = s.amax(-1)
    tp.all_reduce_(m, dist.ReduceOp.MAX)
    e = torch.exp(s - m[..., None])
    total = e.sum(-1).reshape(B, H)
    acc = torch.einsum("bkgs,bskh->bkgh", e.to(cache_v.dtype), cache_v).float().reshape(B, H, hd)
    if heads:
        total, acc = tp.scattered_sums(total, acc, dim=1)
    else:
        both = torch.cat([total[..., None], acc], dim=-1)
        tp.all_reduce_(both)
        total, acc = both[..., 0], both[..., 1:]
    return (acc / total[..., None]).to(cache_v.dtype)
