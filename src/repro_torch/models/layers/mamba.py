"""Mamba-1 block (selective SSM) for falcon-mamba and jamba.

The full-sequence forward runs the selective scan through the hand-written
kernel (`repro_torch.kernels.ops.mamba_scan`), which also returns the last
state for the prefill -> decode handoff; the JAX layer runs the kernel's jnp
analogue, a chunked associative scan that builds the whole [B, S, di, N]
state history.  That scan is ported too (`chunked_scan`): it is what a
gradient differentiates.  With grad on, `backend="cuda"` scans with the
kernel and differentiates `chunked_scan` in the backward
(`repro_torch.kernels.autograd.MambaScanFn`), `backend="ref"` runs
`chunked_scan` itself; with grad off, `"ref"` runs the kernel's plain
version, the sequential recurrence.  Decode carries the [B, d_inner, N]
state explicitly, one token at a time.

Under tensor parallelism (`tp`, a `repro_torch.parallel.tensor.ModelRegion`
whose "in_proj" is split along "model") every leaf is split over d_inner,
as the JAX templates say: in_proj column-parallel, the conv, dt_proj,
dt_bias, A_log, D and the scan per channel on the rank's channels;
x_proj row-parallel, its [B, S, r + 2N] output summed over "model" and
copied back into the region for dt_proj and for the B and C every rank's
channels read; out_proj row-parallel, its output summed over "model".  The
prefill's final states and the decode step's states are the rank's channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, ref
from repro_torch.kernels.autograd import MambaScanFn, needs_grad
from repro_torch.models.layers import BACKENDS


class Mamba(nn.Module):
    """in_proj [d, 2, di], conv_w [d_conv, di], conv_b [di], x_proj
    [di, r + 2N], dt_proj [r, di], dt_bias [di], A_log [di, N] (f32),
    D [di] (f32), out_proj [di, d]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        N, dconv, r = cfg.mamba.d_state, cfg.mamba.d_conv, cfg.dt_rank
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = nn.Parameter(torch.empty(d, 2, di, **kw))
        self.conv_w = nn.Parameter(torch.empty(dconv, di, **kw))
        self.conv_b = nn.Parameter(torch.empty(di, **kw))
        self.x_proj = nn.Parameter(torch.empty(di, r + 2 * N, **kw))
        self.dt_proj = nn.Parameter(torch.empty(r, di, **kw))
        self.dt_bias = nn.Parameter(torch.empty(di, **kw))
        self.A_log = nn.Parameter(torch.empty(di, N, **f32))
        self.D = nn.Parameter(torch.empty(di, **f32))
        self.out_proj = nn.Parameter(torch.empty(di, d, **kw))

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        d, di = cfg.d_model, cfg.d_inner
        N, dconv, r = cfg.mamba.d_state, cfg.mamba.d_conv, cfg.dt_rank
        with torch.no_grad():
            self.in_proj.normal_(generator=gen).mul_(d**-0.5)
            self.conv_w.normal_(generator=gen).mul_(dconv**-0.5)
            self.conv_b.zero_()
            self.x_proj.normal_(generator=gen).mul_(di**-0.5)
            self.dt_proj.normal_(generator=gen).mul_(r**-0.5)
            self.dt_bias.fill_(-4.6)  # softplus^-1(0.01)
            self.A_log.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(di, N))
            self.D.fill_(1.0)
            self.out_proj.normal_(generator=gen).mul_(di**-0.5)


def mamba_specs(cfg) -> dict:
    """Logical-axis templates of the mamba mixer's parameters (`repro_torch.parallel`)."""
    return {
        "in_proj": ("fsdp", None, "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "x_proj": ("tp", None),
        "dt_proj": (None, "tp"),
        "dt_bias": ("tp",),
        "A_log": ("tp", None),
        "D": ("tp",),
        "out_proj": ("tp", "fsdp"),
    }


def _ssm_inputs(p, cfg, xc: torch.Tensor, tp=None):
    """The pre-scan computation.  xc [B, S, di] (after the conv and silu;
    the rank's channels under `tp`).

    Returns the decay a [B, S, di, N] and drive b [B, S, di, N] in f32, and
    C [B, S, N] in xc's dtype."""
    N, r = cfg.mamba.d_state, cfg.dt_rank
    dbl = xc @ p.x_proj
    if tp is not None:  # the channels' partial sums, whole, read by every rank's channels
        dbl = tp.copy(tp.reduce(dbl))
    dt, Bc, Cc = torch.split(dbl, [r, N, N], dim=-1)
    dt = F.softplus((dt @ p.dt_proj).float() + p.dt_bias.float())  # [B, S, di]
    A = -torch.exp(p.A_log)  # [di, N]
    a = (dt[..., None] * A).exp_()  # in place: a is [B, S, di, N] f32
    b = (dt * xc.float())[..., None] * Bc[:, :, None, :].float()
    return a, b, Cc


def scan_chunk(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor, h0: torch.Tensor):
    """One chunk of the JAX layer's chunked scan, from the state h0.

    a, b [B, Q, di, N] and C [B, Q, N] f32, h0 [B, di, N] f32 ->
    (y [B, Q, di], h_Q [B, di, N]).  Within the chunk the pairs (a_t, b_t)
    are combined as `jax.lax.associative_scan` combines them, l then r ->
    (a_l a_r, b_l a_r + b_r), in log2(Q) rounds of the Hillis-Steele form
    (round d combines every t >= d with t - d); then h_t = a_cum h0 + b_cum
    and y_t = sum_n h_t[:, n] C_t[n].  Differentiable by autograd."""
    Q = a.shape[1]
    d = 1
    while d < Q:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1),
                torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1))
        d *= 2
    h = a * h0[:, None] + b
    return torch.einsum("bqin,bqn->bqi", h, C), h[:, -1]


def chunked_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor, chunk: int):
    """The JAX layer's chunked associative scan, h_0 = 0: a, b [B, S, di, N]
    and C [B, S, N] f32 -> (y [B, S, di], h_S [B, di, N]).  `chunk` divides S;
    the chunks run in order, each from the last one's final state
    (`scan_chunk`).  With grad on, each chunk runs under non-reentrant
    `torch.utils.checkpoint`: the graph keeps each chunk's inputs, and the
    backward recomputes one chunk's rounds at a time.  The chunks are a
    `split` of the inputs, whose backward is one `cat` of the chunks'
    gradients (a slice's would add a zero-filled [B, S, di, N] per chunk)."""
    B, S, di, N = a.shape
    h = torch.zeros((B, di, N), dtype=a.dtype, device=a.device)
    remat = needs_grad(a, b, C)
    ys = []
    for args in zip(a.split(chunk, 1), b.split(chunk, 1), C.split(chunk, 1)):
        y, h = (checkpoint(scan_chunk, *args, h, use_reentrant=False, preserve_rng_state=False)
                if remat else scan_chunk(*args, h))
        ys.append(y)
    return torch.cat(ys, 1), h


def _causal_conv(p, cfg, x1: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x1 [B, S, di]; conv_state [B, dconv-1, di] or
    None (zeros).  Returns (out [B, S, di], the new state: the last dconv-1
    inputs)."""
    dconv = cfg.mamba.d_conv
    if conv_state is None:
        pad = x1.new_zeros((x1.shape[0], dconv - 1, x1.shape[2]))
    else:
        pad = conv_state.to(x1.dtype)
    xp = torch.cat([pad, x1], dim=1)  # [B, S + dconv - 1, di]
    S = x1.shape[1]
    out = sum(xp[:, i:i + S, :] * p.conv_w[i] for i in range(dconv))
    new_state = xp[:, -(dconv - 1):, :] if dconv > 1 else pad
    return out + p.conv_b, new_state


def _gate_out(p, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """(y + D xc) silu(z), in f32, cast to the model's dtype, then out_proj."""
    y = y + p.D * xc.float()
    return (y * F.silu(z.float())).to(dtype) @ p.out_proj


def mamba_forward(p, cfg, x: torch.Tensor, return_state: bool = False, *,
                  backend: str = "cuda", tp=None):
    """x [B, S, d] -> [B, S, d]: the selective scan from h_0 = 0.

    With return_state=True also returns (ssm_state [B, di, N] f32,
    conv_state [B, dconv-1, di]) after the last step, for the prefill ->
    decode handoff.  `backend="cuda"` scans with the kernel (its plain version
    on CPU tensors), `"ref"` with the plain version on any device.  With grad
    on and an input that requires it, the scan's gradient is that of the JAX
    layer's chunked scan (`chunked_scan`, chunk as the JAX layer picks it):
    `"cuda"` keeps the kernel in the forward (`MambaScanFn`), `"ref"` runs
    `chunked_scan`.  `tp`: the layer's `ModelRegion` (module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if tp is not None and not tp.split("in_proj"):
        tp = None  # d_inner whole: the layer runs whole on every rank
    if tp is not None:
        x = tp.copy(x)
    S = x.shape[1]
    d, _, di = p.in_proj.shape
    xz = (x @ p.in_proj.reshape(d, 2 * di)).unflatten(-1, (2, di))
    x1, z = xz[..., 0, :], xz[..., 1, :]
    xc, _ = _causal_conv(p, cfg, x1)
    xc = F.silu(xc)
    a, b, Cc = _ssm_inputs(p, cfg, xc, tp)
    C32 = Cc.float().contiguous()
    if needs_grad(a, b, C32):
        Q = min(cfg.mamba.chunk, S)  # the JAX layer's chunk: halved until it divides S
        while S % Q:
            Q //= 2
        if backend == "cuda":
            y, h_last = MambaScanFn.apply(a, b, C32, Q)
        else:
            y, h_last = chunked_scan(a, b, C32, Q)
    else:
        scan = ops.mamba_scan if backend == "cuda" else ref.mamba_scan
        y, h_last = scan(a, b, C32, return_state=True)
    del a, b
    out = _gate_out(p, y, xc, z, x.dtype)
    if tp is not None:
        out = tp.reduce(out)
    if not return_state:
        return out
    dconv = cfg.mamba.d_conv
    if S >= dconv - 1:
        conv_state = x1[:, S - (dconv - 1):, :]
    else:
        conv_state = F.pad(x1, (0, 0, dconv - 1 - S, 0))
    return out, (h_last, conv_state)


def mamba_decode(p, cfg, x: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor,
                 tp=None):
    """One-token step.  x [B, 1, d]; ssm_state [B, di, N]; conv_state
    [B, dconv-1, di].  Returns (out [B, 1, d], new ssm_state, new conv_state).
    `tp`: the layer's `ModelRegion` (module docstring): the states are the
    rank's channels, in_proj column-parallel, x_proj and out_proj
    row-parallel, as in the forward."""
    if tp is not None and not tp.split("in_proj"):
        tp = None
    if tp is not None:
        x = tp.copy(x)
    d, _, di = p.in_proj.shape
    xz = (x @ p.in_proj.reshape(d, 2 * di)).unflatten(-1, (2, di))
    x1, z = xz[..., 0, :], xz[..., 1, :]
    xc, new_conv = _causal_conv(p, cfg, x1, conv_state)
    xc = F.silu(xc)
    a, b, Cc = _ssm_inputs(p, cfg, xc, tp)  # S = 1
    h = a[:, 0] * ssm_state + b[:, 0]  # [B, di, N]
    y = (h * Cc[:, 0, None, :].float()).sum(-1)
    out = _gate_out(p, y, xc[:, 0], z[:, 0], x.dtype)
    if tp is not None:
        out = tp.reduce(out)
    return out[:, None, :], h, new_conv
