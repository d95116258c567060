"""Gradients through the LM stack's forward kernels.

The JAX package trains through the jnp analogues of its Pallas kernels
(`blocked_attention`, the chunked associative scan) and has no backward
kernel.  Here the forward stays on the hand-written kernel and the backward
differentiates the JAX package's formulation at the saved inputs: the
gradient is the one the JAX package computes, the forward value the one the
kernel computes.

- `FlashAttentionFn`: forward `ops.flash_attention`; backward recomputes
  `blocked_attention` (`repro_torch.models.layers.attention`) with autograd
  on and returns its gradient.
- `MambaScanFn`: forward `ops.mamba_scan` (y and the last state); backward
  reruns the chunked scan (`repro_torch.models.layers.mamba.chunked_scan`)
  with autograd on and returns its gradient.  That scan checkpoints each
  chunk, so one chunk's rounds live at a time, where the whole graph would
  keep log2(Q) [B, S, di, N] pairs.

Through the wrappers, a CUDA tensor launches the kernel (or raises) and a
CPU tensor runs its plain version; each launch counts as any other.  The
layers import the formulations' modules, so the backward imports them when
it runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a forward on these inputs must record a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFn(torch.autograd.Function):
    """apply(q, k, v, causal, window, softcap, chunk, score_dtype) -> [B, S, H, hd]:
    `ops.flash_attention` forward, `blocked_attention`'s gradient (KV chunks
    of `chunk`, positions arange(S), scores in `score_dtype`) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, softcap, chunk: int,
                score_dtype: torch.dtype = torch.float32):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk,
                      score_dtype=score_dtype)
        return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                   score_dtype=score_dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.layers.attention import blocked_attention

        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        pos = torch.arange(q.shape[1], device=q.device)
        with torch.enable_grad():
            out = blocked_attention(q, k, v, pos, pos, **ctx.kw)
            gq, gk, gv = torch.autograd.grad(out, (q, k, v), g)
        return gq, gk, gv, None, None, None, None, None


class MambaScanFn(torch.autograd.Function):
    """apply(a, b, C, chunk) -> (y [B, S, di], h_S [B, di, N]):
    `ops.mamba_scan` forward, the chunked scan's gradient (chunks of `chunk`,
    which divides S) backward."""

    @staticmethod
    def forward(ctx, a, b, C, chunk: int):
        ctx.save_for_backward(a, b, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ops.mamba_scan(a, b, C, return_state=True)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models.layers.mamba import chunked_scan

        a, b, C = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, h = chunked_scan(a, b, C, ctx.chunk)
        pairs = [(out, g) for out, g in ((y, gy), (h, gh)) if g is not None]
        if not pairs:
            return None, None, None, None
        ga, gb, gC = torch.autograd.grad([out for out, _ in pairs], (a, b, C),
                                         [g for _, g in pairs], allow_unused=True)
        return ga, gb, gC, None
