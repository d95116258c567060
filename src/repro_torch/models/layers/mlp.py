"""Gated MLP (SwiGLU / GeGLU) or the classic two-matrix MLP.

`gelu` is the tanh approximation, as `jax.nn.gelu` computes by default
(PyTorch's default is the erf form).

Under tensor parallelism (`tp`, a `repro_torch.parallel.tensor.ModelRegion`
whose "w_in" is split along "model") w_in is column-parallel over d_ff,
gate and up by the same columns, and w_out row-parallel, the output summed
over "model".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}; known: silu, gelu")


class MLP(nn.Module):
    """w_in [d, g, d_ff] (g = 2 gate+up when gated, else 1), w_out [d_ff, d]."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        g = 2 if cfg.mlp_gated else 1
        self.w_in = nn.Parameter(torch.empty(cfg.d_model, g, cfg.d_ff, device=device, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model, device=device, dtype=dtype))

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.w_in.normal_(generator=gen).mul_(cfg.d_model**-0.5)
            self.w_out.normal_(generator=gen).mul_(cfg.d_ff**-0.5)


def mlp_specs(cfg) -> dict:
    """Logical-axis templates of the MLP's parameters (`repro_torch.parallel`)."""
    return {"w_in": ("fsdp", None, "tp"), "w_out": ("tp", "fsdp")}


def mlp_forward(p, cfg, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; gate and up projections in one product
    (`tp`: the layer's `ModelRegion`, module docstring)."""
    split = tp is not None and tp.split("w_in")
    if split:
        x = tp.copy(x)
    d, g, ff = p.w_in.shape
    gu = (x @ p.w_in.reshape(d, g * ff)).unflatten(-1, (g, ff))
    h = _act(cfg.act, gu[..., 0, :])
    if cfg.mlp_gated:
        h = h * gu[..., 1, :]
    return tp.reduce(h @ p.w_out) if split else h @ p.w_out
