"""RMSNorm (f32 statistics, cast back to the input's dtype).

The scale is stored as an offset from one, `x / rms(x) * (1 + scale)`, as in
the JAX package, so a freshly made norm (scale 0) is the identity scaling.
"""

from __future__ import annotations

import torch
from torch import nn


def rms_specs() -> dict:
    """Logical-axis template of a norm's scale (`repro_torch.parallel`)."""
    return {"scale": (None,)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * (1.0 + scale.float())).to(x.dtype)


class RMSNorm(nn.Module):
    """scale [d], stored as the offset from one (zeros when made)."""

    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, device=device, dtype=dtype))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.zero_()
