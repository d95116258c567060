"""Gradient-compression collective, as the JAX package's
`repro/parallel/compression.py`: a quantized all-reduce over a
`torch.distributed` process group.

Each rank quantizes its tensor to `bits`-bit levels with one f32 scale
shared by the group (max |x| over every rank), the levels are summed over
the group, and the sum is dequantized.  As in the JAX function, the levels
travel as int32: 4 bytes an element, the bytes of an f32 all-reduce, so the
collective models the precision of a low-bit wire format, not its bytes
(an int8 payload would overflow when the group's levels add up).  No
training path calls it, as in the JAX package: the data-parallel step
reduces its f32 gradients and then quantizes them
(`repro_torch.training.train_step`), as the JAX step under jit/GSPMD does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def compressed_psum(x: torch.Tensor, group=None, bits: int = 8) -> torch.Tensor:
    """The quantized sum of `x` over `group` (the default group when None),
    in x's dtype on every rank: with amax = max |x| over the group (an f32
    all-reduce MAX), qmax = 2^(bits-1) - 1 and scale = max(amax, 1e-12) /
    qmax, each rank's round(x / scale) (half to even, as `jnp.round`),
    clipped to +-qmax, is summed as int32 (an all-reduce SUM) and multiplied
    back by scale.  The scale's division is a product by 1 / qmax rounded to
    f32, as XLA compiles the JAX function's division by the constant qmax,
    so the two agree bit for bit."""
    if not 2 <= bits <= 16:
        raise ValueError(f"compressed_psum: bits must be in 2..16, got {bits}")
    qmax = 2 ** (bits - 1) - 1
    x32 = x.float()
    amax = torch.max(torch.abs(x32)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax[0], min=1e-12) * (1.0 / qmax)
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.float() * scale).to(x.dtype)


def compressed_psum_tree(tree, group=None, bits: int = 8):
    """`compressed_psum` of each tensor of a nested dict, in key order."""
    if isinstance(tree, dict):
        return {k: compressed_psum_tree(v, group, bits) for k, v in tree.items()}
    return compressed_psum(tree, group, bits)
