"""Train step builder: gradient accumulation, optional gradient quantization
(compression), clipping and the optimizer update, with the loss and the
gradient norm as metrics, as the JAX package's
`repro/training/train_step.py`.

The state's parameters are the model's own (`TrainState.params` is the
model), updated in place by each step; the optimizer state is keyed by the
JAX tree's leaves (`repro_torch.training.optimizer`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.transformer import param_leaves
from repro_torch.training.optimizer import (
    OptConfig,
    adafactor_update,
    adamw_update,
    clip_by_global_norm,
    init_opt_state,
)


@dataclass
class TrainState:
    params: torch.nn.Module  # the model: its parameters are the state's
    opt: dict
    step: torch.Tensor  # 0-d int32 on the model's device


def init_train_state(model, gen: torch.Generator, opt_cfg: OptConfig) -> TrainState:
    """Draw the model's parameters from `gen` (a generator on the model's
    device), switch it to training (train mode, every parameter requiring
    grad) and zero the optimizer state and the step."""
    model.init_params(gen)
    model.train().requires_grad_(True)
    return TrainState(params=model, opt=init_opt_state(dict(model.named_parameters()), opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def _quantize_dequantize(g: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor fake quantization to `bits` (the gradient
    compression model): round(g / s) s with s = max|g| / (2^(bits-1) - 1)."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / (2 ** (bits - 1) - 1)
    return (torch.round(g32 / scale) * scale).to(g.dtype)


def _compress(grads: dict, bits: int) -> dict:
    """`_quantize_dequantize` of each leaf of the JAX tree: a stacked leaf's
    groups share one scale, as the JAX package quantizes the stacked leaf."""
    out = {}
    for key, names in param_leaves(grads).items():
        if key.startswith("blocks/"):
            out.update(zip(names, _quantize_dequantize(
                torch.stack([grads[n] for n in names]), bits).unbind(0)))
        else:
            out[names[0]] = _quantize_dequantize(grads[names[0]], bits)
    return out


def accumulate_grads(model, batch: dict, *, accum: int = 1, remat: bool = True):
    """(loss, grads) of `model` on `batch`, as a train step takes them before
    compression: the batch (a dict of tensors, on any device) is split into
    `accum` micro-batches along its first axis, their f32 gradients summed
    and divided by `accum`.  `grads` is keyed by the model's parameter
    names; a parameter the loss does not reach gets a zero gradient, as
    under `jax.grad`."""
    params = dict(model.named_parameters())

    def grads_of(mb: dict):
        loss = model.loss_fn(mb, remat=remat)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(params.items(), got)}

    batch = {k: v.to(model.device) for k, v in batch.items()}
    if accum == 1:
        return grads_of(batch)
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    for i in range(accum):
        mb_loss, mb_grads = grads_of({k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                                      for k, v in batch.items()})
        loss = loss + mb_loss
        for n, g in mb_grads.items():
            grads[n] = grads[n] + g
    return loss / accum, {n: g / accum for n, g in grads.items()}


def make_train_step(model, opt_cfg: OptConfig, *, accum: int = 1,
                    compress_bits: int | None = None, remat: bool = True):
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm"}).

    The step takes the loss and the f32 gradient over `accum` micro-batches
    (`accumulate_grads`), quantizes the gradient to `compress_bits` (one
    scale per leaf of the JAX tree), clips it to opt_cfg.grad_clip and
    applies it.  `model` is the model the states hold; each step takes it
    from `state.params`."""
    update = adamw_update if opt_cfg.kind == "adamw" else adafactor_update

    def train_step(state: TrainState, batch: dict):
        model = state.params
        loss, grads = accumulate_grads(model, batch, accum=accum, remat=remat)
        if compress_bits:
            grads = _compress(grads, compress_bits)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        update(dict(model.named_parameters()), grads, state.opt, state.step, opt_cfg)
        return (TrainState(params=model, opt=state.opt, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step
