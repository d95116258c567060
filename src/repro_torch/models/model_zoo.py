"""Build a model from a ModelConfig, on the card unless asked otherwise."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BACKENDS
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, *, device=None, dtype=None, backend: str = "cuda",
                seed: int = 0) -> Transformer:
    """The model of `cfg` with random parameters drawn from a `torch.Generator`
    seeded with `seed` on the model's device, ready for `forward`, `prefill`
    and `decode_step`: in eval mode, no parameter requiring grad
    (`repro_torch.training.init_train_state` switches it to training).

    `device` None is the CUDA card (a CPU-only host raises; pass "cpu" for the
    plain versions on the CPU).  `dtype` defaults to `cfg.param_dtype`.
    `backend="cuda"` runs the hand-written attention and scan kernels on the
    card, `"ref"` their plain versions on any device.  Load other parameters
    with `model.load_state_dict` (see `repro_torch.interop.lm_params_from_numpy`).
    An MoE layer's router stays in f32 whatever `dtype` is, as in the JAX
    package.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    dev = resolve_device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype or cfg.param_dtype)
    model = Transformer(cfg, device=dev, dtype=dt, backend=backend)
    model.init_params(torch.Generator(device=dev).manual_seed(seed))
    return model.eval().requires_grad_(False)
