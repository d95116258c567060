"""Architecture registry: --arch <id> -> ModelConfig, plus reduced variants
for the CPU tests.  The same ten configs as the JAX package's, copied: the
port imports nothing of `repro`.  Full configs run on the CUDA card."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes, skipped_shapes
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.phi3_mini_3p8b import CONFIG as _phi3
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3moe
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _hubert,
        _starcoder2,
        _gemma2,
        _qwen3,
        _phi3,
        _qwen3moe,
        _llama4,
        _jamba,
        _falcon,
        _internvl2,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, groups: int = 2) -> ModelConfig:
    """Shrink a config for CPU smoke tests: same family/pattern/features,
    small widths, few experts, tiny vocab."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=len(cfg.pattern) * min(groups, cfg.n_groups),
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        window=8 if cfg.window else None,
        n_patches=4,
        frame_dim=64 if cfg.frame_dim else None,
        param_dtype="float32",
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32, n_dispatch_groups=2
        )
    if cfg.mamba:
        kw["mamba"] = MambaConfig(d_state=4, d_conv=cfg.mamba.d_conv, expand=2, chunk=8)
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCHS",
    "get_config",
    "reduced",
    "SHAPES",
    "ShapeSpec",
    "applicable_shapes",
    "skipped_shapes",
]
