"""falcon-mamba-7b [ssm]: 64L d=4096 (attention-free) vocab=65024,
ssm_state=16 — pure Mamba-1 stack [arXiv:2410.05355]."""

from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv=1,
    head_dim=64,
    d_ff=0,
    vocab=65024,
    pattern=(LayerSpec("mamba", "none"),),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    source="arXiv:2410.05355; unverified",
)
