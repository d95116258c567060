"""phi3-mini-3.8b [dense]: 32L d=3072 32H (kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU [arXiv:2404.14219]."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    pattern=(LayerSpec("attn", "mlp"),),
    source="arXiv:2404.14219; unverified",
)
