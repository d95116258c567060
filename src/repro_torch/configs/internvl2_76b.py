"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + InternLM2 backbone [arXiv:2404.16821]; the vision tower is a
stub — input_specs feeds precomputed patch embeddings occupying the first
n_patches sequence positions (early fusion)."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=1e6,
    input_mode="tokens+patches",
    n_patches=256,
    source="arXiv:2404.16821; unverified",
)
