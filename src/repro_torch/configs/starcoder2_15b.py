"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

GQA + RoPE [arXiv:2402.19173]; classic (non-gated) GELU MLP at 4x."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=1e5,
    act="gelu",
    mlp_gated=False,
    source="arXiv:2402.19173; hf",
)
