"""qwen3-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.

qk-norm + GQA + SwiGLU [hf:Qwen/Qwen3-8B]."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=1e6,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
