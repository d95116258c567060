"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) vocab=151936,
MoE 128 experts top-8 with d_ff_expert=1536; qk-norm
[hf:Qwen/Qwen3-30B-A3B scaled]."""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    pattern=(LayerSpec("attn", "moe"),),
    rope_theta=1e6,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
