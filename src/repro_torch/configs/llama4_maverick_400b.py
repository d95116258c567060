"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) vocab=202048,
MoE 128 experts top-1 with d_ff_expert=8192, dense/MoE layers alternating
(Maverick interleave); early-fusion multimodal stack modeled through the text
backbone [hf:meta-llama/Llama-4; unverified].  Totals ~400B / ~17B active.

Note: 40 heads do not divide the 16-way model axis; GSPMD shards the head
dimension unevenly (implicit padding) — noted in DESIGN.md."""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=16384,
    vocab=202048,
    pattern=(LayerSpec("attn", "mlp"), LayerSpec("attn", "moe")),
    rope_theta=5e5,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
