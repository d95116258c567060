"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local(4096-window)/global alternating attention, attn/final logit
soft-capping, GeGLU, tied embeddings [arXiv:2408.00118]."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    pattern=(LayerSpec("attn_local", "mlp"), LayerSpec("attn", "mlp")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
