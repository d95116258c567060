"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional), same backbone as wav2vec2 [arXiv:2106.07447].
The conv waveform frontend is a stub — input_specs feeds precomputed frame
embeddings of size d_model (per the assignment)."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    pattern=(LayerSpec("attn", "mlp"),),
    causal=False,
    act="gelu",
    mlp_gated=False,
    input_mode="frames",
    frame_dim=1280,
    source="arXiv:2106.07447; unverified",
)
