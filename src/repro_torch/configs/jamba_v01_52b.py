"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16 experts top-2; Mamba:attention 7:1 interleave (attention at offset 4 of
each 8-layer block), MoE every other layer [arXiv:2403.19887]."""

from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, MoEConfig


def _jamba_pattern():
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        out.append(LayerSpec(mixer, ffn))
    return tuple(out)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    pattern=_jamba_pattern(),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    source="arXiv:2403.19887; hf",
)
