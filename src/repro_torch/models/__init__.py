"""LM stack of the port: the config schema, the layers, the group stack and
`build_model`.

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("qwen3-8b"))        # on the CUDA card, bf16
    logits, caches = model.prefill({"tokens": tokens}, max_len=4096)
"""

from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, MoEConfig
from repro_torch.models.model_zoo import build_model

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "LayerSpec", "build_model"]
