"""Token embedding and logit head (tied or untied), with the modality stubs.

`[audio]` (hubert) and `[vlm]` (internvl2) architectures specify the
transformer backbone only; their modality frontend is a stub, as in the JAX
package: the batch carries precomputed frame or patch embeddings.
"""

from __future__ import annotations

import torch


def init_embeddings(model, cfg, gen: torch.Generator) -> None:
    """Fill `model.embed` (and `model.head` unless tied) in place."""
    with torch.no_grad():
        model.embed.normal_(generator=gen).mul_(0.02)
        if not cfg.tie_embeddings:
            model.head.normal_(generator=gen).mul_(cfg.d_model**-0.5)


def embed_specs(cfg) -> dict:
    """Logical-axis templates of embed and head (`repro_torch.parallel`)."""
    p = {"embed": ("tp", "fsdp")}
    if not cfg.tie_embeddings:
        p["head"] = ("fsdp", "tp")
    return p


def embed_inputs(model, cfg, batch: dict) -> torch.Tensor:
    """batch -> [B, S, d] per cfg.input_mode."""
    if cfg.input_mode == "frames":
        # audio stub: precomputed frame embeddings, already d_model-sized
        return batch["frames"].to(model.embed.dtype)
    x = model.embed[batch["tokens"]]
    if cfg.input_mode == "tokens+patches":
        # vlm stub: patch embeddings replace the first n_patches positions
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)
    return x


def logits_out(model, cfg, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] -> [B, S, V], with gemma2's final softcap."""
    w = model.embed.T if cfg.tie_embeddings else model.head
    logits = x @ w
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
