"""Token embedding and logit head (tied or untied), with the modality stubs.

`[audio]` (hubert) and `[vlm]` (internvl2) architectures specify the
transformer backbone only; their modality frontend is a stub, as in the JAX
package: the batch carries precomputed frame or patch embeddings.

Under tensor parallelism (`tp`, a `repro_torch.parallel.tensor.ModelRegion`
whose "embed" or "head" is split over the vocab along "model") a rank holds
the vocab ids [i V / M, (i + 1) V / M): the lookup is vocab-parallel (the
rank looks up the tokens in its range, zeros for the others, summed over
"model") and the head column-parallel over the vocab, giving the rank's
slice of the logits.
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


def lookup(embed: torch.Tensor, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """embed[tokens]; under `tp` with the embedding split over the vocab, the
    vocab-parallel lookup (module docstring)."""
    if tp is None or not tp.split("embed"):
        return embed[tokens]
    n = embed.shape[0]
    local = tokens - tp.index * n
    mine = ((local >= 0) & (local < n))[..., None]
    x = embed[local.clamp(0, n - 1)]
    return tp.reduce(torch.where(mine, x, torch.zeros_like(x)))


def embed_inputs(model, cfg, batch: dict, tp=None) -> torch.Tensor:
    """batch -> [B, S, d] per cfg.input_mode (`tp`: `lookup`'s)."""
    if cfg.input_mode == "frames":
        # audio stub: precomputed frame embeddings, already d_model-sized
        return batch["frames"].to(model.embed.dtype)
    x = lookup(model.embed, batch["tokens"], tp)
    if cfg.input_mode == "tokens+patches":
        # vlm stub: patch embeddings replace the first n_patches positions
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)
    return x


def head_split(cfg, tp) -> bool:
    """Whether the head (the tied embed, or head) is split over the vocab."""
    return tp is not None and tp.split("embed" if cfg.tie_embeddings else "head")


def logits_out(model, cfg, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, V], with gemma2's final softcap (elementwise);
    the rank's vocab slice [B, S, V / M] where `head_split(cfg, tp)`."""
    w = model.embed.T if cfg.tie_embeddings else model.head
    if head_split(cfg, tp):
        x = tp.copy(x)
    logits = x @ w
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
