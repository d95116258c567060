"""Synthetic LM data, deterministically keyed by (seed, step).

`synthetic_batch(cfg, step)` is a pure function of (cfg, step), drawn from a
`torch.Generator` on the CPU seeded from both.  The tokens are not the JAX
package's: its batches come from `jax.random`, whose bits PyTorch does not
reproduce; tests that compare the two packages make their inputs with numpy
and hand them to both.

`copy` mode emits sequences whose second half repeats the first (with a
Zipf-ish unigram prior), so small models show fast, visible learning; unlike
uniform noise, whose loss floor is ln(V).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    mode: str = "copy"  # copy | uniform
    seed: int = 0


def synthetic_batch(cfg: DataConfig, step: int, model_cfg=None) -> dict:
    """{"tokens", "labels"} [B, S] int64 on the CPU (frames or patch
    embeddings too, per `model_cfg.input_mode`)."""
    gen = torch.Generator().manual_seed(cfg.seed * 1_000_003 + step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    if cfg.mode == "uniform":
        tokens = torch.randint(0, V, (B, S), generator=gen)
    elif cfg.mode == "copy":
        half = S // 2
        prior = torch.softmax(-1.2 * torch.log1p(torch.arange(V, dtype=torch.float32)), 0)
        prefix = torch.multinomial(prior.expand(B, V), max(half, 1), replacement=True,
                                   generator=gen)
        tokens = torch.cat([prefix, prefix], dim=1)[:, :S]
    else:
        raise ValueError(f"unknown mode {cfg.mode!r}; known: copy, uniform")
    labels = torch.roll(tokens, -1, dims=1)
    batch = {"tokens": tokens, "labels": labels}
    if model_cfg is not None:
        if model_cfg.input_mode == "frames":
            batch = {"frames": torch.randn(B, S, model_cfg.d_model, generator=gen),
                     "labels": labels}
        elif model_cfg.input_mode == "tokens+patches":
            batch["patch_embeds"] = torch.randn(B, model_cfg.n_patches, model_cfg.d_model,
                                                generator=gen)
    return batch


def data_iterator(cfg: DataConfig, start_step: int = 0, model_cfg=None):
    """Yields (step, synthetic_batch(cfg, step, model_cfg)) from `start_step` on."""
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, step, model_cfg)
        step += 1
