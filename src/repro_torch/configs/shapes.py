"""Assigned input shapes (per-arch applicability in `applicable_shapes`)."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Per the assignment: encoder-only archs skip decode shapes; long_500k
    runs only for sub-quadratic (SSM / hybrid / local-attn) archs."""
    out = ["train_4k", "prefill_32k"]
    if cfg.causal:  # encoder-only models have no decode step
        out.append("decode_32k")
        if cfg.subquadratic:
            out.append("long_500k")
    return out


def skipped_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape -> reason, for DESIGN.md / dry-run reporting."""
    skipped = {}
    if not cfg.causal:
        skipped["decode_32k"] = "encoder-only: no decode step"
        skipped["long_500k"] = "encoder-only: no decode step"
    elif not cfg.subquadratic:
        skipped["long_500k"] = "pure full-attention arch (quadratic): skipped per assignment"
    return skipped
