"""Model configuration schema for every assigned architecture family.

A model is a stack of `n_layers` layers.  The layer sequence is described by a
repeating *pattern* of (mixer, ffn) pairs — the smallest unit that tiles the
stack — so heterogeneous models (gemma2's local/global alternation, jamba's
7:1 mamba:attention interleave with every-other-layer MoE) scan over groups
of `len(pattern)` layers with identical parameter structure per group.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k gate probs (qwen-style)
    n_dispatch_groups: int = 16  # data-local dispatch groups (EP-friendly)
    dispatch: str = "sort"  # "sort": statically-shardable (no scatter);
    #                         "scatter": baseline — GSPMD replicates it (§Perf)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default d_model // 16
    chunk: int = 64  # chunked-scan block (memory / parallelism tradeoff)


@dataclass(frozen=True)
class LayerSpec:
    """(mixer, ffn) of one layer inside the repeating pattern."""

    mixer: str  # "attn" | "attn_local" | "mamba"
    ffn: str  # "mlp" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)
    causal: bool = True
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_softcap: float | None = None  # gemma2: 50.0
    final_softcap: float | None = None  # gemma2: 30.0
    window: int | None = None  # sliding window for "attn_local" mixers
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    mlp_gated: bool = True  # False: classic 2-matrix MLP (hubert, starcoder2)
    attn_score_dtype: str = "float32"  # bfloat16: scores, s - m and p rounded to
    #   bf16 as the JAX blocked attention holds them.  A numerics setting: the
    #   flash kernel keeps its scores in registers, so there is no buffer
    #   traffic to save, and the rounding costs time (online-softmax max/sum
    #   statistics stay fp32 either way)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    tie_embeddings: bool = False
    input_mode: str = "tokens"  # tokens | frames (audio stub) | tokens+patches (vlm stub)
    n_patches: int = 256  # vlm stub: image patch positions at sequence head
    frame_dim: int | None = None  # audio stub: precomputed frame embedding dim
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # paper-pool metadata
    source: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )
        kinds = {s.ffn for s in self.pattern}
        if "moe" in kinds and self.moe is None:
            raise ValueError(f"{self.name}: MoE layers but no MoEConfig")
        if any(s.mixer == "mamba" for s in self.pattern) and self.mamba is None:
            raise ValueError(f"{self.name}: mamba layers but no MambaConfig")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return (self.mamba.expand if self.mamba else 2) * self.d_model

    @property
    def dt_rank(self) -> int:
        if self.mamba and self.mamba.dt_rank:
            return self.mamba.dt_rank
        return max(self.d_model // 16, 1)

    @property
    def has_attention(self) -> bool:
        return any(s.mixer.startswith("attn") for s in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (per assignment: SSM / hybrid / linear-attn).

        Attention-free patterns qualify outright; hybrids qualify because the
        KV cache exists only on their minority attention layers (jamba: 1/8).
        `attn_local` (sliding window) is sub-quadratic; plain `attn` is not.
        """
        if all(s.mixer != "attn" for s in self.pattern):
            return True
        return self.family == "hybrid"

    @property
    def n_params(self) -> float:
        """Approximate parameter count (for 6ND model-FLOP accounting)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_pattern = 0.0
        for spec in self.pattern:
            if spec.mixer.startswith("attn"):
                per_pattern += d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
            elif spec.mixer == "mamba":
                di, N, r = self.d_inner, self.mamba.d_state, self.dt_rank
                per_pattern += d * 2 * di + di * self.mamba.d_conv
                per_pattern += di * (r + 2 * N) + r * di + di * N + di + di * d
            if spec.ffn == "mlp":
                per_pattern += (3 if self.mlp_gated else 2) * d * self.d_ff
            elif spec.ffn == "moe":
                per_pattern += d * self.moe.n_experts
                per_pattern += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            per_pattern += 2 * d  # norms
        return total + per_pattern * self.n_groups

    @property
    def n_active_params(self) -> float:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        inactive = (
            (self.moe.n_experts - self.moe.top_k)
            * 3
            * d
            * self.moe.d_ff_expert
            * sum(1 for s in self.pattern if s.ffn == "moe")
            * self.n_groups
        )
        return self.n_params - inactive
