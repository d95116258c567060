"""One group of the repeating (mixer, ffn) pattern, as an nn.Module.

A model is `cfg.n_groups` groups of `len(cfg.pattern)` layers each; a group
is a ModuleDict keyed "pos{i}" by the position in the pattern, as the JAX
package keys its per-group parameters.  The group runs its layers for the
three passes: the full-sequence forward, the prefill (which also fills this
group's slot of the decode caches) and the one-token decode step.
Each pass takes the group's `ModelRegion` under tensor parallelism (`tp`,
`repro_torch.parallel.tensor`) and hands each layer its own.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers.attention import (
    Attention,
    attention_forward,
    attn_specs,
    cache_block,
    decode_attention,
)
from repro_torch.models.layers.mamba import Mamba, mamba_decode, mamba_forward, mamba_specs
from repro_torch.models.layers.mlp import MLP, mlp_forward, mlp_specs
from repro_torch.models.layers.moe import MoE, moe_forward, moe_specs
from repro_torch.models.layers.norms import RMSNorm, rms_norm, rms_specs


def group_specs(cfg) -> dict:
    """Logical-axis templates of one group's parameters, keyed as the JAX
    package's per-group tree ("pos{i}" -> layer -> leaf)."""
    p = {}
    for i, spec in enumerate(cfg.pattern):
        lp = {"norm_mixer": rms_specs(), "norm_ffn": rms_specs()}
        if spec.mixer.startswith("attn"):
            lp["attn"] = attn_specs(cfg)
        elif spec.mixer == "mamba":
            lp["mamba"] = mamba_specs(cfg)
        if spec.ffn == "mlp":
            lp["mlp"] = mlp_specs(cfg)
        elif spec.ffn == "moe":
            lp["moe"] = moe_specs(cfg)
        p[f"pos{i}"] = lp
    return p


class Layer(nn.Module):
    """One (mixer, ffn) position: norm_mixer, attn or mamba, norm_ffn, mlp or moe."""

    def __init__(self, cfg, spec, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.norm_mixer = RMSNorm(cfg.d_model, **kw)
        self.norm_ffn = RMSNorm(cfg.d_model, **kw)
        if spec.mixer in ("attn", "attn_local"):
            self.attn = Attention(cfg, **kw)
        elif spec.mixer == "mamba":
            self.mamba = Mamba(cfg, **kw)
        else:
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.ffn == "mlp":
            self.mlp = MLP(cfg, **kw)
        elif spec.ffn == "moe":
            self.moe = MoE(cfg, **kw)

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        self.norm_mixer.reset_parameters()
        self.norm_ffn.reset_parameters()
        for name in ("attn", "mamba", "mlp", "moe"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(cfg, gen)

    def ffn(self, cfg, x: torch.Tensor, dispatch_ranks: int = 1, tp=None) -> torch.Tensor:
        """x + mlp(norm(x)) or x + moe(norm(x)), or x for a mixer-only layer
        (`dispatch_ranks`: `moe_forward`'s `ranks`; `tp`: the layer's
        `ModelRegion`: the MLP's d_ff, or the MoE experts, split along
        "model")."""
        if self.spec.ffn == "none":
            return x
        h = rms_norm(x, self.norm_ffn.scale, cfg.norm_eps)
        if self.spec.ffn == "moe":
            return x + moe_forward(self.moe, cfg, h, dispatch_ranks,
                                   None if tp is None else tp.at("moe."))
        return x + mlp_forward(self.mlp, cfg, h, None if tp is None else tp.at("mlp."))


class Group(nn.ModuleDict):
    """The layers of one pattern group, keyed "pos{i}"."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__({f"pos{i}": Layer(cfg, spec, device=device, dtype=dtype)
                          for i, spec in enumerate(cfg.pattern)})

    def reset_parameters(self, cfg, gen: torch.Generator) -> None:
        for layer in self.values():
            layer.reset_parameters(cfg, gen)

    def forward(self, cfg, x, positions, *, backend: str = "cuda", caches=None, g: int = 0,
                chunk: int = 1024, dispatch_ranks: int = 1, tp=None, position: int | None = None,
                seq: range | None = None):
        """Full-sequence pass (`chunk`: the KV chunk of `blocked_attention`;
        `dispatch_ranks`: `moe_forward`'s `ranks`; `tp`: the group's
        `ModelRegion` under tensor parallelism).  With `caches` (the stacked
        decode caches, the rank's block of them), the prefill: also writes
        this group's attention k/v of the prompt's positions in `seq` (the
        rank's block of the caches' sequence; None: all, [0, S)) and its
        mamba states into slot `g`.  With `position`, the decode step of x
        [B, 1, d] at that position instead (`decode`; `positions`
        unused)."""
        if position is not None:
            return self.decode(cfg, x, caches, g, position, dispatch_ranks=dispatch_ranks, tp=tp,
                               seq=seq)
        for key, layer in self.items():
            ltp = None if tp is None else tp.at(f"{key}.")
            h = rms_norm(x, layer.norm_mixer.scale, cfg.norm_eps)
            mixer = layer.spec.mixer
            if mixer.startswith("attn"):
                atp = None if ltp is None else ltp.at("attn.")
                out, (k, v) = attention_forward(layer.attn, cfg, h, positions,
                                                local=mixer == "attn_local", backend=backend,
                                                chunk=chunk, tp=atp)
                if caches is not None:
                    k, v = cache_block(layer.attn, cfg, h, positions, k, v, seq, atp)
                    caches[key]["k"][g, :, :k.shape[1]] = k
                    caches[key]["v"][g, :, :v.shape[1]] = v
            elif caches is None:
                out = mamba_forward(layer.mamba, cfg, h, backend=backend,
                                    tp=None if ltp is None else ltp.at("mamba."))
            else:
                out, (ssm, conv) = mamba_forward(layer.mamba, cfg, h, return_state=True,
                                                 backend=backend,
                                                 tp=None if ltp is None else ltp.at("mamba."))
                caches[key]["ssm"][g] = ssm
                caches[key]["conv"][g] = conv
            x = layer.ffn(cfg, x + out, dispatch_ranks, ltp)
        return x

    def decode(self, cfg, x, caches, g: int, position: int, *, dispatch_ranks: int = 1,
               tp=None, seq: range | None = None):
        """One token through the group, updating slot `g` of the caches in
        place (`dispatch_ranks`, `tp`, `seq`: as `forward`'s)."""
        for key, layer in self.items():
            ltp = None if tp is None else tp.at(f"{key}.")
            h = rms_norm(x, layer.norm_mixer.scale, cfg.norm_eps)
            mixer = layer.spec.mixer
            c = caches[key]
            if mixer.startswith("attn"):
                out, _, _ = decode_attention(layer.attn, cfg, h, c["k"][g], c["v"][g], position,
                                             local=mixer == "attn_local",
                                             tp=None if ltp is None else ltp.at("attn."), seq=seq)
            else:
                out, ssm, conv = mamba_decode(layer.mamba, cfg, h, c["ssm"][g], c["conv"][g],
                                              tp=None if ltp is None else ltp.at("mamba."))
                c["ssm"][g] = ssm
                c["conv"][g] = conv
            x = layer.ffn(cfg, x + out, dispatch_ranks, ltp)
        return x
