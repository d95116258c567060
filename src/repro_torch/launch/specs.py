"""Meta-device stand-ins and partition specs for every (arch x shape) cell,
as the JAX package's `repro/launch/specs.py`.

The JAX package's abstract values are `jax.ShapeDtypeStruct`s; the port's
are tensors on `torch.device("meta")`: they have shapes and dtypes and hold
no memory, so a full-width model is built and run (`repro_torch.launch.
dryrun`) without allocating.  Every function here that makes tensors makes
them on the meta device and takes a model on it, no other.

The partition specs are the JAX package's rules on the port's abstract
`Mesh` (`repro_torch.parallel.sharding`).  The port's data-parallel step
reads the batch's rule and the parameters' "data" entries (its sharded
state, `repro_torch.parallel.fsdp`); the specs also serve the dry run's
JAX-mesh view of the bytes and `Checkpointer.restore`'s check of a
restore onto a mesh.  `model_flops` is the analytic 6*N_active*D (+ attention)
count the roofline compares against, the JAX formula value for value.
"""

from __future__ import annotations

import torch

from repro_torch.configs import SHAPES
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import PartitionSpec, ShardingRules, batch_pspecs, tree_pspecs
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import TrainState

META = torch.device("meta")


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    """bf16 moments for the >100B archs keep optimizer state in HBM budget."""
    mdt = "bfloat16" if cfg.n_params > 1e11 else "float32"
    return OptConfig(moment_dtype=mdt)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """A cell's global input batch as meta tensors, in the dtypes the port's
    model takes: int64 tokens and labels (the JAX package's are int32), f32
    frames and patch embeddings."""
    sh = SHAPES[shape_name]
    B, S = sh.global_batch, sh.seq_len

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if sh.kind == "decode":
        return {"tokens": empty((B,), torch.int64)}
    batch = {}
    if cfg.input_mode == "frames":
        batch["frames"] = empty((B, S, cfg.d_model), torch.float32)
    else:
        batch["tokens"] = empty((B, S), torch.int64)
        if cfg.input_mode == "tokens+patches":
            batch["patch_embeds"] = empty((B, cfg.n_patches, cfg.d_model), torch.float32)
    if sh.kind == "train":
        batch["labels"] = empty((B, S), torch.int64)
    return batch


def _on_meta(model) -> None:
    if model.device.type != "meta":
        raise ValueError(f"the dry-run specs take a model on the meta device, not {model.device}")


def abstract_train_state(model, opt_cfg: OptConfig) -> TrainState:
    """The `TrainState` over `model` (on the meta device): the model in
    training mode, its zeroed optimizer state and step, all on meta.  The
    parameters are left unset (`init_params` draws from a generator on the
    model's device, which meta has not)."""
    _on_meta(model)
    model.train().requires_grad_(True)
    return TrainState(params=model, opt=init_opt_state(dict(model.named_parameters()), opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=META))


def abstract_caches(model, shape_name: str) -> dict:
    """A cell's decode caches (`Transformer.init_caches`) on the meta device."""
    _on_meta(model)
    sh = SHAPES[shape_name]
    return model.init_caches(batch_size=sh.global_batch, max_len=sh.seq_len)


def train_state_pspecs(model, rules: ShardingRules, kind: str = "adamw") -> TrainState:
    """The JAX `TrainState`'s specs: the parameters' tree, the same tree for
    each of the moments "m" and "v", and a replicated step.  With `kind`
    "adafactor" the optimizer state is {"vr", "vc"}, each leaf's spec the
    parameter's with the entry of the dimension its factored shape drops
    removed (`factored_pspec`): the JAX rules applied to the factored
    shapes, which the JAX package's launcher never lays out."""
    params = tree_pspecs(model.param_specs(), rules)
    if kind == "adamw":
        opt = {k: params for k in ("m", "v")}
    elif kind == "adafactor":
        opt = {k: _tree_map(lambda spec, k=k: factored_pspec(spec, k), params)
               for k in ("vr", "vc")}
    else:
        raise ValueError(kind)
    return TrainState(params=params, opt=opt, step=PartitionSpec())


def factored_pspec(spec: PartitionSpec, part: str) -> PartitionSpec:
    """The spec of Adafactor's statistic `part` ("vr" or "vc") of a leaf of
    spec `spec` (one entry a dimension): a leaf of 2 or more dimensions
    drops the last (vr) or the one before it (vc); a 1-D leaf's vr keeps
    its spec and its vc is a scalar."""
    if len(spec) < 2:
        return spec if part == "vr" else PartitionSpec()
    drop = len(spec) - (1 if part == "vr" else 2)
    return PartitionSpec(*spec[:drop], *spec[drop + 1:])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_pspecs(model, rules: ShardingRules) -> dict:
    return tree_pspecs(model.cache_specs(), rules)


def batch_specs_for(cfg: ModelConfig, shape_name: str, rules: ShardingRules) -> dict:
    return batch_pspecs(cfg, rules, kind=SHAPES[shape_name].kind)


# ---------------------------------------------------------------------------
# Analytic model FLOPs (per device) for the roofline's "useful compute".
# ---------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig) -> int:
    per = sum(1 for s in cfg.pattern if s.mixer.startswith("attn"))
    return per * cfg.n_groups


def model_flops(cfg: ModelConfig, shape_name: str, n_devices: int) -> float:
    sh = SHAPES[shape_name]
    B, S = sh.global_batch, sh.seq_len
    Na = cfg.n_active_params
    Hhd = cfg.n_heads * cfg.head_dim
    La = _attn_layers(cfg)
    if sh.kind == "train":
        tokens = B * S
        mm = 6.0 * Na * tokens
        attn = 3 * (4.0 * B * S * S / 2 * Hhd) * La  # fwd 2BS^2/2*(qk+pv), bwd 2x
    elif sh.kind == "prefill":
        tokens = B * S
        mm = 2.0 * Na * tokens
        attn = 4.0 * B * S * S / 2 * Hhd * La
    else:  # decode: one token against an S-long cache
        tokens = B
        mm = 2.0 * Na * tokens
        attn = 4.0 * B * S * Hhd * La
    return (mm + attn) / n_devices
