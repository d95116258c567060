"""The port's training stack against the JAX package's, on the CPU.

Parameters, optimizer states and batches are made from a seed with numpy (in
the shapes of the JAX package's trees) and handed to both packages.  The
port's forward runs the kernels' plain versions on CPU tensors (dense
softmax attention, the sequential scan) and takes its gradient from the JAX
package's formulations (`blocked_attention`, the chunked scan), as the JAX
package differentiates; so the values agree up to reordered f32 sums.

Tolerances, all f32 unless stated:
- `loss_fn` and its gradient, ten reduced archs: loss within 2e-4 relative;
  each gradient leaf within 2e-4 of the leaf's max |g_jax| plus 1e-7 (the
  absolute term is for a leaf whose gradient is zero but for rounding, as
  llama4's top-1 router, whose renormalized gate is p / p = 1: max |g_jax|
  about 5e-9 there).  The largest reading on the CPU was 1.3e-5 of max |g|
  (jamba's); every other leaf stayed under 2e-6.
- one optimizer update: f32 results within 1e-6 of the leaf's max |x_jax|;
  bf16 moments within one bf16 ulp of the JAX value.
- `make_train_step`, three steps: each step's loss and grad_norm within 2e-4
  relative, the final parameters within 1e-4 of each leaf's max |p_jax|.
  With 8-bit gradient compression the steps run in lockstep (each from
  JAX's state), since quantization is discontinuous: the pre-compression
  gradient as above; an element whose quantized level differs moved by
  exactly one level and lies within 0.05 levels (FLIP_LEVELS, what the
  gradient tolerance allows) of the edge between them on both sides (on
  the CPU, over three steps: 1 and 2 elements of qwen3, 0 and 1 of
  falcon-mamba, 101 and 99 of jamba, accum 1 and 2); the port's new
  parameters and moments within 1e-6 of each leaf's max of JAX's clip and
  AdamW applied to the port's own quantized gradient; every parameter but
  the flipped elements within 1e-4 of JAX's train step.
- bf16 parameters (qwen3-8b and falcon-mamba-7b, as the card trains them),
  in lockstep: loss within 1e-3 and grad_norm within 5e-3 relative, each
  gradient leaf within 5e-2 of its max (2.7e-2 on the CPU: each package's
  bf16 gradient is 2.5-3.3e-2 from its own f32 one), and the new
  parameters within one bf16 ulp per element of JAX's update applied to the
  port's gradient (0 ulp on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.layers import mamba as jmamba
from repro.models.model_zoo import build_model as jbuild
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adafactor_update as j_adafactor_update
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.train_step import TrainState as JTrainState
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, data_iterator, synthetic_batch
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy, train_state_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models.layers import mamba
from repro_torch.models.transformer import param_leaves
from repro_torch.runtime import RunConfig, StragglerWatchdog, run_training
from repro_torch.training import (
    OptConfig,
    adafactor_update,
    adamw_update,
    init_opt_state,
    init_train_state,
    make_train_step,
)
from repro_torch.training.train_step import _compress, _quantize_dequantize, accumulate_grads

B, S = 4, 16
LOSS_RTOL = 2e-4
GRAD_REL, GRAD_ABS = 2e-4, 1e-7
UPDATE_REL = 1e-6
STEP_RTOL, PARAM_REL = 2e-4, 1e-4
FLIP_LEVELS = 254 * GRAD_REL  # x = g / s moves 127 (|dg| + |d max|g||) / max|g| levels
BF16_LOSS_RTOL, BF16_STEP_RTOL, BF16_GRAD_REL = 1e-3, 5e-3, 5e-2


def _cfgs(arch: str):
    return jreduced(jget(arch)), reduced(get_config(arch))


def np_params(jcfg, seed: int) -> dict:
    """A parameter tree in the JAX package's shapes, drawn with numpy: each
    leaf normal with the spread of the JAX init's leaf (0.1 where that leaf
    is constant, as the norm scales are); A_log, D and dt_bias are the init's
    values plus small noise, so the SSM stays stable.  Each leaf comes in
    the init's dtype (cfg.param_dtype, f32 for A_log, D and the router)."""
    tree = jbuild(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = np.asarray(leaf, np.float32)
        if path[-1].key in ("A_log", "D", "dt_bias"):
            x = (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        else:
            x = (rng.standard_normal(a.shape) * (float(a.std()) or 0.1)).astype(np.float32)
        return x.astype(np.asarray(leaf).dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def np_batch(cfg, seed: int, batch: int = B, seq: int = S) -> dict:
    """Inputs and labels in int32 / f32 numpy, per cfg.input_mode."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        return out
    out["tokens"] = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    if cfg.input_mode == "tokens+patches":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def flat(tree) -> dict:
    """{"a/b": leaf} of a nested dict, as numpy."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out.update({f"{k}/{kk}": v for kk, v in flat(x).items()})
        else:
            out[k] = np.asarray(x)
    return out


def assert_tree_close(got: dict, want: dict, rel: float, abs_: float = 0.0) -> float:
    """Each leaf of `got` within rel * max|want leaf| + abs_; returns the
    largest reading in units of max|want leaf|."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    worst = 0.0
    for key in want:
        w = np.asarray(want[key], np.float64)
        g = np.asarray(got[key], np.float64)
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * scale + abs_, (key, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def port_model(cfg, P):
    m = build_model(cfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    return m.train().requires_grad_(True)


def port_grads(m, batch: dict):
    named = dict(m.named_parameters())
    loss = m.loss_fn(to_torch(batch))
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss, {n: torch.zeros_like(p) if g is None else g
                  for (n, p), g in zip(named.items(), got)}


# --------------------------------------------------------------------------
# loss_fn and its gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 0)
    batch = np_batch(cfg, 1)
    jm = jbuild(jcfg)
    jl, jg = jax.value_and_grad(lambda p: jm.loss_fn(p, to_jax(batch), remat=True))(to_jax(P))
    loss, grads = port_grads(port_model(cfg, P), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_tree_close(lm_params_to_numpy(cfg, grads), jg, GRAD_REL, GRAD_ABS)


def test_loss_mask_weights_the_mean():
    jcfg, cfg = _cfgs("qwen3-8b")
    P = np_params(jcfg, 2)
    batch = np_batch(cfg, 3)
    batch["loss_mask"] = (np.random.default_rng(4).random((B, S)) < 0.5).astype(np.float32)
    jl = jbuild(jcfg).loss_fn(to_jax(P), to_jax(batch))
    m = port_model(cfg, P)
    np.testing.assert_allclose(float(m.loss_fn(to_torch(batch))), float(jl), rtol=LOSS_RTOL)
    batch["loss_mask"][:] = 0  # an empty mask divides by one, not by zero
    assert float(m.loss_fn(to_torch(batch))) == 0.0


def test_remat_changes_neither_loss_nor_grads():
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    m = port_model(cfg, np_params(jcfg, 5))
    batch = to_torch(np_batch(cfg, 6))
    named = dict(m.named_parameters())
    out = []
    for remat in (True, False):
        loss = m.loss_fn(batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g1, g0))


def test_eval_model_forward_keeps_no_graph():
    """build_model's model (no parameter requiring grad) records nothing, so
    the served paths run as before."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    m = build_model(cfg, device="cpu")
    out = m.forward(to_torch({"tokens": np_batch(cfg, 0)["tokens"]}))
    assert not out.requires_grad and out.grad_fn is None


# --------------------------------------------------------------------------
# The chunked scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S_, chunk", [(16, 8), (12, 4), (8, 8), (5, 1)])
def test_chunked_scan_equals_the_sequential_scan(S_, chunk):
    rng = np.random.default_rng(S_ + chunk)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S_, 6, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S_, 6, 4)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((2, S_, 4)).astype(np.float32))
    y, h = mamba.chunked_scan(a, b, C, chunk)
    y_ref, h_ref = ref.mamba_scan(a, b, C, return_state=True)
    torch.testing.assert_close(y, y_ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(h, h_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_mamba_forward_value_and_grad_match_the_jax_layer(arch):
    """With grad on, backend="ref" runs `chunked_scan` and "cuda" the kernel's
    plain version with `MambaScanFn`'s gradient; both against the JAX layer's
    chunked associative scan, in value and in the gradient of every input."""
    jcfg, cfg = _cfgs(arch)
    pos = next(i for i, s in enumerate(cfg.pattern) if s.mixer == "mamba")
    tree = {k: np.asarray(v)[0] for k, v in np_params(jcfg, 7)["blocks"][f"pos{pos}"]
            ["mamba"].items()}
    x = np.random.default_rng(8).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jmamba.mamba_forward(p, jcfg, xx) * w)

    jval, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(to_jax(tree), jnp.asarray(x))
    for backend in ("ref", "cuda"):
        layer = mamba.Mamba(cfg, device="cpu", dtype=torch.float32)
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
        xt = torch.from_numpy(x).requires_grad_()
        val = torch.sum(mamba.mamba_forward(layer, cfg, xt, backend=backend)
                        * torch.from_numpy(w))
        named = dict(layer.named_parameters())
        got = torch.autograd.grad(val, [*named.values(), xt])
        np.testing.assert_allclose(float(val), float(jval), rtol=LOSS_RTOL)
        assert_tree_close({n: g.numpy() for n, g in zip(named, got)}, jgp, GRAD_REL, GRAD_ABS)
        assert_tree_close({"x": got[-1].numpy()}, {"x": jgx}, GRAD_REL, GRAD_ABS)


# --------------------------------------------------------------------------
# The optimizers
# --------------------------------------------------------------------------

G, D, H = 2, 8, 6


def np_opt_case(seed: int):
    """A small parameter tree in the JAX layout (stacked [G, ...] blocks, an
    unstacked matrix and vector) and gradients of the same structure."""
    rng = np.random.default_rng(seed)

    def tree():
        return {"embed": rng.standard_normal((16, D)).astype(np.float32),
                "blocks": {"pos0": {"attn": {"wq": rng.standard_normal((G, D, 2, H)).astype(
                    np.float32)}, "norm_mixer": {"scale": rng.standard_normal((G, D)).astype(
                        np.float32)}}},
                "final_norm": {"scale": rng.standard_normal((D,)).astype(np.float32)}}

    return tree(), tree()


def named(tree: dict) -> dict:
    """The port's names for a JAX-layout tree's leaves."""
    out = {}
    for key, x in flat(tree).items():
        if key.startswith("blocks/"):
            for g in range(x.shape[0]):
                out[f"groups.{g}." + key.removeprefix("blocks/").replace("/", ".")] = (
                    torch.from_numpy(x[g].copy()))
        else:
            out[key.replace("/", ".")] = torch.from_numpy(x.copy())
    return out


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("step", [0, 1, 150])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(kind, moment_dtype, step):
    P, Gr = np_opt_case(step)
    jcfg = JOptConfig(kind=kind, moment_dtype=moment_dtype)
    cfg = OptConfig(kind=kind, moment_dtype=moment_dtype)
    rng = np.random.default_rng(100 + step)
    jopt = jax.tree.map(  # non-zero moments (positive second moments)
        lambda z: jnp.asarray(np.abs(rng.standard_normal(z.shape)).astype(np.float32) * 0.1,
                              z.dtype),
        j_init_opt_state(to_jax(P), jcfg))
    update = {"adamw": (j_adamw_update, adamw_update),
              "adafactor": (j_adafactor_update, adafactor_update)}[kind]
    jp, jo = update[0](to_jax(P), to_jax(Gr), jopt, jnp.asarray(step, jnp.int32), jcfg)

    params, grads = named(P), named(Gr)
    opt = init_opt_state(params, cfg)
    jflat = flat(jopt)
    for part, leaves in opt.items():
        assert list(leaves) == [k.removeprefix(part + "/") for k in jflat if k.startswith(part)]
        for key, t in leaves.items():
            t.copy_(torch.from_numpy(np.asarray(jflat[f"{part}/{key}"], np.float32)))
    update[1](params, grads, opt, torch.tensor(step, dtype=torch.int32), cfg)

    p_got = {k: v.numpy() for k, v in params.items()}
    assert_tree_close(named_tree(p_got), jp, UPDATE_REL)
    for part, leaves in opt.items():
        for key, t in leaves.items():
            want = np.asarray(flat(jo)[f"{part}/{key}"], np.float32)
            got = t.float().numpy()
            assert t.dtype == getattr(torch, moment_dtype)
            if moment_dtype == "float32":
                assert np.abs(got - want).max() <= UPDATE_REL * np.abs(want).max(), (part, key)
            else:
                assert (np.abs(got - want) <= bf16_ulp(want)).all(), (part, key)


def named_tree(named_np: dict) -> dict:
    """The inverse of `named`: the JAX-layout tree of port-named arrays."""
    out: dict = {}
    for key, names in param_leaves(named_np).items():
        x = (np.stack([named_np[n] for n in names]) if key.startswith("blocks/")
             else named_np[names[0]])
        node = out
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def test_adafactor_state_has_the_jax_factored_shapes():
    P, _ = np_opt_case(0)
    jst = flat(j_init_opt_state(to_jax(P), JOptConfig(kind="adafactor")))
    st = init_opt_state(named(P), OptConfig(kind="adafactor"))
    got = {f"{part}/{k}": tuple(t.shape) for part, leaves in st.items() for k, t in leaves.items()}
    assert got == {k: tuple(v.shape) for k, v in jst.items()}


def test_quantize_dequantize_matches_jax():
    from repro.training.train_step import _quantize_dequantize as jqd

    g = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    for bits in (4, 8):
        np.testing.assert_array_equal(_quantize_dequantize(torch.from_numpy(g), bits).numpy(),
                                      np.asarray(jqd(jnp.asarray(g), bits)))


# --------------------------------------------------------------------------
# make_train_step against the JAX train step
# --------------------------------------------------------------------------

def _jax_grads(jcfg, accum: int):
    """JAX's train step up to its compression, jitted: the loss and the f32
    gradient of the JAX `loss_fn` with remat, summed over `accum`
    micro-batches by `lax.scan` and divided, as `make_train_step` takes them."""
    loss_fn = functools.partial(jbuild(jcfg).loss_fn, remat=True)

    def grads(params, batch):
        if accum == 1:
            return jax.value_and_grad(loss_fn)(params, batch)

        def micro(carry, mb):
            loss, g = jax.value_and_grad(loss_fn)(params, mb)
            return (carry[0] + loss, jax.tree.map(jnp.add, carry[1], g)), None

        mbs = jax.tree.map(lambda x: x.reshape(accum, x.shape[0] // accum, *x.shape[1:]), batch)
        zero = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (loss, g), _ = jax.lax.scan(micro, (0.0, zero), mbs)
        return loss / accum, jax.tree.map(lambda x: x / accum, g)

    return jax.jit(grads)


def _jax_apply(jopt_cfg):
    """JAX's train step after its compression, jitted: clip, then AdamW."""
    def apply(params, opt, step, grads):
        grads, _ = j_clip_by_global_norm(grads, jopt_cfg.grad_clip)
        return j_adamw_update(params, grads, opt, step, jopt_cfg)

    return jax.jit(apply)


def _as_jax_tree(cfg, named_grads: dict, like) -> dict:
    """The port's gradients (by parameter name) as the JAX tree, each leaf in
    the dtype of `like`'s (the widened bf16 leaves narrow back exactly)."""
    return jax.tree.map(lambda x, w: jnp.asarray(x, w.dtype),
                        lm_params_to_numpy(cfg, named_grads), like)


def _level_flips(gp: np.ndarray, gj: np.ndarray, bits: int) -> np.ndarray:
    """Where the two packages' gradients quantize to different levels (the
    levels of `_quantize_dequantize`, in f32): a mask, after asserting that
    each such element moved by exactly one level and that its gradient lies
    within FLIP_LEVELS of the edge between the two levels on both sides."""
    top = np.float32(2 ** (bits - 1) - 1)
    xp = gp / (np.maximum(np.abs(gp).max(), np.float32(1e-12)) / top)
    xj = gj / (np.maximum(np.abs(gj).max(), np.float32(1e-12)) / top)
    lp, lj = np.round(xp), np.round(xj)
    flip = lp != lj
    if flip.any():
        edge = np.minimum(lp, lj)[flip] + 0.5
        assert (np.abs(lp - lj)[flip] == 1).all()
        assert np.abs(xj[flip] - edge).max() <= FLIP_LEVELS, np.abs(xj[flip] - edge).max()
        assert np.abs(xp[flip] - edge).max() <= FLIP_LEVELS, np.abs(xp[flip] - edge).max()
    return flip


def _lockstep(arch: str, accum: int, compress, param_dtype: str) -> int:
    """Three train steps, each from JAX's state: the port's step and JAX's
    from the same parameters, moments and batch.  Holds, each step, the loss
    and grad_norm to JAX's train step; the pre-compression gradient to
    JAX's; with compression, every element whose quantized level differs to
    a level edge (`_level_flips`); the port's new parameters and moments to
    JAX's clip and AdamW applied to the port's own (quantized) gradient; in
    f32, the new parameters to JAX's train step except at the flipped
    elements.  Returns the number of flipped elements."""
    jcfg, cfg = (dataclasses.replace(c, param_dtype=param_dtype) for c in _cfgs(arch))
    bf16 = param_dtype == "bfloat16"
    step_rtol, grad_rel, loss_rtol = ((BF16_STEP_RTOL, BF16_GRAD_REL, BF16_LOSS_RTOL) if bf16
                                      else (STEP_RTOL, GRAD_REL, STEP_RTOL))
    P = np_params(jcfg, 11)
    jopt_cfg = JOptConfig(lr=1e-3, warmup_steps=2)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    jstate = JTrainState(params=to_jax(P), opt=j_init_opt_state(to_jax(P), jopt_cfg),
                         step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_make_train_step(jbuild(jcfg), jopt_cfg, accum=accum,
                                      compress_bits=compress))
    jgrads, japply = _jax_grads(jcfg, accum), _jax_apply(jopt_cfg)
    flips = 0
    for s in range(3):
        batch = np_batch(cfg, 20 + s)
        np_p, np_o = jax.tree.map(np.asarray, (jstate.params, jstate.opt))
        state = train_state_from_numpy(cfg, np_p, np_o, int(jstate.step), device="cpu")
        step = make_train_step(state.params, opt_cfg, accum=accum, compress_bits=compress)

        _, gp = accumulate_grads(state.params, to_torch(batch), accum=accum)
        _, gj = jgrads(jstate.params, to_jax(batch))
        gp_np, gj_np = flat(lm_params_to_numpy(cfg, gp)), flat(gj)
        assert_tree_close(gp_np, gj_np, grad_rel, GRAD_ABS)
        flipped = {}
        if compress:
            flipped = {k: _level_flips(gp_np[k], np.asarray(gj_np[k], np.float32), compress)
                       for k in gj_np}
            flips += sum(int(f.sum()) for f in flipped.values())
        sent = _compress(gp, compress) if compress else gp
        want_p, want_o = japply(jstate.params, jstate.opt, jstate.step,
                                _as_jax_tree(cfg, sent, jstate.params))

        state, m = step(state, to_torch(batch))
        jstate, jm = jstep(jstate, to_jax(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=loss_rtol)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=step_rtol)
        got = flat(lm_params_to_numpy(cfg, state.params))
        for key, w in flat(want_p).items():
            w = np.asarray(w, np.float32)
            if bf16:
                assert (np.abs(got[key] - w) <= bf16_ulp(w)).all(), key
            else:
                assert np.abs(got[key] - w).max() <= UPDATE_REL * np.abs(w).max(), key
        for part, leaves in state.opt.items():
            want = flat(want_o[part])
            for key, t in leaves.items():
                w = np.asarray(want[key], np.float32)
                assert np.abs(t.float().numpy() - w).max() <= UPDATE_REL * np.abs(w).max(), (
                    part, key)
        if not bf16:
            for key, w in flat(jstate.params).items():
                w = np.asarray(w, np.float64)
                d = np.abs(got[key] - w)
                if key in flipped:
                    d = np.where(flipped[key], 0.0, d)
                assert d.max() <= PARAM_REL * np.abs(w).max(), (key, d.max())
    assert int(state.step) == int(jstate.step) == 3
    return flips


@pytest.mark.parametrize("accum, compress", [(1, None), (2, None), (1, 8), (2, 8)])
@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_train_step_matches_jax(arch, accum, compress):
    """Without compression the port runs its own three steps and ends within
    PARAM_REL of JAX's; 8-bit quantization is discontinuous (an element
    within rounding of a level's edge rounds to the neighbouring level in
    one package), so the compressed cases run in lockstep (`_lockstep`)."""
    if compress:
        _lockstep(arch, accum, compress, "float32")
        return
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 11)
    jopt_cfg = JOptConfig(lr=1e-3, warmup_steps=2)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    jopt = j_init_opt_state(to_jax(P), jopt_cfg)
    jstate = JTrainState(params=to_jax(P), opt=jopt, step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_make_train_step(jbuild(jcfg), jopt_cfg, accum=accum))
    state = train_state_from_numpy(cfg, P, jax.tree.map(np.asarray, jopt), 0, device="cpu")
    step = make_train_step(state.params, opt_cfg, accum=accum)
    for s in range(3):
        batch = np_batch(cfg, 20 + s)
        jstate, jm = jstep(jstate, to_jax(batch))
        state, m = step(state, to_torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
    assert int(state.step) == int(jstate.step) == 3
    assert_tree_close(flat(lm_params_to_numpy(cfg, state.params)), flat(jstate.params),
                      PARAM_REL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_train_step_with_bf16_params_matches_jax(arch):
    """bf16 parameters, as the card trains these two archs, in lockstep: the
    two packages' bf16 forwards round at different points, so their
    gradients part by up to BF16_GRAD_REL and Adam's normalized step turns a
    small gradient's sign into a whole lr; the update itself is held to one
    bf16 ulp per element given the port's gradient.  Reduced jamba has no
    bf16 case: its bf16 gradient is 1.23x a leaf's max away from its f32
    gradient in the JAX package itself (1.54x in the port)."""
    _lockstep(arch, 1, None, "bfloat16")


# --------------------------------------------------------------------------
# The port's own copies of tests/test_substrate.py's optimizer and loop tests
# --------------------------------------------------------------------------

def tiny_model():
    return build_model(reduced(get_config("qwen3-8b"), groups=1), device="cpu")


def fresh(model, opt_cfg, seed: int = 0):
    return init_train_state(model, torch.Generator().manual_seed(seed), opt_cfg)


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_loss_decreases(kind):
    m = tiny_model()
    opt = OptConfig(kind=kind, lr=1e-2, warmup_steps=1)
    state = fresh(m, opt)
    step = make_train_step(m, opt)
    dc = DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4)
    losses = []
    for _ in range(8):
        state, metrics = step(state, synthetic_batch(dc, 0))  # same batch: must overfit
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_bf16_moments():
    state = fresh(tiny_model(), OptConfig(moment_dtype="bfloat16"))
    assert all(x.dtype == torch.bfloat16 for x in state.opt["m"].values())
    assert state.step.dtype == torch.int32 and int(state.step) == 0


def test_grad_accumulation_matches_full_batch():
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    m1, m2 = tiny_model(), tiny_model()
    dc = DataConfig(vocab=m1.cfg.vocab, seq_len=16, global_batch=8)
    batch = synthetic_batch(dc, 3)
    s1, s2 = fresh(m1, opt), fresh(m2, opt)
    s1, r1 = make_train_step(m1, opt, accum=1)(s1, batch)
    s2, r2 = make_train_step(m2, opt, accum=4)(s2, batch)
    assert float(r1["loss"]) == pytest.approx(float(r2["loss"]), rel=1e-4)
    for a, b in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-5)


def test_gradient_compression_close_to_exact():
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    dc = DataConfig(vocab=128, seq_len=16, global_batch=4)
    batch = synthetic_batch(dc, 0)
    out = []
    for bits in (None, 8):
        m = tiny_model()
        _, metrics = make_train_step(m, opt, compress_bits=bits)(fresh(m, opt), batch)
        out.append(float(metrics["grad_norm"]))
    assert out[1] == pytest.approx(out[0], rel=0.05)


def _run(tmp, fail_at=None, arch="qwen3-8b", async_writes=False):
    m = build_model(reduced(get_config(arch), groups=1), device="cpu")
    dc = DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4)
    fired = {"done": False}

    def injector(step):
        if fail_at is not None and step == fail_at and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    ck = Checkpointer(tmp, async_writes=async_writes)
    return run_training(
        m, dc, OptConfig(lr=1e-3, warmup_steps=1),
        RunConfig(total_steps=12, ckpt_every=4, log_every=100, metrics=[]),
        ck, fail_injector=injector if fail_at else None,
    )


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b"])
def test_crash_resume_bitwise_identical(tmp_path, arch):
    clean = _run(str(tmp_path / "clean"), arch=arch)
    crashed = _run(str(tmp_path / "crash"), fail_at=6, arch=arch)
    assert clean["restarts"] == 0 and crashed["restarts"] == 1
    assert _params_equal(clean["final_state"].params, crashed["final_state"].params)
    by_step = {r["step"]: r["loss"] for r in crashed["metrics"]}  # replayed steps: last run
    assert by_step == {r["step"]: r["loss"] for r in clean["metrics"]}
    losses = [r["loss"] for r in clean["metrics"]]
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("deterministic", [True, False])
def test_run_training_runs_under_deterministic_algorithms(tmp_path, deterministic):
    """Every step runs with deterministic algorithms on (warn-only) unless
    RunConfig.deterministic is off, and the process's setting comes back."""
    seen = []

    def probe(step):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled()))

    m = build_model(reduced(get_config("qwen3-8b"), groups=1), device="cpu")
    dc = DataConfig(vocab=m.cfg.vocab, seq_len=8, global_batch=2)
    assert not torch.are_deterministic_algorithms_enabled()
    run_training(m, dc, OptConfig(warmup_steps=1),
                 RunConfig(total_steps=3, ckpt_every=10, metrics=[], deterministic=deterministic),
                 Checkpointer(str(tmp_path)), fail_injector=probe)
    assert seen == [(deterministic, deterministic)] * 3
    assert not torch.are_deterministic_algorithms_enabled()


def test_resume_from_an_async_checkpoint(tmp_path):
    """A run that stops at step 8 and one resumed from its checkpoints to 12
    end where an uninterrupted run ends (async writes)."""
    clean = _run(str(tmp_path / "clean"), async_writes=True)
    m = build_model(reduced(get_config("qwen3-8b"), groups=1), device="cpu")
    dc = DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4)
    ck = Checkpointer(str(tmp_path / "split"))
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    run_training(m, dc, opt, RunConfig(total_steps=8, ckpt_every=4, metrics=[]), ck)
    assert ck.latest_step() == 8
    out = run_training(m, dc, opt, RunConfig(total_steps=12, ckpt_every=4, metrics=[]), ck)
    assert [r["step"] for r in out["metrics"]] == [9, 10, 11, 12]
    assert _params_equal(clean["final_state"].params, out["final_state"].params)


def test_straggler_watchdog():
    wd = StragglerWatchdog(window=16, factor=3.0)
    for s in range(10):
        wd.observe(s, 0.01)
    assert wd.observe(10, 0.2) is True
    assert wd.alarms == 1 and wd.slow_steps == [10]


def test_data_iterator_is_keyed_by_step():
    dc = DataConfig(vocab=128, seq_len=16, global_batch=2)
    it = data_iterator(dc, start_step=5)
    for want in (5, 6):
        step, batch = next(it)
        assert step == want
        assert torch.equal(batch["tokens"], synthetic_batch(dc, want)["tokens"])


def test_train_launcher_refuses_a_missing_card_and_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "qwen3-8b", "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "x")])
    out = train.main(["--arch", "qwen3-8b", "--reduced", "--steps", "4", "--batch", "4",
                      "--seq", "16", "--ckpt-dir", str(tmp_path / "c"), "--device", "cpu"])
    assert out["restarts"] == 0 and [r["step"] for r in out["metrics"]] == [1, 2, 3, 4]
    assert "done: steps=4" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path / "c")).latest_step() == 4


# --------------------------------------------------------------------------
# The autograd Functions: their backward is the gradient of their forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("H, KV, causal, window, softcap, chunk", [
    (2, 2, True, None, None, 8),     # causal
    (2, 1, True, 3, None, 4),        # windowed, GQA 2:1
    (4, 2, False, None, 5.0, 3),     # bidirectional, softcapped, short last chunk
    (3, 1, True, 4, 2.0, 8),         # all of them, GQA 3:1
])
def test_flash_attention_fn_gradcheck(H, KV, causal, window, softcap, chunk):
    """In f64 on the CPU the forward is the kernel's plain version (dense
    softmax) and the backward `blocked_attention`'s gradient: gradcheck holds
    the one against finite differences of the other."""
    from repro_torch.kernels.autograd import FlashAttentionFn

    rng = np.random.default_rng(H * 10 + KV)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
               for shape in ((2, 7, H, 4), (2, 7, KV, 4), (2, 7, KV, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal, window, softcap, chunk),
        (q, k, v))


@pytest.mark.parametrize("S_, chunk, outputs", [(8, 4, "both"), (12, 4, "y"), (6, 2, "h"),
                                                (4, 4, "both")])
def test_mamba_scan_fn_gradcheck(S_, chunk, outputs):
    """Forward: the sequential scan (the kernel's plain version); backward: the
    chunked scan's gradient, chunk by chunk, through y, h_S or both."""
    from repro_torch.kernels.autograd import MambaScanFn

    rng = np.random.default_rng(S_ + chunk)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S_, 3, 2))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, S_, 3, 2))).requires_grad_()
    C = torch.from_numpy(rng.standard_normal((2, S_, 2))).requires_grad_()

    def f(a, b, C):
        y, h = MambaScanFn.apply(a, b, C, chunk)
        return {"both": (y, h), "y": y, "h": h}[outputs]

    assert torch.autograd.gradcheck(f, (a, b, C))
