"""Shared helpers of the port's training tests against the JAX package
(`tests/test_torch_training.py`, `tests/test_torch_training_ssm.py`,
`tests/test_torch_data_parallel.py`): numpy-drawn parameters and batches
in the JAX tree's shapes, tree comparisons, JAX's train step split at its
compression, and the case bodies that the two training files share, so that
each case keeps its test name and assertions in whichever file holds it.
The tolerances are stated in `tests/test_torch_training.py`'s docstring.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.train_step import TrainState as JTrainState
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy, train_state_from_numpy
from repro_torch.models import build_model
from repro_torch.runtime import RunConfig, run_training
from repro_torch.training import OptConfig, make_train_step
from repro_torch.training.train_step import _compress, accumulate_grads

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


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


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


def loss_and_grads_case(arch):
    """test_loss_and_grads_match_jax's body."""
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 0)
    batch = np_batch(cfg, 1)
    jm = jbuild(jcfg)
    jl, jg = jax.value_and_grad(lambda p: jm.loss_fn(p, to_jax(batch), remat=True))(to_jax(P))
    loss, grads = port_grads(port_model(cfg, P), batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_tree_close(lm_params_to_numpy(cfg, grads), jg, GRAD_REL, GRAD_ABS)


def train_step_case(arch, accum, compress):
    """test_train_step_matches_jax's body.  Without compression the port runs its own three steps and ends within
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


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


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


def crash_resume_case(tmp_path, arch):
    """test_crash_resume_bitwise_identical's body."""
    clean = _run(str(tmp_path / "clean"), arch=arch)
    crashed = _run(str(tmp_path / "crash"), fail_at=6, arch=arch)
    assert clean["restarts"] == 0 and crashed["restarts"] == 1
    assert _params_equal(clean["final_state"].params, crashed["final_state"].params)
    by_step = {r["step"]: r["loss"] for r in crashed["metrics"]}  # replayed steps: last run
    assert by_step == {r["step"]: r["loss"] for r in clean["metrics"]}
    losses = [r["loss"] for r in clean["metrics"]]
    assert losses[-1] < losses[0], losses
