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

The cases of the recurrent archs (falcon-mamba-7b and jamba-v0.1-52b, the
slowest: JAX compiles each of their steps) are in
`tests/test_torch_training_ssm.py`; both files take their helpers and
shared case bodies from `tests/multidev/torch_training_common.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model_zoo import build_model as jbuild
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adafactor_update as j_adafactor_update
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, data_iterator, synthetic_batch
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
from repro_torch.training.train_step import _quantize_dequantize

sys.path.insert(0, str(Path(__file__).resolve().parent / "multidev"))
try:
    from torch_training_common import (
        LOSS_RTOL,
        B,
        S,
        UPDATE_REL,
        _cfgs,
        _lockstep,
        _params_equal,
        _run,
        assert_tree_close,
        bf16_ulp,
        crash_resume_case,
        flat,
        loss_and_grads_case,
        np_batch,
        np_params,
        port_model,
        to_jax,
        to_torch,
        train_step_case,
    )
finally:
    sys.path.remove(str(Path(__file__).resolve().parent / "multidev"))

# The recurrent archs' parity cases are in tests/test_torch_training_ssm.py.
SSM_ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b")

# --------------------------------------------------------------------------
# loss_fn and its gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(SSM_ARCHS)))
def test_loss_and_grads_match_jax(arch):
    loss_and_grads_case(arch)


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

@pytest.mark.parametrize("accum, compress", [(1, None), (2, None), (1, 8), (2, 8)])
@pytest.mark.parametrize("arch", ["qwen3-8b"])
def test_train_step_matches_jax(arch, accum, compress):
    """Without compression the port runs its own three steps and ends within
    PARAM_REL of JAX's; 8-bit quantization is discontinuous (an element
    within rounding of a level's edge rounds to the neighbouring level in
    one package), so the compressed cases run in lockstep (`_lockstep`).
    The SSM archs' cases are in tests/test_torch_training_ssm.py."""
    train_step_case(arch, accum, compress)



@pytest.mark.parametrize("arch", ["qwen3-8b"])
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


@pytest.mark.parametrize("arch", ["qwen3-8b"])
def test_crash_resume_bitwise_identical(tmp_path, arch):
    crash_resume_case(tmp_path, arch)



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
