"""The port's checkpointer: its own round trips (copies of
tests/test_substrate.py's checkpoint tests) and the JAX package's format in
both directions, bit for bit, on the CPU; and `launch.serve --ckpt-dir`.

Leaf i of a checkpoint is leaf i of the JAX `TrainState` of the same config
and optimizer.  The JAX package writes a bf16 leaf as a 2-byte void array
('<V2', manifest dtype "bfloat16"); its own `restore` cannot read one back
(`jnp.asarray` refuses a void array), so bf16 travels from JAX to the port
only, and f32 both ways.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.train_step import init_train_state as j_init_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import state_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.models import build_model
from repro_torch.runtime import RunConfig, run_training
from repro_torch.serving import SamplerConfig, ServeEngine
from repro_torch.training import OptConfig, init_train_state


def tiny(arch: str = "qwen3-8b", dtype: str = "float32"):
    return dataclasses.replace(reduced(get_config(arch), groups=2), param_dtype=dtype)


def port_state(cfg, opt=OptConfig(), seed: int = 0):
    m = build_model(cfg, device="cpu")
    return init_train_state(m, torch.Generator().manual_seed(seed), opt)


def bits(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bits as an integer array (so NaN payloads compare
    too)."""
    t = t.detach().to("cpu", copy=True)
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.contiguous().view(view).numpy()


def jbits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[x.itemsize])


def port_leaf_bits(state) -> list[np.ndarray]:
    """Each JAX leaf of a port state, as bits (stacked parameters stacked)."""
    out = []
    for path, tensors in state_leaves(state):
        t = torch.stack(tensors) if path.startswith("params/blocks/") else tensors[0]
        out.append(bits(t))
    return out


def states_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(port_leaf_bits(a), port_leaf_bits(b)))


# --------------------------------------------------------------------------
# The port's own round trips
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind, dtype, moments", [("adamw", "float32", "float32"),
                                                  ("adamw", "bfloat16", "bfloat16"),
                                                  ("adafactor", "float32", "float32")])
def test_round_trip_bitwise(tmp_path, kind, dtype, moments):
    cfg = tiny("jamba-v0.1-52b", dtype)
    opt = OptConfig(kind=kind, moment_dtype=moments)
    state = port_state(cfg, opt)
    for part in state.opt.values():  # non-zero moments, so their bits are seen
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state.step.fill_(7)
    ck = Checkpointer(str(tmp_path), async_writes=False)
    ck.save(7, state)
    other = port_state(cfg, opt, seed=1)
    assert not states_equal(state, other)
    restored = ck.restore(other, step=7)
    assert restored is other and states_equal(state, restored)
    assert ck.latest_step() == 7 and int(restored.step) == 7


def test_async_and_prune(tmp_path):
    state = port_state(tiny())
    ck = Checkpointer(str(tmp_path), keep_last=2, async_writes=True)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_save_copies_before_the_state_moves(tmp_path):
    """An async save holds the values at the call, though the next step
    updates the tensors in place."""
    state = port_state(tiny())
    want = port_leaf_bits(state)
    ck = Checkpointer(str(tmp_path), async_writes=True)
    ck.save(1, state)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    ck.wait()
    restored = ck.restore(port_state(tiny(), seed=3))
    assert all(np.array_equal(a, b) for a, b in zip(port_leaf_bits(restored), want))


def test_tmp_dir_never_visible_as_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), async_writes=False)
    ck.save(1, port_state(tiny()))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")  # a write cut before its rename
    assert ck.all_steps() == [1] and ck.latest_step() == 1


def test_restore_refuses_another_structure(tmp_path):
    ck = Checkpointer(str(tmp_path), async_writes=False)
    ck.save(1, port_state(tiny()))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(port_state(tiny("falcon-mamba-7b")))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(port_state(tiny(), OptConfig(kind="adafactor")))
    with pytest.raises(ValueError, match="Custom node type mismatch"):
        ck.restore(port_state(tiny()), shardings={})  # shardings: a TrainState of specs
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(port_state(tiny()))


# --------------------------------------------------------------------------
# The JAX package's format, both ways
# --------------------------------------------------------------------------

CROSS = [("qwen3-8b", "float32", "adamw", "float32"),
         ("jamba-v0.1-52b", "float32", "adafactor", "float32"),
         ("falcon-mamba-7b", "bfloat16", "adamw", "float32"),
         ("qwen3-8b", "bfloat16", "adamw", "bfloat16")]


def jax_state(arch: str, dtype: str, kind: str, moments: str, step: int):
    jcfg = dataclasses.replace(jreduced(jget(arch), groups=2), param_dtype=dtype)
    opt = JOptConfig(kind=kind, moment_dtype=moments)
    st = j_init_train_state(jbuild(jcfg), jax.random.key(3), opt)
    rng = np.random.default_rng(step)
    st = jax.tree.map(  # every leaf drawn, so that no two leaves look alike
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype) if x.ndim else x, st)
    return dataclasses.replace(st, step=jnp.asarray(step, jnp.int32))


@pytest.mark.parametrize("arch, dtype, kind, moments", CROSS)
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, arch, dtype, kind,
                                                           moments):
    jst = jax_state(arch, dtype, kind, moments, 5)
    JCheckpointer(str(tmp_path), async_writes=False).save(5, jst)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        manifest = json.load(f)
    state = Checkpointer(str(tmp_path)).restore(
        port_state(tiny(arch, dtype), OptConfig(kind=kind, moment_dtype=moments)))
    want = [jbits(x) for x in jax.tree.leaves(jst)]
    got = port_leaf_bits(state)
    assert len(got) == len(want) == manifest["n_leaves"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), (i, manifest["dtypes"][i])
    assert int(state.step) == 5


@pytest.mark.parametrize("arch, kind", [("qwen3-8b", "adamw"), ("jamba-v0.1-52b", "adafactor"),
                                        ("falcon-mamba-7b", "adamw")])
def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, arch, kind):
    cfg = tiny(arch)
    state = port_state(cfg, OptConfig(kind=kind))
    for part in state.opt.values():
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state.step.fill_(9)
    Checkpointer(str(tmp_path), async_writes=False).save(9, state)
    example = jax_state(arch, "float32", kind, "float32", 0)
    restored = JCheckpointer(str(tmp_path)).restore(example)
    got = [jbits(x) for x in jax.tree.leaves(restored)]
    want = port_leaf_bits(state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), i
    with open(tmp_path / "step_00000009" / "manifest.json") as f:
        assert set(json.load(f)) == {"step", "n_leaves", "treedef", "dtypes", "shapes"}


def test_bf16_leaves_are_written_as_the_jax_package_writes_them(tmp_path):
    jst = jax_state("qwen3-8b", "bfloat16", "adamw", "bfloat16", 4)
    JCheckpointer(str(tmp_path / "jax"), async_writes=False).save(4, jst)
    state = Checkpointer(str(tmp_path / "jax")).restore(
        port_state(tiny("qwen3-8b", "bfloat16"), OptConfig(moment_dtype="bfloat16")))
    Checkpointer(str(tmp_path / "port"), async_writes=False).save(4, state)
    jd, pd = tmp_path / "jax" / "step_00000004", tmp_path / "port" / "step_00000004"
    leaves = sorted(n for n in os.listdir(jd) if n.endswith(".npy"))
    assert leaves == sorted(n for n in os.listdir(pd) if n.endswith(".npy"))
    for n in leaves:
        assert (jd / n).read_bytes() == (pd / n).read_bytes(), n
    jm, pm = (json.loads((d / "manifest.json").read_text()) for d in (jd, pd))
    assert {k: v for k, v in jm.items() if k != "treedef"} == {
        k: v for k, v in pm.items() if k != "treedef"}


# --------------------------------------------------------------------------
# Serving a trained model from its checkpoint
# --------------------------------------------------------------------------

def test_serve_restores_the_trained_model_and_generates_its_tokens(tmp_path, capsys):
    from repro_torch.launch import serve

    cfg = reduced(get_config("qwen3-8b"), groups=2)
    model = build_model(cfg, device="cpu")
    out = run_training(model, DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
                       OptConfig(lr=3e-3, warmup_steps=1),
                       RunConfig(total_steps=6, ckpt_every=3, metrics=[]),
                       Checkpointer(str(tmp_path)))
    trained = out["final_state"].params.eval().requires_grad_(False)
    argv = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--max-new", "8"]
    served = serve.main(argv)
    assert "restored step 6" in capsys.readouterr().out
    from repro_torch.data import synthetic_batch

    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    prompts = synthetic_batch(dc, 123)["tokens"][:, :16].tolist()
    engine = ServeEngine(trained, max_len=64, batch_size=2,
                         sampler=SamplerConfig(max_new_tokens=8), device="cpu")
    assert served == engine.generate(prompts)
    fresh = serve.main(argv[:-4] + ["--max-new", "8"])  # no checkpoint: the seed's model
    assert fresh != served
