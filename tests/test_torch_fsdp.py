"""The port's training state sharded over the "data" axis
(`repro_torch.parallel.fsdp`, `init_train_state(rules=...)`,
`run_training(rules=...)`, `launch.train` under a torchrun environment)
against the JAX package's one-device train step on the global batch and
against the JAX rules' layout, on gloo CPU ranks.

`tests/multidev/torch_fsdp_cases.py` runs 2 and 4 ranks (one subprocess each,
with a time limit) on `CASES`: reduced qwen3-8b, qwen3-moe-235b-a22b and
falcon-mamba-7b on 2 ranks (plain, accum = 2, 8-bit compression), reduced
gemma2-9b (a tied head: one gathered embed serves both uses) and
hubert-xlarge (frames: the embed unused) on 2 ranks, reduced qwen3-8b on 4
ranks (plain, accum = 2), and reduced qwen3-8b with d_model = 66 on 4 ranks, where "data" divides no leaf (every fsdp template names
d_model) and the state stays whole.  The ranks run their own two-step
trajectory from the state they shard; this file runs JAX's train step from
each state the ranks started a step from (lockstep, as
`test_torch_data_parallel.py`) on the same global batch.  Tolerances, f32,
as there:
- each step's loss and gradient norm within 2e-4 relative (STEP_RTOL);
- the pre-compression gradient, gathered whole, per leaf within 2e-4 of
  the leaf's max |g_jax| plus 1e-7 (GRAD_REL, GRAD_ABS);
- with compression, an element whose quantized level differs moved by one
  level and lies within FLIP_LEVELS of that level's edge on both sides;
- the new parameters and moments within 1e-6 of each leaf's max
  (UPDATE_REL) of JAX's AdamW applied to the ranks' own (quantized)
  gradient clipped by JAX's rule at its exact norm (`exact_clip`: the norm
  in f64), and within 1e-4 (PARAM_REL) of JAX's own step but at flipped
  elements.  JAX's own f32 norm is held by the grad_norm check: on the CPU
  its sums of squares are off by up to ~1e-6 of the norm (8.7e-7 on
  moe_compress8's first gradient, whose `moe/w_in` sum is off by 1.9e-4),
  as much as UPDATE_REL, while the port's sums stay within ~1e-8, so the
  moments (0.1 g / norm after one step) are held to the exact clip.
Each rank holds exactly the slice of each leaf that the JAX rules give it
(`repro.parallel.sharding` on an abstract (R, 1) mesh), in shape and in
bits; the gathered parameters are bit-alike across ranks.  Crash and
resume on two sharded ranks ends bit-identical; checkpoints restore
across layouts (one card -> 2 ranks -> 4 ranks, one card -> 4 ranks, and
each back onto one card) bit for bit; `launch.train.main` on two gloo ranks
shards its state and prints one `done:` line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.train_step import _quantize_dequantize as j_qd
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer, param_leaves
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import Mesh, leaf_shard, make_rules
from repro_torch.training import OptConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_fsdp_cases.py"
SUBPROCESS_TIMEOUT_S = 300

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_fsdp_cases as cases
    from torch_training_common import (
        GRAD_ABS,
        GRAD_REL,
        PARAM_REL,
        STEP_RTOL,
        UPDATE_REL,
        _jax_grads,
        _level_flips,
        assert_tree_close,
        flat,
        np_batch,
        np_params,
        to_jax,
    )
finally:
    sys.path.remove(str(MULTIDEV))


def jcfg_for(arch: str, d_model=None):
    """The JAX package's reduced config (`d_model` replaced if given)."""
    jcfg = jreduced(jget(arch))
    return jcfg if d_model is None else dataclasses.replace(jcfg, d_model=d_model)


def jcfg_of(name: str):
    """The JAX package's config of a case."""
    _, arch, _, _, _, d_model = cases.CASES[name]
    return jcfg_for(arch, d_model)


def _jax_adamw(jopt_cfg):
    return jax.jit(lambda params, opt, step, grads: j_adamw_update(params, grads, opt, step,
                                                                   jopt_cfg))


def exact_clip(grads: dict, max_norm: float) -> dict:
    """JAX's `clip_by_global_norm` rule (scale = min(1, max_norm / max(norm,
    1e-12)) in f32, each leaf times it in f32) at the norm of `grads` taken
    in f64 and rounded to f32."""
    norm = np.float32(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))
    scale = np.minimum(np.float32(1.0), np.float32(max_norm) / np.maximum(norm, np.float32(1e-12)))
    return {k: (g.astype(np.float32) * scale).astype(g.dtype) for k, g in grads.items()}


def _batch(name: str, step: int) -> dict:
    B = cases.CASES[name][4]
    return np_batch(jcfg_of(name), 500 + 10 * step + sorted(cases.CASES).index(name), batch=B)


class _Jax:
    """JAX's train step split at its compression, jitted once per case
    config and accum."""

    def __init__(self):
        self.cfg = JOptConfig(lr=cases.LR, warmup_steps=cases.WARMUP)
        self.adamw = _jax_adamw(self.cfg)
        self.clip = jax.jit(lambda g: j_clip_by_global_norm(g, self.cfg.grad_clip))
        self.grads = functools.lru_cache(None)(
            lambda arch, d_model, accum: _jax_grads(jcfg_for(arch, d_model), accum))

    def step(self, name: str, params, opt, step: int, batch: dict) -> dict:
        _, arch, accum, bits, _, d_model = cases.CASES[name]
        loss, g = self.grads(arch, d_model, accum)(params, to_jax(batch))
        sent = jax.tree.map(lambda x: j_qd(x, bits), g) if bits else g
        clipped, norm = self.clip(sent)
        p, o = self.adamw(params, opt, jnp.asarray(step, jnp.int32), clipped)
        return {"loss": float(loss), "grad_norm": float(norm), "g": g, "p": p, "o": o}


def _state(npz, s: int):
    def tree(prefix):
        return cases._nest({k[len(prefix):]: jnp.asarray(npz[k]) for k in npz.files
                            if k.startswith(prefix)})
    return tree(f"s{s}/p/"), {"m": tree(f"s{s}/m/"), "v": tree(f"s{s}/v/")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_card_checkpoint(root: Path) -> dict:
    """The layout config's one-card state at step 5, every leaf drawn,
    saved into root/ckpt_one; returns its leaves as numpy."""
    sys.path.insert(0, str(MULTIDEV))
    try:
        cfg = cases.layout_cfg()
        model = build_model(cfg, device="cpu", seed=7)
        state = init_train_state(model, torch.Generator().manual_seed(7), OptConfig())
        for part in state.opt.values():
            for t in part.values():
                t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
        state.step.fill_(5)
        Checkpointer(str(root / "ckpt_one"), async_writes=False).save(5, state)
        return cases.whole_state(state)
    finally:
        sys.path.remove(str(MULTIDEV))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 2- and 4-rank runs and the two launcher ranks; meanwhile
    takes JAX's step 0; then the 4-rank restore of the 2-rank checkpoint
    and JAX's later steps from the ranks' states.  Returns (JAX's results by
    case and step, the output root, the launcher's logs, the jitted JAX
    step, the one-card checkpoint's leaves)."""
    root = tmp_path_factory.mktemp("fsdp")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for name in cases.CASES:
        params[name] = np_params(jcfg_of(name), 13)
        np.savez(in_dir / f"params_{name}.npz", **cases._flat(params[name]))
        for s in range(cases.STEPS):
            np.savez(in_dir / f"batch_{name}_{s}.npz", **_batch(name, s))
    one = _one_card_checkpoint(in_dir)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for world in (2, 4):
        out = root / f"r{world}"
        out.mkdir()
        procs[f"r{world}"] = subprocess.Popen(
            [sys.executable, str(SCRIPT), str(world), str(in_dir), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _free_port()
    for rank in range(2):
        procs[f"launch{rank}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-8b", "--reduced",
             "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt-dir", str(root / "launch"),
             "--device", "cpu"],
            env={**env, "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jx = _Jax()
    want = {}
    try:
        for name in cases.CASES:  # step 0, while the ranks run
            P = to_jax(params[name])
            zeros = jax.tree.map(jnp.zeros_like, P)
            want[name] = [jx.step(name, P, {"m": zeros, "v": zeros}, 0, _batch(name, 0))]
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S) for k, p in procs.items()}
        assert procs["r2"].returncode == 0, logs["r2"][0][-4000:]
        (root / "layouts").mkdir()
        procs["layouts"] = subprocess.Popen(
            [sys.executable, str(SCRIPT), "layouts", str(in_dir), str(root / "layouts")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, case in cases.CASES.items():
            npz = np.load(root / f"r{case[0]}" / f"{name}.npz")
            for s in range(1, cases.STEPS):
                P, opt = _state(npz, s)
                want[name].append(jx.step(name, P, opt, s, _batch(name, s)))
        logs["layouts"] = procs["layouts"].communicate(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{str(logs.get(k, ''))[-4000:]}"
    return want, root, logs, jx, one


@pytest.mark.parametrize("name", list(cases.CASES))
def test_sharded_step_matches_the_jax_one_device_step(runs, name):
    want, root, _, jx, _ = runs
    world, _, _, bits, _, _ = cases.CASES[name]
    npz = np.load(root / f"r{world}" / f"{name}.npz")
    flips_total = 0
    for s in range(cases.STEPS):
        w = want[name][s]
        np.testing.assert_allclose(float(npz[f"s{s}/loss"]), w["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(float(npz[f"s{s}/grad_norm"]), w["grad_norm"], rtol=STEP_RTOL)
        gp = {k[len(f"s{s}/g/"):]: npz[k] for k in npz.files if k.startswith(f"s{s}/g/")}
        gj = flat(w["g"])
        assert_tree_close(gp, gj, GRAD_REL, GRAD_ABS)
        flipped = {}
        if bits:
            flipped = {k: _level_flips(gp[k], np.asarray(gj[k], np.float32), bits) for k in gj}
            flips_total += sum(int(f.sum()) for f in flipped.values())
        P, opt = _state(npz, s)
        sent = {k: np.asarray(j_qd(jnp.asarray(v), bits)) if bits else v for k, v in gp.items()}
        clipped = cases._nest({k: jnp.asarray(v) for k, v in
                               exact_clip(sent, jx.cfg.grad_clip).items()})
        ap, ao = jx.adamw(P, opt, jnp.asarray(s, jnp.int32), clipped)
        nxt = (f"s{s + 1}/" if s + 1 < cases.STEPS else "final/")
        got_p = {k[len(nxt) + 2:]: npz[k] for k in npz.files if k.startswith(nxt + "p/")}
        for key, x in flat(ap).items():
            x = np.asarray(x, np.float32)
            assert np.abs(got_p[key] - x).max() <= UPDATE_REL * np.abs(x).max(), key
        if s + 1 < cases.STEPS:
            for part in ("m", "v"):
                for key, x in flat(ao[part]).items():
                    x = np.asarray(x, np.float32)
                    got = npz[f"{nxt}{part}/{key}"]
                    assert np.abs(got - x).max() <= UPDATE_REL * np.abs(x).max(), (part, key)
        for key, x in flat(w["p"]).items():
            x = np.asarray(x, np.float64)
            d = np.abs(got_p[key] - x)
            if key in flipped:
                d = np.where(flipped[key], 0.0, d)
            assert d.max() <= PARAM_REL * np.abs(x).max(), (key, d.max())
    if bits:  # a handful of edge elements at most
        assert flips_total <= 16, flips_total


def jax_rule_slice(whole: np.ndarray, key: str, jcfg, world: int, rank: int) -> np.ndarray:
    """Rank `rank`'s slice of the whole JAX leaf `key` ("p/blocks/...",
    "m/...", "v/..."; a moment carries its parameter's spec) under the JAX
    package's rules on an abstract (world, 1) ("data", "model") mesh: the
    dimension whose sanitized spec names "data", cut in `world` pieces."""
    mesh = jax.sharding.AbstractMesh((world, 1), ("data", "model"))
    specs = J.tree_pspecs(jbuild(jcfg).param_specs(), J.make_rules(mesh, model_cfg=jcfg))
    spec = specs
    for k in key.split("/")[1:]:
        spec = spec[k]
    spec = J.sanitize_pspec(spec, whole.shape, mesh)
    for d, entry in enumerate(spec):
        if entry == "data" or (isinstance(entry, tuple) and "data" in entry):
            n = whole.shape[d] // world
            return np.take(whole, range(rank * n, (rank + 1) * n), axis=d)
    return whole


def _layout_cases():
    return [(name, r) for name, c in cases.CASES.items() for r in range(c[0])]


@pytest.mark.parametrize("name, rank", _layout_cases())
def test_each_rank_holds_its_jax_rule_slices(runs, name, rank):
    """The final parameters and moments a rank holds equal, in shape and in
    bits, the JAX-rule slice of the leaves as rank 0 gathered them whole."""
    _, root, _, _, _ = runs
    world = cases.CASES[name][0]
    npz = np.load(root / f"r{world}" / f"{name}.npz")
    mine = np.load(root / f"r{world}" / f"{name}_rank{rank}.npz")
    jcfg = jcfg_of(name)
    for key in mine.files:
        spec_of = key if key.startswith("p/") else "p/" + key.split("/", 1)[1]
        want = jax_rule_slice(npz[f"final/{key}"], spec_of, jcfg, world, rank)
        assert mine[key].shape == want.shape, key
        assert np.array_equal(mine[key], want), key


def test_the_gathered_parameters_are_bit_alike_across_ranks(runs):
    _, root, _, _, _ = runs
    for world in (2, 4):
        facts = [json.loads((root / f"r{world}" / f"rank{r}.json").read_text())
                 for r in range(world)]
        assert all(f["digests"] == facts[0]["digests"] for f in facts)
        assert set(facts[0]["digests"]) == {n for n, c in cases.CASES.items() if c[0] == world}


def test_a_leaf_the_axis_does_not_divide_stays_whole(runs):
    """d_model = 66 on 4 ranks: "data" divides no leaf, so every rank holds
    every leaf whole (GSPMD replicates them); with d_model = 64 the norm
    scales, whose templates name no axis, stay whole on every rank."""
    _, root, _, _, _ = runs
    whole = np.load(root / "r4" / "qwen3_d66_4ranks.npz")
    for r in range(4):
        mine = np.load(root / "r4" / f"qwen3_d66_4ranks_rank{r}.npz")
        for key in (k for k in mine.files if k.startswith("p/")):
            assert np.array_equal(mine[key], whole[f"final/{key}"]), key
        split = np.load(root / "r4" / f"qwen3_plain_4ranks_rank{r}.npz")
        final = np.load(root / "r4" / "qwen3_plain_4ranks.npz")
        norms = [k for k in split.files if k.startswith("p/") and "norm" in k]
        assert norms and all(np.array_equal(split[k], final[f"final/{k}"]) for k in norms)
        assert split["p/embed"].shape == (128, 16)  # [V, d] split on d


def test_crash_and_resume_on_two_sharded_ranks_is_bit_identical(runs):
    _, root, _, _, _ = runs
    facts = [json.loads((root / "r2" / f"rank{r}.json").read_text())["resume"] for r in range(2)]
    for f in facts:
        assert f["sharded"] and f["restarts"] == [0, 1]
        assert f["state_bit_identical"]
        assert f["losses"]["crash"] == f["losses"]["clean"]
        assert f["latest"] == 12
    assert facts[0]["digest"] == facts[1]["digest"]
    losses = [facts[0]["losses"]["clean"][str(s)] for s in (1, 12)]
    assert losses[1] < losses[0]


@pytest.mark.parametrize("path", ["r2/ckpt_fsdp2", "layouts/ckpt_fsdp2_fsdp4",
                                  "layouts/ckpt_one_fsdp4"])
def test_checkpoints_restore_across_layouts_bit_for_bit(runs, path):
    """The one-card checkpoint restored onto 2 sharded ranks and saved
    (ckpt_fsdp2), that one restored onto 4 ranks and saved, and the one-card
    checkpoint restored onto 4 ranks and saved: each restores on one card to
    the one-card state, every leaf bit for bit; each rank held its JAX-rule
    slices of it."""
    _, root, _, _, one = runs
    sys.path.insert(0, str(MULTIDEV))
    try:
        cfg = cases.layout_cfg()
        state = init_train_state(build_model(cfg, device="cpu", seed=9),
                                 torch.Generator().manual_seed(9), OptConfig())
        state = Checkpointer(str(root / path)).restore(state)
        got = cases.whole_state(state)
    finally:
        sys.path.remove(str(MULTIDEV))
    assert int(state.step) == 5
    assert set(got) == set(one)
    for k in one:
        assert np.array_equal(got[k], one[k]), k
    tag = {"r2/ckpt_fsdp2": ("r2", "one_fsdp2", 2),
           "layouts/ckpt_fsdp2_fsdp4": ("layouts", "fsdp2_fsdp4", 4),
           "layouts/ckpt_one_fsdp4": ("layouts", "one_fsdp4", 4)}[path]
    jcfg = jreduced(jget(cases.LAYOUT_ARCH), groups=1)
    for r in range(tag[2]):
        mine = np.load(root / tag[0] / f"{tag[1]}_rank{r}.npz")
        assert bool(mine["sharded"])
        for key in (k for k in mine.files if k != "sharded"):
            spec_of = key if key.startswith("p/") else "p/" + key.split("/", 1)[1]
            want = jax_rule_slice(one[key], spec_of, jcfg, tag[2], r)
            assert np.array_equal(mine[key], want), (r, key)


def test_the_launcher_shards_the_state_on_two_gloo_ranks(runs):
    _, root, logs, _, _ = runs
    out0, err0 = logs["launch0"]
    out1, err1 = logs["launch1"]
    done = [ln for ln in out0.splitlines() if ln.startswith("done: ")]
    assert len(done) == 1 and done[0].startswith("done: steps=3 loss=")
    assert np.isfinite(float(done[0].split("loss=")[1].split()[0]))
    assert "done:" not in out1
    assert ('data-parallel: rank 0 of 2 (gloo), the state laid out by the rules of the (2, 1)'
            in err0) and "data-parallel: rank 1 of 2 (gloo)" in err1
    cfg = reduced(get_config("qwen3-8b"))
    state = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0),
                             OptConfig())
    ck = Checkpointer(str(root / "launch"))
    assert ck.latest_step() == 3
    assert int(ck.restore(state).step) == 3


# --------------------------------------------------------------------------
# Without ranks: the layout, the draws, the meta path
# --------------------------------------------------------------------------

LAYOUT_ARCHS = ["qwen3-8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b", "jamba-v0.1-52b",
                "gemma2-9b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
@pytest.mark.parametrize("mesh_shape, d_model", [((2, 1), None), ((4, 1), None), ((4, 1), 66),
                                                 ((2, 2), None), ((16, 16), None)])
def test_leaf_shard_is_the_jax_rules_slice(arch, mesh_shape, d_model):
    """`leaf_shard` of every parameter against JAX's sanitized spec of its
    stacked leaf: along "data" and along "model", the split dimension (None
    where the axis was dropped or has one rank), the slice count and each
    rank's index (ranks row-major); "model" on an "ep" dimension (the
    experts) splits it as on any other."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget(arch))
    if d_model is not None:
        cfg, jcfg = (dataclasses.replace(c, d_model=d_model) for c in (cfg, jcfg))
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    mesh = Mesh(mesh_shape, ("data", "model"))
    jmesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    rules, jrules = make_rules(mesh, model_cfg=cfg), J.make_rules(jmesh, model_cfg=jcfg)
    jtemplates = jbuild(jcfg).param_specs()
    jspecs = J.tree_pspecs(jtemplates, jrules)
    for name, p in model.named_parameters():
        stacked = name.startswith("groups.")
        spec = jspecs
        for k in (["blocks", *name.split(".")[2:]] if stacked else name.split(".")):
            spec = spec[k]
        shape = (cfg.n_groups, *p.shape) if stacked else tuple(p.shape)
        spec = J.sanitize_pspec(spec, shape, jmesh)

        def axis_dim(axis):  # an axis of one rank splits nothing
            if mesh.shape[axis] == 1:
                return None
            return next((d - stacked for d, e in enumerate(spec)
                         if e == axis or (isinstance(e, tuple) and axis in e)), None)

        want, mwant = axis_dim("data"), axis_dim("model")
        for rank in range(mesh.size):
            got = leaf_shard(name, tuple(p.shape), model.param_specs(), mesh, rules, rank)
            assert got.dim == want, (name, spec)
            assert got.parts == (1 if want is None else mesh_shape[0])
            assert got.index == (0 if want is None else rank // mesh_shape[1])
            assert got.mdim == mwant, (name, spec)
            assert got.mparts == (1 if mwant is None else mesh_shape[1])
            assert got.mindex == (0 if mwant is None else rank % mesh_shape[1])


def test_a_sharded_model_draws_the_one_card_values():
    """`init_train_state(rules=..., place=(mesh, rank))` on the CPU (no
    collective runs in a draw): each rank's slices are its slices of the
    one-card draw from the same seed, bit for bit, and its moments are
    zeros of the slices' shapes."""
    cfg = reduced(get_config("qwen3-8b"))
    one = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4),
                           OptConfig())
    whole = dict(one.params.named_parameters())
    mesh = Mesh((2, 1), ("data", "model"))
    for rank in range(2):
        st = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4),
                              OptConfig(), rules=make_rules(mesh, model_cfg=cfg),
                              place=(mesh, rank))
        sharding = st.params.fsdp
        assert sharding is not None and sharding.rank == rank
        for n, p in st.params.named_parameters():
            assert torch.equal(p, sharding.layout[n].cut(whole[n])), n
            assert p.is_contiguous()
        assert st.opt["m"]["embed"].shape == (cfg.vocab, cfg.d_model // 2)
        assert not any(t.any() for part in st.opt.values() for t in part.values())


def test_fsdp_false_and_one_data_rank_leave_the_state_whole():
    """Along "data": `make_rules(fsdp=False)` on (2, 1) splits no leaf (the
    model stays whole and replicated), and a (1, 4) mesh, one data rank,
    slices no leaf along "data"; there tp -> "model" cuts the heads, d_ff
    and the vocab into 4 blocks (`repro_torch.parallel.tensor`)."""
    cfg = reduced(get_config("qwen3-8b"))
    mesh = Mesh((2, 1), ("data", "model"))
    model = build_model(cfg, device="cpu")
    assert fsdp.shard_model(model, make_rules(mesh, fsdp=False, model_cfg=cfg),
                            place=(mesh, 0)) is None
    assert model.fsdp is None and model.embed.shape == (cfg.vocab, cfg.d_model)
    mesh = Mesh((1, 4), ("data", "model"))
    model = build_model(cfg, device="cpu")
    sharding = fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, 0))
    assert not any(sharding.split(n) for n in sharding.layout)
    assert model.embed.shape == (cfg.vocab // 4, cfg.d_model)
    assert model.groups[0].pos0.mlp.w_in.shape == (cfg.d_model, 2, cfg.d_ff // 4)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_adafactor_state_is_laid_out_on_the_factored_blocks(mesh_shape):
    """Adafactor on a state the rules split: `init_train_state(rules=...)`
    zeroes each rank's vr and vc on the blocks of the factored shapes, and
    `shard_train_state` cuts a whole JAX Adafactor state to the same blocks
    (`fsdp.opt_leaf_shard`: the parameter's Shard with the dropped
    dimension removed).  Reduced falcon-mamba-7b, 2 groups: a per-group
    vector such as D is a [G, d_inner] leaf, whose vr [G] is whole and whose
    vc [d_inner] is cut along "model", as is its parameter."""
    cfg, jcfg = reduced(get_config("falcon-mamba-7b")), jreduced(jget("falcon-mamba-7b"))
    mesh = Mesh(mesh_shape, ("data", "model"))
    rules = make_rules(mesh, model_cfg=cfg)
    P = np_params(jcfg, 1)
    rng = np.random.default_rng(2)
    opt = {part: jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                              tree)
           for part, tree in j_init_opt_state(to_jax(P), JOptConfig(kind="adafactor")).items()}
    flat_opt = {part: cases._flat(tree) for part, tree in opt.items()}
    G, di = cfg.n_groups, cfg.mamba.expand * cfg.d_model
    M = mesh_shape[1]
    for rank in range(2):
        st = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0),
                              OptConfig(kind="adafactor"), rules=rules, place=(mesh, rank))
        cut = train_state_from_numpy(cfg, P, opt, 0, device="cpu")
        fsdp.shard_train_state(cut, rules, place=(mesh, rank))
        sharding = cut.params.fsdp
        assert sharding is not None and st.params.fsdp is not None
        names = param_leaves(dict(cut.params.named_parameters()))
        cut_leaves = 0
        for part in ("vr", "vc"):
            assert sorted(st.opt[part]) == sorted(cut.opt[part]) == sorted(names)
            for key, t in cut.opt[part].items():
                shard, lead = fsdp.opt_leaf_shard(sharding, names[key], part)
                whole = torch.from_numpy(flat_opt[part][key])
                assert torch.equal(t, shard.cut(whole, lead)) and t.is_contiguous(), key
                assert st.opt[part][key].shape == t.shape and not st.opt[part][key].any(), key
                cut_leaves += tuple(t.shape) != tuple(whole.shape)
        assert cut_leaves
        D = "blocks/pos0/mamba/D"
        assert cut.opt["vr"][D].shape == (G,)
        assert cut.opt["vc"][D].shape == (di // M,)
        assert cut.opt["vc"]["embed"].shape == (cfg.d_model // mesh_shape[0],)


def test_the_meta_gather_returns_shapes_and_counts_the_ring_bytes():
    """Without a group, on meta tensors: the gather returns the whole
    leaves' shapes and its backward the slices' (a leaf split along a
    non-leading dimension included), and each call adds (R - 1) / R of its
    payload to WIRE; a CPU tensor without a group raises."""
    cfg = reduced(get_config("qwen3-8b"))
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    mesh = Mesh((4, 1), ("data", "model"))
    sharding = fsdp.shard_model(model, make_rules(mesh), place=(mesh, 1))
    wo = model.groups[0].pos0.attn.wo  # [H, hd, d] split on d
    assert wo.shape == (cfg.n_heads, cfg.head_dim, cfg.d_model // 4)
    fsdp.WIRE.reset()
    named = {"pos0.attn.wo": wo, "pos0.attn.wq": model.groups[0].pos0.attn.wq}
    whole = sharding.gather(named, "groups.0.")
    assert whole["pos0.attn.wo"].shape == (cfg.n_heads, cfg.head_dim, cfg.d_model)
    full = 4 * sum(t.numel() for t in named.values())
    assert fsdp.WIRE.bytes["all-gather"] == 3 / 4 * 4 * full
    assert fsdp.WIRE.calls == {"all-gather": 2, "reduce-scatter": 0, "all-reduce": 0}
    assert fsdp.WIRE.largest_gather == 4 * full
    g = torch.autograd.grad(sum(t.sum() for t in whole.values()), list(named.values()))
    assert [tuple(x.shape) for x in g] == [tuple(t.shape) for t in named.values()]
    assert fsdp.WIRE.bytes["reduce-scatter"] == 3 / 4 * 4 * full
    with pytest.raises(ValueError, match="needs a process group"):
        fsdp.all_reduce(torch.zeros(3), None, 2)
