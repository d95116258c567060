"""The port's expert parallelism over the "model" axis, by the JAX rule
ep -> "model" (`repro_torch.models.layers.moe` under a
`repro_torch.parallel.tensor.ModelRegion`): the MoE experts split across
the ranks of a row, their outputs gathered for the combine, against the
JAX package's one-device train step on the global batch and against the
JAX rules' layout, on gloo CPU ranks.

`tests/multidev/torch_ep_cases.py` runs the (1, 2), (1, 4) and (2, 2)
("data", "model") meshes (one subprocess each, with a time limit) on
`CASES`: on (1, 2) reduced qwen3-moe (plain, accum = 2, 8-bit compression,
`dispatch="scatter"`), reduced jamba (attention, mamba and MoE layers) and
reduced llama4-maverick (top-1, MLP and MoE layers interleaved), and
qwen3-moe with 3 experts, which 2 ranks do not divide (the experts whole,
the layer whole on each rank); on (1, 4) qwen3-moe, one expert a rank; on
(2, 2) qwen3-moe, plain and accum = 2.  The ranks run their own two-step
trajectory; this file runs JAX's train step from each state the ranks
started a step from (lockstep), with `torch_training_common`'s
tolerances: loss and gradient norm within 2e-4 relative, the gradient
leaves within 2e-4 of their max plus 1e-7, the update within 1e-6 of
JAX's clip and AdamW of the ranks' own gradient, the parameters within
1e-4 of JAX's own step.

Each rank holds exactly the JAX rules' block of every leaf, the experts'
E / M on their "ep" dimension included, in shape and in bits (and, shape
only, on (16, 16) for the full qwen3-moe-235b-a22b and llama4-maverick);
the router and every leaf whole along "model" stay bit-alike along
"model" after each step; crash and resume on (1, 2) ends bit-identical;
checkpoints restore across (2, 2), one card, (1, 2) and (4, 1) bit for
bit, experts included; the model axis' gather along a dimension and the
MoE layer alone match the whole computation on 2 ranks, each rank
receiving the same gradient for the gathered expert outputs; the dry run's
rank counts the real ranks' state and wire bytes exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.train_step import _quantize_dequantize as j_qd
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import specs as SP
from repro_torch.models import build_model
from repro_torch.models.layers.moe import _expert_mm
from repro_torch.models.transformer import Transformer
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.sharding import Mesh, make_rules
from repro_torch.training import OptConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_ep_cases.py"
SUBPROCESS_TIMEOUT_S = 400
MESHES = ("1x2", "1x4", "2x2")
MOE_LAYER_REL = 1e-6  # the MoE layer alone against the whole layer, f32
EXPERT_LEAVES = ("moe/w_in", "moe/w_out")

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_ep_cases as cases
    import torch_fsdp_cases as fcases
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


def jcfg_for(arch: str, overrides=None):
    """The JAX package's reduced config, its MoE config replaced by a case's
    overrides."""
    jcfg = jreduced(jget(arch))
    if overrides:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **overrides))
    return jcfg


def jcfg_of(name: str):
    _, arch, _, _, _, overrides = cases.CASES[name]
    return jcfg_for(arch, overrides)


def exact_clip(grads: dict, max_norm: float) -> dict:
    """JAX's `clip_by_global_norm` rule at the norm of `grads` taken in f64."""
    norm = np.float32(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))
    scale = np.minimum(np.float32(1.0), np.float32(max_norm) / np.maximum(norm, np.float32(1e-12)))
    return {k: (g.astype(np.float32) * scale).astype(g.dtype) for k, g in grads.items()}


def _batch(name: str, step: int) -> dict:
    B = cases.CASES[name][4]
    return np_batch(jcfg_of(name), 900 + 10 * step + sorted(cases.CASES).index(name), batch=B)


class _Jax:
    """JAX's train step split at its compression, jitted once per case."""

    def __init__(self):
        self.cfg = JOptConfig(lr=cases.tp.LR, warmup_steps=cases.tp.WARMUP)
        self.adamw = jax.jit(lambda params, opt, step, grads: j_adamw_update(
            params, grads, opt, step, self.cfg))
        self.clip = jax.jit(lambda g: j_clip_by_global_norm(g, self.cfg.grad_clip))
        self.grads = functools.lru_cache(None)(
            lambda name, accum: _jax_grads(jcfg_of(name), accum))

    def step(self, name: str, params, opt, step: int, batch: dict) -> dict:
        _, _, accum, bits, _, _ = cases.CASES[name]
        loss, g = self.grads(name, accum)(params, to_jax(batch))
        sent = jax.tree.map(lambda x: j_qd(x, bits), g) if bits else g
        clipped, norm = self.clip(sent)
        p, o = self.adamw(params, opt, jnp.asarray(step, jnp.int32), clipped)
        return {"loss": float(loss), "grad_norm": float(norm), "g": g, "p": p, "o": o}


def _state(npz, s: int):
    def tree(prefix):
        return fcases._nest({k[len(prefix):]: jnp.asarray(npz[k]) for k in npz.files
                             if k.startswith(prefix)})
    return tree(f"s{s}/p/"), {"m": tree(f"s{s}/m/"), "v": tree(f"s{s}/v/")}


def _one_card_checkpoint(root: Path) -> dict:
    """The layout config's one-card state at step 5, every leaf drawn,
    saved into root/ckpt_one; returns its leaves as numpy."""
    model = build_model(cases.layout_cfg(), device="cpu", seed=7)
    state = init_train_state(model, torch.Generator().manual_seed(7), OptConfig())
    for part in state.opt.values():
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state.step.fill_(5)
    Checkpointer(str(root / "ckpt_one"), async_writes=False).save(5, state)
    return fcases.whole_state(state)


def _start(mode: str, in_dir: Path, out: Path, env: dict) -> subprocess.Popen:
    out.mkdir(exist_ok=True)
    return subprocess.Popen([sys.executable, str(SCRIPT), mode, str(in_dir), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the three meshes' runs; meanwhile takes JAX's step 0; then the
    layouts' restores and JAX's later steps from the ranks' states.  Returns
    (JAX's results by case and step, the output root, the jitted JAX step,
    the one-card checkpoint's leaves, each mesh's rank facts)."""
    root = tmp_path_factory.mktemp("ep")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for name in cases.CASES:
        params[name] = np_params(jcfg_of(name), 19)
        np.savez(in_dir / f"params_{name}.npz", **fcases._flat(params[name]))
        for s in range(cases.STEPS):
            np.savez(in_dir / f"batch_{name}_{s}.npz", **_batch(name, s))
    one = _one_card_checkpoint(in_dir)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {mode: _start(mode, in_dir, root / mode, env) for mode in MESHES}
    jx = _Jax()
    want, logs = {}, {}
    try:
        for name in cases.CASES:  # step 0, while the ranks run
            P = to_jax(params[name])
            zeros = jax.tree.map(jnp.zeros_like, P)
            want[name] = [jx.step(name, P, {"m": zeros, "v": zeros}, 0, _batch(name, 0))]
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0] for k, p in procs.items()}
        for k in ("1x2", "2x2"):
            assert procs[k].returncode == 0, logs[k][-4000:]
        procs["layouts"] = _start("layouts", in_dir, root / "layouts", env)
        for name, case in cases.CASES.items():
            npz = np.load(root / cases.label(case[0]) / f"{name}.npz")
            for s in range(1, cases.STEPS):
                P, opt = _state(npz, s)
                want[name].append(jx.step(name, P, opt, s, _batch(name, s)))
        logs["layouts"] = procs["layouts"].communicate(timeout=SUBPROCESS_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{logs.get(k, '')[-4000:]}"
    facts = {mode: [json.loads((root / mode / f"rank{r}.json").read_text())
                    for r in range(4 if mode != "1x2" else 2)] for mode in MESHES}
    return want, root, jx, one, facts


@pytest.mark.parametrize("name", list(cases.CASES))
def test_ep_step_matches_the_jax_one_device_step(runs, name):
    want, root, jx, _, _ = runs
    mesh, _, _, bits, _, _ = cases.CASES[name]
    npz = np.load(root / cases.label(mesh) / f"{name}.npz")
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
        clipped = fcases._nest({k: jnp.asarray(v) for k, v in
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


def jax_rule_block(whole: np.ndarray, key: str, jcfg, mesh_shape, rank: int) -> np.ndarray:
    """Rank `rank`'s block of the whole JAX leaf `key` ("p/blocks/...",
    "m/...", "v/..."; a moment carries its parameter's spec) under the JAX
    package's rules on an abstract ("data", "model") mesh of `mesh_shape`,
    ranks row-major: each dimension whose sanitized spec names "data" cut
    by the rank's data index, and "model" by its model index."""
    spec = jax_spec(key, jcfg, whole.shape, mesh_shape)
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = whole
    for d, entry in enumerate(spec):
        for axis in ("data", "model"):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                n = whole.shape[d] // sizes[axis]
                out = np.take(out, range(coords[axis] * n, (coords[axis] + 1) * n), axis=d)
    return out


def jax_spec(key: str, jcfg, shape: tuple, mesh_shape) -> tuple:
    """The JAX rules' sanitized spec of leaf `key` of `shape`."""
    mesh = jax.sharding.AbstractMesh(tuple(mesh_shape), ("data", "model"))
    spec = J.tree_pspecs(jbuild(jcfg).param_specs(), J.make_rules(mesh, model_cfg=jcfg))
    for k in (key if key.startswith("p/") else "p/" + key.split("/", 1)[1]).split("/")[1:]:
        spec = spec[k]
    return tuple(J.sanitize_pspec(spec, shape, mesh))


def _rank_cases():
    return [(name, r) for name, c in cases.CASES.items() for r in range(c[0][0] * c[0][1])]


@pytest.mark.parametrize("name, rank", _rank_cases())
def test_each_rank_holds_its_jax_rule_block(runs, name, rank):
    """The final parameters and moments a rank holds equal, in shape and in
    bits, the JAX-rule block of the leaves as rank 0 gathered them whole;
    the experts' blocks are E / M experts wherever M divides E."""
    _, root, _, _, _ = runs
    mesh = cases.CASES[name][0]
    npz = np.load(root / cases.label(mesh) / f"{name}.npz")
    mine = np.load(root / cases.label(mesh) / f"{name}_rank{rank}.npz")
    jcfg = jcfg_of(name)
    experts = [k for k in mine.files if k.endswith(EXPERT_LEAVES)]
    # each MoE position's w_in and w_out, and both their moments
    assert len(experts) == 3 * 2 * sum(s.ffn == "moe" for s in jcfg.pattern)
    for key in mine.files:
        want = jax_rule_block(npz[f"final/{key}"], key, jcfg, mesh, rank)
        assert mine[key].shape == want.shape, key
        assert np.array_equal(mine[key], want), key
    E, M = jcfg.moe.n_experts, mesh[1]
    for key in experts:  # [groups, E / M or E, ...]
        assert mine[key].shape[1] == (E // M if E % M == 0 else E), key


@pytest.mark.parametrize("mode", MESHES)
def test_the_router_and_leaves_whole_along_model_stay_bit_alike_along_model(runs, mode):
    """After each step every rank of a row (the same "data" index) holds
    the same bits of the router, its moments and every other leaf whole
    along "model"; the final gathered parameters are bit-alike on every
    rank; nothing is summed over "model" but the qk-norm scales."""
    *_, facts = runs
    M = int(mode.split("x")[1])
    ranks = facts[mode]
    for name in ranks[0]["cases"]:
        whole = ranks[0]["cases"][name]["model_whole"]
        routers = [k for k in whole if k.endswith("moe/router")]
        assert routers, name
        for r, f in enumerate(ranks):
            mine = f["cases"][name]
            assert mine["digest"] == ranks[0]["cases"][name]["digest"], (name, r)
            assert all(n.rsplit(".", 1)[1] in ("q_norm", "k_norm", "wk", "wv")
                       for n in mine["summed_over_model"]), (name, mine["summed_over_model"])
            head = ranks[r - r % M]["cases"][name]  # the row's first rank
            for s in range(cases.STEPS):
                for key in whole:
                    assert mine["blocks"][s][key] == head["blocks"][s][key], (name, r, s, key)


def test_experts_the_axis_does_not_divide_run_whole(runs):
    """3 experts on 2 ranks: the experts' leaves and moments whole and
    bit-alike on both ranks; on (1, 4) with 4 experts, one expert a rank."""
    _, root, _, _, facts = runs
    final = np.load(root / "1x2" / "moe_3experts.npz")
    for r in range(2):
        mine = np.load(root / "1x2" / f"moe_3experts_rank{r}.npz")
        keys = [k for k in mine.files if k.endswith(EXPERT_LEAVES)]
        assert len(keys) == 6
        for key in keys:
            assert np.array_equal(mine[key], final[f"final/{key}"]), key
        assert set(keys) <= set(facts["1x2"][r]["cases"]["moe_3experts"]["model_whole"])
    for r in range(4):
        mine = np.load(root / "1x4" / f"moe_plain_1x4_rank{r}.npz")
        assert mine["p/blocks/pos0/moe/w_in"].shape[1] == 1
        assert mine["p/blocks/pos0/moe/w_out"].shape[1] == 1


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("rank", [0, 17, 255])
def test_a_16x16_rank_holds_the_jax_rule_expert_blocks(arch, rank):
    """Shape only, on the meta device: the full config's state on the
    production (16, 16) mesh; every expert leaf and both its moments take
    the JAX rules' block shape, E / 16 experts (128 of qwen3-moe, 8 a rank;
    llama4's 128, 8 a rank) by d / 16."""
    cfg, jcfg = get_config(arch), jget(arch)
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    state = SP.abstract_train_state(model, OptConfig())
    mesh = Mesh((16, 16), ("data", "model"))
    fsdp.shard_train_state(state, make_rules(mesh, model_cfg=cfg), place=(mesh, rank))
    named = dict(model.named_parameters())
    seen = 0
    for pos, spec in enumerate(cfg.pattern):
        if spec.ffn != "moe":
            continue
        for leaf in ("w_in", "w_out"):
            key = f"blocks/pos{pos}/moe/{leaf}"
            whole = (cfg.n_groups, *model.fsdp.layout[f"groups.0.pos{pos}.moe.{leaf}"].shape)
            want = list(whole)
            for d, entry in enumerate(jax_spec("p/" + key, jcfg, whole, (16, 16))):
                for axis in ("data", "model"):
                    if entry == axis or (isinstance(entry, tuple) and axis in entry):
                        want[d] //= 16
            assert want[1] == cfg.moe.n_experts // 16
            assert (cfg.n_groups, *named[f"groups.0.pos{pos}.moe.{leaf}"].shape) == tuple(want)
            for part in ("m", "v"):
                assert tuple(state.opt[part][key].shape) == tuple(want), (part, key)
            seen += 1
    assert seen >= 2


def test_crash_and_resume_on_1x2_is_bit_identical(runs):
    *_, facts = runs
    got = [f["resume"] for f in facts["1x2"]]
    for f in got:
        assert f["model_parts"] == 2 and f["restarts"] == [0, 1]
        assert f["state_bit_identical"]
        assert f["losses"]["crash"] == f["losses"]["clean"]
        assert f["latest"] == 12
    assert got[0]["digest"] == got[1]["digest"]
    losses = [got[0]["losses"]["clean"][str(s)] for s in (1, 12)]
    assert losses[1] < losses[0]


CHECKPOINTS = {  # path -> (directory of the blocks, tag, mesh)
    "2x2/ckpt_one_2x2": ("2x2", "one_2x2", (2, 2)),
    "1x2/ckpt_one_1x2": ("1x2", "one_1x2", (1, 2)),
    "layouts/ckpt_2x2_1x2": ("layouts", "2x2_1x2", (1, 2)),
    "layouts/ckpt_1x2_4x1": ("layouts", "1x2_4x1", (4, 1)),
}


@pytest.mark.parametrize("path", sorted(CHECKPOINTS))
def test_checkpoints_restore_across_layouts_bit_for_bit(runs, path):
    """One card -> (2, 2) -> (1, 2) and one card -> (1, 2) -> (4, 1), of
    reduced qwen3-moe: each saved checkpoint restores on one card to the
    one-card state, every leaf (the experts' too) bit for bit, and each
    rank held its JAX-rule blocks of it."""
    _, root, _, one, _ = runs
    cfg = cases.layout_cfg()
    state = init_train_state(build_model(cfg, device="cpu", seed=9),
                             torch.Generator().manual_seed(9), OptConfig())
    state = Checkpointer(str(root / path)).restore(state)
    got = fcases.whole_state(state)
    assert int(state.step) == 5
    assert set(got) == set(one)
    assert any(k.endswith(EXPERT_LEAVES) for k in one)
    for k in one:
        assert np.array_equal(got[k], one[k]), k
    where, tag, mesh = CHECKPOINTS[path]
    jcfg = jreduced(jget(cases.QWEN3_MOE), groups=1)
    for r in range(mesh[0] * mesh[1]):
        mine = np.load(root / where / f"{tag}_rank{r}.npz")
        assert bool(mine["sharded"])
        for key in (k for k in mine.files if k != "sharded"):
            want = jax_rule_block(one[key], key, jcfg, mesh, r)
            assert np.array_equal(mine[key], want), (r, key)


def test_the_gather_along_a_dimension_matches_the_whole_computation(runs):
    """On 2 ranks, f64: `ModelRegion.gather` along dimensions 0 and 1 is the
    concatenation of the ranks' slices, and its gradient the rank's slice
    of the incoming gradient."""
    *_, facts = runs
    for f in facts["1x2"]:
        for key, err in f["ops"].items():
            if key.startswith("gather_"):
                assert err == 0.0, (key, err)


def test_the_moe_layer_on_two_ranks_matches_the_whole_layer(runs):
    """Reduced qwen3-moe's MoE layer, 2 of its 4 experts a rank, f32: the
    output and the gradients of x, the router and the rank's expert blocks
    within MOE_LAYER_REL of the whole layer's; the gradient each rank
    receives for the gathered expert outputs [E, G, cap, d] is bit-alike
    across the ranks (what makes the gather's backward narrow exact)."""
    *_, facts = runs
    ops = [f["ops"] for f in facts["1x2"]]
    for o in ops:
        for key, rel in o["moe_rel"].items():
            assert rel <= MOE_LAYER_REL, (key, rel)
        assert o["y_grad_shape"][0] == o["experts"] == 4
    assert ops[0]["y_grad_digest"] == ops[1]["y_grad_digest"]


def test_the_meta_gather_counts_the_model_axis_ring_bytes():
    """Without a group, on meta tensors: the gather along dimension 0 of an
    [E / M, G, cap, d] block returns [E, G, cap, d] and counts (M - 1) / M
    of the gathered output under "model"; its backward narrows and counts
    nothing; a CPU tensor without a group raises."""
    tp = tensor.ModelRegion({}, None, 4, 1)
    x = torch.empty(2, 3, 5, 8, device="meta", requires_grad=True)
    fsdp.WIRE.reset()
    y = tp.gather(x, 0)
    assert y.shape == (8, 3, 5, 8)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape
    assert fsdp.WIRE.by_axis() == {"model": {
        "all-gather": 3 / 4 * 8 * 3 * 5 * 8 * 4, "reduce-scatter": 0.0, "all-reduce": 0.0}}
    assert fsdp.WIRE.calls == {"all-gather": 1, "reduce-scatter": 0, "all-reduce": 0}
    with pytest.raises(ValueError, match="needs a process group"):
        tp.gather(torch.zeros(2, 3), 0)


def test_an_expert_block_that_does_not_match_the_slots_raises():
    """E / M taken from the block's shape: a block of 3 experts on 2 ranks
    against a buffer of 4 experts' slots raises a ValueError that names the
    shapes; the code never gathers the whole leaf instead."""
    cfg = cases.layout_cfg()
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    p = SimpleNamespace(w_in=torch.zeros(3, d, 2, ff), w_out=torch.zeros(3, ff, d))
    tp = tensor.ModelRegion({}, None, 2, 0)
    with pytest.raises(ValueError, match=r"\(3, 64, 2, 32\).*\(2, 4, 5, 64\)"):
        _expert_mm(p, cfg, torch.zeros(2, 4, 5, d), tp)
    with pytest.raises(ValueError, match="E = 4"):
        _expert_mm(p, cfg, torch.zeros(2, 4, 5, d))


# --------------------------------------------------------------------------
# The dry run against the real ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["moe_plain", "moe_plain_2x2"])
def test_the_dry_runs_ep_rank_counts_the_real_ranks_bytes(runs, name):
    """`lower_cell` of the case's configuration (reduced qwen3-moe, B = 4,
    S = 16, accum 1, f32 AdamW) on its mesh: the rank's parameter and
    moment bytes (its expert blocks E / M) equal every real rank's, and its
    wire bytes by axis and kind, the MoE layers' all-gathers among them,
    equal each real rank's step (`fsdp.WIRE`)."""
    *_, facts = runs
    mesh, arch, accum, bits, B, overrides = cases.CASES[name]
    assert accum == 1 and bits is None and overrides is None
    shape = dataclasses.replace(C.SHAPES["train_4k"], seq_len=16, global_batch=B)
    with mock.patch.dict(C.SHAPES, {"train_4k": shape}), \
            mock.patch.dict(C.ARCHS, {"epcell": cases.case_cfg(arch)}):
        rec, _ = dr.lower_cell("epcell", "train_4k", Mesh(mesh, ("data", "model")), accum=1)
    parts = rec["memory"]["port_rank_parts"]
    ranks = facts[cases.label(mesh)]
    assert all(parts["params"] + parts["opt"] == f["cases"][name]["state_bytes"] for f in ranks)
    by_axis = rec["hlo"]["collective_by_axis"]
    assert by_axis["model"]["all-gather"] > 0
    for f in ranks:
        for wire in f["cases"][name]["wire"]:
            assert by_axis == wire
    assert rec["hlo"]["collective_wire_bytes"] == sum(sum(v.values()) for v in by_axis.values())
    layout = rec["memory"]["state_layout"]
    assert layout["ep"] == "model" and layout["ep_parts"] == mesh[1]
