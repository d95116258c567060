"""The port's tensor parallelism over the "model" axis
(`repro_torch.parallel.tensor`, `init_train_state(rules=..., group=...,
mesh=...)`) against the JAX package's one-device train step on the global
batch and against the JAX rules' layout, on gloo CPU ranks.

`tests/multidev/torch_tp_cases.py` runs the (1, 2), (1, 4) and (2, 2)
("data", "model") meshes (one subprocess each, with a time limit) on
`CASES`: on (1, 2) reduced qwen3-8b (plain, accum = 2, 8-bit compression),
gemma2-9b (the tied head, vocab-parallel), hubert-xlarge (frames: no
lookup), falcon-mamba-7b (every leaf split over d_inner) and qwen3-moe
(the experts whole along "model" until slice 24), and reduced qwen3-8b
with 3 heads and d_ff = 129, which the axis does not divide (attention and
MLP run whole on each rank); on (1, 4) reduced qwen3-8b, whose 2 KV heads
do not split 4 ways (pairs of ranks share a KV head); on (2, 2) reduced
qwen3-8b, plain and accum = 2.  The ranks run their own two-step
trajectory; this file runs JAX's train step from each state the ranks
started a step from (lockstep, as `tests/test_torch_fsdp.py`), with its
tolerances (`torch_training_common`): loss and gradient norm within 2e-4
relative, the gradient leaves within 2e-4 of their max plus 1e-7, the
update within 1e-6 of JAX's clip and AdamW of the ranks' own gradient, the
parameters within 1e-4 of JAX's own step.

Each rank holds exactly the JAX rules' block of every leaf (the "ep"
dimension whole, slice 24), in shape and in bits; the leaves and moments
whole along "model" are bit-alike along "model" after each step; crash and
resume on (1, 2) ends bit-identical; checkpoints restore across (2, 2),
one card, (1, 2) and (4, 1) bit for bit; the operators match the whole
computation; the dry run's rank counts the real ranks' state and wire
bytes exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
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
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as dr
from repro_torch.models import build_model
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.sharding import Mesh, Shard, make_rules
from repro_torch.training import OptConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_tp_cases.py"
SUBPROCESS_TIMEOUT_S = 400
MESHES = ("1x2", "1x4", "2x2")

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_fsdp_cases as fcases
    import torch_tp_cases as cases
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
    """The JAX package's reduced config, with a case's overrides."""
    return dataclasses.replace(jreduced(jget(arch)), **(overrides or {}))


def jcfg_of(name: str):
    _, arch, _, _, _, overrides = cases.CASES[name]
    return jcfg_for(arch, overrides)


def exact_clip(grads: dict, max_norm: float) -> dict:
    """JAX's `clip_by_global_norm` rule at the norm of `grads` taken in f64
    (`tests/test_torch_fsdp.py`'s)."""
    norm = np.float32(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))
    scale = np.minimum(np.float32(1.0), np.float32(max_norm) / np.maximum(norm, np.float32(1e-12)))
    return {k: (g.astype(np.float32) * scale).astype(g.dtype) for k, g in grads.items()}


def _batch(name: str, step: int) -> dict:
    B = cases.CASES[name][4]
    return np_batch(jcfg_of(name), 700 + 10 * step + sorted(cases.CASES).index(name), batch=B)


class _Jax:
    """JAX's train step split at its compression, jitted once per case."""

    def __init__(self):
        self.cfg = JOptConfig(lr=cases.LR, warmup_steps=cases.WARMUP)
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
    cfg = fcases.layout_cfg()
    model = build_model(cfg, device="cpu", seed=7)
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
    root = tmp_path_factory.mktemp("tp")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for name in cases.CASES:
        params[name] = np_params(jcfg_of(name), 17)
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
def test_tp_step_matches_the_jax_one_device_step(runs, name):
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
    by the rank's data index, and "model" by its model index, but for a
    dimension whose template is "ep" (the experts stay whole along "model"
    until slice 24)."""
    mesh = jax.sharding.AbstractMesh(tuple(mesh_shape), ("data", "model"))
    templates = jbuild(jcfg).param_specs()
    specs = J.tree_pspecs(templates, J.make_rules(mesh, model_cfg=jcfg))
    spec, template = specs, templates
    for k in key.split("/")[1:]:
        spec, template = spec[k], template[k]
    spec = J.sanitize_pspec(spec, whole.shape, mesh)
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    out = whole
    for d, entry in enumerate(spec):
        for axis in ("data", "model"):
            if (entry == axis or (isinstance(entry, tuple) and axis in entry)) and not (
                    axis == "model" and template[d] == "ep"):
                n = whole.shape[d] // mesh.shape[axis]
                out = np.take(out, range(coords[axis] * n, (coords[axis] + 1) * n), axis=d)
    return out


def _rank_cases():
    return [(name, r) for name, c in cases.CASES.items() for r in range(c[0][0] * c[0][1])]


@pytest.mark.parametrize("name, rank", _rank_cases())
def test_each_rank_holds_its_jax_rule_block(runs, name, rank):
    """The final parameters and moments a rank holds equal, in shape and in
    bits, the JAX-rule block of the leaves as rank 0 gathered them whole."""
    _, root, _, _, _ = runs
    mesh = cases.CASES[name][0]
    npz = np.load(root / cases.label(mesh) / f"{name}.npz")
    mine = np.load(root / cases.label(mesh) / f"{name}_rank{rank}.npz")
    jcfg = jcfg_of(name)
    for key in mine.files:
        spec_of = key if key.startswith("p/") else "p/" + key.split("/", 1)[1]
        want = jax_rule_block(npz[f"final/{key}"], spec_of, jcfg, mesh, rank)
        assert mine[key].shape == want.shape, key
        assert np.array_equal(mine[key], want), key


@pytest.mark.parametrize("mode", MESHES)
def test_leaves_whole_along_model_stay_bit_alike_along_model(runs, mode):
    """After each step every rank of a row (the same "data" index) holds
    the same bits of each leaf and moment whole along "model"; the final
    gathered parameters are bit-alike on every rank."""
    *_, facts = runs
    M = int(mode.split("x")[1])
    ranks = facts[mode]
    for name in ranks[0]["cases"]:
        whole = ranks[0]["cases"][name]["model_whole"]
        assert whole, name
        for r, f in enumerate(ranks):
            mine = f["cases"][name]
            assert mine["digest"] == ranks[0]["cases"][name]["digest"], (name, r)
            head = ranks[r - r % M]["cases"][name]  # the row's first rank
            for s in range(cases.STEPS):
                for key in whole:
                    assert mine["blocks"][s][key] == head["blocks"][s][key], (name, r, s, key)


def test_a_layer_the_axis_does_not_divide_runs_whole(runs):
    """3 heads and d_ff = 129 on 2 ranks: attention's and the MLP's leaves
    whole on both ranks, the vocab (128) split; nothing summed over "model"."""
    _, root, _, _, facts = runs
    final = np.load(root / "1x2" / "qwen3_undivided.npz")
    for r in range(2):
        mine = np.load(root / "1x2" / f"qwen3_undivided_rank{r}.npz")
        for key in (k for k in mine.files if "/attn/" in k or "/mlp/" in k):
            assert np.array_equal(mine[key], final[f"final/{key}"]), key
        assert mine["p/embed"].shape == (64, 64) and mine["p/head"].shape == (64, 64)
        assert facts["1x2"][r]["cases"]["qwen3_undivided"]["summed_over_model"] == []


def test_ranks_that_share_a_kv_head_sum_its_gradient(runs):
    """(1, 4) with 2 KV heads: wk, wv and the qk-norm scales whole on every
    rank and summed over "model"; ranks 0, 1 read KV head 0, ranks 2, 3 KV
    head 1; on (1, 2) the KV heads split and only the qk-norm scales are
    summed."""
    *_, facts = runs
    summed = facts["1x4"][0]["cases"]["qwen3_plain_1x4"]["summed_over_model"]
    assert sorted(n.rsplit(".", 1)[1] for n in summed) == sorted(
        ["k_norm", "q_norm", "wk", "wv"] * 2)
    summed = facts["1x2"][0]["cases"]["qwen3_plain"]["summed_over_model"]
    assert sorted(n.rsplit(".", 1)[1] for n in summed) == sorted(["k_norm", "q_norm"] * 2)
    cfg = reduced(get_config("qwen3-8b"))
    model = build_model(cfg, device="cpu")
    mesh = Mesh((1, 4), ("data", "model"))
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, 2))
    from repro_torch.models.layers.attention import rank_kv_heads

    attn = model.groups[0].pos0.attn
    for r, want in enumerate([slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]):
        tp = tensor.ModelRegion(model.fsdp.layout, None, 4, r, "groups.0.pos0.attn.")
        assert rank_kv_heads(attn, tp) == want
    assert attn.wq.shape == (cfg.d_model, 1, cfg.head_dim)
    assert attn.wk.shape == (cfg.d_model, 2, cfg.head_dim)


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
    """One card -> (2, 2) -> (1, 2) and one card -> (1, 2) -> (4, 1): each
    saved checkpoint restores on one card to the one-card state, every leaf
    bit for bit, and each rank held its JAX-rule blocks of it."""
    _, root, _, one, _ = runs
    cfg = fcases.layout_cfg()
    state = init_train_state(build_model(cfg, device="cpu", seed=9),
                             torch.Generator().manual_seed(9), OptConfig())
    state = Checkpointer(str(root / path)).restore(state)
    got = fcases.whole_state(state)
    assert int(state.step) == 5
    assert set(got) == set(one)
    for k in one:
        assert np.array_equal(got[k], one[k]), k
    where, tag, mesh = CHECKPOINTS[path]
    jcfg = jreduced(jget(fcases.LAYOUT_ARCH), groups=1)
    for r in range(mesh[0] * mesh[1]):
        mine = np.load(root / where / f"{tag}_rank{r}.npz")
        assert bool(mine["sharded"])
        for key in (k for k in mine.files if k != "sharded"):
            spec_of = key if key.startswith("p/") else "p/" + key.split("/", 1)[1]
            want = jax_rule_block(one[key], spec_of, jcfg, mesh, r)
            assert np.array_equal(mine[key], want), (r, key)


def test_the_operators_match_the_whole_computation(runs):
    """On 2 ranks, f64: the vocab-parallel cross entropy and lookup, copy,
    reduce and gather, forward and gradient, against the whole computation."""
    *_, facts = runs
    for f in facts["1x2"]:
        for key, err in f["ops"].items():
            assert err <= 1e-12, (key, err)


def test_the_meta_operators_count_the_model_axis_ring_bytes():
    """Without a group, on meta tensors: copy, reduce and gather return the
    shapes and count 2 (M - 1) / M of the payload for each all-reduce and
    (M - 1) / M of the gathered output for the all-gather, under "model";
    a CPU tensor without a group raises."""
    tp = tensor.ModelRegion({"embed": Shard((8, 4), mdim=0, mparts=4, mindex=1)}, None, 4, 1)
    x = torch.empty(2, 3, 8, device="meta", requires_grad=True)
    fsdp.WIRE.reset()
    y = tp.gather(tp.reduce(tp.copy(x)))
    assert y.shape == (2, 3, 32)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape
    nbytes = 2 * 3 * 8 * 4
    assert fsdp.WIRE.by_axis() == {"model": {
        "all-gather": 3 / 4 * 4 * nbytes, "reduce-scatter": 0.0,
        "all-reduce": 2 * 2 * 3 / 4 * nbytes}}
    assert fsdp.WIRE.calls == {"all-gather": 1, "reduce-scatter": 0, "all-reduce": 2}
    with pytest.raises(ValueError, match="needs a process group"):
        tp.reduce(torch.zeros(3))


LAYOUT_ARCHS = ["qwen3-8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b", "gemma2-9b",
                "hubert-xlarge"]


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
@pytest.mark.parametrize("mesh_shape, ranks", [((1, 2), (0, 1)), ((1, 4), (0, 3)),
                                                ((2, 2), (1, 2)), ((16, 16), (0, 17, 255))])
def test_a_tp_rank_draws_its_jax_rule_block_of_the_one_card_values(arch, mesh_shape, ranks):
    """`init_train_state(rules=..., place=(mesh, rank))` on the CPU (no
    collective runs in a draw): each rank's blocks are the JAX-rule blocks
    of the one-card draw from the same seed, bit for bit, and its moments
    are zeros of the blocks' shapes."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget(arch))
    one = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4),
                           OptConfig())
    whole = fcases.whole_state(one)
    mesh = Mesh(mesh_shape, ("data", "model"))
    for rank in ranks:
        st = init_train_state(build_model(cfg, device="cpu"), torch.Generator().manual_seed(4),
                              OptConfig(), rules=make_rules(mesh, model_cfg=cfg),
                              place=(mesh, rank))
        mine = fcases.rank_slices(st)
        for key, x in mine.items():
            spec_of = key if key.startswith("p/") else "p/" + key.split("/", 1)[1]
            want = jax_rule_block(whole[key], spec_of, jcfg, mesh_shape, rank)
            if key.startswith("p/"):
                assert np.array_equal(x, want), (rank, key)
            else:
                assert x.shape == want.shape and not x.any(), (rank, key)


# --------------------------------------------------------------------------
# The dry run against the real ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3_plain", "qwen3_plain_2x2"])
def test_the_dry_runs_rank_counts_the_real_ranks_bytes(runs, name):
    """`lower_cell` of the case's configuration (reduced qwen3-8b, B = 4,
    S = 16, accum 1, f32 AdamW) on its mesh: the rank's parameter and
    moment bytes equal every real rank's, and its wire bytes by axis and
    kind equal each real rank's step (`fsdp.WIRE`)."""
    *_, facts = runs
    mesh, arch, accum, bits, B, _ = cases.CASES[name]
    assert accum == 1 and bits is None
    shape = dataclasses.replace(C.SHAPES["train_4k"], seq_len=16, global_batch=B)
    with mock.patch.dict(C.SHAPES, {"train_4k": shape}), \
            mock.patch.dict(C.ARCHS, {"tpcell": reduced(get_config(arch))}):
        rec, _ = dr.lower_cell("tpcell", "train_4k", Mesh(mesh, ("data", "model")), accum=1)
    parts = rec["memory"]["port_rank_parts"]
    ranks = facts[cases.label(mesh)]
    assert all(parts["params"] + parts["opt"] == f["cases"][name]["state_bytes"] for f in ranks)
    for f in ranks:
        for wire in f["cases"][name]["wire"]:
            assert rec["hlo"]["collective_by_axis"] == wire
    assert rec["hlo"]["collective_wire_bytes"] == sum(
        sum(v.values()) for v in rec["hlo"]["collective_by_axis"].values())
    assert rec["memory"]["state_layout"]["model_parts"] == mesh[1]
