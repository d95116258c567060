"""Adafactor on the port's sharded training state (`vr` and `vc` on the JAX
rules' blocks of the factored shapes, `fsdp.opt_leaf_shard`; their means
summed over the axis that cuts the leaf, `adafactor_update(sharding=...)`)
against the JAX package's one-device Adafactor step on the global batch,
on gloo CPU ranks.

The JAX package lays out no Adafactor state on a mesh (its
`train_state_pspecs` names AdamW's moments only), so the layout held here
is the JAX rules applied to the factored shapes: a leaf's spec with the
entry of the dimension its statistic drops removed, sanitized against the
factored shape (`factored_spec`, computed here from JAX's `param_specs`).

`tests/multidev/torch_adafactor_cases.py` runs the (2, 1), (1, 2) and (2, 2)
("data", "model") meshes (one subprocess each, with a time limit) on
reduced qwen3-8b, falcon-mamba-7b (2 groups: its per-group vectors are
[G, d] matrices, whose vr is [G] and vc [d]) and qwen3-moe-235b-a22b with
bf16 statistics, two steps each from a drawn nonzero state.  This file runs
JAX's step from each state the ranks started a step from (lockstep, as
`tests/test_torch_tp.py`), with `torch_training_common`'s tolerances: loss
and gradient norm within 2e-4 relative, the gradient leaves within 2e-4 of
their max plus 1e-7, and the new parameters, vr and vc within 1e-6 of each
leaf's max (bf16 statistics within one bf16 ulp) of JAX's
`adafactor_update` of the ranks' own gradient at the exact clip.

Each rank holds exactly the JAX rules' blocks of the factored shapes, in
shape and in bits; a block whole along an axis is bit-alike across that
axis's ranks after each step; one card -> (2, 2) -> (1, 2) -> one card
restores bit for bit (with the specs of `train_state_pspecs(...,
"adafactor")`); crash and resume on (1, 2) ends bit-identical; the
statistics' all-reduces move the payload the factored layout predicts.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
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
from repro.training.optimizer import adafactor_update as j_adafactor_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs as SP
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import Mesh, make_rules
from repro_torch.training import OptConfig, adafactor_update, init_train_state
from test_torch_tp import exact_clip

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_adafactor_cases.py"
SUBPROCESS_TIMEOUT_S = 400
MODES = ("2x1", "1x2", "2x2")

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_adafactor_cases as cases
    import torch_fsdp_cases as fcases
    from torch_training_common import (
        GRAD_ABS,
        GRAD_REL,
        STEP_RTOL,
        UPDATE_REL,
        _jax_grads,
        assert_tree_close,
        bf16_ulp,
        flat,
        np_batch,
        np_params,
        to_jax,
    )
finally:
    sys.path.remove(str(MULTIDEV))


def jcfg_of(name: str):
    return jreduced(jget(cases.CASES[name][1]))


def _jopt(mdt: str) -> JOptConfig:
    return JOptConfig(kind="adafactor", lr=cases.LR, warmup_steps=cases.WARMUP, moment_dtype=mdt)


def _batch(name: str, step: int) -> dict:
    return np_batch(jcfg_of(name), 900 + 10 * step + sorted(cases.CASES).index(name),
                    batch=cases.BATCH)


def _opt_draw(jcfg, mdt: str, seed: int) -> dict:
    """A nonzero Adafactor state in the JAX shapes, {"vr": tree, "vc": tree}
    of f32 numpy arrays that `mdt` holds exactly."""
    rng = np.random.default_rng(seed)
    zeros = j_init_opt_state(jbuild(jcfg).init(jax.random.key(0)), _jopt(mdt))

    def draw(x):
        v = (rng.uniform(0.5, 2.0, np.shape(x)) * 1e-3).astype(np.float32)
        return np.asarray(jnp.asarray(v, jnp.dtype(mdt)), np.float32)

    return jax.tree.map(draw, zeros)


class _Jax:
    """JAX's gradient, clip and Adafactor update, jitted once per arch and
    moment dtype."""

    def __init__(self):
        self.grads = functools.lru_cache(None)(lambda arch: _jax_grads(jreduced(jget(arch)), 1))
        self.clip = jax.jit(lambda g: j_clip_by_global_norm(g, _jopt("float32").grad_clip))
        self.update = functools.lru_cache(None)(lambda mdt: jax.jit(
            lambda params, opt, step, grads: j_adafactor_update(params, grads, opt, step,
                                                                _jopt(mdt))))

    def step(self, name: str, params, batch: dict) -> dict:
        loss, g = self.grads(cases.CASES[name][1])(params, to_jax(batch))
        _, norm = self.clip(g)
        return {"loss": float(loss), "grad_norm": float(norm), "g": g}


def _state(npz, prefix: str, mdt: str):
    """(params, {"vr", "vc"}) as JAX trees from a case file's `prefix`
    ("s<i>/" or "final/"), the statistics in `mdt`."""
    def tree(part, dtype=None):
        head = f"{prefix}{part}/"
        return fcases._nest({k[len(head):]: jnp.asarray(npz[k], dtype) for k in npz.files
                             if k.startswith(head)})
    return tree("p"), {part: tree(part, jnp.dtype(mdt)) for part in ("vr", "vc")}


def _write_one_card_checkpoint(root: Path) -> dict:
    """The layout config's one-card Adafactor state at step LAYOUT_STEP,
    every leaf drawn, saved into root/ckpt_one; returns its leaves."""
    cfg = cases.layout_cfg()
    state = init_train_state(build_model(cfg, device="cpu", seed=7),
                             torch.Generator().manual_seed(7), cases.opt_config())
    for part in state.opt.values():
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    state.step.fill_(cases.LAYOUT_STEP)
    Checkpointer(str(root / "ckpt_one"), async_writes=False).save(cases.LAYOUT_STEP, state)
    return fcases.whole_state(state)


def _start(mode: str, in_dir: Path, out: Path, env: dict) -> subprocess.Popen:
    out.mkdir(exist_ok=True)
    return subprocess.Popen([sys.executable, str(SCRIPT), mode, str(in_dir), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the three meshes' runs; meanwhile takes JAX's step 0; then the
    layouts' restore and JAX's later steps from the ranks' states.  Returns
    (JAX's results by case and step, the output root, the jitted JAX
    functions, the one-card checkpoint's leaves, each mesh's rank facts)."""
    root = tmp_path_factory.mktemp("adafactor")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for i, (name, (_, _, mdt)) in enumerate(cases.CASES.items()):
        params[name] = np_params(jcfg_of(name), 31 + i)
        np.savez(in_dir / f"params_{name}.npz", **fcases._flat(params[name]))
        np.savez(in_dir / f"opt_{name}.npz", **fcases._flat(_opt_draw(jcfg_of(name), mdt, i)))
        for s in range(cases.STEPS):
            np.savez(in_dir / f"batch_{name}_{s}.npz", **_batch(name, s))
    one = _write_one_card_checkpoint(in_dir)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {mode: _start(mode, in_dir, root / mode, env) for mode in MODES}
    jx = _Jax()
    want, logs = {}, {}
    try:
        for name in cases.CASES:  # step 0, while the ranks run
            want[name] = [jx.step(name, to_jax(params[name]), _batch(name, 0))]
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0] for k, p in procs.items()}
        assert procs["2x2"].returncode == 0, logs["2x2"][-4000:]
        procs["layouts"] = _start("layouts", in_dir, root / "layouts", env)
        for name, (mesh, _, mdt) in cases.CASES.items():
            npz = np.load(root / cases.tp.label(mesh) / f"{name}.npz")
            for s in range(1, cases.STEPS):
                want[name].append(jx.step(name, _state(npz, f"s{s}/", mdt)[0], _batch(name, s)))
        logs["layouts"] = procs["layouts"].communicate(timeout=SUBPROCESS_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{logs.get(k, '')[-4000:]}"
    facts = {mode: [json.loads((root / mode / f"rank{r}.json").read_text())
                    for r in range(int(mode[0]) * int(mode[2]))] for mode in MODES}
    return want, root, jx, one, facts


@pytest.mark.parametrize("name", list(cases.CASES))
def test_sharded_adafactor_step_matches_the_jax_one_device_step(runs, name):
    want, root, jx, _, _ = runs
    mesh, _, mdt = cases.CASES[name]
    npz = np.load(root / cases.tp.label(mesh) / f"{name}.npz")
    for s in range(cases.STEPS):
        w = want[name][s]
        np.testing.assert_allclose(float(npz[f"s{s}/loss"]), w["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(float(npz[f"s{s}/grad_norm"]), w["grad_norm"], rtol=STEP_RTOL)
        gp = {k[len(f"s{s}/g/"):]: npz[k] for k in npz.files if k.startswith(f"s{s}/g/")}
        assert_tree_close(gp, flat(w["g"]), GRAD_REL, GRAD_ABS)
        P, opt = _state(npz, f"s{s}/", mdt)
        clipped = fcases._nest({k: jnp.asarray(v) for k, v in
                                exact_clip(gp, _jopt(mdt).grad_clip).items()})
        ap, ao = jx.update(mdt)(P, opt, jnp.asarray(s, jnp.int32), clipped)
        nxt = f"s{s + 1}/" if s + 1 < cases.STEPS else "final/"
        for part, tree in (("p", ap), ("vr", ao["vr"]), ("vc", ao["vc"])):
            for key, x in flat(tree).items():
                x = np.asarray(x, np.float32)
                got = npz[f"{nxt}{part}/{key}"]
                assert got.shape == x.shape, (part, key)
                err = np.abs(got - x)
                if part != "p" and mdt == "bfloat16":
                    assert (err <= bf16_ulp(x)).all(), (s, part, key, err.max())
                else:
                    assert err.max() <= UPDATE_REL * np.abs(x).max(), (s, part, key, err.max())


@functools.lru_cache(None)
def _jax_specs(jcfg, mesh_shape: tuple):
    mesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    return J.tree_pspecs(jbuild(jcfg).param_specs(), J.make_rules(mesh, model_cfg=jcfg)), mesh


def factored_spec(key: str, shape: tuple, jcfg, mesh_shape):
    """The sanitized JAX-rule spec of state leaf `key` ("p/...", "vr/..."
    or "vc/...", the JAX tree's path) of whole shape `shape` on an abstract
    ("data", "model") mesh: a parameter's spec from JAX's `param_specs`, a
    statistic's that spec with the entry of its dropped dimension removed
    (vr: the last of a leaf of 2 or more dimensions, vc: the one before it;
    a 1-D leaf's vr keeps the spec and its vc is a scalar)."""
    spec, mesh = _jax_specs(jcfg, tuple(mesh_shape))
    part, path = key.split("/", 1)
    for k in path.split("/"):
        spec = spec[k]
    entries = list(spec)
    if part != "p":
        if len(entries) >= 2:
            del entries[len(entries) - (1 if part == "vr" else 2)]
        elif part == "vc":
            entries = []
    return J.sanitize_pspec(jax.sharding.PartitionSpec(*entries), shape, mesh), mesh


def jax_rule_block(whole: np.ndarray, key: str, jcfg, mesh_shape, rank: int) -> np.ndarray:
    """Rank `rank`'s block of the whole leaf `key` under `factored_spec`,
    ranks row-major."""
    spec, mesh = factored_spec(key, whole.shape, jcfg, mesh_shape)
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    out = whole
    for d, entry in enumerate(spec):
        for axis in ("data", "model"):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                n = whole.shape[d] // mesh.shape[axis]
                out = np.take(out, range(coords[axis] * n, (coords[axis] + 1) * n), axis=d)
    return out


def _rank_cases():
    return [(name, r) for name, c in cases.CASES.items() for r in range(c[0][0] * c[0][1])]


@pytest.mark.parametrize("name, rank", _rank_cases())
def test_each_rank_holds_the_jax_rules_block_of_the_factored_shapes(runs, name, rank):
    """The final parameters, vr and vc a rank holds equal, in shape and in
    bits, the `factored_spec` blocks of the leaves rank 0 gathered whole."""
    _, root, _, _, _ = runs
    mesh = cases.CASES[name][0]
    npz = np.load(root / cases.tp.label(mesh) / f"{name}.npz")
    mine = np.load(root / cases.tp.label(mesh) / f"{name}_rank{rank}.npz")
    assert sorted({k.split("/", 1)[0] for k in mine.files}) == ["p", "vc", "vr"]
    cut = 0
    for key in mine.files:
        want = jax_rule_block(npz[f"final/{key}"], key, jcfg_of(name), mesh, rank)
        assert mine[key].shape == want.shape, key
        assert np.array_equal(mine[key], want), key
        cut += key.split("/", 1)[0] != "p" and want.shape != npz[f"final/{key}"].shape
    assert cut, name  # some statistic is cut on every mesh


def _whole_along(key: str, shape: tuple, jcfg, mesh_shape) -> set:
    spec, _ = factored_spec(key, shape, jcfg, mesh_shape)
    named = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    return {"data", "model"} - named


@pytest.mark.parametrize("mode", MODES)
def test_blocks_whole_along_an_axis_stay_bit_alike_along_it(runs, mode):
    """After each step every rank holds the bits of the first rank of its
    row (column) in each leaf, vr and vc whole along "model" ("data"), by
    `factored_spec`: a statistic's sums are all-reduced, and what follows
    them is the same arithmetic on every rank."""
    _, root, _, _, facts = runs
    D, M = int(mode[0]), int(mode[2])
    ranks = facts[mode]
    checked = {"data": 0, "model": 0}
    for name in ranks[0]["cases"]:
        final = np.load(root / mode / f"{name}.npz")
        for key in ranks[0]["cases"][name]["blocks"][0]:
            whole = _whole_along(key, final[f"final/{key}"].shape, jcfg_of(name), (D, M))
            for r, f in enumerate(ranks):
                heads = {"model": r - r % M, "data": r % M}  # the row's and column's first
                for axis in whole:
                    if (M if axis == "model" else D) == 1:
                        continue
                    head = ranks[heads[axis]]["cases"][name]
                    checked[axis] += 1
                    for s in range(cases.STEPS):
                        assert (f["cases"][name]["blocks"][s][key]
                                == head["blocks"][s][key]), (name, r, s, key, axis)
    assert all(checked[a] for a, n in (("data", D), ("model", M)) if n > 1), checked


@pytest.mark.parametrize("path, tag, mesh", [("2x2/ckpt_one_2x2", "one_2x2", (2, 2)),
                                             ("layouts/ckpt_2x2_1x2", "2x2_1x2", (1, 2))])
def test_checkpoints_restore_across_layouts_bit_for_bit(runs, path, tag, mesh):
    """One card -> (2, 2) -> (1, 2): each saved checkpoint restores on one
    card to the one-card Adafactor state, every leaf bit for bit, and each
    rank held the `factored_spec` blocks of it."""
    _, root, _, one, _ = runs
    cfg = cases.layout_cfg()
    state = init_train_state(build_model(cfg, device="cpu", seed=9),
                             torch.Generator().manual_seed(9), cases.opt_config())
    state = Checkpointer(str(root / path)).restore(state)
    got = fcases.whole_state(state)
    assert int(state.step) == cases.LAYOUT_STEP
    assert set(got) == set(one) and {k.split("/")[0] for k in one} == {"p", "vr", "vc"}
    for k in one:
        assert np.array_equal(got[k], one[k]), k
    where = path.split("/")[0]
    jcfg = jreduced(jget(cases.LAYOUT_ARCH))
    for r in range(mesh[0] * mesh[1]):
        mine = np.load(root / where / f"{tag}_rank{r}.npz")
        assert bool(mine["sharded"])
        for key in (k for k in mine.files if k != "sharded"):
            assert np.array_equal(mine[key], jax_rule_block(one[key], key, jcfg, mesh, r)), \
                (r, key)


def test_crash_and_resume_on_1x2_is_bit_identical(runs):
    *_, facts = runs
    got = [f["resume"] for f in facts["1x2"]]
    for f in got:
        assert f["model_parts"] == 2 and f["parts"] == ["vc", "vr"]
        assert f["restarts"] == [0, 1]
        assert f["state_bit_identical"]
        assert f["losses"]["crash"] == f["losses"]["clean"]
        assert f["latest"] == 12
    assert got[0]["digest"] == got[1]["digest"]
    losses = [got[0]["losses"]["clean"][str(s)] for s in (1, 12)]
    assert losses[1] < losses[0]


# --------------------------------------------------------------------------
# The statistics' all-reduces, counted on the meta device
# --------------------------------------------------------------------------

def _predicted_payload(jcfg, mesh_shape) -> dict:
    """{(round, axis): f32 elements} that Adafactor's statistics put in each
    round's all-reduce on the (D, M) mesh, from the JAX leaves' shapes and
    `factored_spec`: round 1 a rank's vr block where the leaf's last
    dimension c is cut and its vc block where the one before, r, is; round
    2 the normalizer (vr's block less its last dimension) where r is."""
    sizes = dict(zip(("data", "model"), mesh_shape))
    leaves = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    out: dict = {}

    def block(key, shape):
        spec, _ = factored_spec(key, shape, jcfg, mesh_shape)
        return int(np.prod([d // (1 if e is None else sizes[e]) for d, e in zip(shape, spec)]))

    for kp, leaf in jax.tree_util.tree_flatten_with_path(leaves)[0]:
        path, shape = "/".join(k.key for k in kp), tuple(leaf.shape)
        if len(shape) < 2:
            continue
        spec, _ = factored_spec(f"p/{path}", shape, jcfg, mesh_shape)
        r_axis, c_axis = (e if e is not None and sizes[e] > 1 else None for e in spec[-2:])
        vr = block(f"vr/{path}", shape[:-1])
        terms = [(1, c_axis, vr), (1, r_axis, block(f"vc/{path}", shape[:-2] + shape[-1:]))]
        if r_axis is not None:
            terms.append((2, r_axis, vr // (shape[-2] // sizes[r_axis])))
        for rnd, axis, n in terms:
            if axis is not None:
                out[(rnd, axis)] = out.get((rnd, axis), 0) + n
    return out


def _meta_update_wire(cfg, mesh_shape) -> tuple[dict, dict]:
    """fsdp.WIRE's bytes and calls by axis of one `adafactor_update` on rank
    0's blocks of `cfg`'s meta state on the (D, M) mesh."""
    mesh = Mesh(mesh_shape, ("data", "model"))
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    state = SP.abstract_train_state(model, OptConfig(kind="adafactor"))
    fsdp.shard_train_state(state, make_rules(mesh, model_cfg=cfg), place=(mesh, 0))
    params = dict(model.named_parameters())
    grads = {n: torch.empty_like(p) for n, p in params.items()}
    fsdp.WIRE.reset()
    adafactor_update(params, grads, state.opt, state.step, OptConfig(kind="adafactor"),
                     sharding=model.fsdp)
    return fsdp.WIRE.by_axis(), fsdp.WIRE.by_axis("calls")


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2)])
def test_the_statistics_all_reduces_move_the_factored_payload(arch, mesh_shape):
    """On the meta device (counted, not run): each axis that cuts a leaf's r
    or c gets one all-reduce a round of the payload `_predicted_payload`
    gives, 2 (R - 1) / R of it on the wire, and nothing else moves."""
    wire, calls = _meta_update_wire(reduced(get_config(arch)), mesh_shape)
    want = _predicted_payload(jreduced(jget(arch)), mesh_shape)
    assert want
    for axis in ("data", "model"):
        R = mesh_shape[0 if axis == "data" else 1]
        n = sum(v for (_, ax), v in want.items() if ax == axis)
        rounds = sum(1 for (_, ax) in want if ax == axis)
        if not rounds:
            assert axis not in wire
            continue
        assert calls[axis] == {"all-gather": 0, "reduce-scatter": 0, "all-reduce": rounds}
        assert wire[axis]["all-reduce"] == 2 * (R - 1) / R * 4 * n


def test_full_width_falcon_mamba_on_1x2_all_reduces_135636_bytes_a_step():
    """falcon-mamba-7b at full width, 2 layers, on (1, 2): the statistics'
    two all-reduces along "model" move 135,608 + 28 bytes, the payload the
    chip check (`chip_smoke.py`'s `adafactor_tp_falcon_mamba`) is held to."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    wire, calls = _meta_update_wire(cfg, (1, 2))
    assert calls == {"model": {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 2}}
    assert wire["model"]["all-reduce"] == 135_608 + 28
    jcfg = dataclasses.replace(jget("falcon-mamba-7b"), n_layers=2)
    assert _predicted_payload(jcfg, (1, 2)) == {(1, "model"): 135_608 // 4, (2, "model"): 7}
