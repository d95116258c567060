"""The port's serving path on a sharded state (`Transformer.prefill`,
`decode_step` and `ServeEngine` on a model from `fsdp.shard_model` on a
("data", "model") mesh) against the JAX package's one-device `prefill` and
`decode_step`, on gloo CPU ranks.

`tests/multidev/torch_serve_cases.py` runs the (2, 1), (1, 2), (2, 2) and
(1, 4) meshes (one subprocess each, at once, with a time limit) on its
`CASES`: reduced qwen3-8b on every mesh ((1, 4): its 2 KV heads on 4
ranks, kv dropped) and with 3 rows on (2, 1) (every rank runs every row),
falcon-mamba-7b, gemma2-9b (tied head, softcap, local window) on (1, 2)
and (2, 2), jamba-v0.1-52b (attention, mamba and MoE) on (2, 2), and
qwen3-moe-235b-a22b (the experts split along "model") on (1, 2), (2, 2)
and (1, 4); and qwen3-moe with one dispatch group on (2, 1), whose rows
lie on both ranks (a span: each dispatches the whole group from the
choices gathered over both).  Both sides get the same numpy parameters (through
`repro_torch.interop`), prompts and teacher-forced decode tokens; this
file runs JAX's `prefill` and three `decode_step`s meanwhile.

Held, f32: each rank's logits rows within 2e-4 of max|logit| of JAX's
(prefill and every step); its caches its block of JAX's (its rows, its
block of the attention caches' sequence, mamba's channels), each leaf within 2e-4 of
its max |value|; `ServeEngine`'s completions, greedy and with a
temperature, identical on every rank and equal to the one-device port
engine's; the dry run's serving rank (`lower_cell` on the meta device)
counts the ranks' parameter, cache and gathered bytes and their wire bytes
by axis and kind exactly.  The attention caches' layout is JAX's
`cache_specs` block (sp -> "model": every KV head on the rank's block of
the sequence, the whole sequence where M does not divide it).
"""

from __future__ import annotations

import dataclasses
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
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jbuild
from repro.parallel import sharding as J
from repro_torch.configs import get_config, reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import dryrun as dr
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer, cache_specs
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import Mesh, make_rules
from repro_torch.serving import SamplerConfig, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_serve_cases.py"
SUBPROCESS_TIMEOUT_S = 300
LOGIT_REL = CACHE_REL = 2e-4
PROMPT = 16

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_fsdp_cases as fcases
    import torch_serve_cases as cases
    from torch_training_common import np_params
finally:
    sys.path.remove(str(MULTIDEV))

RUN = {n: c for n, c in cases.CASES.items() if c[3] is None}  # the cases that serve
INPUTS = sorted({(c[1], c[2]) for c in RUN.values()})  # (arch, global batch)


def _ranks(name: str) -> int:
    D, M = cases.CASES[name][0]
    return D * M


def _start(mode: str, in_dir: Path, out: Path, env: dict) -> subprocess.Popen:
    out.mkdir(exist_ok=True)
    return subprocess.Popen([sys.executable, str(SCRIPT), mode, str(in_dir), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _one_device_engine(cfg, P, prompts, temperature: float) -> list:
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    engine = ServeEngine(model, cases.MAX_LEN, len(prompts), SamplerConfig(
        temperature=temperature, max_new_tokens=cases.NEW_TOKENS, seed=5), device="cpu")
    return engine.generate(prompts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the four meshes' runs; meanwhile JAX's one-device prefill and
    decode steps and the one-device port engine on each (arch, batch).
    Returns (JAX's logits and caches, the one-device completions, the
    output root, each mesh's rank facts)."""
    root = tmp_path_factory.mktemp("serve")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for arch in sorted({c[1] for c in cases.CASES.values()}):
        params[arch] = np_params(jreduced(jget(arch)), 31)
        np.savez(in_dir / f"params_{arch}.npz", **fcases._flat(params[arch]))
    tokens = {}
    for i, (arch, B) in enumerate(sorted({(c[1], c[2]) for c in cases.CASES.values()})):
        rng = np.random.default_rng(40 + i)
        V = reduced(get_config(arch)).vocab
        tokens[arch, B] = {"prompts": rng.integers(0, V, (B, PROMPT)).astype(np.int32),
                           "steps": rng.integers(0, V, (cases.STEPS, B)).astype(np.int32)}
        np.savez(in_dir / cases.tokens_file(arch, B), **tokens[arch, B])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {mode: _start(mode, in_dir, root / mode, env) for mode in cases.MESHES}
    want, engines, logs = {}, {}, {}
    try:
        for arch, B in INPUTS:
            jm, jP, t = jbuild(jreduced(jget(arch))), jax.tree.map(jnp.asarray, params[arch]), \
                tokens[arch, B]
            logits, jc = jm.prefill(jP, {"tokens": jnp.asarray(t["prompts"])},
                                    max_len=cases.MAX_LEN)
            got = {"l0": np.asarray(logits, np.float32), "c0": _np_caches(jc)}
            for s in range(cases.STEPS):
                logits, jc = jm.decode_step(jP, jc, jnp.asarray(t["steps"][s]),
                                            jnp.int32(PROMPT + s))
                got[f"l{s + 1}"] = np.asarray(logits, np.float32)
            got[f"c{cases.STEPS}"] = _np_caches(jc)
            want[arch, B] = got
            cfg = reduced(get_config(arch))
            engines[arch, B] = {mode: _one_device_engine(cfg, params[arch],
                                                         t["prompts"].tolist(), temp)
                                for mode, temp in (("greedy", 0.0),
                                                   ("temperature", cases.TEMPERATURE))}
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{logs.get(k, '')[-4000:]}"
    facts = {}
    for mode in cases.MESHES:
        D, M = (int(x) for x in mode.split("x"))
        facts[mode] = [json.loads((root / mode / f"rank{r}.json").read_text())
                       for r in range(D * M)]
    return want, engines, root, facts


def _np_caches(jc) -> dict:
    return {f"{k}/{n}": np.asarray(v, np.float32) for k, c in jc.items() for n, v in c.items()}


def _facts(runs, name: str) -> list:
    *_, facts = runs
    return [f["cases"][name] for f in facts[cases.label(cases.CASES[name][0])]]


def _rank_npz(runs, name: str, rank: int):
    _, _, root, _ = runs
    return np.load(root / cases.label(cases.CASES[name][0]) / f"{name}_rank{rank}.npz")


def _cache_block(whole: np.ndarray, key: str, name: str, rank: int, rows) -> np.ndarray:
    """Rank `rank`'s block of the one-device cache leaf `key` ("pos<i>/k",
    ...), as `sanitize_pspec` of JAX's `cache_specs` places it: its rows,
    and along "model" its block of the sequence, every KV head (attention;
    the whole sequence where M does not divide it) or its d_inner channels
    (mamba)."""
    (D, M), arch, _, _ = cases.CASES[name]
    cfg = reduced(get_config(arch))
    m = rank % M
    block = whole[:, rows[0]:rows[1]]
    leaf = key.split("/")[1]
    if leaf in ("k", "v"):
        S_max = block.shape[2]
        if M == 1 or S_max % M:
            return block
        n = S_max // M
        return block[:, :, m * n:(m + 1) * n]
    if M == 1 or cfg.d_inner % M:
        return block
    n = cfg.d_inner // M
    return block[:, :, :, m * n:(m + 1) * n] if leaf == "conv" else block[:, :, m * n:(m + 1) * n]


def _rank_cases(names):
    return [(n, r) for n in names for r in range(_ranks(n))]


@pytest.mark.parametrize("name, rank", _rank_cases(RUN))
def test_logits_match_the_jax_one_device_prefill_and_decode(runs, name, rank):
    """The prefill's and each teacher-forced decode step's logits of the
    rank's rows, whole along "model", within 2e-4 of max|logit| of JAX's."""
    want = runs[0][cases.CASES[name][1], cases.CASES[name][2]]
    got = _rank_npz(runs, name, rank)
    r0, r1 = got["rows"]
    for s in range(cases.STEPS + 1):
        w = want[f"l{s}"][r0:r1]
        assert got[f"l{s}"].shape == w.shape, s
        err = float(np.abs(got[f"l{s}"] - w).max())
        assert err <= LOGIT_REL * float(np.abs(w).max()), (s, err)


@pytest.mark.parametrize("name, rank", _rank_cases(RUN))
def test_each_ranks_caches_are_its_block_of_the_one_device_caches(runs, name, rank):
    """After the prefill and after the last step: every cache leaf the rank
    holds has the shape of its block of JAX's one-device leaf and its values
    within 2e-4 of the block's max |value|."""
    want = runs[0][cases.CASES[name][1], cases.CASES[name][2]]
    got = _rank_npz(runs, name, rank)
    rows = tuple(got["rows"])
    for when in ("c0", f"c{cases.STEPS}"):
        keys = sorted(k[len(when) + 1:] for k in got.files if k.startswith(when + "/"))
        assert keys == sorted(want[when]), when
        for key in keys:
            w = _cache_block(want[when][key], key, name, rank, rows)
            g = got[f"{when}/{key}"]
            assert g.shape == w.shape, (when, key, g.shape, w.shape)
            assert np.abs(g - w).max() <= CACHE_REL * max(float(np.abs(w).max()), 1e-30), (
                when, key)


@pytest.mark.parametrize("name", sorted(RUN))
def test_the_ranks_of_a_row_agree_and_the_rows_split_along_data(runs, name):
    """Ranks with the same "data" index hold the same rows and bit-equal
    logits (gathered whole along "model"); the data axis splits the batch
    where it divides it, else every rank runs every row."""
    (D, M), _, B, _ = cases.CASES[name]
    facts = _facts(runs, name)
    for r, f in enumerate(facts):
        want = [r // M * B // D, (r // M + 1) * B // D] if B % D == 0 else [0, B]
        assert f["rows"] == want, (r, f["rows"])
        mine, head = _rank_npz(runs, name, r), _rank_npz(runs, name, r - r % M)
        for s in range(cases.STEPS + 1):
            assert np.array_equal(mine[f"l{s}"], head[f"l{s}"]), (r, s)


@pytest.mark.parametrize("mode", ["greedy", "temperature"])
@pytest.mark.parametrize("name", sorted(RUN))
def test_engine_completions_are_every_ranks_and_the_one_device_engines(runs, name, mode):
    """`ServeEngine.generate` on the global prompts: the same completions on
    every rank, equal to the one-device port engine's on the same
    parameters; the engine's wire of a decode step is the model's, and it
    gathers logits rows along "data" only where the data axis splits them."""
    _, engines, _, _ = runs
    (D, M), arch, B, _ = cases.CASES[name]
    facts = _facts(runs, name)
    got = [f["engine"][mode]["completions"] for f in facts]
    assert all(g == got[0] for g in got)
    assert got[0] == engines[arch, B][mode]
    for f in facts:
        stats = f["engine"][mode]["stats"]
        assert stats["decode_steps"] == cases.NEW_TOKENS - 1
        assert stats["wire_prefill"] == f["wire_prefill"]
        assert all(w == f["wire_steps"][0] for w in stats["wire_decode_steps"])
        assert (stats["wire_logits"] > 0) == (D > 1 and B % D == 0)


def test_a_batch_the_data_axis_does_not_divide_runs_every_row_on_every_rank(runs):
    """3 rows on 2 data ranks: both ranks run all 3 (as `sanitize_pspec`
    drops the data axis from JAX's batch), gather no logits and dispatch
    nothing across ranks; the weights are still gathered along "data"."""
    for f in _facts(runs, "qwen3_rows3_2x1"):
        assert f["rows"] == [0, 3]
        assert f["engine"]["greedy"]["stats"]["wire_logits"] == 0
        assert set(f["wire_prefill"]) == {"data"} and f["wire_prefill"]["data"]["all-gather"] > 0


def test_an_moe_group_on_two_data_ranks_serves_as_one_device(runs):
    """One dispatch group on two data ranks: each rank's row is half of the
    group, and both dispatch it whole from their gathered choices.  Each
    rank's prefill and decode logits are its rows of JAX's one-device
    `prefill` and `decode_step` on the same config, within LOGIT_REL of
    max|logit|; the prefill all-gathers the choices along "data" once a MoE
    layer (site "moe-choices": the other rank's 16 tokens x top-2 int64);
    `ServeEngine`'s completions are the one-device port engine's.  Without a
    process group a span raises rather than dispatch the rows alone, and
    `data_split`, which a serving rank calls before any collective, refuses
    a split whose G and R divide neither the other."""
    from repro_torch.models.layers.moe import DataSplit, data_split

    name = "moe_one_group_2x1"
    _, _, root, _ = runs
    (D, _), arch, B, overrides = cases.CASES[name]
    jcfg = jreduced(jget(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **overrides))
    cfg = cases.case_cfg(arch, overrides)
    P = fcases._nest(dict(np.load(root / "in" / f"params_{arch}.npz")))
    t = np.load(root / "in" / cases.tokens_file(arch, B))
    jm, jP = jbuild(jcfg), jax.tree.map(jnp.asarray, P)
    logits, jc = jm.prefill(jP, {"tokens": jnp.asarray(t["prompts"])}, max_len=cases.MAX_LEN)
    want = [np.asarray(logits, np.float32)]
    for s in range(cases.STEPS):
        logits, jc = jm.decode_step(jP, jc, jnp.asarray(t["steps"][s]), jnp.int32(PROMPT + s))
        want.append(np.asarray(logits, np.float32))
    for rank, f in enumerate(_facts(runs, name)):
        assert f["rows"] == [rank, rank + 1]
        got = _rank_npz(runs, name, rank)
        for i, w in enumerate(want):
            w = w[rank:rank + 1]
            assert np.abs(got[f"l{i}"] - w).max() <= LOGIT_REL * np.abs(w).max(), (rank, i)
        assert f["choices_prefill"]["moe-choices"]["calls"] == cfg.n_groups
        assert f["choices_prefill"]["moe-choices"]["bytes"] == (
            cfg.n_groups * PROMPT * cfg.moe.top_k * 8)
        for mode, temp in (("greedy", 0.0), ("temperature", cases.TEMPERATURE)):
            assert f["engine"][mode]["completions"] == _one_device_engine(
                cfg, P, t["prompts"].tolist(), temp), mode
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        model.prefill({"tokens": torch.zeros(1, 4, dtype=torch.int64)}, 8,
                      data_split=DataSplit(2))
    # a decode step of 6 rows on 3 data ranks: 2 groups of 3 tokens
    with pytest.raises(ValueError, match="G = 2 .* R = 3 .* neither divides"):
        data_split(reduced(get_config(arch)), 6, 1, Mesh((3, 1), ("data", "model")), 0)


@pytest.mark.parametrize("mode", ["1x2", "1x4"])
def test_the_model_axis_operators_run_without_a_graph_under_no_grad(runs, mode):
    """copy, reduce and gather under `torch.no_grad`, as the serving passes
    run them: the whole computation's values, f64, and no graph."""
    *_, facts = runs
    for f in facts[mode]:
        ops = f["no_grad_ops"]
        assert ops["graphs"] == []
        assert all(err <= 1e-12 for err in ops["errors"].values()), ops


def test_sharding_gather_builds_no_graph_under_no_grad():
    """`Sharding.gather` of blocks that require grad: a graph with grad on,
    none under `torch.no_grad`, the same bytes counted on "data" either
    way (meta device, no group)."""
    cfg = reduced(get_config("qwen3-8b"))
    model = Transformer(cfg, device="meta", dtype=torch.float32).requires_grad_(True)
    mesh = Mesh((2, 1), ("data", "model"))
    sharding = fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, 0))
    named = dict(model.groups[0].named_parameters())
    counts = []
    for grad in (True, False):
        fsdp.WIRE.reset()
        with torch.set_grad_enabled(grad):
            whole = sharding.gather(named, "groups.0.")
        assert all((t.grad_fn is not None) == grad for t in whole.values())
        counts.append(fsdp.WIRE.by_axis())
    assert counts[0] == counts[1] and counts[0]["data"]["all-gather"] > 0


# --------------------------------------------------------------------------
# The attention caches' layout: JAX's `cache_specs` block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape, S_max", [((1, 2), 24), ((2, 2), 24), ((1, 4), 24),
                                               ((2, 1), 24), ((1, 4), 22), ((1, 2), 23)])
def test_attention_caches_split_their_heads_where_jax_splits_the_sequence(mesh_shape, S_max):
    """Reduced qwen3-8b (2 KV heads), B = 4: every rank's k cache is the
    block that `sanitize_pspec` of JAX's `cache_specs` (None, "dp", "sp",
    None, None) gives its device, [G, B / D, S_max / M, KV, hd] with every
    KV head (on (1, 4) too, where kv is dropped), its positions the rank's
    block of the sequence (`cache_sequence`), or the whole sequence where M
    does not divide S_max (22 on 4 ranks, 23 on 2): 1x JAX's bytes.
    Mamba's caches are JAX's blocks exactly."""
    from repro_torch.models.transformer import cache_sequence

    cfg, jcfg = reduced(get_config("qwen3-8b")), jreduced(jget("qwen3-8b"))
    assert cache_specs(cfg) == JT.cache_specs(jcfg) == {
        "pos0": {"k": (None, "dp", "sp", None, None), "v": (None, "dp", "sp", None, None)}}
    D, M = mesh_shape
    mesh = Mesh(mesh_shape, ("data", "model"))
    jmesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    B = 4
    whole = (cfg.n_groups, B, S_max, cfg.n_kv, cfg.head_dim)
    jspec = J.sanitize_pspec(J.tree_pspecs(JT.cache_specs(jcfg), J.make_rules(
        jmesh, model_cfg=jcfg))["pos0"]["k"], whole, jmesh)
    jax_block = [n // (1 if e is None else jmesh.shape[e]) for n, e in zip(whole, jspec)]
    split = S_max % M == 0
    assert jax_block == [cfg.n_groups, B // D, S_max // M if split else S_max, cfg.n_kv,
                         cfg.head_dim]
    for rank in range(D * M):
        model = Transformer(cfg, device="meta", dtype=torch.float32)
        sharding = fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, rank))
        caches = model.init_caches(B // D, S_max)
        for leaf in ("k", "v"):
            assert list(caches["pos0"][leaf].shape) == jax_block
            assert caches["pos0"][leaf].numel() == np.prod(jax_block)
        m, n = rank % M, S_max // M
        want = range(m * n, (m + 1) * n) if split and M > 1 else None
        assert caches.sequence == cache_sequence(cfg, S_max, sharding) == want
    mcfg, mjcfg = reduced(get_config("falcon-mamba-7b")), jreduced(jget("falcon-mamba-7b"))
    model = Transformer(mcfg, device="meta", dtype=torch.float32)
    fsdp.shard_model(model, make_rules(mesh, model_cfg=mcfg), place=(mesh, 0))
    caches = model.init_caches(B // D, S_max)["pos0"]
    jspecs = J.tree_pspecs(JT.cache_specs(mjcfg), J.make_rules(jmesh, model_cfg=mjcfg))["pos0"]
    for name, t in caches.items():
        shape = dict(JT.init_caches(mjcfg, B, S_max)["pos0"])[name].shape
        spec = J.sanitize_pspec(jspecs[name], shape, jmesh)
        assert list(t.shape) == [n // (1 if e is None else jmesh.shape[e])
                                 for n, e in zip(shape, spec)], name


# --------------------------------------------------------------------------
# The dry run against the real ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3_2x2", "qwen3_1x4", "mamba_2x2", "gemma2_2x2",
                                  "jamba_2x2", "moe_2x2", "moe_1x4"])
def test_the_dry_runs_serving_rank_counts_the_real_ranks_bytes(runs, name):
    """`lower_cell` of the case's configuration on its mesh, the prefill
    cell at the prompt's length and the decode cell at max_len (its caches
    the ranks'): the rank's parameter bytes, largest gather and cache block
    equal every real rank's, and the wire bytes by axis and kind of the
    prefill and of a decode step equal each real rank's."""
    mesh_shape, arch, B, _ = cases.CASES[name]
    shapes = {"prefill_32k": dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=PROMPT,
                                                 global_batch=B),
              "decode_32k": dataclasses.replace(C.SHAPES["decode_32k"], seq_len=cases.MAX_LEN,
                                                global_batch=B)}
    with mock.patch.dict(C.SHAPES, shapes), \
            mock.patch.dict(C.ARCHS, {"servecell": reduced(get_config(arch))}):
        pre, _ = dr.lower_cell("servecell", "prefill_32k", Mesh(mesh_shape, ("data", "model")))
        dec, _ = dr.lower_cell("servecell", "decode_32k", Mesh(mesh_shape, ("data", "model")))
    assert pre["ok"] and dec["ok"]
    for rec in (pre, dec):
        assert rec["rank"]["repetition"] == 1 and rec["memory"]["state_layout"]["caches"]
    for f in _facts(runs, name):
        for rec in (pre, dec):
            parts = rec["memory"]["port_rank_parts"]
            assert parts["params"] == f["param_bytes"]
            assert parts["gathered"] == f["largest_gather"]
        assert dec["memory"]["port_rank_parts"]["caches"] == f["cache_bytes"]
        assert pre["hlo"]["collective_by_axis"] == f["wire_prefill"]
        assert all(dec["hlo"]["collective_by_axis"] == w for w in f["wire_steps"])
    assert dec["hlo"]["collective_wire_bytes"] == sum(
        sum(v.values()) for v in dec["hlo"]["collective_by_axis"].values()) > 0
