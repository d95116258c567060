"""The attention caches' sequence split along "model" (JAX's `cache_specs`:
(None, "dp", "sp", None, None), sp -> "model") on the port's sharded
serving path, against the JAX package's one-device `prefill` and
`decode_step`, on gloo CPU ranks.

`tests/multidev/torch_serve_sequence_cases.py` runs the (1, 2), (2, 2) and
(1, 4) meshes (one subprocess each, at once, with a time limit) on its
`CASES`: reduced qwen3-8b on each of them (kv -> "model" on (1, 2) and
(2, 2); its 2 KV heads on 4 ranks, kv dropped, on (1, 4)), gemma2-9b on
(1, 4) (softcap and a local window of 8: rank 0's block of 6 positions is
wholly outside the window of every decode step), qwen3-moe-235b-a22b on
(1, 2), and qwen3-8b with max_len 22 on (1, 4) and 23 on (1, 2), which
the model axis does not divide: there every rank holds the whole
sequence, as `sanitize_pspec` drops the axis.  Both sides get the same
numpy parameters, prompts and teacher-forced decode tokens; this file runs
JAX's `prefill` and three `decode_step`s and the one-device port engine
meanwhile.

Held, f32: each rank's attention caches, after the prefill and after the
last step, are the block of JAX's one-device caches that `sanitize_pspec`
of JAX's `cache_specs` gives the rank's device (its rows, its block of the
sequence, every KV head), within 2e-4 of each leaf's max |value|, with
JAX's per-device bytes; its logits within 2e-4 of max|logit| of JAX's,
bit-alike across the ranks of a row; `ServeEngine`'s completions, greedy
and with a temperature, the same on every rank and equal to the
one-device port engine's; a wholly masked block weighs exactly 0; and the
dry run's rank (`lower_cell`) counts the real ranks' cache bytes and wire.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from math import prod
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from repro_torch.parallel.sharding import Mesh
from repro_torch.serving import SamplerConfig, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_serve_sequence_cases.py"
SUBPROCESS_TIMEOUT_S = 240
LOGIT_REL = CACHE_REL = 2e-4
PROMPT = 16

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_fsdp_cases as fcases
    import torch_serve_sequence_cases as cases
    from torch_training_common import np_params
finally:
    sys.path.remove(str(MULTIDEV))

ARCHS = sorted({c[1] for c in cases.CASES.values()})
INPUTS = sorted({(c[1], c[2], c[3]) for c in cases.CASES.values()})  # (arch, B, max_len)


def _ranks(name: str) -> int:
    D, M = cases.CASES[name][0]
    return D * M


def _one_device_engine(cfg, P, prompts, max_len: int, temperature: float) -> list:
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    engine = ServeEngine(model, max_len, len(prompts), SamplerConfig(
        temperature=temperature, max_new_tokens=cases.NEW_TOKENS, seed=5), device="cpu")
    return engine.generate(prompts)


def _np_caches(jc) -> dict:
    return {f"{k}/{n}": np.asarray(v, np.float32) for k, c in jc.items() for n, v in c.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the three meshes' runs; meanwhile JAX's one-device prefill and
    decode steps and the one-device port engine on each (arch, batch,
    max_len).  Returns (JAX's logits and caches, the one-device
    completions, the output root, each mesh's rank facts)."""
    root = tmp_path_factory.mktemp("serve_sequence")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for arch in ARCHS:
        params[arch] = np_params(jreduced(jget(arch)), 37)
        np.savez(in_dir / f"params_{arch}.npz", **fcases._flat(params[arch]))
    tokens = {}
    for i, (arch, B) in enumerate(sorted({(c[1], c[2]) for c in cases.CASES.values()})):
        rng = np.random.default_rng(60 + i)
        V = reduced(get_config(arch)).vocab
        tokens[arch, B] = {"prompts": rng.integers(0, V, (B, PROMPT)).astype(np.int32),
                           "steps": rng.integers(0, V, (cases.STEPS, B)).astype(np.int32)}
        np.savez(in_dir / cases.tokens_file(arch, B), **tokens[arch, B])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for mode in cases.MESHES:
        (root / mode).mkdir()
        procs[mode] = subprocess.Popen(
            [sys.executable, str(SCRIPT), mode, str(in_dir), str(root / mode)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    want, engines, logs = {}, {}, {}
    try:
        for arch, B, max_len in INPUTS:
            jm, jP = jbuild(jreduced(jget(arch))), jax.tree.map(jnp.asarray, params[arch])
            t = tokens[arch, B]
            logits, jc = jm.prefill(jP, {"tokens": jnp.asarray(t["prompts"])}, max_len=max_len)
            got = {"l0": np.asarray(logits, np.float32), "c0": _np_caches(jc)}
            for s in range(cases.STEPS):
                logits, jc = jm.decode_step(jP, jc, jnp.asarray(t["steps"][s]),
                                            jnp.int32(PROMPT + s))
                got[f"l{s + 1}"] = np.asarray(logits, np.float32)
            got[f"c{cases.STEPS}"] = _np_caches(jc)
            want[arch, B, max_len] = got
            cfg = reduced(get_config(arch))
            engines[arch, B, max_len] = {
                mode: _one_device_engine(cfg, params[arch], t["prompts"].tolist(), max_len, temp)
                for mode, temp in (("greedy", 0.0), ("temperature", cases.TEMPERATURE))}
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


def _want(runs, name: str) -> dict:
    _, arch, B, max_len = cases.CASES[name]
    return runs[0][arch, B, max_len]


def _facts(runs, name: str) -> list:
    *_, facts = runs
    return [f[name] for f in facts[cases.label(cases.CASES[name][0])]]


def _rank_npz(runs, name: str, rank: int):
    _, _, root, _ = runs
    return np.load(root / cases.label(cases.CASES[name][0]) / f"{name}_rank{rank}.npz")


def _jax_block(whole: np.ndarray, key: str, name: str, rank: int) -> np.ndarray:
    """The block of the one-device cache leaf `key` ("pos<i>/k", ...) that
    JAX places on the device of `rank` (row-major on the ("data", "model")
    mesh): `sanitize_pspec` of its `cache_specs` spec under JAX's rules."""
    mesh_shape, arch, _, _ = cases.CASES[name]
    jcfg = jreduced(jget(arch))
    jmesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    pos, leaf = key.split("/")
    spec = J.tree_pspecs(JT.cache_specs(jcfg), J.make_rules(jmesh, model_cfg=jcfg))[pos][leaf]
    coords = {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}
    block = whole
    for dim, entry in enumerate(J.sanitize_pspec(spec, whole.shape, jmesh)):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        index, parts = 0, 1
        for ax in axes:
            index, parts = index * jmesh.shape[ax] + coords[ax], parts * jmesh.shape[ax]
        n = whole.shape[dim] // parts
        block = np.take(block, range(index * n, (index + 1) * n), axis=dim)
    return block


def _rank_cases(names):
    return [(n, r) for n in names for r in range(_ranks(n))]


@pytest.mark.parametrize("name, rank", _rank_cases(cases.CASES))
def test_each_ranks_caches_are_jaxs_sequence_block(runs, name, rank):
    """After the prefill and after the last step: every cache leaf the rank
    holds is its device's block of JAX's one-device leaf (shape; values
    within 2e-4 of the block's max |value|), its bytes JAX's per-device
    share, and its positions the rank's block of the sequence: [m n,
    (m + 1) n), n = max_len / M, or the whole sequence where M does not
    divide max_len."""
    want = _want(runs, name)
    (D, M), _, _, max_len = cases.CASES[name]
    got = _rank_npz(runs, name, rank)
    facts = _facts(runs, name)[rank]
    share = 0
    for when in ("c0", f"c{cases.STEPS}"):
        keys = sorted(k[len(when) + 1:] for k in got.files if k.startswith(when + "/"))
        assert keys == sorted(want[when]), when
        for key in keys:
            w = _jax_block(want[when][key], key, name, rank)
            g = got[f"{when}/{key}"]
            assert g.shape == w.shape, (when, key, g.shape, w.shape)
            assert np.abs(g - w).max() <= CACHE_REL * max(float(np.abs(w).max()), 1e-30), (
                when, key)
            share += 4 * w.size if when == "c0" else 0
    assert facts["cache_bytes"] == share
    n = max_len // M
    assert facts["sequence"] == (None if max_len % M else [rank % M * n, (rank % M + 1) * n])


@pytest.mark.parametrize("name, rank", _rank_cases(cases.CASES))
def test_logits_match_the_jax_one_device_prefill_and_decode(runs, name, rank):
    """The prefill's and each teacher-forced decode step's logits of the
    rank's rows within 2e-4 of max|logit| of JAX's: the ranks' partial
    softmaxes combined across the row."""
    want = _want(runs, name)
    got = _rank_npz(runs, name, rank)
    r0, r1 = got["rows"]
    for s in range(cases.STEPS + 1):
        w = want[f"l{s}"][r0:r1]
        assert got[f"l{s}"].shape == w.shape, s
        err = float(np.abs(got[f"l{s}"] - w).max())
        assert err <= LOGIT_REL * float(np.abs(w).max()), (s, err)


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_the_ranks_of_a_row_are_bit_alike(runs, name):
    """Ranks with the same "data" index hold bit-equal logits of every step,
    though each combined the partial sums of its own query heads."""
    (D, M), _, _, _ = cases.CASES[name]
    for r in range(D * M):
        mine, head = _rank_npz(runs, name, r), _rank_npz(runs, name, r - r % M)
        for s in range(cases.STEPS + 1):
            assert np.array_equal(mine[f"l{s}"], head[f"l{s}"]), (r, s)


@pytest.mark.parametrize("mode", ["greedy", "temperature"])
@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_engine_completions_are_every_ranks_and_the_one_device_engines(runs, name, mode):
    """`ServeEngine.generate` on the global prompts, caches of the case's
    max_len: the same completions on every rank, equal to the one-device
    port engine's on the same parameters."""
    _, engines, _, _ = runs
    _, arch, B, max_len = cases.CASES[name]
    got = [f["engine"][mode] for f in _facts(runs, name)]
    assert all(g == got[0] for g in got)
    assert got[0] == engines[arch, B, max_len][mode]


def test_a_wholly_masked_block_weighs_exactly_zero(runs):
    """gemma2 on (1, 4), max_len 24: at position 19 rank 0's block [0, 6) of
    the local layers' caches lies wholly outside the window (kv > 11).
    Overwriting its k and v with large values leaves every rank's logits
    bit for bit: the global max is taken before any exponential, so the
    block's scores (NEG_INF, the finite -1e30) weigh exp(-1e30 - M) = 0."""
    facts = _facts(runs, cases.MASKED)
    assert cases.CASES[cases.MASKED][0] == (1, 4) and facts[0]["sequence"] == [0, 6]
    assert jreduced(jget("gemma2-9b")).window == 8
    assert all(f["masked_equal"] is True for f in facts)


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_a_decode_steps_wire_combines_across_the_row_where_the_sequence_is_split(runs, name):
    """Every decode step puts the same bytes on the wire.  Along "model" a
    split sequence adds, per attention layer, one all-gather of q (and the
    new k, v where kv -> "model"), an all-reduce of the score maxima and a
    reduce-scatter of the partial sums; a whole sequence has no
    reduce-scatter.  The caches hold the rank's max_len / M positions, or
    all max_len."""
    (D, M), _, _, max_len = cases.CASES[name]
    split = max_len % M == 0
    for f in _facts(runs, name):
        steps = f["wire_steps"]
        assert all(w == steps[0] for w in steps)
        assert (steps[0]["model"]["reduce-scatter"] > 0) == split
        assert f["cache_shapes"]["pos0/k"][2] == (max_len // M if split else max_len)


@pytest.mark.parametrize("name", ["qwen3_1x4", "gemma2_1x4", "qwen3_whole_1x4",
                                  "qwen3_whole_1x2"])
def test_the_dry_runs_serving_rank_counts_the_real_ranks_caches_and_wire(runs, name):
    """`lower_cell` of the case's configuration on its mesh (decode at
    max_len, prefill at the prompt's length): its cache block's bytes are
    every real rank's and JAX's sanitized cache share, `cache_layout`
    names the sequence along "model" (whole where M does not divide
    max_len), and the wire of a prefill and of a decode step by axis and
    kind is every real rank's."""
    mesh_shape, arch, B, max_len = cases.CASES[name]
    shapes = {"prefill_32k": dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=PROMPT,
                                                 global_batch=B),
              "decode_32k": dataclasses.replace(C.SHAPES["decode_32k"], seq_len=max_len,
                                                global_batch=B)}
    with mock.patch.dict(C.SHAPES, shapes), \
            mock.patch.dict(C.ARCHS, {"seqcell": reduced(get_config(arch))}):
        pre, _ = dr.lower_cell("seqcell", "prefill_32k", Mesh(mesh_shape, ("data", "model")))
        dec, _ = dr.lower_cell("seqcell", "decode_32k", Mesh(mesh_shape, ("data", "model")))
    assert pre["ok"] and dec["ok"]
    layout = dec["memory"]["state_layout"]["caches"]
    M = mesh_shape[1]
    split = max_len % M == 0
    assert layout["sequence"] == ("model" if split else dr.WHOLE)
    assert layout["positions"] == [0, max_len // M if split else max_len]
    jcfg = jreduced(jget(arch))
    jmesh = jax.sharding.AbstractMesh(mesh_shape, ("data", "model"))
    jspecs = J.tree_pspecs(JT.cache_specs(jcfg), J.make_rules(jmesh, model_cfg=jcfg))
    share = 0
    for pos, c in JT.init_caches(jcfg, B, max_len).items():
        for leaf, t in c.items():
            spec = J.sanitize_pspec(jspecs[pos][leaf], t.shape, jmesh)
            div = prod(1 if e is None else jmesh.shape[e] for e in spec)
            share += t.size * t.dtype.itemsize // div
    assert dec["memory"]["port_rank_parts"]["caches"] == share
    for f in _facts(runs, name):
        assert f["cache_bytes"] == share
        assert pre["hlo"]["collective_by_axis"] == f["wire_prefill"]
        assert all(dec["hlo"]["collective_by_axis"] == w for w in f["wire_steps"])


def test_a_model_split_along_model_refuses_caches_without_their_block():
    """A plain dict of caches carries no block of the sequence: a model
    split along "model" refuses it before any collective (meta device, no
    process group), and takes the `Caches` of its own `init_caches`."""
    import torch

    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import make_rules

    cfg = reduced(get_config("qwen3-8b"))
    mesh = Mesh((1, 2), ("data", "model"))
    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), place=(mesh, 1))
    caches = model.init_caches(2, 24)
    assert caches.sequence == range(12, 24)
    tokens = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="carry the rank's sequence block"):
        model.decode_step(dict(caches), tokens, 16)
    logits, out = model.decode_step(caches, tokens, 16)
    assert out is caches and logits.shape == (2, cfg.vocab)
