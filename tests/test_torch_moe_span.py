"""MoE dispatch groups that span data ranks (`repro_torch.models.layers.moe`):
where G dispatch groups divide R data-parallel ranks, each group's rows lie
on a span of s = R / G consecutive batch shards, and every rank of the span
dispatches the whole group (its capacity, ranks and drops) from the
routing choices all-gathered over the span, filling only its own tokens'
slots and combining its own tokens.  Held against the JAX package's
one-device step, prefill and decode step, on gloo CPU ranks.

`tests/multidev/torch_moe_span_cases.py` runs the (2, 1), (4, 1) and (2, 2)
("data", "model") meshes (one subprocess each, at once, with a time limit):
- training, 2 steps, reduced configs, B = 4, S = 16: qwen3-moe with its 2
  groups on (4, 1) (spans of 2); with one group on (2, 1), (4, 1) (a span
  of 4) and (2, 2) (the span and the experts split along "model"), with
  accum 2 and with `dispatch="scatter"` on (2, 1); jamba (attention, mamba
  and MoE) and llama4-maverick (top-1; 2 steps, lr 1e-3 with warmup 2: its
  first update, as its router's noise requires) with one group on (2, 1).
  This file runs JAX's train step from each state the ranks started a step
  from (lockstep), with `torch_training_common`'s tolerances: loss and
  gradient norm within 2e-4 relative, the gradient leaves within 2e-4 of
  their max plus 1e-7, the update within 1e-6 of JAX's clip and AdamW of
  the ranks' own gradient, the parameters within 1e-4 of JAX's own step.
  Every rank ends with the same whole parameters, bit for bit; its state
  bytes and its wire bytes by axis, kind and site (the choices' all-gathers
  in the forward and the remat recompute) equal the dry run's meta count of
  the same configuration exactly.
- serving, one group: a prefill of 16 tokens and 3 decode steps on (2, 1)
  (B = 4) and (2, 2) (B = 2): each rank's logits rows within 2e-4 of
  max|logit| of JAX's one-device `prefill` and `decode_step`; `ServeEngine`
  completions equal the one-device port engine's; parameter, cache and
  wire bytes equal the dry run's.
- the drops: the MoE layer alone on 32 tokens in one group over 2 ranks.
  In numpy, at least one choice is kept or dropped otherwise by the whole
  group (capacity 20) than by a dispatch of a rank's 16 tokens alone
  (capacity 10); the ranks' output rows match JAX's one-device layer on the
  whole group, and differ from JAX's layer on each half alone by far more
  than the tolerance, so a port that dispatched its rows alone would fail.
The span's rank order, the batch-shard order, is pinned on a ("pod",
"data", "model") meta mesh.
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

import repro_torch.configs as C
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models.layers import moe as jmoe
from repro.models.model_zoo import build_model as jbuild
from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import dryrun as dr
from repro_torch.models import build_model
from repro_torch.models.layers.moe import DataSplit, data_split, dispatch_shape
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import Mesh
from repro_torch.serving import SamplerConfig, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_moe_span_cases.py"
SUBPROCESS_TIMEOUT_S = 400
LOGIT_REL = 2e-4
PROMPT = 16
DROPS_SEED = 3

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_fsdp_cases as fcases
    import torch_moe_span_cases as cases
    from torch_training_common import (
        GRAD_ABS,
        GRAD_REL,
        PARAM_REL,
        STEP_RTOL,
        UPDATE_REL,
        _jax_grads,
        assert_tree_close,
        flat,
        np_batch,
        np_params,
        to_jax,
    )
finally:
    sys.path.remove(str(MULTIDEV))


def jcfg_for(arch: str, overrides=None):
    """The JAX package's reduced config, its MoE config replaced by the
    overrides."""
    jcfg = jreduced(jget(arch))
    if overrides:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **overrides))
    return jcfg


def _batch(name: str, step: int) -> dict:
    _, arch, _, _, B, overrides = cases.CASES[name]
    return np_batch(jcfg_for(arch, overrides),
                    700 + 10 * step + sorted(cases.CASES).index(name), batch=B)


def exact_clip(grads: dict, max_norm: float) -> dict:
    """JAX's `clip_by_global_norm` rule at the norm of `grads` taken in f64."""
    norm = np.float32(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))
    scale = np.minimum(np.float32(1.0), np.float32(max_norm) / np.maximum(norm, np.float32(1e-12)))
    return {k: (g.astype(np.float32) * scale).astype(g.dtype) for k, g in grads.items()}


class _Jax:
    """JAX's one-device train step, its gradient jitted once per (arch, MoE
    overrides, accum): the one-group cases on three meshes share one."""

    def __init__(self):
        self.cfg = JOptConfig(lr=cases.tp.LR, warmup_steps=cases.tp.WARMUP)
        self.adamw = jax.jit(lambda params, opt, step, grads: j_adamw_update(
            params, grads, opt, step, self.cfg))
        self.clip = jax.jit(lambda g: j_clip_by_global_norm(g, self.cfg.grad_clip))
        self._grads = functools.lru_cache(None)(
            lambda arch, overrides, accum: _jax_grads(jcfg_for(arch, dict(overrides)), accum))

    def grads(self, name: str):
        _, arch, accum, _, _, overrides = cases.CASES[name]
        return self._grads(arch, tuple(sorted((overrides or {}).items())), accum)

    def step(self, name: str, params, opt, step: int, batch: dict) -> dict:
        loss, g = self.grads(name)(params, to_jax(batch))
        clipped, norm = self.clip(g)
        p, o = self.adamw(params, opt, jnp.asarray(step, jnp.int32), clipped)
        return {"loss": float(loss), "grad_norm": float(norm), "g": g, "p": p, "o": o}


def _state(npz, s: int):
    def tree(prefix):
        return fcases._nest({k[len(prefix):]: jnp.asarray(npz[k]) for k in npz.files
                             if k.startswith(prefix)})
    return tree(f"s{s}/p/"), {"m": tree(f"s{s}/m/"), "v": tree(f"s{s}/v/")}


def _jax_serve(arch: str, overrides, P: dict, toks: dict) -> list:
    """JAX's one-device prefill and decode steps: the logits of each."""
    jm, jP = jbuild(jcfg_for(arch, overrides)), jax.tree.map(jnp.asarray, P)
    logits, jc = jm.prefill(jP, {"tokens": jnp.asarray(toks["prompts"])},
                            max_len=cases.serve.MAX_LEN)
    out = [np.asarray(logits, np.float32)]
    for s in range(cases.serve.STEPS):
        logits, jc = jm.decode_step(jP, jc, jnp.asarray(toks["steps"][s]), jnp.int32(PROMPT + s))
        out.append(np.asarray(logits, np.float32))
    return out


def _one_device_engine(cfg, P, prompts, temperature: float) -> list:
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    engine = ServeEngine(model, cases.serve.MAX_LEN, len(prompts), SamplerConfig(
        temperature=temperature, max_new_tokens=cases.serve.NEW_TOKENS, seed=5), device="cpu")
    return engine.generate(prompts)


def _drops_inputs() -> dict:
    """The drops case's layer input x [B, S, d] and layer parameters (the
    JAX init's spreads), drawn with numpy."""
    cfg = cases.case_cfg(*cases.DROPS_CFG)
    rng = np.random.default_rng(DROPS_SEED)
    d, E, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    B, S = cases.DROPS_SHAPE
    return {"x": rng.standard_normal((B, S, d)).astype(np.float32),
            "router": (rng.standard_normal((d, E)) * d**-0.5).astype(np.float32),
            "w_in": (rng.standard_normal((E, d, 2, ff)) * d**-0.5).astype(np.float32),
            "w_out": (rng.standard_normal((E, ff, d)) * ff**-0.5).astype(np.float32)}


def _jax_moe(x: np.ndarray, inputs: dict) -> np.ndarray:
    """JAX's one-device MoE layer on x as one dispatch group."""
    jcfg = jcfg_for(*cases.DROPS_CFG)
    params = {k: jnp.asarray(inputs[k]) for k in ("router", "w_in", "w_out")}
    return np.asarray(jmoe.moe_forward(params, jcfg, jnp.asarray(x)), np.float32)


def _start(mode: str, in_dir: Path, out: Path, env: dict) -> subprocess.Popen:
    out.mkdir(exist_ok=True)
    return subprocess.Popen([sys.executable, str(SCRIPT), mode, str(in_dir), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the three meshes' runs; meanwhile JAX's step 0, its serving
    references, the one-device port engines and JAX's MoE layer on the
    drops case; then JAX's later steps from the ranks' states.  Returns
    (JAX's steps by case, JAX's serving logits and the one-device engines'
    completions by case, JAX's drops layer outputs, the output root, the
    jitted JAX step, each mesh's rank facts)."""
    root = tmp_path_factory.mktemp("span")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for name, (_, arch, _, _, _, overrides) in cases.CASES.items():
        params[name] = np_params(jcfg_for(arch, overrides), 23)
        np.savez(in_dir / f"params_{name}.npz", **fcases._flat(params[name]))
        for s in range(cases.STEPS):
            np.savez(in_dir / f"batch_{name}_{s}.npz", **_batch(name, s))
    serve_p, toks = {}, {}
    for i, (name, (_, arch, B, overrides)) in enumerate(sorted(cases.SERVE.items())):
        serve_p.setdefault(arch, np_params(jcfg_for(arch), 29))
        rng = np.random.default_rng(50 + i)
        V = jcfg_for(arch).vocab
        toks[name] = {"prompts": rng.integers(0, V, (B, PROMPT)).astype(np.int32),
                      "steps": rng.integers(0, V, (cases.serve.STEPS, B)).astype(np.int32)}
        np.savez(in_dir / cases.serve.tokens_file(arch, B), **toks[name])
    for arch, P in serve_p.items():
        np.savez(in_dir / f"params_{arch}.npz", **fcases._flat(P))
    drops = _drops_inputs()
    np.savez(in_dir / "drops.npz", **drops)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {mode: _start(mode, in_dir, root / mode, env) for mode in cases.MESHES}
    jx = _Jax()
    want, served, logs = {}, {}, {}
    try:
        for name in cases.CASES:  # step 0, while the ranks run
            P = to_jax(params[name])
            zeros = jax.tree.map(jnp.zeros_like, P)
            want[name] = [jx.step(name, P, {"m": zeros, "v": zeros}, 0, _batch(name, 0))]
        for name, (_, arch, _, overrides) in cases.SERVE.items():
            cfg = cases.case_cfg(arch, overrides)
            prompts = toks[name]["prompts"].tolist()
            served[name] = {"logits": _jax_serve(arch, overrides, serve_p[arch], toks[name]),
                            "engines": {mode: _one_device_engine(cfg, serve_p[arch], prompts, t)
                                        for mode, t in (("greedy", 0.0),
                                                        ("temperature",
                                                         cases.serve.TEMPERATURE))}}
        half = cases.DROPS_SHAPE[0] // 2
        layer = {"whole": _jax_moe(drops["x"], drops),
                 "halves": np.concatenate([_jax_moe(drops["x"][:half], drops),
                                           _jax_moe(drops["x"][half:], drops)])}
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0] for k, p in procs.items()}
        for k, p in procs.items():
            assert p.returncode == 0, f"{k} failed:\n{logs.get(k, '')[-4000:]}"
        for name, case in cases.CASES.items():
            npz = np.load(root / cases.tp.label(case[0]) / f"{name}.npz")
            for s in range(1, cases.STEPS):
                P, opt = _state(npz, s)
                want[name].append(jx.step(name, P, opt, s, _batch(name, s)))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    facts = {}
    for mode in cases.MESHES:
        D, M = (int(x) for x in mode.split("x"))
        facts[mode] = [json.loads((root / mode / f"rank{r}.json").read_text())
                       for r in range(D * M)]
    return want, served, layer, root, jx, facts


def _facts(runs, kind: str, name: str) -> list:
    *_, facts = runs
    mesh = (cases.CASES if kind == "cases" else cases.SERVE)[name][0]
    return [f[kind][name] for f in facts[cases.tp.label(mesh)]]


# --------------------------------------------------------------------------
# Training against JAX's one-device step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(cases.CASES))
def test_span_step_matches_the_jax_one_device_step(runs, name):
    want, _, _, root, jx, _ = runs
    mesh = cases.CASES[name][0]
    npz = np.load(root / cases.tp.label(mesh) / f"{name}.npz")
    for s in range(cases.STEPS):
        w = want[name][s]
        np.testing.assert_allclose(float(npz[f"s{s}/loss"]), w["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(float(npz[f"s{s}/grad_norm"]), w["grad_norm"], rtol=STEP_RTOL)
        gp = {k[len(f"s{s}/g/"):]: npz[k] for k in npz.files if k.startswith(f"s{s}/g/")}
        assert_tree_close(gp, flat(w["g"]), GRAD_REL, GRAD_ABS)
        P, opt = _state(npz, s)
        clipped = fcases._nest({k: jnp.asarray(v) for k, v in
                                exact_clip(gp, jx.cfg.grad_clip).items()})
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
            assert np.abs(got_p[key] - x).max() <= PARAM_REL * np.abs(x).max(), key


@pytest.mark.parametrize("name", list(cases.CASES))
def test_the_ranks_of_a_span_end_bit_alike(runs, name):
    """Every rank's whole parameters after the last step are rank 0's bits,
    and each step all-gathered the choices on every rank."""
    ranks = _facts(runs, "cases", name)
    assert all(f["digest"] == ranks[0]["digest"] for f in ranks)
    for f in ranks:
        assert all(site["moe-choices"]["calls"] > 0 for site in f["sites"])


@pytest.mark.parametrize("name", [n for n, c in cases.CASES.items() if c[1] == cases.QWEN3_MOE])
def test_the_dry_runs_rank_counts_the_span_ranks_bytes(runs, name):
    """`lower_cell` of the case's configuration (B = 4, S = 16, its accum,
    f32 AdamW) on its mesh: the rank's parameter and moment bytes equal
    every real rank's, and its wire bytes by axis and kind, and the
    choices' site, equal each real rank's step (`fsdp.WIRE`).  The qwen3-moe
    cases: every mesh, accum and dispatch (jamba's meta count loops over
    the scan's steps; llama4's MoE layer runs the same code at top-1)."""
    mesh, arch, accum, _, B, overrides = cases.CASES[name]
    shape = dataclasses.replace(C.SHAPES["train_4k"], seq_len=16, global_batch=B)
    with mock.patch.dict(C.SHAPES, {"train_4k": shape}), \
            mock.patch.dict(C.ARCHS, {"spancell": cases.case_cfg(arch, overrides)}):
        rec, _ = dr.lower_cell("spancell", "train_4k", Mesh(mesh, ("data", "model")),
                               accum=accum)
    assert rec["ok"]
    parts = rec["memory"]["port_rank_parts"]
    by_axis, site = rec["hlo"]["collective_by_axis"], rec["hlo"]["collective_by_site"]
    for f in _facts(runs, "cases", name):
        assert parts["params"] + parts["opt"] == f["state_bytes"]
        for wire, seen in zip(f["wire"], f["sites"]):
            assert wire == by_axis
            assert {k: {"bytes": v["bytes"], "calls": v["calls"]} for k, v in seen.items()} == site


def test_the_choices_gather_is_the_ranks_tokens_choices_a_layer_a_pass(runs):
    """g1_4x1: one group on 4 ranks, one row of 16 tokens a rank, top-2:
    each MoE layer's forward and remat recompute all-gather 4 x 16 x 2
    int64, of which a rank receives 3 / 4 (the ring's share)."""
    mesh, arch, _, _, B, overrides = cases.CASES["g1_4x1"]
    cfg = cases.case_cfg(arch, overrides)
    moe_layers = cfg.n_groups * sum(s.ffn == "moe" for s in cfg.pattern)
    for f in _facts(runs, "cases", "g1_4x1"):
        for seen in f["sites"]:
            assert seen["moe-choices"]["calls"] == 2 * moe_layers
            assert seen["moe-choices"]["bytes"] == 2 * moe_layers * (
                4 * 16 * cfg.moe.top_k * 8) * 3 / 4


# --------------------------------------------------------------------------
# Serving against JAX's one-device prefill and decode steps
# --------------------------------------------------------------------------

def _serve_ranks():
    return [(n, r) for n, c in cases.SERVE.items() for r in range(c[0][0] * c[0][1])]


@pytest.mark.parametrize("name, rank", _serve_ranks())
def test_span_serving_matches_the_jax_one_device_prefill_and_decode(runs, name, rank):
    _, served, _, root, _, _ = runs
    mesh = cases.SERVE[name][0]
    got = np.load(root / cases.tp.label(mesh) / f"{name}_rank{rank}.npz")
    r0, r1 = got["rows"]
    for i, w in enumerate(served[name]["logits"]):
        w = w[r0:r1]
        assert np.abs(got[f"l{i}"] - w).max() <= LOGIT_REL * np.abs(w).max(), (name, rank, i)


@pytest.mark.parametrize("name", list(cases.SERVE))
def test_span_engine_completions_are_the_one_device_engines(runs, name):
    _, served, *_ = runs
    for f in _facts(runs, "serve", name):
        for mode, want in served[name]["engines"].items():
            assert f["engine"][mode]["completions"] == want, mode
        assert f["choices_prefill"]["moe-choices"]["calls"] > 0


@pytest.mark.parametrize("name", list(cases.SERVE))
def test_the_dry_runs_serving_rank_counts_the_span_ranks_bytes(runs, name):
    """`lower_cell`'s prefill cell at the prompt's length and decode cell at
    max_len: the rank's parameter, largest gather and cache bytes equal
    every real rank's, its wire by axis and kind those of the prefill and
    of each decode step, and its choices' site the prefill's."""
    mesh, arch, B, overrides = cases.SERVE[name]
    shapes = {"prefill_32k": dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=PROMPT,
                                                 global_batch=B),
              "decode_32k": dataclasses.replace(C.SHAPES["decode_32k"],
                                                seq_len=cases.serve.MAX_LEN, global_batch=B)}
    with mock.patch.dict(C.SHAPES, shapes), \
            mock.patch.dict(C.ARCHS, {"spanserve": cases.case_cfg(arch, overrides)}):
        pre, _ = dr.lower_cell("spanserve", "prefill_32k", Mesh(mesh, ("data", "model")))
        dec, _ = dr.lower_cell("spanserve", "decode_32k", Mesh(mesh, ("data", "model")))
    assert pre["ok"] and dec["ok"]
    site = pre["hlo"]["collective_by_site"]["moe-choices"]
    assert dec["hlo"]["collective_by_site"]["moe-choices"]["calls"] == site["calls"] > 0
    for f in _facts(runs, "serve", name):
        for rec in (pre, dec):
            parts = rec["memory"]["port_rank_parts"]
            assert parts["params"] == f["param_bytes"]
            assert parts["gathered"] == f["largest_gather"]
        assert dec["memory"]["port_rank_parts"]["caches"] == f["cache_bytes"]
        assert pre["hlo"]["collective_by_axis"] == f["wire_prefill"]
        assert all(dec["hlo"]["collective_by_axis"] == w for w in f["wire_steps"])
        assert {k: v["bytes"] for k, v in f["choices_prefill"].items()} == {
            "moe-choices": site["bytes"]}


# --------------------------------------------------------------------------
# The drops, and the span's order
# --------------------------------------------------------------------------

def _np_keep(x: np.ndarray, router: np.ndarray, K: int, cap: int) -> np.ndarray:
    """keep [T, K] of one group of tokens x [T, d] under the sort dispatch:
    a choice's rank is its place among the group's choices of its expert in
    (token, k) order, kept below `cap`; top-k by a stable descending sort
    of the f32 softmax, ties to the lower expert."""
    logits = x.astype(np.float32) @ router
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    top = np.argsort(-p, axis=-1, kind="stable")[:, :K]
    seen: dict = {}
    keep = np.zeros(top.shape, bool)
    for t in range(top.shape[0]):
        for k in range(K):
            e = int(top[t, k])
            keep[t, k] = seen.get(e, 0) < cap
            seen[e] = seen.get(e, 0) + 1
    return keep


def test_a_local_dispatch_would_drop_otherwise_and_the_span_does_not(runs):
    """The drops case: one group of 32 tokens on 2 ranks.  In numpy, the
    whole group (capacity 20) and a dispatch of each rank's 16 tokens alone
    (capacity 10) keep different choices; the chip check's count of them
    (`chip_smoke.SpanDrops`, around each rank's call) finds the same.  The ranks' output rows are JAX's layer on the whole
    group, and JAX's layer on each half alone is far from it at the tokens
    whose choices differ: a port that dispatched its rows alone would
    fail."""
    _, _, layer, root, _, _ = runs
    cfg = cases.case_cfg(*cases.DROPS_CFG)
    inputs = _drops_inputs()
    B, S = cases.DROPS_SHAPE
    K = cfg.moe.top_k
    x = inputs["x"].reshape(B * S, -1)
    G, T, cap = dispatch_shape(cfg, B, S)
    G_half, T_half, cap_half = dispatch_shape(cfg, B // 2, S)
    assert (G, T, cap, T_half, cap_half) == (1, 32, 20, 16, 10)
    whole = _np_keep(x, inputs["router"], K, cap)
    alone = np.concatenate([_np_keep(x[:T_half], inputs["router"], K, cap_half),
                            _np_keep(x[T_half:], inputs["router"], K, cap_half)])
    differ = whole != alone
    assert differ.any()
    got = np.concatenate([np.load(root / "2x1" / f"drops_rank{r}.npz")["out"] for r in range(2)])
    scale = np.abs(layer["whole"]).max()
    assert np.abs(got - layer["whole"]).max() <= LOGIT_REL * scale
    tokens = differ.any(-1).reshape(B, S)
    assert np.abs(layer["halves"] - layer["whole"])[tokens].max() > 100 * LOGIT_REL * scale
    for r in range(2):
        choices, dropped, local_differ, dispatches = np.load(
            root / "2x1" / f"drops_rank{r}.npz")["drops"]
        mine = slice(r * T_half, (r + 1) * T_half)
        assert (choices, dispatches) == (T_half * K, 1)
        assert dropped == (~whole[mine]).sum()
        assert local_differ == differ[mine].sum()


def test_the_span_is_consecutive_batch_shards_pod_major():
    """On a (pod 2, data 4, model 2) mesh (ranks row-major) the batch shards
    run pod-major (`rank_rows`): rank (p, d, m) takes shard 4 p + d.  A span
    of 2 is two consecutive shards at one place along "model", so it never
    pairs ranks of two pods or two model places; a span of 8 runs over both
    pods.  `data_split` gives every rank its shard and R."""
    mesh = Mesh((2, 4, 2), ("pod", "data", "model"))
    assert fsdp.span_ranks(mesh, 2) == [[0, 2], [4, 6], [8, 10], [12, 14],
                                        [1, 3], [5, 7], [9, 11], [13, 15]]
    assert fsdp.span_ranks(mesh, 8) == [[0, 2, 4, 6, 8, 10, 12, 14],
                                        [1, 3, 5, 7, 9, 11, 13, 15]]
    cfg = cases.case_cfg(cases.QWEN3_MOE)  # 2 groups
    for rank in range(mesh.size):
        p, d = divmod(rank // 2, 4)
        assert data_split(cfg, 8, 16, mesh, rank) == DataSplit(8, 4 * p + d, None)
    with pytest.raises(ValueError, match="does not divide"):
        fsdp.span_ranks(mesh, 3)
