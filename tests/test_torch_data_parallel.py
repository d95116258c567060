"""The port's data-parallel training (`make_train_step(group=...)`,
`run_training(group=...)`, `launch.train` under a torchrun environment)
against the JAX package's one-device train step on the global batch, on
gloo CPU ranks.

`tests/multidev/torch_dp_cases.py` runs 2 and 4 ranks (one subprocess each,
with a time limit) on `CASES`: reduced qwen3-8b and qwen3-moe-235b-a22b,
plain, accum = 2, a loss mask whose count differs between the ranks, 8-bit
compression, and a global batch of 3 that two ranks do not divide (every
rank takes every row); qwen3-8b also on 4 ranks (one row a rank, and
accum = 2, whose micro-batches of 2 rows every rank takes whole).  The ranks run their own
two-step trajectory; this file runs JAX's train step from each state the
ranks started a step from (lockstep, as `test_torch_training.py::_lockstep`)
on the same global batch: JAX's gradient (`value_and_grad` of its
`loss_fn` with remat, `lax.scan` over micro-batches), its quantization, its
clipping and its AdamW.  Tolerances, f32, as the one-device tests':
- each step's loss and gradient norm within 2e-4 relative (STEP_RTOL);
- the pre-compression gradient, per leaf, within 2e-4 of the leaf's max
  |g_jax| plus 1e-7 (GRAD_REL, GRAD_ABS), before the update;
- with compression, an element whose quantized level differs moved by one
  level and lies within FLIP_LEVELS of that level's edge on both sides;
- the new parameters and moments within 1e-6 of each leaf's max
  (UPDATE_REL) of JAX's clip and AdamW applied to the ranks' own (quantized)
  gradient, and within 1e-4 (PARAM_REL) of JAX's own step but at flipped
  elements.
Every rank ends with the same parameters, bit for bit.  Crash and resume
on two ranks ends bit-identical to the uninterrupted two-rank run; four
ranks step reduced qwen3-moe (two dispatch groups, each on a span of two
ranks) as one rank does, within the step tolerances; a split whose groups
and ranks divide neither the other raises ValueError;
`launch.train.main` on two gloo ranks prints one `done:` line.
"""

from __future__ import annotations

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

from repro.training.optimizer import OptConfig as JOptConfig
from repro.training.optimizer import adamw_update as j_adamw_update
from repro.training.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro.training.train_step import _quantize_dequantize as j_qd

ROOT = Path(__file__).resolve().parents[1]
MULTIDEV = ROOT / "tests" / "multidev"
SCRIPT = MULTIDEV / "torch_dp_cases.py"
SUBPROCESS_TIMEOUT_S = 300

sys.path.insert(0, str(MULTIDEV))
try:
    import torch_dp_cases as cases
    from torch_training_common import (
        FLIP_LEVELS,
        GRAD_ABS,
        GRAD_REL,
        PARAM_REL,
        STEP_RTOL,
        UPDATE_REL,
        _cfgs,
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

assert FLIP_LEVELS > 0


def _jax_rest(jopt_cfg):
    """JAX's train step after its gradient, jitted: clip, then AdamW; with
    the norm."""
    def rest(params, opt, step, grads):
        grads, norm = j_clip_by_global_norm(grads, jopt_cfg.grad_clip)
        p, o = j_adamw_update(params, grads, opt, step, jopt_cfg)
        return p, o, norm

    return jax.jit(rest)


def _batch(name: str, step: int) -> dict:
    _, arch, _, _, B, mask = cases.CASES[name]
    out = np_batch(_cfgs(arch)[1], 300 + 10 * step + sorted(cases.CASES).index(name), batch=B)
    if mask == "uneven":
        out["loss_mask"] = cases.uneven_mask(B, out["labels"].shape[1], 7 + step)
    return out


class _Jax:
    """JAX's train step split at its compression, jitted once per (arch,
    accum) and batch structure."""

    def __init__(self):
        self.cfg = JOptConfig(lr=cases.LR, warmup_steps=cases.WARMUP)
        self.rest = _jax_rest(self.cfg)
        self.grads = functools.lru_cache(None)(lambda arch, accum: _jax_grads(_cfgs(arch)[0],
                                                                            accum))

    def step(self, name: str, params, opt, step: int, batch: dict) -> dict:
        _, arch, accum, bits, _, _ = cases.CASES[name]
        loss, g = self.grads(arch, accum)(params, to_jax(batch))
        sent = jax.tree.map(lambda x: j_qd(x, bits), g) if bits else g
        p, o, norm = self.rest(params, opt, jnp.asarray(step, jnp.int32), sent)
        return {"loss": float(loss), "grad_norm": float(norm), "g": g, "p": p, "o": o}


def _state(npz, s: int):
    """The (params, {"m", "v"}) trees a rank started step s from."""
    def tree(prefix):
        return cases._nest({k[len(prefix):]: jnp.asarray(npz[k]) for k in npz.files
                            if k.startswith(prefix)})
    return tree(f"s{s}/p/"), {"m": tree(f"s{s}/m/"), "v": tree(f"s{s}/v/")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 2- and 4-rank runs and the two launcher ranks; meanwhile
    takes JAX's step 0 (the ranks start from the drawn parameters); then
    JAX's later steps from the ranks' states.  Returns (JAX's results by
    case and step, the output directories, the launcher's logs, the jitted
    JAX step)."""
    root = tmp_path_factory.mktemp("dp")
    in_dir = root / "in"
    in_dir.mkdir()
    params = {}
    for arch in sorted({c[1] for c in cases.CASES.values()}):
        params[arch] = np_params(_cfgs(arch)[0], 11)
        np.savez(in_dir / f"params_{arch}.npz", **cases._flat(params[arch]))
    for name in cases.CASES:
        for s in range(cases.STEPS):
            np.savez(in_dir / f"batch_{name}_{s}.npz", **_batch(name, s))
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
            arch = cases.CASES[name][1]
            P = to_jax(params[arch])
            zeros = jax.tree.map(jnp.zeros_like, P)
            want[name] = [jx.step(name, P, {"m": zeros, "v": zeros}, 0, _batch(name, 0))]
        logs = {k: p.communicate(timeout=SUBPROCESS_TIMEOUT_S) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{str(logs.get(k, ''))[-4000:]}"
    for name, case in cases.CASES.items():
        npz = np.load(root / f"r{case[0]}" / f"{name}.npz")
        for s in range(1, cases.STEPS):
            P, opt = _state(npz, s)
            want[name].append(jx.step(name, P, opt, s, _batch(name, s)))
    return want, root, logs, jx


@pytest.mark.parametrize("name", list(cases.CASES))
def test_data_parallel_step_matches_the_jax_one_device_step(runs, name):
    want, root, _, jx = runs
    world, arch, accum, bits, _, _ = cases.CASES[name]
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
        # JAX's clip and AdamW on the ranks' own (quantized) gradient.
        P, opt = _state(npz, s)
        sent = cases._nest({k: jnp.asarray(np.asarray(j_qd(jnp.asarray(v), bits)) if bits else v)
                            for k, v in gp.items()})
        ap, ao, _ = jx.rest(P, opt, jnp.asarray(s, jnp.int32), sent)
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
    if bits:  # a handful of edge elements at most (0 to 2 on the CPU)
        assert flips_total <= 16, flips_total


def test_every_rank_ends_with_the_same_parameters(runs):
    _, root, _, _ = runs
    for world in (2, 4):
        facts = [json.loads((root / f"r{world}" / f"rank{r}.json").read_text())
                 for r in range(world)]
        assert all(f["digests"] == facts[0]["digests"] for f in facts)
        assert set(facts[0]["digests"]) == {n for n, c in cases.CASES.items() if c[0] == world}


def test_crash_and_resume_on_two_ranks_is_bit_identical(runs):
    _, root, _, _ = runs
    facts = [json.loads((root / "r2" / f"rank{r}.json").read_text())["resume"] for r in range(2)]
    for f in facts:
        assert f["restarts"] == [0, 1]
        assert f["params_bit_identical"]
        assert f["losses"]["crash"] == f["losses"]["clean"]
        assert f["latest"] == 12
    assert facts[0]["digest"] == facts[1]["digest"]
    losses = [facts[0]["losses"]["clean"][str(s)] for s in (1, 12)]
    assert losses[1] < losses[0]


def test_moe_groups_shared_by_two_ranks_step_as_one_rank(runs):
    """Reduced qwen3-moe makes two dispatch groups of a 4-row batch: on four
    ranks each group's rows lie on two, which dispatch it from their
    gathered choices.  Rank 0's losses, gradient norms, gradients and
    parameters after each step match the port's one-rank step on the same
    batches (STEP_RTOL, GRAD_REL, PARAM_REL)."""
    import torch

    from repro_torch.interop import lm_params_to_numpy, train_state_from_numpy
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.train_step import accumulate_grads

    _, root, _, _ = runs
    name = "moe_span_4ranks"
    _, arch, *_ = cases.CASES[name]
    cfg = _cfgs(arch)[1]
    npz = np.load(root / "r4" / f"{name}.npz")
    P = cases._nest(dict(np.load(root / "in" / f"params_{arch}.npz")))
    zeros = {part: cases._nest({k: np.zeros_like(v) for k, v in cases._flat(P).items()})
             for part in ("m", "v")}
    state = train_state_from_numpy(cfg, P, zeros, 0, device="cpu")
    step = make_train_step(state.params, OptConfig(lr=cases.LR, warmup_steps=cases.WARMUP))
    for s in range(cases.STEPS):
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in _batch(name, s).items()}
        _, g = accumulate_grads(state.params, batch)
        gp = {k[len(f"s{s}/g/"):]: npz[k] for k in npz.files if k.startswith(f"s{s}/g/")}
        assert_tree_close(gp, flat(lm_params_to_numpy(cfg, g)), GRAD_REL, GRAD_ABS)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(npz[f"s{s}/loss"]), m["loss"].item(), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(npz[f"s{s}/grad_norm"]), m["grad_norm"].item(),
                                   rtol=STEP_RTOL)
        nxt = f"s{s + 1}/p/" if s + 1 < cases.STEPS else "final/p/"
        got = {k[len(nxt):]: npz[k] for k in npz.files if k.startswith(nxt)}
        assert_tree_close(got, flat(lm_params_to_numpy(cfg, state.params)), PARAM_REL)


def test_moe_dispatch_split_error_says_neither_divides():
    """12 groups on 8 ranks: neither divides the other, so no rank can hold
    whole groups and no group lies on whole spans.  The error names G, R
    and why, and that no batch would split (8 x 3 tokens: G is 12 for
    every multiple of 8 rows).  A split that either divides passes, also
    where a batch's token count halves G (8 x 5: 40 tokens make one group,
    on all 8 ranks)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.layers.moe import check_dispatch_split, dispatch_shape

    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_dispatch_groups=12))
    check_dispatch_split(cfg, 4)  # R | G: 3 whole groups a rank
    check_dispatch_split(cfg, 24)  # G | R: each group on a span of 2
    assert dispatch_shape(cfg, 8, 5)[0] == 1
    check_dispatch_split(cfg, 8, rows=8, S=5)
    with pytest.raises(ValueError, match=r"G = 12 .* R = 8 .* neither divides the other"
                                         r".* no global batch of 12 tokens or more"):
        check_dispatch_split(cfg, 8)
    assert dispatch_shape(cfg, 8, 3)[0] == 12
    with pytest.raises(ValueError, match=r"8 x 3 tokens makes G = 12 .* R = 8 .* neither "
                                         r"divides .* no global batch"):
        check_dispatch_split(cfg, 8, rows=8, S=3)


def test_the_launcher_trains_on_two_gloo_ranks(runs):
    _, root, logs, _ = runs
    out0, err0 = logs["launch0"]
    out1, _ = logs["launch1"]
    done = [ln for ln in out0.splitlines() if ln.startswith("done: ")]
    assert len(done) == 1 and done[0].startswith("done: steps=3 loss=")
    assert np.isfinite(float(done[0].split("loss=")[1].split()[0]))
    assert "done:" not in out1  # rank 0 alone prints it
    assert "data-parallel: rank 0 of 2 (gloo)" in err0
    from repro_torch.checkpoint import Checkpointer

    assert Checkpointer(str(root / "launch")).latest_step() == 3
