"""The port's training state sharded over "data" on gloo CPU ranks, for
`tests/test_torch_fsdp.py`.

    python tests/multidev/torch_fsdp_cases.py R IN_DIR OUT_DIR
    python tests/multidev/torch_fsdp_cases.py layouts IN_DIR OUT_DIR

`R` spawns R ranks.  For each case of `CASES` with R ranks, every rank
loads the starting parameters (IN_DIR/params_<case>.npz, the JAX tree's
leaves flattened with "/" keys) and each step's global batch
(IN_DIR/batch_<case>_<step>.npz), builds the one-card state, shards it by
`make_rules` on the (R, 1) ("data", "model") mesh
(`repro_torch.parallel.fsdp.shard_train_state`) and runs STEPS steps
(`make_train_step(group=...)`) on its own trajectory; before each step it
also takes the step's pre-compression gradient (`accumulate_grads`).  Rank
0 writes OUT_DIR/<case>.npz: per step the whole state the step started
from ("s<i>/p/...", "s<i>/m/...", "s<i>/v/..."), the whole gradient
("s<i>/g/..."), loss and grad_norm, and the final whole state
("final/...").  Each
rank writes OUT_DIR/<case>_rank<r>.npz: the final slices it holds, stacked
over the groups as the JAX tree stacks them ("p/...", "m/...", "v/...").
Every rank writes OUT_DIR/rank<r>.json: the sha256 of each case's final
whole (gathered) parameters and, with R = 2:

- `resume`: `run_training(rules=...)` with a failure injected before step
  6 against an uninterrupted run, both on the two ranks (reduced qwen3-8b,
  one group, 12 steps, checkpoints every 4);
- `layouts`: the one-card checkpoint IN_DIR/ckpt_one restored into a
  sharded state and saved again into OUT_DIR/ckpt_fsdp2.

`layouts` spawns 4 ranks, which restore OUT_DIR/ckpt_fsdp2 (written by the
R = 2 run into the same OUT_DIR/../r2) and IN_DIR/ckpt_one into sharded
states and save them into OUT_DIR/ckpt_fsdp2_fsdp4 and
OUT_DIR/ckpt_one_fsdp4.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

STEPS = 2
RANK_TIMEOUT_S = 200  # all ranks together
# name -> (ranks, arch, accum, compress bits, global batch, d_model or None
# for the reduced config's 64)
CASES = {
    "qwen3_plain": (2, "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2": (2, "qwen3-8b", 2, None, 4, None),
    "qwen3_compress8": (2, "qwen3-8b", 1, 8, 4, None),
    "moe_plain": (2, "qwen3-moe-235b-a22b", 1, None, 4, None),
    "moe_accum2": (2, "qwen3-moe-235b-a22b", 2, None, 4, None),
    "moe_compress8": (2, "qwen3-moe-235b-a22b", 1, 8, 4, None),
    "mamba_plain": (2, "falcon-mamba-7b", 1, None, 4, None),
    "mamba_accum2": (2, "falcon-mamba-7b", 2, None, 4, None),
    "mamba_compress8": (2, "falcon-mamba-7b", 1, 8, 4, None),
    "gemma2_tied": (2, "gemma2-9b", 1, None, 4, None),  # one gathered embed, two uses
    "hubert_frames": (2, "hubert-xlarge", 1, None, 4, None),  # the embed unused
    "qwen3_plain_4ranks": (4, "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2_4ranks": (4, "qwen3-8b", 2, None, 4, None),
    # every fsdp template names d_model: 66 is split by 2 ranks, not by 4
    "qwen3_d66_4ranks": (4, "qwen3-8b", 1, None, 4, 66),
}
LR, WARMUP = 1e-3, 2
LAYOUT_ARCH = "qwen3-8b"  # the checkpoints' config: reduced, one group


def case_cfg(arch: str, d_model=None):
    """The port's reduced config of a case (`d_model` replaced if given)."""
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(arch))
    return cfg if d_model is None else dataclasses.replace(cfg, d_model=d_model)


def layout_cfg():
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(LAYOUT_ARCH), groups=1)


def _flat(tree: dict, prefix: str = "") -> dict:
    """{"a/b": a copy of leaf} of a nested dict."""
    out = {}
    for k, x in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(x, key) if isinstance(x, dict) else {key: np.array(x)})
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, x in flat.items():
        *parents, last = key.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _cases(world: int) -> dict:
    return {k: c for k, c in CASES.items() if c[0] == world}


def whole_state(state) -> dict:
    """The state's parameters and moments, whole on every rank, as numpy
    arrays keyed "p/<leaf>", "<part>/<leaf>" (JAX tree paths)."""
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.models.transformer import param_leaves
    from repro_torch.parallel import fsdp

    model = state.params
    sharding = model.fsdp
    named = dict(model.named_parameters())
    out = {f"p/{k}": v for k, v in _flat(lm_params_to_numpy(
        model.cfg, fsdp.whole_named(sharding, named))).items()}
    names = param_leaves(named)
    for part, leaves in state.opt.items():
        for key, t in leaves.items():
            if sharding is not None:
                t = sharding.whole(t, *fsdp.opt_leaf_shard(sharding, names[key], part))
            out[f"{part}/{key}"] = t.float().numpy().copy()
    return out


def rank_slices(state) -> dict:
    """The tensors the rank holds, as numpy, keyed as `whole_state` keys the
    whole leaves (a per-group parameter's slices stacked over the groups)."""
    from repro_torch.interop import lm_params_to_numpy

    out = {f"p/{k}": v for k, v in _flat(lm_params_to_numpy(state.params.cfg,
                                                            state.params)).items()}
    for part, leaves in state.opt.items():
        out.update({f"{part}/{k}": t.float().numpy().copy() for k, t in leaves.items()})
    return out


def _rules(group, cfg):
    import torch.distributed as dist

    from repro_torch.parallel.sharding import Mesh, make_rules

    return make_rules(Mesh((dist.get_world_size(group), 1), ("data", "model")), model_cfg=cfg)


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int) -> str:
    import torch

    from repro_torch.interop import lm_params_to_numpy, train_state_from_numpy
    from repro_torch.parallel import fsdp
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.train_step import accumulate_grads

    _, arch, accum, bits, _, d_model = case
    cfg = case_cfg(arch, d_model)
    P = _nest(dict(np.load(in_dir / f"params_{name}.npz")))
    zeros = {part: _nest({k: np.zeros_like(v) for k, v in _flat(P).items()})
             for part in ("m", "v")}
    state = train_state_from_numpy(cfg, P, zeros, 0, device="cpu")
    fsdp.shard_train_state(state, _rules(group, cfg), group=group)
    sharding = state.params.fsdp
    step = make_train_step(state.params, OptConfig(lr=LR, warmup_steps=WARMUP), accum=accum,
                           compress_bits=bits, group=group)
    out = {}
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in np.load(in_dir / f"batch_{name}_{s}.npz").items()}
        out.update({f"s{s}/{k}": v for k, v in whole_state(state).items()})
        _, g = accumulate_grads(state.params, batch, accum=accum, group=group)
        out.update({f"s{s}/g/{k}": v for k, v in _flat(lm_params_to_numpy(
            cfg, fsdp.whole_named(sharding, g))).items()})
        state, m = step(state, batch)
        out[f"s{s}/loss"] = np.float32(m["loss"].item())
        out[f"s{s}/grad_norm"] = np.float32(m["grad_norm"].item())
    final = whole_state(state)
    out.update({f"final/{k}": v for k, v in final.items()})
    np.savez(out_dir / f"{name}_rank{rank}.npz", **rank_slices(state))
    if rank == 0:
        np.savez(out_dir / f"{name}.npz", **out)
    return _digest({k: v for k, v in final.items() if k.startswith("p/")})


def _resume(out_dir: Path, group) -> dict:
    """Crash and resume on the group's sharded ranks against an
    uninterrupted run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.runtime import RunConfig, run_training
    from repro_torch.training import OptConfig

    runs = {}
    for run, fail_at in (("clean", None), ("crash", 6)):
        fired = []

        def injector(step, fail_at=fail_at, fired=fired):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        m = build_model(layout_cfg(), device="cpu")
        runs[run] = run_training(
            m, DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4),
            OptConfig(lr=1e-3, warmup_steps=1),
            RunConfig(total_steps=12, ckpt_every=4, log_every=100, metrics=[]),
            Checkpointer(str(out_dir / f"resume_{run}")), fail_injector=injector, group=group,
            rules=_rules(group, m.cfg))
    wholes = {r: whole_state(runs[r]["final_state"]) for r in runs}
    return {"restarts": [runs["clean"]["restarts"], runs["crash"]["restarts"]],
            "sharded": runs["crash"]["final_state"].params.fsdp is not None,
            "state_bit_identical": all(np.array_equal(wholes["clean"][k], wholes["crash"][k])
                                       for k in wholes["clean"]),
            "losses": {r: {m["step"]: m["loss"] for m in runs[r]["metrics"]} for r in runs},
            "latest": Checkpointer(str(out_dir / "resume_crash")).latest_step(),
            "digest": _digest(wholes["crash"])}


def _restore_and_save(src: Path, dst: Path, group, out_dir: Path, tag: str, rank: int) -> None:
    """The checkpoint in `src` restored into a sharded state of the layout
    config and saved into `dst`; the rank's slices into OUT_DIR."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state

    cfg = layout_cfg()
    state = init_train_state(build_model(cfg, device="cpu", seed=3),
                             torch.Generator().manual_seed(3), OptConfig(),
                             rules=_rules(group, cfg), group=group)
    state = Checkpointer(str(src), async_writes=False).restore(state)
    np.savez(out_dir / f"{tag}_rank{rank}.npz", **rank_slices(state),
             sharded=np.array(state.params.fsdp is not None))
    Checkpointer(str(dst), async_writes=False).save(int(state.step), state)


def _rank_main(rank: int, world: int, mode: str, in_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous_{mode}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        if mode == "layouts":
            src = out_dir.parent / "r2"
            _restore_and_save(src / "ckpt_fsdp2", out_dir / "ckpt_fsdp2_fsdp4", group, out_dir,
                              "fsdp2_fsdp4", rank)
            _restore_and_save(in_dir / "ckpt_one", out_dir / "ckpt_one_fsdp4", group, out_dir,
                              "one_fsdp4", rank)
            return
        facts = {"digests": {name: _run_case(name, case, in_dir, out_dir, group, rank)
                             for name, case in _cases(world).items()}}
        if world == 2:
            facts["resume"] = _resume(out_dir, group)
            _restore_and_save(in_dir / "ckpt_one", out_dir / "ckpt_fsdp2", group, out_dir,
                              "one_fsdp2", rank)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def run(mode: str, in_dir: str, out_dir: str) -> None:
    import multiprocessing as mp

    world = 4 if mode == "layouts" else int(mode)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, mode, in_dir, out_dir))
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if hung or failed:
        raise SystemExit(f"ranks {failed} failed (of which {hung} hung past {RANK_TIMEOUT_S} s)")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    run(sys.argv[1], sys.argv[2], sys.argv[3])
