"""Adafactor on the port's training state sharded over ("data", "model")
meshes by the JAX rules (`vr` and `vc` on the factored shapes' blocks,
`repro_torch.parallel.fsdp.opt_leaf_shard`), on gloo CPU ranks, for
`tests/test_torch_adafactor_sharded.py`.

    python tests/multidev/torch_adafactor_cases.py MESH IN_DIR OUT_DIR
    python tests/multidev/torch_adafactor_cases.py layouts IN_DIR OUT_DIR

MESH is "2x1", "1x2" or "2x2": it spawns D x M ranks, which run each case
of `CASES` on that mesh: every rank loads the starting parameters and
Adafactor state (IN_DIR/params_<case>.npz, IN_DIR/opt_<case>.npz: the JAX
tree's leaves flattened with "/" keys, "vr/..." and "vc/..."; the state in
the case's moment dtype) and each step's global batch
(IN_DIR/batch_<case>_<step>.npz), builds the one-card state
(`interop.train_state_from_numpy`), cuts it by `make_rules` on the mesh
(`fsdp.shard_train_state(..., mesh=...)`) and runs STEPS steps
(`make_train_step(group=...)`); before each step it also takes the step's
gradient (`accumulate_grads`).  Rank 0 writes OUT_DIR/<case>.npz: per step
the whole state the step started from ("s<i>/p/...", "s<i>/vr/...",
"s<i>/vc/..."), the whole gradient ("s<i>/g/..."), loss and grad_norm, and
the final whole state ("final/...").  Each rank writes
OUT_DIR/<case>_rank<r>.npz, the final blocks it holds ("p/...", "vr/...",
"vc/..."), and OUT_DIR/rank<r>.json: per case the sha256 of each leaf's
block after each step ("blocks", by step and key).  On 1x2 a rank also
writes `resume` (`run_training(rules=..., mesh=...)` with Adafactor and a
failure injected before step 6, against an uninterrupted run: reduced
falcon-mamba-7b, 12 steps, checkpoints every 4).  On 2x2 the one-card
checkpoint IN_DIR/ckpt_one (`LAYOUT_ARCH`, Adafactor) is restored into a
sharded state with the JAX rules' specs (`restore(shardings=...)`) and
saved again into OUT_DIR/ckpt_one_2x2.

`layouts` restores OUT_DIR/../2x2/ckpt_one_2x2 on 1x2 into
OUT_DIR/ckpt_2x2_1x2, with each rank's blocks.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch_tp_cases as tp
from torch_fsdp_cases import _digest, _flat, _nest, rank_slices, whole_state

STEPS = 2
RANK_TIMEOUT_S = 300  # all ranks of a spawn together
MESHES = ((2, 1), (1, 2), (2, 2))
# (short name, arch, moment dtype): falcon-mamba's 2 groups make its
# per-group vectors [G, d] matrices, whose vr is [G] and vc [d]
CONFIGS = (("qwen3", "qwen3-8b", "float32"), ("mamba", "falcon-mamba-7b", "float32"),
           ("moe_bf16", "qwen3-moe-235b-a22b", "bfloat16"))
# name -> (mesh, arch, moment dtype)
CASES = {f"{short}_{tp.label(mesh)}": (mesh, arch, mdt)
         for mesh in MESHES for short, arch, mdt in CONFIGS}
BATCH = 4
LR, WARMUP = 1e-3, 2
LAYOUT_ARCH = "falcon-mamba-7b"  # the checkpoints' and the resume's config: reduced
LAYOUT_STEP = 5


def opt_config(moment_dtype: str = "float32", lr: float = LR, warmup: int = WARMUP):
    from repro_torch.training import OptConfig

    return OptConfig(kind="adafactor", lr=lr, warmup_steps=warmup, moment_dtype=moment_dtype)


def layout_cfg():
    return tp.case_cfg(LAYOUT_ARCH)


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int) -> dict:
    """One case on this rank (module docstring)."""
    import torch

    from repro_torch.interop import lm_params_to_numpy, train_state_from_numpy
    from repro_torch.parallel import fsdp
    from repro_torch.training import make_train_step
    from repro_torch.training.train_step import accumulate_grads

    mesh, arch, mdt = case
    cfg = tp.case_cfg(arch)
    P = _nest(dict(np.load(in_dir / f"params_{name}.npz")))
    opt = _nest(dict(np.load(in_dir / f"opt_{name}.npz")))
    state = train_state_from_numpy(cfg, P, opt, 0, device="cpu")
    state.opt = {part: {k: t.to(getattr(torch, mdt)) for k, t in leaves.items()}
                 for part, leaves in state.opt.items()}
    fsdp.shard_train_state(state, tp._rules(mesh, cfg), group=group, mesh=tp._mesh(mesh))
    sharding = state.params.fsdp
    step = make_train_step(state.params, opt_config(mdt), group=group)
    out, facts = {}, {"blocks": []}
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in np.load(in_dir / f"batch_{name}_{s}.npz").items()}
        out.update({f"s{s}/{k}": v for k, v in whole_state(state).items()})
        _, g = accumulate_grads(state.params, batch, group=group)
        out.update({f"s{s}/g/{k}": v for k, v in _flat(lm_params_to_numpy(
            cfg, fsdp.whole_named(sharding, g))).items()})
        state, m = step(state, batch)
        facts["blocks"].append(tp._leaf_digests(state))
        out[f"s{s}/loss"] = np.float32(m["loss"].item())
        out[f"s{s}/grad_norm"] = np.float32(m["grad_norm"].item())
    out.update({f"final/{k}": v for k, v in whole_state(state).items()})
    np.savez(out_dir / f"{name}_rank{rank}.npz", **rank_slices(state))
    if rank == 0:
        np.savez(out_dir / f"{name}.npz", **out)
    return facts


def _resume(out_dir: Path, group) -> dict:
    """Crash and resume with Adafactor on the group's (1, 2) ranks against an
    uninterrupted run."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.runtime import RunConfig, run_training

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
            opt_config(warmup=1), RunConfig(total_steps=12, ckpt_every=4, log_every=100,
                                            metrics=[]),
            Checkpointer(str(out_dir / f"resume_{run}")), fail_injector=injector, group=group,
            rules=tp._rules((1, 2), m.cfg), mesh=tp._mesh((1, 2)))
    wholes = {r: whole_state(runs[r]["final_state"]) for r in runs}
    final = runs["crash"]["final_state"]
    return {"restarts": [runs["clean"]["restarts"], runs["crash"]["restarts"]],
            "model_parts": final.params.fsdp.model_parts if final.params.fsdp else 0,
            "parts": sorted(final.opt),
            "state_bit_identical": all(np.array_equal(wholes["clean"][k], wholes["crash"][k])
                                       for k in wholes["clean"]),
            "losses": {r: {m["step"]: m["loss"] for m in runs[r]["metrics"]} for r in runs},
            "latest": Checkpointer(str(out_dir / "resume_crash")).latest_step(),
            "digest": _digest(wholes["crash"])}


def _restore_and_save(src: Path, dst: Path, group, mesh, out_dir: Path, tag: str,
                      rank: int) -> None:
    """The Adafactor checkpoint in `src` restored into a state of the layout
    config sharded on `mesh`, checked against the JAX rules' specs, and
    saved into `dst`; the rank's blocks into OUT_DIR/<tag>_rank<r>.npz."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.specs import train_state_pspecs
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state

    cfg = layout_cfg()
    rules = tp._rules(mesh, cfg)
    state = init_train_state(build_model(cfg, device="cpu", seed=3),
                             torch.Generator().manual_seed(3), opt_config(), rules=rules,
                             group=group, mesh=tp._mesh(mesh))
    state = Checkpointer(str(src), async_writes=False).restore(
        state, shardings=train_state_pspecs(state.params, rules, "adafactor"))
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
            _restore_and_save(out_dir.parent / "2x2" / "ckpt_one_2x2", out_dir / "ckpt_2x2_1x2",
                              group, (1, 2), out_dir, "2x2_1x2", rank)
            return
        mesh = tuple(int(x) for x in mode.split("x"))
        facts = {"cases": {name: _run_case(name, case, in_dir, out_dir, group, rank)
                           for name, case in CASES.items() if case[0] == mesh}}
        if mesh == (1, 2):
            facts["resume"] = _resume(out_dir, group)
        if mesh == (2, 2):
            _restore_and_save(in_dir / "ckpt_one", out_dir / "ckpt_one_2x2", group, mesh,
                              out_dir, "one_2x2", rank)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def run(mode: str, in_dir: str, out_dir: str) -> None:
    import multiprocessing as mp

    world = 2 if mode == "layouts" else int(mode[0]) * int(mode[2])
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
        raise SystemExit(f"{mode}: ranks {failed} failed (of which {hung} hung past "
                         f"{RANK_TIMEOUT_S} s)")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    run(sys.argv[1], sys.argv[2], sys.argv[3])
