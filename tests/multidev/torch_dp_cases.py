"""The port's data-parallel train step on gloo CPU ranks, for
`tests/test_torch_data_parallel.py`.

    python tests/multidev/torch_dp_cases.py R IN_DIR OUT_DIR

Spawns R ranks.  For each case of `CASES` with R ranks, every rank loads
the starting parameters (IN_DIR/params_<arch>.npz, the JAX tree's leaves
flattened with "/" keys) and each step's global batch
(IN_DIR/batch_<case>_<step>.npz), builds the same state, and runs STEPS
data-parallel steps (`make_train_step(group=...)`) on its own trajectory;
before each step it also takes the step's pre-compression gradient
(`accumulate_grads(group=...)`).  Rank 0 writes OUT_DIR/<case>.npz: per
step the state the step started from ("s<i>/p/...", "s<i>/m/...",
"s<i>/v/..."), the gradient ("s<i>/g/..."), loss and grad_norm, and the
final parameters.  Every rank writes OUT_DIR/rank<r>.json: a digest of each
case's final parameters and, per R, the extra checks (`extras`):

- R = 2: `run_training` with a failure injected before step 6 against an
  uninterrupted run, both on the two ranks (reduced qwen3-8b, one group,
  12 steps, checkpoints every 4, rank 0 writing them);
- R = 4: none; its MoE case ("moe_span_4ranks": reduced qwen3-moe-235b-a22b,
  one row a rank) makes two dispatch groups, each on a span of two ranks.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

STEPS = 2
RANK_TIMEOUT_S = 200  # all ranks together
# name -> (ranks, arch, accum, compress bits, global batch, mask kind)
CASES = {
    "qwen3_plain": (2, "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2": (2, "qwen3-8b", 2, None, 4, None),
    "qwen3_uneven_mask": (2, "qwen3-8b", 1, None, 4, "uneven"),
    "qwen3_compress8": (2, "qwen3-8b", 1, 8, 4, None),
    "qwen3_replicated": (2, "qwen3-8b", 1, None, 3, None),
    "moe_plain": (2, "qwen3-moe-235b-a22b", 1, None, 4, None),
    "moe_accum2": (2, "qwen3-moe-235b-a22b", 2, None, 4, None),
    "moe_uneven_mask": (2, "qwen3-moe-235b-a22b", 1, None, 4, "uneven"),
    "moe_compress8": (2, "qwen3-moe-235b-a22b", 1, 8, 4, None),
    "moe_replicated": (2, "qwen3-moe-235b-a22b", 1, None, 3, None),
    "qwen3_plain_4ranks": (4, "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2_4ranks": (4, "qwen3-8b", 2, None, 4, None),  # 2-row micro-batches: replicated
    "moe_span_4ranks": (4, "qwen3-moe-235b-a22b", 1, None, 4, None),  # 2 groups, 2 ranks each
}
LR, WARMUP = 1e-3, 2


def uneven_mask(batch: int, seq: int, seed: int) -> np.ndarray:
    """A loss mask whose rows of the first half keep ~90% of their tokens
    and those of the second half ~20%: the ranks' counts differ."""
    rng = np.random.default_rng(seed)
    keep = np.where(np.arange(batch) < batch // 2, 0.9, 0.2)[:, None]
    return (rng.random((batch, seq)) < keep).astype(np.float32)


def _flat(tree: dict, prefix: str = "") -> dict:
    """{"a/b": a copy of leaf} of a nested dict (a CPU parameter's numpy view
    would follow the in-place updates)."""
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


def _digest(model) -> str:
    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _cases(world: int) -> dict:
    return {k: c for k, c in CASES.items() if c[0] == world}


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int) -> str:
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.interop import lm_params_to_numpy, train_state_from_numpy
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.train_step import accumulate_grads

    _, arch, accum, bits, _, _ = case
    cfg = reduced(get_config(arch))
    P = _nest(dict(np.load(in_dir / f"params_{arch}.npz")))
    zeros = {part: _nest({k: np.zeros_like(v) for k, v in _flat(P).items()})
             for part in ("m", "v")}  # arrays of their own: the state shares their memory
    state = train_state_from_numpy(cfg, P, zeros, 0, device="cpu")
    opt_cfg = OptConfig(lr=LR, warmup_steps=WARMUP)
    step = make_train_step(state.params, opt_cfg, accum=accum, compress_bits=bits, group=group)
    out = {}
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in np.load(in_dir / f"batch_{name}_{s}.npz").items()}
        out.update({f"s{s}/p/{k}": v for k, v in _flat(
            lm_params_to_numpy(cfg, state.params)).items()})
        for part, leaves in state.opt.items():
            out.update({f"s{s}/{part}/{k}": t.float().numpy().copy() for k, t in leaves.items()})
        _, g = accumulate_grads(state.params, batch, accum=accum, group=group)
        out.update({f"s{s}/g/{k}": v for k, v in _flat(lm_params_to_numpy(cfg, g)).items()})
        state, m = step(state, batch)
        out[f"s{s}/loss"] = np.float32(m["loss"].item())
        out[f"s{s}/grad_norm"] = np.float32(m["grad_norm"].item())
    out.update({f"final/p/{k}": v for k, v in _flat(lm_params_to_numpy(cfg, state.params)).items()})
    if rank == 0:
        np.savez(out_dir / f"{name}.npz", **out)
    return _digest(state.params)


def _resume(out_dir: Path, group) -> dict:
    """Crash and resume on the group's ranks against an uninterrupted run."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced
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

        m = build_model(reduced(get_config("qwen3-8b"), groups=1), device="cpu")
        runs[run] = run_training(
            m, DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4),
            OptConfig(lr=1e-3, warmup_steps=1),
            RunConfig(total_steps=12, ckpt_every=4, log_every=100, metrics=[]),
            Checkpointer(str(out_dir / f"resume_{run}")), fail_injector=injector, group=group)
    clean, crash = runs["clean"], runs["crash"]
    pairs = zip(clean["final_state"].params.parameters(), crash["final_state"].params.parameters())
    return {"restarts": [clean["restarts"], crash["restarts"]],
            "params_bit_identical": all(torch.equal(a, b) for a, b in pairs),
            "losses": {r: {m["step"]: m["loss"] for m in runs[r]["metrics"]} for r in runs},
            "latest": Checkpointer(str(out_dir / "resume_crash")).latest_step(),
            "digest": _digest(crash["final_state"].params)}


def _rank_main(rank: int, world: int, in_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=world)
    try:
        group = dist.group.WORLD
        facts = {"digests": {name: _run_case(name, case, Path(in_dir), Path(out_dir), group,
                                             rank)
                             for name, case in _cases(world).items()}}
        if world == 2:
            facts["resume"] = _resume(Path(out_dir), group)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def run(world: int, in_dir: str, out_dir: str) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, in_dir, out_dir))
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
    run(int(sys.argv[1]), sys.argv[2], sys.argv[3])
