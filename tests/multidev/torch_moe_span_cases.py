"""MoE dispatch groups that span data ranks (`repro_torch.models.layers.moe`:
each group's rows on s = R / G consecutive batch shards, dispatched whole
from the choices all-gathered over them) on gloo CPU ranks, for
`tests/test_torch_moe_span.py`.

    python tests/multidev/torch_moe_span_cases.py MESH IN_DIR OUT_DIR

MESH is "2x1", "4x1" or "2x2": it spawns D x M ranks, which run on that
mesh
- each training case of `CASES` as `torch_tp_cases` runs its cases (the
  same files: OUT_DIR/<case>.npz from rank 0, OUT_DIR/<case>_rank<r>.npz,
  and each case's digests, state bytes, wire bytes by axis and by site in
  OUT_DIR/rank<r>.json), with the MoE overrides of the case;
- each serving case of `SERVE` as `torch_serve_cases` runs its cases
  (OUT_DIR/<case>_rank<r>.npz: the logits of the prefill and of each
  decode step, the caches; the engine's completions and the wire bytes,
  with the choices' site, in OUT_DIR/rank<r>.json);
- on 2x1, the MoE layer of `DROPS_CFG` alone on IN_DIR/drops.npz ("x"
  [B, S, d] and the layer's "router", "w_in", "w_out"), each rank its half
  of the rows as its share of the one group: OUT_DIR/drops_rank<r>.npz
  holds its output rows ("out") and the readings of `chip_smoke.SpanDrops`
  (the chip check's count of the span's drops) around the call.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

import torch_serve_cases as serve
import torch_tp_cases as tp

STEPS = 2
RANK_TIMEOUT_S = 300  # all ranks of a spawn together
QWEN3_MOE = "qwen3-moe-235b-a22b"
ONE = {"n_dispatch_groups": 1}
# name -> (mesh, arch, accum, compress bits, global batch, MoE config overrides); reduced
# configs, 4 rows of 16 tokens: the config's 2 groups or one
CASES = {
    "g2_4x1": ((4, 1), QWEN3_MOE, 1, None, 4, None),  # 2 groups, 2 ranks each
    "g1_2x1": ((2, 1), QWEN3_MOE, 1, None, 4, ONE),
    "g1_4x1": ((4, 1), QWEN3_MOE, 1, None, 4, ONE),  # one group on 4 ranks
    "g1_2x2": ((2, 2), QWEN3_MOE, 1, None, 4, ONE),  # and the experts split along "model"
    "g1_accum2_2x1": ((2, 1), QWEN3_MOE, 2, None, 4, ONE),  # a micro-batch of 2 rows
    "g1_scatter_2x1": ((2, 1), QWEN3_MOE, 1, None, 4, {**ONE, "dispatch": "scatter"}),
    "jamba_g1_2x1": ((2, 1), "jamba-v0.1-52b", 1, None, 4, ONE),  # attention, mamba, MoE
    "llama4_g1_2x1": ((2, 1), "llama4-maverick-400b-a17b", 1, None, 4, ONE),  # top-1
}
# name -> (mesh, arch, global batch, MoE config overrides): a prefill of
# serve.MAX_LEN - 8 tokens and serve.STEPS decode steps, then the engine
SERVE = {
    "srv_g1_2x1": ((2, 1), QWEN3_MOE, 4, ONE),  # 2 rows a rank, one group
    "srv_g1_2x2": ((2, 2), QWEN3_MOE, 2, ONE),
}
DROPS_CFG = (QWEN3_MOE, ONE)  # the layer of the drops case: 4 experts, top-2, one group
DROPS_SHAPE = (4, 8)  # rows, tokens a row: 32 tokens, cap 20; a rank's 16 alone: cap 10
MESHES = ("2x1", "4x1", "2x2")


def case_cfg(arch: str, overrides=None):
    """The port's reduced config, its MoE config replaced by the overrides."""
    return serve.case_cfg(arch, overrides)


def _drops(in_dir: Path, out_dir: Path, group, rank: int) -> None:
    """The drops case's layer on this rank's rows, its share of the group."""
    import torch
    from chip_smoke import SpanDrops

    from repro_torch.models.layers import moe
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import Mesh

    cfg = case_cfg(*DROPS_CFG)
    d = dict(np.load(in_dir / "drops.npz"))
    p = moe.MoE(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k in ("router", "w_in", "w_out"):
            getattr(p, k).copy_(torch.from_numpy(d[k]))
    rows = DROPS_SHAPE[0] // 2
    x = torch.from_numpy(d["x"])[rank * rows:(rank + 1) * rows]
    span = fsdp.span_group(group, Mesh((2, 1), ("data", "model")), 2)
    with SpanDrops(cfg) as drops:
        out = moe.moe_forward(p, cfg, x, moe.DataSplit(2, rank, span))
    seen = drops.readings()
    np.savez(out_dir / f"drops_rank{rank}.npz", out=out.detach().numpy(),
             drops=np.array([seen[k] for k in ("choices", "dropped", "local_would_differ",
                                               "dispatches")]))


def _rank_main(rank: int, world: int, mode: str, in_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous_{mode}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        mesh = tuple(int(x) for x in mode.split("x"))
        facts = {"cases": {name: tp._run_case(name, case, in_dir, out_dir, group, rank,
                                              case_cfg(case[1], case[5]))
                           for name, case in CASES.items() if case[0] == mesh},
                 "serve": {name: serve._run_case(name, case, in_dir, out_dir, group, rank)
                           for name, case in SERVE.items() if case[0] == mesh}}
        if mesh == (2, 1):
            _drops(in_dir, out_dir, group, rank)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def run(mode: str, in_dir: str, out_dir: str) -> None:
    import multiprocessing as mp

    D, M = (int(x) for x in mode.split("x"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, D * M, mode, in_dir, out_dir))
             for r in range(D * M)]
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
    root = Path(__file__).resolve().parents[2]
    sys.path[:0] = [str(root / "src"), str(root)]
    run(sys.argv[1], sys.argv[2], sys.argv[3])
