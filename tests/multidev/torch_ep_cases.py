"""The port's expert parallelism over the "model" axis (the JAX rule
ep -> "model": the MoE experts split across the ranks of a row) on gloo CPU
ranks, for `tests/test_torch_ep.py`.

    python tests/multidev/torch_ep_cases.py MESH IN_DIR OUT_DIR
    python tests/multidev/torch_ep_cases.py layouts IN_DIR OUT_DIR

MESH is "1x2", "1x4" or "2x2": it spawns D x M ranks, which run each case
of `CASES` on that mesh as `torch_tp_cases` runs its cases (the same files:
OUT_DIR/<case>.npz from rank 0, OUT_DIR/<case>_rank<r>.npz, and
OUT_DIR/rank<r>.json with each case's digests, state bytes and wire bytes),
with the MoE overrides of the case (`case_cfg`).  On 1x2 a rank also writes
`ops` (the model axis' gather along a dimension, and the MoE layer alone,
against the whole computation, with the digest of the gradient it received
for the experts' gathered outputs) and `resume` (crash and resume of
`layout_cfg()`, reduced qwen3-moe with one group, against an uninterrupted
run).  On 1x2 and 2x2 the one-card checkpoint IN_DIR/ckpt_one (of
`layout_cfg()`) is restored into a sharded state and saved again into
OUT_DIR/ckpt_one_<mesh>.

`layouts` restores OUT_DIR/../2x2/ckpt_one_2x2 on 1x2 (into
OUT_DIR/ckpt_2x2_1x2) and then OUT_DIR/../1x2/ckpt_one_1x2 on 4x1 (into
OUT_DIR/ckpt_1x2_4x1), with each rank's blocks.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import torch_tp_cases as tp

STEPS = 2
RANK_TIMEOUT_S = 300  # all ranks of a spawn together
QWEN3_MOE = "qwen3-moe-235b-a22b"
# name -> (mesh, arch, accum, compress bits, global batch, MoE config overrides)
CASES = {
    "moe_plain": ((1, 2), QWEN3_MOE, 1, None, 4, None),
    "moe_accum2": ((1, 2), QWEN3_MOE, 2, None, 4, None),
    "moe_compress8": ((1, 2), QWEN3_MOE, 1, 8, 4, None),
    "moe_scatter": ((1, 2), QWEN3_MOE, 1, None, 4, {"dispatch": "scatter"}),
    "jamba": ((1, 2), "jamba-v0.1-52b", 1, None, 4, None),  # attention, mamba and MoE
    "llama4": ((1, 2), "llama4-maverick-400b-a17b", 1, None, 4, None),  # top-1, MLP and MoE
    # 3 experts on 2 ranks: the experts whole, the layer whole on each rank
    "moe_3experts": ((1, 2), QWEN3_MOE, 1, None, 4, {"n_experts": 3}),
    "moe_plain_1x4": ((1, 4), QWEN3_MOE, 1, None, 4, None),  # one expert a rank
    "moe_plain_2x2": ((2, 2), QWEN3_MOE, 1, None, 4, None),
    "moe_accum2_2x2": ((2, 2), QWEN3_MOE, 2, None, 4, None),
}
CHECKPOINT_MESHES = ((1, 2), (2, 2))
label = tp.label


def case_cfg(arch: str, overrides=None):
    """The port's reduced config of a case, its MoE config replaced by the
    case's overrides."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(arch))
    if overrides:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **overrides))
    return cfg


def layout_cfg():
    """The checkpoints' and the resume's config: reduced qwen3-moe, one group."""
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(QWEN3_MOE), groups=1)


def _moe_layer_ops(group, rank: int) -> dict:
    """The MoE layer of reduced qwen3-moe alone on 2 ranks (each holding 2 of
    its 4 experts) against the whole layer on this rank: the output and the
    gradients of x, the router and the rank's expert blocks; and the sha256
    of the gradient the rank received for the experts' gathered outputs."""
    import torch
    from types import SimpleNamespace

    from repro_torch.models.layers.moe import MoE, moe_forward
    from repro_torch.parallel import tensor
    from repro_torch.parallel.sharding import Shard

    cfg = layout_cfg()
    whole = MoE(cfg, device="cpu", dtype=torch.float32)
    whole.reset_parameters(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    w = torch.randn(2, 16, cfg.d_model, generator=gen)
    E, n = cfg.moe.n_experts, cfg.moe.n_experts // 2

    def run(p, region):
        xx = x.clone().requires_grad_(True)
        out = moe_forward(p, cfg, xx, None, region)
        got = torch.autograd.grad((out * w).sum(), [xx, p.router, p.w_in, p.w_out])
        return out.detach(), got

    params = [t.detach().clone().requires_grad_(True) for t in whole.parameters()]
    want_out, want = run(SimpleNamespace(**dict(zip(("router", "w_in", "w_out"), params))), None)
    mine = SimpleNamespace(
        router=whole.router.detach().clone().requires_grad_(True),
        w_in=whole.w_in.detach()[rank * n:(rank + 1) * n].clone().requires_grad_(True),
        w_out=whole.w_out.detach()[rank * n:(rank + 1) * n].clone().requires_grad_(True))
    layout = {k: Shard(tuple(getattr(whole, k).shape), mdim=0, mparts=2, mindex=rank)
              for k in ("w_in", "w_out")}
    region = tensor.ModelRegion(layout, group, 2, rank)
    seen = []
    gather = tensor.ModelRegion.gather

    def spy(self, t, dim=-1):  # the gathered outputs' gradient, as the rank receives it
        y = gather(self, t, dim)
        y.register_hook(lambda g: seen.append(g.clone()))
        return y

    tensor.ModelRegion.gather = spy
    try:
        out, got = run(mine, region)
    finally:
        tensor.ModelRegion.gather = gather
    rel = {}
    for key, a, b in (("out", out, want_out), ("grad_x", got[0], want[0]),
                      ("grad_router", got[1], want[1]),
                      ("grad_w_in", got[2], want[2][rank * n:(rank + 1) * n]),
                      ("grad_w_out", got[3], want[3][rank * n:(rank + 1) * n])):
        rel[key] = float((a - b).abs().max() / b.abs().max())
    (g,) = seen
    return {"moe_rel": rel, "y_grad_shape": list(g.shape), "experts": E,
            "y_grad_digest": hashlib.sha256(g.numpy().tobytes()).hexdigest()}


def _gather_ops(group, rank: int) -> dict:
    """`ModelRegion.gather` along dimensions 0 and 1 of f64 tensors on 2
    ranks against the concatenation, and its gradient against the rank's
    slice of the incoming gradient."""
    import torch

    from repro_torch.parallel.tensor import ModelRegion

    gen = torch.Generator().manual_seed(4)
    region = ModelRegion({}, group, 2, rank)
    out = {}
    for dim in (0, 1):
        parts = [torch.randn(3, 4, 5, generator=gen, dtype=torch.float64) for _ in range(2)]
        up = torch.randn(*(2 * s if d == dim else s for d, s in enumerate((3, 4, 5))),
                         generator=gen, dtype=torch.float64)
        x = parts[rank].clone().requires_grad_(True)
        y = region.gather(x, dim)
        (g,) = torch.autograd.grad((y * up).sum(), x)
        out[f"gather_dim{dim}_err"] = float((y - torch.cat(parts, dim)).abs().max())
        out[f"gather_dim{dim}_grad_err"] = float(
            (g - up.narrow(dim, rank * x.shape[dim], x.shape[dim])).abs().max())
    return out


def _rank_main(rank: int, world: int, mode: str, in_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous_{mode}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        if mode == "layouts_1x2":
            tp._restore_and_save(out_dir.parent / "2x2" / "ckpt_one_2x2",
                                 out_dir / "ckpt_2x2_1x2", group, (1, 2), out_dir, "2x2_1x2",
                                 rank, layout_cfg())
            return
        if mode == "layouts_4x1":
            tp._restore_and_save(out_dir.parent / "1x2" / "ckpt_one_1x2",
                                 out_dir / "ckpt_1x2_4x1", group, (4, 1), out_dir, "1x2_4x1",
                                 rank, layout_cfg())
            return
        mesh = tuple(int(x) for x in mode.split("x"))
        facts = {"cases": {name: tp._run_case(name, case, in_dir, out_dir, group, rank,
                                              case_cfg(case[1], case[5]))
                           for name, case in CASES.items() if case[0] == mesh}}
        if mesh == (1, 2):
            facts["ops"] = {**_gather_ops(group, rank), **_moe_layer_ops(group, rank)}
            facts["resume"] = tp._resume(out_dir, group, layout_cfg())
        if mesh in CHECKPOINT_MESHES:
            tp._restore_and_save(in_dir / "ckpt_one", out_dir / f"ckpt_one_{mode}", group, mesh,
                                 out_dir, f"one_{mode}", rank, layout_cfg())
        (out_dir / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        dist.destroy_process_group()


def _spawn(mode: str, world: int, in_dir: str, out_dir: str) -> None:
    import multiprocessing as mp

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


def run(mode: str, in_dir: str, out_dir: str) -> None:
    if mode == "layouts":
        _spawn("layouts_1x2", 2, in_dir, out_dir)
        _spawn("layouts_4x1", 4, in_dir, out_dir)
        return
    D, M = (int(x) for x in mode.split("x"))
    _spawn(mode, D * M, in_dir, out_dir)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    run(sys.argv[1], sys.argv[2], sys.argv[3])
