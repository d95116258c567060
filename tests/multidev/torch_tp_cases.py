"""The port's training state on ("data", "model") meshes, tensor-parallel
along "model" (`repro_torch.parallel.tensor`), on gloo CPU ranks, for
`tests/test_torch_tp.py`.

    python tests/multidev/torch_tp_cases.py MESH IN_DIR OUT_DIR
    python tests/multidev/torch_tp_cases.py layouts IN_DIR OUT_DIR

MESH is "1x2", "1x4" or "2x2": it spawns D x M ranks, which run each case
of `CASES` on that mesh: every rank loads the starting parameters
(IN_DIR/params_<case>.npz, the JAX tree's leaves flattened with "/" keys)
and each step's global batch (IN_DIR/batch_<case>_<step>.npz), builds the
one-card state, shards it by `make_rules` on the mesh
(`fsdp.shard_train_state(..., mesh=...)`) and runs STEPS steps
(`make_train_step(group=...)`) on its own trajectory; before each step it
also takes the step's pre-compression gradient (`accumulate_grads`).  Rank
0 writes OUT_DIR/<case>.npz: per step the whole state the step started
from ("s<i>/p/...", "s<i>/m/...", "s<i>/v/..."), the whole gradient
("s<i>/g/..."), loss and grad_norm, and the final whole state
("final/...").  Each rank writes OUT_DIR/<case>_rank<r>.npz: the final
blocks it holds, stacked over the groups as the JAX tree stacks them
("p/...", "m/...", "v/...").  Every rank writes OUT_DIR/rank<r>.json:
per case the sha256 of the final whole parameters, of each leaf's block
after each step ("blocks", by step and leaf key), the bytes of the state
it holds, the wire bytes of each step by axis and kind and by named site
(`fsdp.WIRE`, reset just before the step) and the layout's leaves summed
over "model";
and on 1x2 also `ops` (the operators against the whole computation),
`resume` (`run_training(rules=..., mesh=...)` with a failure injected
before step 6 against an uninterrupted run: reduced qwen3-8b, one group,
12 steps, checkpoints every 4).  On 1x2 and 2x2 the one-card checkpoint
IN_DIR/ckpt_one is restored into a sharded state and saved again into
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

import numpy as np

from torch_fsdp_cases import _digest, _flat, _nest, layout_cfg, rank_slices, whole_state

STEPS = 2
RANK_TIMEOUT_S = 300  # all ranks of a spawn together
# name -> (mesh, arch, accum, compress bits, global batch, config overrides)
CASES = {
    "qwen3_plain": ((1, 2), "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2": ((1, 2), "qwen3-8b", 2, None, 4, None),
    "qwen3_compress8": ((1, 2), "qwen3-8b", 1, 8, 4, None),
    "gemma2_tied": ((1, 2), "gemma2-9b", 1, None, 4, None),  # the tied head, vocab-parallel
    "hubert_frames": ((1, 2), "hubert-xlarge", 1, None, 4, None),  # no lookup
    "mamba_plain": ((1, 2), "falcon-mamba-7b", 1, None, 4, None),
    "moe_plain": ((1, 2), "qwen3-moe-235b-a22b", 1, None, 4, None),  # experts split
    # 3 heads and d_ff 129 on 2 ranks: attention and MLP run whole on each rank
    "qwen3_undivided": ((1, 2), "qwen3-8b", 1, None, 4, {"n_heads": 3, "n_kv": 1, "d_ff": 129}),
    # 2 KV heads on 4 ranks: kv dropped, pairs of ranks share a KV head
    "qwen3_plain_1x4": ((1, 4), "qwen3-8b", 1, None, 4, None),
    "qwen3_plain_2x2": ((2, 2), "qwen3-8b", 1, None, 4, None),
    "qwen3_accum2_2x2": ((2, 2), "qwen3-8b", 2, None, 4, None),
}
LR, WARMUP = 1e-3, 2
CHECKPOINT_MESHES = ((1, 2), (2, 2))


def label(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def case_cfg(arch: str, overrides=None):
    """The port's reduced config of a case, with its overrides."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config(arch)), **(overrides or {}))


def _rules(mesh, cfg):
    from repro_torch.parallel.sharding import Mesh, make_rules

    return make_rules(Mesh(mesh, ("data", "model")), model_cfg=cfg)


def _mesh(shape):
    from repro_torch.parallel.sharding import Mesh

    return Mesh(shape, ("data", "model"))


def _leaf_digests(state) -> dict:
    """{"p/<leaf>" or "<part>/<leaf>": sha256 of the rank's block}."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in rank_slices(state).items()}


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int,
              cfg=None) -> dict:
    """One case on this rank (module docstring); `cfg`: the port's config,
    `case_cfg` of the case's by default."""
    import torch

    from repro_torch.interop import lm_params_to_numpy, train_state_from_numpy
    from repro_torch.parallel import fsdp, tensor
    from repro_torch.training import OptConfig, make_train_step
    from repro_torch.training.train_step import accumulate_grads

    mesh, arch, accum, bits, _, overrides = case
    cfg = case_cfg(arch, overrides) if cfg is None else cfg
    P = _nest(dict(np.load(in_dir / f"params_{name}.npz")))
    zeros = {part: _nest({k: np.zeros_like(v) for k, v in _flat(P).items()})
             for part in ("m", "v")}
    state = train_state_from_numpy(cfg, P, zeros, 0, device="cpu")
    fsdp.shard_train_state(state, _rules(mesh, cfg), group=group, mesh=_mesh(mesh))
    sharding = state.params.fsdp
    step = make_train_step(state.params, OptConfig(lr=LR, warmup_steps=WARMUP), accum=accum,
                           compress_bits=bits, group=group)
    out, facts = {}, {"blocks": [], "wire": [], "sites": []}
    facts["state_bytes"] = (sum(p.numel() * p.element_size() for p in state.params.parameters())
                            + sum(t.numel() * t.element_size()
                                  for part in state.opt.values() for t in part.values()))
    facts["summed_over_model"] = tensor.summed_over_model(sharding.layout)
    facts["model_whole"] = sorted({k for k in _leaf_digests(state)
                                   if not _model_split(sharding, k)})
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in np.load(in_dir / f"batch_{name}_{s}.npz").items()}
        out.update({f"s{s}/{k}": v for k, v in whole_state(state).items()})
        _, g = accumulate_grads(state.params, batch, accum=accum, group=group)
        out.update({f"s{s}/g/{k}": v for k, v in _flat(lm_params_to_numpy(
            cfg, fsdp.whole_named(sharding, g))).items()})
        fsdp.WIRE.reset()
        state, m = step(state, batch)
        facts["wire"].append(fsdp.WIRE.by_axis())
        facts["sites"].append(fsdp.WIRE.by_site())
        facts["blocks"].append(_leaf_digests(state))
        out[f"s{s}/loss"] = np.float32(m["loss"].item())
        out[f"s{s}/grad_norm"] = np.float32(m["grad_norm"].item())
    final = whole_state(state)
    out.update({f"final/{k}": v for k, v in final.items()})
    np.savez(out_dir / f"{name}_rank{rank}.npz", **rank_slices(state))
    if rank == 0:
        np.savez(out_dir / f"{name}.npz", **out)
    facts["digest"] = _digest({k: v for k, v in final.items() if k.startswith("p/")})
    return facts


def _model_split(sharding, key: str) -> bool:
    """Whether the leaf of a rank-slice key ("p/blocks/pos0/attn/wq",
    "m/embed", ...) is sliced along "model"."""
    path = key.split("/", 1)[1].split("/")
    name = ".".join(["groups", "0", *path[1:]] if path[0] == "blocks" else path)
    return sharding.model_split(name)


def _ops(group, rank: int) -> dict:
    """The operators on 2 ranks against the whole computation, in f64: the
    vocab-parallel cross entropy and lookup (values and gradients), `copy`
    (its gradient the ranks' sum), `reduce` and `gather`."""
    import torch

    from repro_torch.models.layers.embeddings import lookup
    from repro_torch.parallel.sharding import Shard
    from repro_torch.parallel.tensor import ModelRegion

    gen = torch.Generator().manual_seed(3)
    V, n = 10, 5
    logits = torch.randn(3, 4, V, generator=gen, dtype=torch.float64)
    labels = torch.randint(0, V, (3, 4), generator=gen)
    embed = torch.randn(V, 6, generator=gen, dtype=torch.float64)
    tokens = torch.randint(0, V, (3, 4), generator=gen)
    w = torch.randn(3, 4, generator=gen, dtype=torch.float64)
    tp = ModelRegion({"embed": Shard((V, 6), mdim=0, mparts=2, mindex=rank)}, group, 2, rank)
    out = {}

    mine = logits[..., rank * n:(rank + 1) * n].clone().requires_grad_(True)
    ce = tp.cross_entropy(mine, labels)
    (g_mine,) = torch.autograd.grad((ce * w).sum(), mine)
    whole = logits.clone().requires_grad_(True)
    want = torch.logsumexp(whole, -1) - torch.take_along_dim(whole, labels[..., None], -1)[..., 0]
    (g_whole,) = torch.autograd.grad((want * w).sum(), whole)
    out["ce_err"] = float((ce - want).abs().max())
    out["ce_grad_err"] = float((g_mine - g_whole[..., rank * n:(rank + 1) * n]).abs().max())

    block = embed[rank * n:(rank + 1) * n].clone().requires_grad_(True)
    x = lookup(block, tokens, tp)
    (g_block,) = torch.autograd.grad((x * x).sum(), block)
    whole = embed.clone().requires_grad_(True)
    (g_embed,) = torch.autograd.grad((whole[tokens] ** 2).sum(), whole)
    out["lookup_err"] = float((x - embed[tokens]).abs().max())
    out["lookup_grad_err"] = float((g_block - g_embed[rank * n:(rank + 1) * n]).abs().max())

    a = torch.randn(4, 3, generator=gen, dtype=torch.float64)
    c = [torch.randn(4, 3, generator=gen, dtype=torch.float64) for _ in range(2)]
    xa = a.clone().requires_grad_(True)
    y = tp.copy(xa)
    (g_copy,) = torch.autograd.grad((y * c[rank]).sum(), xa)
    out["copy_value_err"] = float((y - a).abs().max())
    out["copy_grad_err"] = float((g_copy - (c[0] + c[1])).abs().max())
    xr = c[rank].clone().requires_grad_(True)
    y = tp.reduce(xr)
    (g_reduce,) = torch.autograd.grad((y * a).sum(), xr)
    out["reduce_err"] = float((y - (c[0] + c[1])).abs().max())
    out["reduce_grad_err"] = float((g_reduce - a).abs().max())
    whole = torch.cat(c, -1)
    xg = c[rank].clone().requires_grad_(True)
    y = tp.gather(xg)
    (g_gather,) = torch.autograd.grad((y * torch.cat([a, 2 * a], -1)).sum(), xg)
    out["gather_err"] = float((y - whole).abs().max())
    out["gather_grad_err"] = float((g_gather - (rank + 1) * a).abs().max())
    return out


def _resume(out_dir: Path, group, cfg=None) -> dict:
    """Crash and resume on the group's (1, 2) ranks against an uninterrupted
    run (`cfg`: `layout_cfg()` by default)."""
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

        m = build_model(layout_cfg() if cfg is None else cfg, device="cpu")
        runs[run] = run_training(
            m, DataConfig(vocab=m.cfg.vocab, seq_len=16, global_batch=4),
            OptConfig(lr=1e-3, warmup_steps=1),
            RunConfig(total_steps=12, ckpt_every=4, log_every=100, metrics=[]),
            Checkpointer(str(out_dir / f"resume_{run}")), fail_injector=injector, group=group,
            rules=_rules((1, 2), m.cfg), mesh=_mesh((1, 2)))
    wholes = {r: whole_state(runs[r]["final_state"]) for r in runs}
    sharding = runs["crash"]["final_state"].params.fsdp
    return {"restarts": [runs["clean"]["restarts"], runs["crash"]["restarts"]],
            "model_parts": sharding.model_parts if sharding is not None else 0,
            "state_bit_identical": all(np.array_equal(wholes["clean"][k], wholes["crash"][k])
                                       for k in wholes["clean"]),
            "losses": {r: {m["step"]: m["loss"] for m in runs[r]["metrics"]} for r in runs},
            "latest": Checkpointer(str(out_dir / "resume_crash")).latest_step(),
            "digest": _digest(wholes["crash"])}


def _restore_and_save(src: Path, dst: Path, group, mesh, out_dir: Path, tag: str,
                      rank: int, cfg=None) -> None:
    """The checkpoint in `src` restored into a state of `cfg` (the layout
    config by default) sharded on `mesh` and saved into `dst`; the rank's
    blocks into OUT_DIR/<tag>_rank<r>.npz."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state

    cfg = layout_cfg() if cfg is None else cfg
    state = init_train_state(build_model(cfg, device="cpu", seed=3),
                             torch.Generator().manual_seed(3), OptConfig(),
                             rules=_rules(mesh, cfg), group=group, mesh=_mesh(mesh))
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
        if mode == "layouts_1x2":
            _restore_and_save(out_dir.parent / "2x2" / "ckpt_one_2x2", out_dir / "ckpt_2x2_1x2",
                              group, (1, 2), out_dir, "2x2_1x2", rank)
            return
        if mode == "layouts_4x1":
            _restore_and_save(out_dir.parent / "1x2" / "ckpt_one_1x2", out_dir / "ckpt_1x2_4x1",
                              group, (4, 1), out_dir, "1x2_4x1", rank)
            return
        mesh = tuple(int(x) for x in mode.split("x"))
        facts = {"cases": {name: _run_case(name, case, in_dir, out_dir, group, rank)
                           for name, case in CASES.items() if case[0] == mesh}}
        if mesh == (1, 2):
            facts["ops"] = _ops(group, rank)
            facts["resume"] = _resume(out_dir, group)
        if mesh in CHECKPOINT_MESHES:
            _restore_and_save(in_dir / "ckpt_one", out_dir / f"ckpt_one_{mode}", group, mesh,
                              out_dir, f"one_{mode}", rank)
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
