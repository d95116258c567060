"""The port's serving path on a sharded state (`Transformer.prefill`,
`decode_step` and `ServeEngine` on ("data", "model") meshes), on gloo CPU
ranks, for `tests/test_torch_serve_sharded.py`.

    python tests/multidev/torch_serve_cases.py MESH IN_DIR OUT_DIR

MESH is "2x1", "1x2", "2x2" or "1x4": it spawns D x M ranks, which run each
case of `CASES` on that mesh.  Every rank loads the parameters
(IN_DIR/params_<arch>.npz, the JAX tree's leaves flattened with "/" keys)
into the one-card model, shards it by `make_rules` on the mesh
(`fsdp.shard_model(..., group=..., mesh=...)`), runs the prefill of its rows
of the prompts (IN_DIR/tokens_<arch>_<B>.npz: "prompts" [B, S] and "steps"
[STEPS, B]) and STEPS decode steps fed the given tokens, and writes
OUT_DIR/<case>_rank<r>.npz: its rows ("rows"), the f32 logits of the
prefill ("l0") and of each step ("l<i>"), whole along "model", and its
block of the caches after the prefill ("c0/pos<i>/<name>") and after the
last step ("c<STEPS>/..."); then `ServeEngine` greedy and at
TEMPERATURE on the global prompts.  Every rank writes OUT_DIR/rank<r>.json: per
case its rows, the bytes of its parameter blocks and cache block, the
largest gather, the wire bytes by axis and kind of the prefill and of each
decode step (`fsdp.WIRE`, reset just before each), the engine's
completions and wire, and `no_grad_ops` on two-rank model axes (copy,
reduce and gather under `torch.no_grad`: values and no graph).

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from torch_fsdp_cases import _nest

STEPS = 3
MAX_LEN = 24
NEW_TOKENS = 6
TEMPERATURE = 0.8
RANK_TIMEOUT_S = 240  # all ranks of a spawn together
# name -> (mesh, arch, global batch, config overrides)
CASES = {
    "qwen3_2x1": ((2, 1), "qwen3-8b", 2, None),
    "qwen3_1x2": ((1, 2), "qwen3-8b", 2, None),
    "qwen3_2x2": ((2, 2), "qwen3-8b", 2, None),
    "qwen3_1x4": ((1, 4), "qwen3-8b", 2, None),  # 2 KV heads on 4 ranks: kv dropped
    "qwen3_rows3_2x1": ((2, 1), "qwen3-8b", 3, None),  # 2 data ranks, 3 rows: every row
    "mamba_1x2": ((1, 2), "falcon-mamba-7b", 2, None),
    "mamba_2x2": ((2, 2), "falcon-mamba-7b", 2, None),
    "gemma2_1x2": ((1, 2), "gemma2-9b", 2, None),  # tied head, softcap, local window
    "gemma2_2x2": ((2, 2), "gemma2-9b", 2, None),
    "jamba_2x2": ((2, 2), "jamba-v0.1-52b", 2, None),  # attention, mamba and MoE
    "moe_1x2": ((1, 2), "qwen3-moe-235b-a22b", 2, None),
    "moe_2x2": ((2, 2), "qwen3-moe-235b-a22b", 2, None),
    "moe_1x4": ((1, 4), "qwen3-moe-235b-a22b", 2, None),
    # one dispatch group on two data ranks: each rank's row is half of it
    "moe_one_group_2x1": ((2, 1), "qwen3-moe-235b-a22b", 2, {"n_dispatch_groups": 1}),
}
MESHES = ("2x1", "1x2", "2x2", "1x4")


def label(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def case_cfg(arch: str, overrides=None):
    """The port's reduced config of a case, its MoE overrides applied."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config(arch))
    if overrides:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **overrides))
    return cfg


def tokens_file(arch: str, B: int) -> str:
    return f"tokens_{arch}_{B}.npz"


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int) -> dict:
    """One case on this rank (module docstring)."""
    import torch

    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import Mesh, make_rules, rank_rows
    from repro_torch.serving import SamplerConfig, ServeEngine

    mesh_shape, arch, B, overrides = case
    cfg = case_cfg(arch, overrides)
    mesh = Mesh(mesh_shape, ("data", "model"))
    model = build_model(cfg, device="cpu")
    P = _nest(dict(np.load(in_dir / f"params_{arch}.npz")))
    model.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), group=group, mesh=mesh)
    toks = np.load(in_dir / tokens_file(arch, B))
    rows = rank_rows(B, mesh, make_rules(mesh), rank)
    facts = {"rows": [rows.start, rows.stop], "param_bytes": _nbytes(model.parameters())}
    out = {"rows": np.array([rows.start, rows.stop])}
    prompts = torch.from_numpy(toks["prompts"]).long()
    S = prompts.shape[1]
    split, step_split = model.data_split(B, S), model.data_split(B, 1)
    fsdp.WIRE.reset()
    logits, caches = model.prefill({"tokens": prompts[rows.start:rows.stop]}, MAX_LEN,
                                   data_split=split)
    facts["wire_prefill"] = fsdp.WIRE.by_axis()
    facts["choices_prefill"] = fsdp.WIRE.by_site()
    facts["largest_gather"] = fsdp.WIRE.largest_gather
    facts["cache_bytes"] = _nbytes(_flat_t(caches).values())
    facts["cache_shapes"] = {k: list(t.shape) for k, t in _flat_t(caches).items()}
    out["l0"] = logits.float().numpy()
    out.update({f"c0/{k}": t.numpy().copy() for k, t in _flat_t(caches).items()})
    facts["wire_steps"] = []
    for s in range(STEPS):
        tok = torch.from_numpy(toks["steps"][s]).long()[rows.start:rows.stop]
        fsdp.WIRE.reset()
        logits, caches = model.decode_step(caches, tok, S + s, data_split=step_split)
        facts["wire_steps"].append(fsdp.WIRE.by_axis())
        out[f"l{s + 1}"] = logits.float().numpy()
    out.update({f"c{STEPS}/{k}": t.numpy() for k, t in _flat_t(caches).items()})
    np.savez(out_dir / f"{name}_rank{rank}.npz", **out)
    facts["engine"] = {}
    for mode, temperature in (("greedy", 0.0), ("temperature", TEMPERATURE)):
        engine = ServeEngine(model, MAX_LEN, B, SamplerConfig(
            temperature=temperature, max_new_tokens=NEW_TOKENS, seed=5), device="cpu")
        got = engine.generate(toks["prompts"].tolist())
        facts["engine"][mode] = {"completions": got, "stats": {
            k: v for k, v in engine.stats.items() if k.startswith("wire") or k == "decode_steps"}}
    return facts


def _flat_t(caches: dict) -> dict:
    return {f"{k}/{n}": t for k, c in caches.items() for n, t in c.items()}


def _no_grad_ops(group, rank: int, M: int) -> dict:
    """copy, reduce and gather of a region over the group's M ranks under
    `torch.no_grad`: their errors against the whole computation, and
    the outputs that carry a graph (`grad_fn`) though the input requires
    grad."""
    import torch

    from repro_torch.parallel.sharding import Shard
    from repro_torch.parallel.tensor import ModelRegion

    gen = torch.Generator().manual_seed(3)
    c = [torch.randn(4, 3, generator=gen, dtype=torch.float64) for _ in range(M)]
    tp = ModelRegion({"w": Shard((M, 1), mdim=0, mparts=M, mindex=rank)}, group, M, rank)
    x = c[rank].clone().requires_grad_(True)
    with torch.no_grad():
        outs = {"copy": tp.copy(x), "reduce": tp.reduce(x), "gather": tp.gather(x, 0)}
    want = {"copy": c[rank], "reduce": sum(c), "gather": torch.cat(c, 0)}
    return {"errors": {k: float((outs[k] - want[k]).abs().max()) for k in outs},
            "graphs": [k for k, t in outs.items() if t.grad_fn is not None]}


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
        facts = {"cases": {name: _run_case(name, case, in_dir, out_dir, group, rank)
                           for name, case in CASES.items() if case[0] == mesh}}
        if mesh[0] == 1:
            facts["no_grad_ops"] = _no_grad_ops(group, rank, mesh[1])
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
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    run(sys.argv[1], sys.argv[2], sys.argv[3])
