"""The port's serving path with the attention caches' sequence split along
"model" (JAX's `cache_specs`, sp -> "model"), on gloo CPU ranks, for
`tests/test_torch_serve_sequence.py`.

    python tests/multidev/torch_serve_sequence_cases.py MESH IN_DIR OUT_DIR

MESH is "1x2", "2x2" or "1x4": it spawns D x M ranks, which run each case
of `CASES` on that mesh.  Every rank loads the parameters
(IN_DIR/params_<arch>.npz, the JAX tree's leaves flattened with "/" keys)
into the one-card model, shards it by `make_rules` on the mesh, runs the
prefill of its rows of the prompts (IN_DIR/tokens_<arch>_<B>.npz:
"prompts" [B, S] and "steps" [STEPS, B]) into caches of the case's
max_len and STEPS decode steps fed the given tokens, and writes
OUT_DIR/<case>_rank<r>.npz: its rows ("rows"), the f32 logits of the
prefill ("l0") and of each step ("l<i>"), and its block of the caches
after the prefill ("c0/pos<i>/<name>") and after the last step
("c<STEPS>/..."); then `ServeEngine` greedy and at TEMPERATURE on the
global prompts.  On a case with `MASKED` set, it also decodes one more
step from a copy of the caches twice, once with the k and v of the local
attention layers' positions [0, 6) (rank 0's block, wholly outside the
window there) overwritten with large finite values: the logits bits of
both ("masked_equal").  Every rank writes OUT_DIR/rank<r>.json: per case
its rows, its block of the sequence, its caches' shapes and bytes, the
wire bytes by axis and kind of the prefill and of each decode step, and
the engine's completions.

Exits non-zero when a rank fails or does not finish within its time limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from torch_fsdp_cases import _nest
from torch_serve_cases import _flat_t, _nbytes, case_cfg, tokens_file

STEPS = 3
NEW_TOKENS = 5
TEMPERATURE = 0.8
RANK_TIMEOUT_S = 200  # all ranks of a spawn together
MASKED = "gemma2_1x4"  # window 8, blocks of 6: block 0 outside the window from 14 on
# name -> (mesh, arch, global batch, max_len)
CASES = {
    "qwen3_1x2": ((1, 2), "qwen3-8b", 2, 24),  # kv -> "model": blocks of 12
    "qwen3_2x2": ((2, 2), "qwen3-8b", 2, 24),
    "qwen3_1x4": ((1, 4), "qwen3-8b", 2, 24),  # 2 KV heads on 4 ranks: kv dropped
    "gemma2_1x4": ((1, 4), "gemma2-9b", 2, 24),  # softcap, local window, tied head
    "moe_1x2": ((1, 2), "qwen3-moe-235b-a22b", 2, 24),
    "qwen3_whole_1x4": ((1, 4), "qwen3-8b", 2, 22),  # 4 does not divide 22: whole
    "qwen3_whole_1x2": ((1, 2), "qwen3-8b", 2, 23),  # 2 does not divide 23: whole
}
MESHES = ("1x2", "2x2", "1x4")


def label(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _masked_step(model, caches, tok, position: int, ranks: int) -> bool:
    """Whether a decode step at `position` gives the same logits bits with
    the local layers' k and v at positions [0, 6) overwritten (module
    docstring)."""
    import torch

    def copy(c):
        return type(c)({k: {n: t.clone() for n, t in v.items()} for k, v in c.items()},
                       c.sequence)

    plain, changed = copy(caches), copy(caches)
    seq = caches.sequence
    for i, spec in enumerate(model.cfg.pattern):
        if spec.mixer == "attn_local" and seq.start < 6:
            for t in changed[f"pos{i}"].values():
                t[:, :, :6 - seq.start] = 1e3 * torch.randn_like(t[:, :, :6 - seq.start])
    a, _ = model.decode_step(plain, tok, position, dispatch_ranks=ranks)
    b, _ = model.decode_step(changed, tok, position, dispatch_ranks=ranks)
    return bool(torch.equal(a, b))


def _run_case(name: str, case, in_dir: Path, out_dir: Path, group, rank: int) -> dict:
    """One case on this rank (module docstring)."""
    import torch

    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import Mesh, make_rules, rank_rows
    from repro_torch.serving import SamplerConfig, ServeEngine

    mesh_shape, arch, B, max_len = case
    cfg = case_cfg(arch)
    mesh = Mesh(mesh_shape, ("data", "model"))
    model = build_model(cfg, device="cpu")
    P = _nest(dict(np.load(in_dir / f"params_{arch}.npz")))
    model.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), group=group, mesh=mesh)
    toks = np.load(in_dir / tokens_file(arch, B))
    rows = rank_rows(B, mesh, make_rules(mesh), rank)
    ranks = B // len(rows)
    out = {"rows": np.array([rows.start, rows.stop])}
    prompts = torch.from_numpy(toks["prompts"]).long()
    fsdp.WIRE.reset()
    logits, caches = model.prefill({"tokens": prompts[rows.start:rows.stop]}, max_len,
                                   dispatch_ranks=ranks)
    seq = caches.sequence
    facts = {"rows": [rows.start, rows.stop],
             "sequence": None if seq is None else [seq.start, seq.stop],
             "wire_prefill": fsdp.WIRE.by_axis(),
             "cache_bytes": _nbytes(_flat_t(caches).values()),
             "cache_shapes": {k: list(t.shape) for k, t in _flat_t(caches).items()}}
    out["l0"] = logits.float().numpy()
    out.update({f"c0/{k}": t.numpy().copy() for k, t in _flat_t(caches).items()})
    facts["wire_steps"] = []
    S = prompts.shape[1]
    for s in range(STEPS):
        tok = torch.from_numpy(toks["steps"][s]).long()[rows.start:rows.stop]
        fsdp.WIRE.reset()
        logits, caches = model.decode_step(caches, tok, S + s, dispatch_ranks=ranks)
        facts["wire_steps"].append(fsdp.WIRE.by_axis())
        out[f"l{s + 1}"] = logits.float().numpy()
    out.update({f"c{STEPS}/{k}": t.numpy() for k, t in _flat_t(caches).items()})
    if name == MASKED:
        tok = torch.from_numpy(toks["steps"][-1]).long()[rows.start:rows.stop]
        facts["masked_equal"] = _masked_step(model, caches, tok, S + STEPS, ranks)
    np.savez(out_dir / f"{name}_rank{rank}.npz", **out)
    facts["engine"] = {}
    for mode, temperature in (("greedy", 0.0), ("temperature", TEMPERATURE)):
        engine = ServeEngine(model, max_len, B, SamplerConfig(
            temperature=temperature, max_new_tokens=NEW_TOKENS, seed=5), device="cpu")
        facts["engine"][mode] = engine.generate(toks["prompts"].tolist())
    return facts


def _rank_main(rank: int, world: int, mode: str, in_dir: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous_{mode}",
                            rank=rank, world_size=world)
    try:
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        mesh = tuple(int(x) for x in mode.split("x"))
        facts = {name: _run_case(name, case, in_dir, out_dir, dist.group.WORLD, rank)
                 for name, case in CASES.items() if case[0] == mesh}
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
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here.parents[1] / "src"))
    run(sys.argv[1], sys.argv[2], sys.argv[3])
