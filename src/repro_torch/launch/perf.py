"""Perf hillclimb tool, as the JAX package's `repro/launch/perf.py`.

Runs named variants of the three hillclimb cells through the port's dry run
(`repro_torch.launch.dryrun.lower_cell`, on the meta device), appending
each variant's roofline terms to results/perf_torch.json.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell A --variant sort_dispatch

A variant changes the config (`MoEConfig.dispatch`, `n_dispatch_groups`,
`attn_score_dtype`) or the step (`accum`, `remat`).  `temp_gb` (XLA's
temporary buffers) and `compile_s` have no counterpart in the port: they
are None, and `no_counterpart` names them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_production_mesh

CELLS = {
    "A": ("qwen3-moe-235b-a22b", "train_4k"),
    "B": ("qwen3-8b", "train_4k"),
    "C": ("jamba-v0.1-52b", "train_4k"),
}


def _moe_dispatch(mode):
    def override(cfg):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=mode))
    return override


def _moe_groups(n):
    def override(cfg):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="sort", n_dispatch_groups=n)
        )
    return override


def _bf16_scores(cfg):
    return dataclasses.replace(cfg, attn_score_dtype="bfloat16")


def _sort_bf16(cfg):
    return _bf16_scores(_moe_dispatch("sort")(cfg))


# variant -> (kwargs for lower_cell, description)
VARIANTS = {
    "baseline": (dict(cfg_override=_moe_dispatch("scatter")), "baseline (scatter MoE, accum=4)"),
    "sort_dispatch": (dict(cfg_override=_moe_dispatch("sort")),
                      "sort-based MoE dispatch (no scatter replication)"),
    "sort_accum1": (dict(cfg_override=_moe_dispatch("sort"), accum=1),
                    "sort dispatch + no grad accumulation (1 weight gather/step)"),
    "sort_accum2": (dict(cfg_override=_moe_dispatch("sort"), accum=2),
                    "sort dispatch + accum=2"),
    "sort_groups64": (dict(cfg_override=_moe_groups(64), accum=4),
                      "sort dispatch + 64 dispatch groups (smaller sorts)"),
    "accum1": (dict(accum=1), "no grad accumulation (1 weight gather/step)"),
    "accum2": (dict(accum=2), "accum=2"),
    "no_remat": (dict(remat=False), "no per-group remat (memory for compute)"),
    "no_remat_accum1": (dict(remat=False, accum=1), "no remat + accum=1"),
    "bf16_scores": (dict(cfg_override=_bf16_scores),
                    "bf16 attention score/probability buffers (fp32 stats)"),
    "bf16_scores_accum2": (dict(cfg_override=_bf16_scores, accum=2),
                           "bf16 scores + accum=2 (fewer FSDP regathers)"),
    "sort_accum8": (dict(cfg_override=_moe_dispatch("sort"), accum=8),
                    "sort dispatch + accum=8 (smaller MoE buffers/activations)"),
    "sort_bf16_scores": (dict(cfg_override=_sort_bf16),
                         "sort dispatch + bf16 attention scores"),
}


def run(cell: str, variant: str, out="results/perf_torch.json", mesh_kind="single"):
    """Count `variant` of `cell` on the production mesh and append its entry to
    `out`.  A variant the port cannot run records its reason (`ok: false`)."""
    arch, shape = CELLS[cell]
    kw, desc = VARIANTS[variant]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec, _ = lower_cell(arch, shape, mesh, **kw)
    entry = {"cell": cell, "arch": arch, "shape": shape, "variant": variant, "desc": desc,
             "ok": rec["ok"]}
    if rec["ok"]:
        rl = rec["roofline"]
        entry.update({
            "t_compute_s": rl["t_compute_s"], "t_memory_s": rl["t_memory_s"],
            "t_collective_s": rl["t_collective_s"], "bottleneck": rl["bottleneck"],
            "roofline_fraction": rl["roofline_fraction"], "flops_ratio": rl["flops_ratio"],
            "temp_gb": None,
            "collective_by_kind_gb": {
                k: v / 1e9 for k, v in rec["hlo"]["collective_by_kind"].items()
            },
            "compile_s": None,
            "count_s": rec["count_s"],
            "port_rank_gb": rec["memory"]["port_rank_bytes"] / 1e9,
            "fits_one_card": rec["memory"]["fits_one_card"],
            "no_counterpart": ["temp_gb", "compile_s"],
        })
    else:
        entry["error"] = rec["error"]
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    results = []
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.append(entry)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(entry, indent=1))
    return entry


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/perf_torch.json")
    a = ap.parse_args()
    run(a.cell, a.variant, out=a.out, mesh_kind=a.mesh)
