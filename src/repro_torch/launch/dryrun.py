"""Dry run of the port: every (architecture x input shape) cell counted on
the production meshes, as the JAX package's `repro/launch/dryrun.py` lowers
and compiles each cell there.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single --out results/dryrun_torch.json

PyTorch has no XLA and no compiled program to read.  A dry run of the port
is its own program on `torch.device("meta")`: the full-width model is built
there and one rank's step runs eagerly on tensors that have shapes and
dtypes and no memory.  Nothing runs on the CPU or on the card, and nothing
is allocated.  The entry points take the meta device and no other.  The
model runs with `backend="ref"`: the kernel wrappers take no meta tensor,
so every count is that of the kernels' plain versions.

One rank's program is what the port's step runs on the mesh: rank 0's
`rank_rows` of each micro-batch (`repro_torch.parallel.sharding`), through
`accumulate_grads` and the optimizer's update, for a train cell;
`Transformer.prefill` of its rows for prefill; `decode_step` of its rows at
position S - 1 (JAX's `serve_step`) for decode.  On the production mesh a
rank takes B / 16 rows (B / 32 with the pod axis).  The state is sharded by
the cell's rules, `make_rules(mesh, model_cfg=cfg)`, as the JAX dry run's
`in_shardings` shard it (`repro_torch.parallel.fsdp.shard_train_state`, and
`shard_model` for prefill and decode): rank 0 holds its blocks of the
parameters (and, training, of the AdamW moments), sliced along "data"
(fsdp, gathered where a group runs, the gradients reduce-scattered) and
along "model" (tp and kv, Megatron tensor parallelism:
`repro_torch.parallel.tensor`; and ep, the MoE experts, E / M of them a
rank), and the ranks along "model" run the layers on their blocks, on the
same rows, with the model axis' all-reduces and the MoE layers'
all-gathers of the experts' outputs.  A prefill or decode cell's rank
holds its block of the decode caches (`Transformer.init_caches`), JAX's
`cache_specs` block: its rows, every KV head on its block of the
attention caches' sequence along "model" (the whole sequence where the
axis does not divide it) and mamba's d_inner channels; at S - 1 only the
last rank of a row writes the new token's k and v.  `rank.repetition`
counts the ranks that run the rank's very program (the ranks along
"model" on a cell whose rules split no leaf along it).
`memory.state_layout` says how the state lies.  The record's keys follow
the JAX record's; where a value has no counterpart it is None and
`no_counterpart` names it:

- `hlo.dot_flops`: the rank's FLOPs under `torch.utils.flop_counter.
  FlopCounterMode` (matrix products and convolutions, as JAX's
  `analyze_hlo` counts dots), the remat recompute included.
  `hlo.dot_flops_jax_view` is the rank's count over `rank.repetition`
  (the ranks that repeat its program do no new work): JAX's per-device
  view, the global count over the mesh's size where the ranks split the
  work.
- `hlo.bytes_accessed`: the bytes of every aten op's tensor inputs and
  outputs (`ByteCounter`); views and metadata-only ops (an allocation
  without a fill) count 0.  Eager PyTorch reads each op's inputs from
  device memory and writes its outputs back, so this is the port's
  traffic, the collectives' local copies (packing, moving a sliced
  dimension to the front, buckets) included.
- `hlo.collective_wire_bytes`: the sum over the train step's collective
  calls of the bytes a rank puts on the wire (`fsdp.WIRE`, counted by the
  calls' meta path in the ring model): along "data" the all-gathers in the
  forward and in the remat recompute, the gradients' reduce-scatters, the
  all-reduces of the whole leaves' f32 gradients with the loss; along
  "model" the layers' all-reduces (forward, recompute and backward), the
  MoE layers' all-gathers of the experts' outputs (forward and recompute)
  and all-reduces of the dispatch input's gradient (backward), the cross
  entropy's and the leaves a region reads whole; the norm's squares
  and the compression's maxima along both.  A prefill or decode cell's:
  each group's, the embedding's and the head's all-gathers along "data"
  (once a call, no recompute), the layers' all-reduces and the MoE
  layers' all-gathers along "model", the logits' all-gather along
  "model" where the head is split, and the attention caches': a
  prefill's all-gather of the KV heads where kv -> "model", a decode
  step's all-gather of q (with the new k and v where kv -> "model"), its
  all-reduce of the score maxima and its reduce-scatter of the partial
  softmax sums where the sequence is split.  `collective_by_kind` splits
  it by kind, `collective_by_axis` by mesh axis and kind, and
  `n_collective_sites` counts the calls.
- `memory.argument_bytes`: the per-rank bytes of the program's arguments
  (state and batch; parameters, caches and tokens for decode) under the
  JAX rules on the mesh (`sanitize_pspec` against each leaf's shape), to
  compare with JAX's.  The port's tokens and labels are int64, JAX's
  int32: the difference is 4 bytes a token or label a device.
  `memory.port_rank_bytes`: what one rank of the port holds, the sum of
  `port_rank_parts`: for train its blocks of the parameters ("params") and
  of the moments ("opt") with the leaves that stay whole, its gradients'
  blocks ("grads": f32 where the step sums them), the largest set of
  blocks one gather makes whole along "data" ("gathered") and the global
  batch every rank is handed; for decode and prefill its blocks of the
  parameters, the largest gather, its block of the caches (JAX's
  per-device cache bytes, `cache_share_bytes`) and its rows' batch.
  `fits_one_card` says whether that is within one H100's 80 GB.
- `roofline`: `analysis/roofline.py::roofline` at `H100_SXM` with the
  rank's FLOPs, bytes and wire bytes and the analytic `model_flops`.

A cell that the port cannot run at all (a data-parallel split of a train,
prefill or decode batch that `check_dispatch_split` refuses) is a record with `ok: false` and the
reason.  `count_s` is the host seconds of the count.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from math import prod

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import H100_SXM, roofline
from repro_torch.checkpoint.checkpointer import flatten_up_to, state_leaves
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, mesh_label
from repro_torch.models.layers.moe import check_dispatch_split
from repro_torch.models.transformer import Transformer, cache_blocks, cache_sequence, param_leaves
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.sharding import Mesh, make_rules, rank_rows, sanitize_pspec, tree_pspecs
from repro_torch.training.optimizer import _stacked_shape
from repro_torch.training.train_step import make_train_step

META = SP.META
NO_COUNTERPART = ["memory.output_bytes", "memory.temp_bytes", "memory.generated_code_bytes",
                  "cost_analysis", "compile_s"]
COUNTS_OF = ("the port's program on the meta device with backend='ref': the kernels' plain "
             "versions (the kernel wrappers take no meta tensor)")

WHOLE = "whole on every rank"

_aten = torch.ops.aten
_METADATA_ONLY = {_aten._unsafe_view, _aten._reshape_alias, _aten.empty, _aten.empty_like,
                  _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
                  _aten.lift_fresh}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs (read once) and
    outputs (written once): an in-place op reads and writes its tensor.
    Views and metadata-only ops count 0."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _METADATA_ONLY:
            ins = tree_flatten((args, {k: v for k, v in kwargs.items() if k != "out"}))[0]
            self.total += sum(_nbytes(t) for t in ins + tree_flatten(out)[0]
                              if isinstance(t, torch.Tensor))
        return out


def count(fn):
    """(fn(), FLOPs, bytes, host seconds) of `fn` run under FlopCounterMode
    and ByteCounter."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        out = fn()
    return out, flops.get_total_flops(), nbytes.total, time.perf_counter() - t0


def shard_bytes(shape: tuple, itemsize: int, spec, mesh: Mesh) -> int:
    """A device's bytes of a leaf under `spec`, sanitized against `shape`."""
    div = 1
    for entry in sanitize_pspec(spec, shape, mesh):
        for ax in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
            div *= mesh.shape[ax]
    return prod(shape) * itemsize // div


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree_bytes(tensors: dict, pspecs: dict, mesh: Mesh) -> int:
    """Sanitized per-device bytes of a nested dict of tensors under the
    matching nested dict of specs."""
    specs = _flat(pspecs)
    return sum(shard_bytes(tuple(t.shape), t.element_size(), specs[k], mesh)
               for k, t in _flat(tensors).items())


def _param_bytes(model, pspecs: dict, mesh: Mesh) -> int:
    """Sanitized per-device bytes of the parameters, leaf by leaf of the JAX
    tree (a per-group leaf stacked over the groups)."""
    named = dict(model.named_parameters())
    specs = _flat(pspecs)
    return sum(shard_bytes(_stacked_shape(named, names), named[names[0]].element_size(),
                           specs[key], mesh)
               for key, names in param_leaves(named).items())


def _state_bytes(state, state_pspecs, mesh: Mesh) -> int:
    """Sanitized per-device bytes of a TrainState, its specs matched leaf by
    leaf as a restore onto the mesh matches them."""
    total = 0
    for (path, ts), spec in zip(state_leaves(state), flatten_up_to(state, state_pspecs)):
        shape = (len(ts), *ts[0].shape) if path.startswith("params/blocks/") else tuple(
            ts[0].shape)
        total += shard_bytes(shape, ts[0].element_size(), spec, mesh)
    return total


def state_layout(sharding, model, rules) -> dict:
    """How a cell's state lies on the mesh: the rules' axes for fsdp,
    tp, kv and ep with their part counts (`ep_parts`: the ranks that split
    the MoE experts, 1 where the model axis does not divide n_experts; ep
    and ep_parts None without MoE layers), and the leaves cut along each."""
    layout = sharding.layout
    data = [n for n in layout if sharding.split(n)]
    along_model = [n for n in layout if sharding.model_split(n)]
    experts = [layout[n].mparts for n in layout if n.endswith("moe.w_in")]
    return {"fsdp": "data", "data_parts": sharding.parts,
            "tp": "model", "kv": rules.axes("kv"), "model_parts": sharding.model_parts,
            "ep": rules.axes("ep") if experts else None,
            "ep_parts": max(experts) if experts else None,
            "split_leaves": len(data), "model_split_leaves": len(along_model),
            "whole_leaves": sum(not (sharding.split(n) or sharding.model_split(n))
                                for n in layout),
            "summed_over_model": len(tensor.summed_over_model(layout)),
            "whole_param_bytes": sum(_nbytes(p) for n, p in model.named_parameters()
                                     if not sharding.split(n)
                                     and not sharding.model_split(n))}


def cache_share_bytes(model, shape_name: str, rules, mesh: Mesh) -> int:
    """JAX's per-device bytes of a serving cell's decode caches: each leaf of
    the whole caches under `sanitize_pspec` of its `cache_specs` spec.
    `model` is the cell's whole model (not yet sharded)."""
    return _tree_bytes(SP.abstract_caches(model, shape_name), SP.cache_pspecs(model, rules),
                       mesh)


def cache_layout(model, max_len: int) -> dict:
    """How a serving cell's decode caches lie on the mesh (the rank's block,
    `Transformer.init_caches`): the rows along "dp"; the attention caches'
    sequence along "model" with rank 0's positions [s0, s1)
    (`cache_sequence`), or whole on every rank where the axis does not
    divide it; the dimension of each position's leaves split along "model"
    ("sequence" of k and v, "d_inner" of mamba's states)."""
    seq = cache_sequence(model.cfg, max_len, model.fsdp)
    split = {}
    for key, leaves in cache_blocks(model.cfg, 1, max_len, model.fsdp).items():
        if any(sh.mdim is not None for sh in leaves.values()):
            split[key] = "sequence" if "k" in leaves else "d_inner"
    return {"rows": "dp", "sequence": WHOLE if seq is None else "model",
            "positions": [0, max_len] if seq is None else [seq.start, seq.stop],
            "model_split": split}


def lower_cell(arch: str, shape_name: str, mesh: Mesh, *, remat: bool = True, accum: int = 4,
               cfg_override=None, extra_metadata: dict | None = None):
    """Count one cell on the meta device.  Returns (record, None): the port
    has no compiled program to hand back.

    accum: gradient-accumulation micro-batches for train cells, 4 as in the
    JAX baseline.  cfg_override: callable(ModelConfig) -> ModelConfig for
    perf experiments.  `mesh` is an abstract `Mesh`; the program runs on
    the meta device, no other (module docstring)."""
    cfg = get_config(arch)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    sh = SHAPES[shape_name]
    kind, S = sh.kind, sh.seq_len
    rules = make_rules(mesh, model_cfg=cfg)
    n_dev = mesh.size
    accum_ = accum if kind == "train" else 1
    mb_rows = sh.global_batch // accum_
    mine = rank_rows(mb_rows, mesh, rules, 0)
    shards = mb_rows // len(mine)
    head = {"arch": arch, "shape": shape_name, "kind": kind, "mesh": mesh_label(mesh),
            "n_devices": n_dev}
    try:
        check_dispatch_split(cfg, shards, mb_rows, 1 if kind == "decode" else S)
    except ValueError as e:
        return {**head, "ok": False, "accum": accum if kind == "train" else None,
                "error": f"the port cannot run this cell data-parallel: {e}",
                **(extra_metadata or {})}, None

    model = Transformer(cfg, device=META, dtype=getattr(torch, cfg.param_dtype), backend="ref")
    batch = SP.input_specs(cfg, shape_name)
    batch_bytes = _tree_bytes(batch, SP.batch_specs_for(cfg, shape_name, rules), mesh)
    n_params = sum(p.numel() for p in model.parameters())
    parts = {}
    if kind == "train":
        opt_cfg = SP.opt_config_for(cfg)
        state = SP.abstract_train_state(model, opt_cfg)
        args = _state_bytes(state, SP.train_state_pspecs(model, rules), mesh) + batch_bytes
        sharding = fsdp.shard_train_state(state, rules, place=(mesh, 0)).params.fsdp
        place = (mesh, 0) if n_dev > 1 and sharding is None else None
        step = make_train_step(model, opt_cfg, accum=accum, remat=remat, place=place)
        fsdp.WIRE.reset()
        _, flops, nbytes, secs = count(lambda: step(state, batch))
        f32_grads = accum > 1 or n_dev > 1  # the step's f32 sums, else the params' dtypes
        parts["opt"] = sum(_nbytes(t) for part in state.opt.values() for t in part.values())
        parts["grads"] = sum(p.numel() * (4 if f32_grads else p.element_size())
                             for p in model.parameters())
        parts["gathered"] = fsdp.WIRE.largest_gather
        parts["batch"] = sum(_nbytes(t) for t in batch.values())  # every rank holds it all
    else:
        model.eval()
        args = _param_bytes(model, tree_pspecs(model.param_specs(), rules), mesh) + batch_bytes
        if kind == "decode":
            args += cache_share_bytes(model, shape_name, rules, mesh)
        sharding = fsdp.shard_model(model, rules, place=(mesh, 0))
        rank_batch = {k: v[mine.start:mine.stop] for k, v in batch.items()}
        fsdp.WIRE.reset()
        if kind == "prefill":
            (_, caches), flops, nbytes, secs = count(
                lambda: model.prefill(rank_batch, max_len=S, dispatch_ranks=shards))
        else:
            caches = model.init_caches(len(mine), S)
            _, flops, nbytes, secs = count(
                lambda: model.decode_step(caches, rank_batch["tokens"], S - 1,
                                          dispatch_ranks=shards))
        parts["gathered"] = fsdp.WIRE.largest_gather
        parts["caches"] = sum(_nbytes(t) for t in _flat(caches).values())
        parts["batch"] = sum(_nbytes(t) for t in rank_batch.values())
    parts = {"params": sum(_nbytes(p) for p in model.parameters()), **parts}  # the rank's
    wire, by_kind, by_axis = fsdp.WIRE.total, dict(fsdp.WIRE.bytes), fsdp.WIRE.by_axis()
    sites = sum(fsdp.WIRE.calls.values())
    layout = WHOLE
    split_along_model = 1  # the ranks along "model" that split the rank's work
    if sharding is not None:
        layout = state_layout(sharding, model, rules)
        if kind != "train":
            layout["caches"] = cache_layout(model, S)
        if layout["model_split_leaves"]:
            split_along_model = sharding.model_parts
    rank_bytes = sum(parts.values())
    mf = SP.model_flops(cfg, shape_name, n_dev)
    rl = roofline(arch=arch, shape=shape_name, mesh=mesh_label(mesh), hlo_flops=flops,
                  hlo_bytes=nbytes, collective_bytes=wire, model_flops=mf, hw=H100_SXM)
    record = {
        **head,
        "ok": True,
        "accum": accum if kind == "train" else None,
        "compile_s": None,
        "count_s": round(secs, 2),
        "device": "meta",
        "counts_of": COUNTS_OF,
        "n_params": n_params,
        "n_params_analytic": cfg.n_params,
        "rank": {"rank": 0, "rows": len(mine), "data_shards": shards,
                 "repetition": n_dev // (shards * split_along_model)},
        "memory": {
            "argument_bytes": args,
            "output_bytes": None,
            "temp_bytes": None,
            "generated_code_bytes": None,
            "token_dtype": "int64",
            "port_rank_bytes": rank_bytes,
            "port_rank_parts": parts,
            "fits_one_card": rank_bytes <= H100_SXM.hbm_per_chip,
            "state_layout": layout,
        },
        "cost_analysis": None,
        "hlo": {
            "dot_flops": flops,
            "dot_flops_jax_view": flops * shards * split_along_model / n_dev,
            "bytes_accessed": nbytes,
            "collective_wire_bytes": wire,
            "collective_by_kind": by_kind,
            "collective_by_axis": by_axis,
            "n_collective_sites": sites,
        },
        "roofline": rl.row(),
        "no_counterpart": NO_COUNTERPART,
        **(extra_metadata or {}),
    }
    return record, None


def run_cells(archs, shapes, meshes, out_path, *, resume=True):
    results = []
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}
    mesh_objs = {m: make_production_mesh(multi_pod=(m == "multi")) for m in meshes}

    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if shape_name not in applicable_shapes(cfg):
                continue
            for mesh in mesh_objs.values():
                key = (arch, shape_name, mesh_label(mesh))
                if key in done:
                    print(f"skip {key} (cached)")
                    continue
                print(f"=== {arch} x {shape_name} x {mesh_label(mesh)} ===", flush=True)
                try:
                    rec, _ = lower_cell(arch, shape_name, mesh)
                    if rec["ok"]:
                        rl = rec["roofline"]
                        print(
                            f"    ok in {rec['count_s']}s  bottleneck={rl['bottleneck']} "
                            f"t=({rl['t_compute_s']:.2e},{rl['t_memory_s']:.2e},"
                            f"{rl['t_collective_s']:.2e})s  frac={rl['roofline_fraction']:.3f}  "
                            f"fits_one_card={rec['memory']['fits_one_card']}",
                            flush=True,
                        )
                    else:
                        print(f"    NOT RUN: {rec['error']}", flush=True)
                except Exception as e:
                    rec = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
                        "ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"    FAIL: {rec['error']}", flush=True)
                results = [r for r in results if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_cells(archs, shapes, meshes, args.out, resume=not args.no_resume)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
