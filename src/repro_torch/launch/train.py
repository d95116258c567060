"""Training entry point: trains a model from a seed on synthetic data through
the fault-tolerant loop, checkpointing as it goes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir CKPT_DIR [--device cpu]

Without --device it runs on the CUDA card (a CPU-only host raises).  A run
resumes from the latest checkpoint in --ckpt-dir.

Across cards, data-parallel as the JAX launcher's (n_dev, 1) ("data",
"model") mesh, under torchrun, one card a rank:

    torchrun --standalone --nproc-per-node=N -m repro_torch.launch.train \
        --arch qwen3-8b --reduced --steps 100 --batch 8 --seq 64

Under torchrun (WORLD_SIZE in the environment, with RANK, LOCAL_RANK and
the rendezvous address), each rank joins an "nccl" group on card
LOCAL_RANK ("gloo" with --device cpu) and trains on its share of each
global batch (`repro_torch.training.make_train_step(group=...)`).  The
state is sharded as the JAX launcher's rules say, `make_rules(mesh,
model_cfg=cfg)` on the (R, 1) mesh, whose fsdp -> "data" gives each rank
its slices of the parameters and AdamW moments (`repro_torch.parallel.
fsdp`): each rank draws the one-card parameters from the seed and keeps
its slices.  Every rank takes part in a checkpoint's save; rank 0 writes
it and prints the `done:` line.  One card allows NCCL only at world size 1
(`--nproc-per-node=1`: a group of one, whose rules split no leaf: the
one-card step).  Without torchrun it trains on one card as before.  The
launcher keeps the (R, 1) mesh and has no mesh flag, as the JAX launcher
(`repro/launch/train.py`) builds a (n_dev, 1) mesh; a ("data", "model")
mesh of another shape, tensor-parallel along "model", is reached through
`run_training(rules=..., mesh=...)` or `init_train_state(rules=...,
group=..., mesh=...)` (`repro_torch.parallel.tensor`).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel.sharding import Mesh, make_rules
from repro_torch.runtime.loop import RunConfig, run_training
from repro_torch.training.optimizer import OptConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-bits", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, groups=args.groups)
    world = int(os.environ.get("WORLD_SIZE", "0"))  # set by torchrun
    group = None
    if world:
        cpu = args.device == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("gloo" if cpu else "nccl")
        group = dist.group.WORLD
        logging.info("data-parallel: rank %d of %d (%s), the state laid out by the rules of the "
                     "(%d, 1) (\"data\", \"model\") mesh", dist.get_rank(), world,
                     dist.get_backend(), world)
    dev = resolve_device(args.device)  # a rank's card is the current one
    try:
        out = _train(args, cfg, dev, group)
    finally:
        if group is not None:
            dist.destroy_process_group()
    return out


def _train(args, cfg, dev, group) -> dict:
    model = build_model(cfg, device=dev)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    run_cfg = RunConfig(total_steps=args.steps, ckpt_every=args.ckpt_every)
    ckpt = Checkpointer(args.ckpt_dir)
    rules = None
    if group is not None:
        rules = make_rules(Mesh((dist.get_world_size(group), 1), ("data", "model")), model_cfg=cfg)
    out = run_training(model, data_cfg, opt_cfg, run_cfg, ckpt,
                       train_step_kw={"accum": args.accum,
                                      "compress_bits": args.compress_bits or None},
                       group=group, rules=rules)
    if group is not None and dist.get_rank(group) != 0:
        return out
    final = out["metrics"][-1] if out["metrics"] else {}
    loss = final.get("loss")
    print(f"done: steps={final.get('step')} loss={'none' if loss is None else f'{loss:.4f}'} "
          f"restarts={out['restarts']} straggler_alarms={out['straggler_alarms']}")
    return out


if __name__ == "__main__":
    main()
