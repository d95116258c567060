"""Training entry point: trains a model from a seed on synthetic data through
the fault-tolerant loop, checkpointing as it goes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir CKPT_DIR [--device cpu]

Without --device it runs on the CUDA card (a CPU-only host raises).  A run
resumes from the latest checkpoint in --ckpt-dir.  Training across several
cards (the JAX package's data-parallel mesh) waits for the port of
`parallel/` (ROADMAP.md module item 13): on a host with more than one card
it raises; pick one with CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
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
    dev = resolve_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} CUDA devices: training across them (the JAX "
            f"package's data-parallel mesh) waits for the port of parallel/ (ROADMAP.md "
            f"module item 13); pick one card with CUDA_VISIBLE_DEVICES")
    model = build_model(cfg, device=dev)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    run_cfg = RunConfig(total_steps=args.steps, ckpt_every=args.ckpt_every)
    ckpt = Checkpointer(args.ckpt_dir)
    out = run_training(model, data_cfg, opt_cfg, run_cfg, ckpt,
                       train_step_kw={"accum": args.accum,
                                      "compress_bits": args.compress_bits or None})
    final = out["metrics"][-1] if out["metrics"] else {}
    loss = final.get("loss")
    print(f"done: steps={final.get('step')} loss={'none' if loss is None else f'{loss:.4f}'} "
          f"restarts={out['restarts']} straggler_alarms={out['straggler_alarms']}")
    return out


if __name__ == "__main__":
    main()
