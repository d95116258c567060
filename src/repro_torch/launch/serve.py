"""Serving entry point: loads the latest checkpoint of a training run (or
draws random parameters from a seed) and serves batched generation requests
with the static-batch engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b [--reduced] \\
        [--ckpt-dir /tmp/repro_ckpt] [--device cpu] [--max-new 16]

Without --device it runs on the CUDA card.  --ckpt-dir restores a
`TrainState` of the default `OptConfig` (what `launch.train` writes, or the
JAX package's checkpoint of the same config) into the model.

The launcher serves on one device and takes no mesh, as the JAX launcher
(`repro/launch/serve.py`) does.  A model whose state is sharded is served
through the API, every rank of the group calling the same code:
`build_model`, then `repro_torch.parallel.fsdp.shard_model(model, rules,
group=..., mesh=Mesh((D, M), ("data", "model")))` (or
`init_train_state(..., rules=..., group=..., mesh=...)`), `Checkpointer.
restore` onto that layout (checkpoints are stored whole), and
`ServeEngine(model, ...)`, which runs each rank's rows on its blocks and
returns the same completions on every rank.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models.model_zoo import build_model
from repro_torch.serving import SamplerConfig, ServeEngine
from repro_torch.training import OptConfig, init_train_state


def main(argv=None) -> list[list[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, groups=args.groups)
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    model = build_model(cfg, device=args.device)
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            gen = torch.Generator(device=model.device).manual_seed(0)
            ckpt.restore(init_train_state(model, gen, OptConfig()))
            model.eval().requires_grad_(False)
            print(f"restored step {ckpt.latest_step()}")
    engine = ServeEngine(
        model, max_len=args.max_len, batch_size=args.batch,
        sampler=SamplerConfig(temperature=args.temperature, max_new_tokens=args.max_new),
        device=args.device,
    )
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len * 2, global_batch=args.batch)
    prompts = synthetic_batch(dc, 123)["tokens"][:, : args.prompt_len].tolist()
    outs = engine.generate(prompts)
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"[{i}] prompt={p[:8]}... -> {o}")
    print(json.dumps({"arch": cfg.name, "device": str(model.device), **engine.stats}))
    return outs


if __name__ == "__main__":
    main()
