"""Time `adamw_update` over a full-width model's state with its large leaves
updated in flat slices (`optimizer.ADAMW_SLICE`) and whole, on one CUDA card.

    python3 tools/adamw_slices.py

For each state of `STATES` (qwen3-8b at full width: `chip_smoke.py`'s
`lm_train_qwen3` state, 4 layers with bf16 parameters, and `lm_train_dp`'s,
2 layers in f32; AdamW with f32 moments) the tool draws random gradients in
the parameters' dtype and runs the update in turns (sliced, whole, whole,
sliced), REPS times a turn.  Each turn prints a JSON line: the median time
of one update (CUDA events; host launch time included), and the device
memory the update allocated beyond the state and the gradients
(`max_memory_allocated` less what was allocated before it).  Whole is
`ADAMW_SLICE` set past every leaf's size, which is the update before the
slices; both compute the same arithmetic per element, so the tool also
checks that their parameters and moments end equal bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STATES = (("qwen3-8b", 4, torch.bfloat16), ("qwen3-8b", 2, torch.float32))
REPS = 5


def _update_ms(params, grads, state, opt_cfg, slice_elems: int) -> tuple[float, float]:
    from repro_torch.training import optimizer

    optimizer.ADAMW_SLICE = slice_elems
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        optimizer.adamw_update(params, grads, state.opt, state.step, opt_cfg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    extra = (torch.cuda.max_memory_allocated() - before) / 2**30
    return statistics.median(times), extra


def main() -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state
    from repro_torch.training import optimizer

    if not torch.cuda.is_available():
        print("adamw_slices: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    sliced = optimizer.ADAMW_SLICE
    ok = True
    for arch, layers, dtype in STATES:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        opt_cfg = OptConfig(warmup_steps=2)
        kept = {}
        for name, elems in (("sliced", sliced), ("whole", 1 << 62)):
            model = build_model(cfg, dtype=dtype, seed=0)
            state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0),
                                     opt_cfg)
            params = dict(model.named_parameters())
            gen = torch.Generator(device=model.device).manual_seed(1)
            grads = {n: torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
                     for n, p in params.items()}
            _update_ms(params, grads, state, opt_cfg, elems)  # warm-up, and the state to hold
            kept[name] = (model, params, grads, state)
        turns = []
        for name in ("sliced", "whole", "whole", "sliced"):
            model, params, grads, state = kept[name]
            ms, extra = _update_ms(params, grads, state, opt_cfg,
                                   sliced if name == "sliced" else 1 << 62)
            turns.append((name, ms))
            print(json.dumps({"state": f"{arch} {layers} layers", "dtype": str(dtype),
                              "params": sum(p.numel() for p in params.values()),
                              "update": name, "slice_elems": sliced, "reps": REPS,
                              "ms": ms, "extra_gib": extra}), flush=True)
        equal = all(
            torch.equal(kept["sliced"][1][n], kept["whole"][1][n]) for n in kept["sliced"][1]
        ) and all(torch.equal(a, b) for part in ("m", "v")
                  for a, b in zip(kept["sliced"][3].opt[part].values(),
                                  kept["whole"][3].opt[part].values()))
        ok &= equal
        print(json.dumps({"state": f"{arch} {layers} layers", "dtype": str(dtype),
                          "bit_equal": equal,
                          "ms_sliced": [t for n, t in turns if n == "sliced"],
                          "ms_whole": [t for n, t in turns if n == "whole"]}), flush=True)
        del kept, model, params, grads, state
        torch.cuda.empty_cache()
    optimizer.ADAMW_SLICE = sliced
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
