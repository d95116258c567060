"""Run `chip_smoke.py`'s MoE span phases alone on one CUDA card: slice 28's
training and serving of one qwen3-moe-235b-a22b layer whose one dispatch
group spans both ranks of the (2, 1) mesh (`chip_smoke.LM_SPAN`).

    python3 tools/span_phases.py

Builds the kernels, runs `chip_smoke.lm_train_sharded` on the span's
training and then on its serving (each a pair of gloo ranks on `cuda:0`)
and `chip_smoke.lm_span` on their results, which prints `dryrun_span`, `lm_train_span_qwen3_moe`,
`lm_serve_span_qwen3_moe` and `profile_lm_serve_span_qwen3_moe` as JSON
lines and raises if a check fails.  Prints the card's name and power limit
first, and the build's, the pair's and the whole run's seconds.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":  # spawned ranks re-import this module
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.time()
    print("build_s", _build.build(), flush=True)
    short = cs.LM_SPAN[4]
    training = cs.lm_train_sharded((f"span_{short}",))
    print("training_pair_s", time.time() - t0, flush=True)
    serving = cs.lm_train_sharded((f"serve_span_{short}",))
    print("serving_pair_s", time.time() - t0, flush=True)
    cs.lm_span(training, serving)
    print("total_s", time.time() - t0, flush=True)
