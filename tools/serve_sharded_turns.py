"""Serve `chip_smoke.py`'s sharded configurations (`LM_SERVE_SHARDED`) from
several trees of this repository in turns, on one CUDA card.

    python3 tools/serve_sharded_turns.py [--out PATH] TREE [TREE ...]

Each TREE is the root of a copy of the repository (unpack another commit
with `git archive <commit> | tar -x -C DIR` under a gitignored directory
such as `build/`, and pass `.` for this one).  The tool runs, for each TREE
in the order given (name the two trees as parent, change, change, parent),
a process of its own in that tree that builds its kernels and calls its
`chip_smoke.lm_train_sharded` on the serving configurations: a pair of
gloo ranks on `cuda:0`, rank 0 under the profiler.  It writes each run's
prefill seconds, ms a decode step, collective seconds, wire bytes and
cache bytes per rank, with rank 0's idle share and wall, to PATH
(`results/serve_sharded_turns.json` by default), and prints the card's
name and power limit and each run's ms a decode step.  Exits non-zero when
a run fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ONE_TREE = r'''
import json, sys
sys.path[:0] = [".", "src"]
if __name__ == "__main__":
    import chip_smoke as cs
    from repro_torch.kernels import _build
    build_s = _build.build()
    runs, spawn_s, _ = cs.lm_train_sharded(tuple(f"serve_{c[0]}" for c in cs.LM_SERVE_SHARDED))
    keep = ("prefill_s", "ms_per_decode_step", "collective_s", "wire_decode_steps",
            "wire_prefill", "decode_steps", "cache_bytes")
    print("RESULT " + json.dumps({"build_s": build_s, "spawn_s": spawn_s, "runs": {
        k: [{f: r.get(f) for f in keep} | {"idle": r.get("profile", {}).get("device_idle_share"),
             "wall_ms": r.get("profile", {}).get("wall_ms")} for r in v]
        for k, v in runs.items()}}))
'''
TIMEOUT_S = 600  # one tree's run, its build included


def main(trees: list[str], out_path: Path) -> int:
    out = []
    for tree in trees:
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", ONE_TREE], cwd=tree, capture_output=True,
                              text=True, timeout=TIMEOUT_S)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        rec = {"tree": tree, "rc": proc.returncode, "seconds": time.time() - t0,
               "result": json.loads(line[-1][len("RESULT "):]) if line else None,
               "stderr_tail": proc.stderr[-3000:] if proc.returncode else ""}
        out.append(rec)
        print(json.dumps({k: rec[k] for k in ("tree", "rc", "seconds")}), flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    for rec in out:
        runs = (rec["result"] or {}).get("runs", {})
        print(rec["tree"], {k: [round(x["ms_per_decode_step"], 2) for x in v]
                            for k, v in runs.items()})
    return max(rec["rc"] for rec in out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=Path("results/serve_sharded_turns.json"))
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    sys.exit(main(args.trees, args.out))
