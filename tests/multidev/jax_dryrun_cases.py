"""The JAX package's dry run on the smoke cells, for the port's tests.

    python tests/multidev/jax_dryrun_cases.py OUT.json

Lowers and compiles `repro.launch.dryrun.lower_cell` on the cells of
`tests/multidev/run_dryrun_smoke.py` (the reduced qwen3-moe, `train_4k` at
S = 128, B = 16 and `decode_32k` at S = 256, B = 16, accum = 2) on a 4x4
("data", "model") mesh, and the train cell with 4 MoE dispatch groups on
4x4 and on a data-only 4x1 mesh, with and without remat; the decode cell
and `prefill_32k` at S = 64, B = 8 on 4x4 with 4 dispatch groups and with
the config's 2 (each of which spans 2 of the port's data ranks); writes each
record's numbers, the production meshes' shapes and labels and
`repro.launch.perf.VARIANTS`' descriptions to OUT.json.
`tests/test_torch_dryrun.py` holds the port's dry run to them.  Importing
`repro.launch.dryrun` forces 512 host devices, so this runs in a process
of its own.
"""

from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402

import repro.configs as C  # noqa: E402
import repro.launch.dryrun as dr  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.launch import perf  # noqa: E402
from repro.launch.mesh import make_production_mesh, mesh_label  # noqa: E402

SMOKE_SHAPES = {"train_4k": (128, 16), "decode_32k": (256, 16), "prefill_32k": (64, 8)}  # (S, B)
# name -> (mesh shape, shape, n_dispatch_groups or None for the config's, remat)
CELLS = {
    "4x4/train": ((4, 4), "train_4k", None, True),
    "4x4/train/noremat": ((4, 4), "train_4k", None, False),
    "4x4/decode": ((4, 4), "decode_32k", 4, True),
    "4x4/prefill": ((4, 4), "prefill_32k", 4, True),
    "4x4/decode/g2": ((4, 4), "decode_32k", None, True),
    "4x4/prefill/g2": ((4, 4), "prefill_32k", None, True),
    "4x4/train/g4": ((4, 4), "train_4k", 4, True),
    "4x4/train/g4/noremat": ((4, 4), "train_4k", 4, False),
    "4x1/train/g4": ((4, 1), "train_4k", 4, True),
    "4x1/train/g4/noremat": ((4, 1), "train_4k", 4, False),
}


def groups(n):
    if n is None:
        return None
    return lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_dispatch_groups=n))


def main(out: str) -> None:
    for name, (S, B) in SMOKE_SHAPES.items():
        C.SHAPES[name] = dataclasses.replace(C.SHAPES[name], seq_len=S, global_batch=B)
    C.ARCHS["smoke"] = reduced(get_config("qwen3-moe-235b-a22b"), groups=2)
    cells = {}
    for name, (mesh_shape, shape, n, remat) in CELLS.items():
        mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        rec, _ = dr.lower_cell("smoke", shape, mesh, accum=2, remat=remat, cfg_override=groups(n))
        cells[name] = {"memory": rec["memory"], "hlo": rec["hlo"],
                       "model_flops": rec["roofline"]["model_flops"],
                       "compile_s": rec["compile_s"]}
    meshes = {}
    for kind in ("single", "multi"):
        m = make_production_mesh(multi_pod=kind == "multi")
        meshes[kind] = {"shape": list(m.devices.shape), "axes": list(m.axis_names),
                        "label": mesh_label(m)}
    with open(out, "w") as fh:
        json.dump({"cells": cells, "meshes": meshes,
                   "variants": {k: d for k, (_, d) in perf.VARIANTS.items()}}, fh)


if __name__ == "__main__":
    main(sys.argv[1])
