"""The JAX package's audit rows, for the port's tests.

    python tests/multidev/jax_audit_cases.py OUT.json

Writes `repro.analysis.audit.bench_audit_rows(N=64, v=8)` (the
comm-conformance rows of every plan combo, distributed ones on 8 forced
host devices) to OUT.json.  `tests/test_torch_audit.py` holds the port's
`schedule_bytes` and `lower_bound_bytes` to them.  `repro.api` imports
`jax.experimental.enable_x64`, which jax 0.9.0 calls `jax.enable_x64`; this
process sets that name before the import, in a process of its own so that
the shim never reaches the test process.
"""

from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import warnings  # noqa: E402

from repro.analysis.audit import bench_audit_rows  # noqa: E402


def main(out: str) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rows = bench_audit_rows(N=64, v=8)
    keep = ("strategy", "backend", "hotloop", "pivot", "compute_dtype", "N", "grid",
            "schedule_bytes", "lower_bound_bytes", "predicted_bytes", "extracted_bytes")
    with open(out, "w") as fh:
        json.dump({"rows": [{k: r.get(k) for k in keep} for r in rows["rows"]],
                   "errors": rows["errors"]}, fh)


if __name__ == "__main__":
    main(sys.argv[1])
