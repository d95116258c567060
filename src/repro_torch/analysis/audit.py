"""The executed-schedule communication model of the 2.5D schedules.

`executed_comm_bytes` counts the per-device wire bytes of a schedule whose
collectives run unconditionally (every rank joins every step's collectives,
with masked payloads), as the JAX package's lowered programs do and as the
port's `core/collectives.py` does.  The cost model prices the collective term
of a distributed candidate with it (`costmodel.predict_wall`).

This module holds only that model, with the bucket helper it shares with the
cost model.  The rest of the JAX package's `repro.analysis.audit` (the
comm-conformance check against the executed volume, the kernel lint, the
cache-key fuzzer) is ROADMAP.md module item 11.
"""

from __future__ import annotations

import math

from repro_torch.core.windows import window_bucket_index, window_buckets


def _ar(bytes_: float, g: int) -> float:
    """Ring all-reduce wire bytes per member (0 for a single-member group,
    which moves nothing)."""
    return 2.0 * bytes_ * (g - 1) / g if g > 1 else 0.0


def _window_caps(nsteps: int) -> list[int]:
    """Per-step window bucket cap (tiles) of the windowed hot loop."""
    buckets = window_buckets(nsteps)
    return [buckets[window_bucket_index(t, nsteps)] for t in range(nsteps)]


def executed_comm_bytes(kind: str, N: int, grid, pivot: str, hotloop: str,
                        compute_itemsize: int) -> dict:
    """Per-device wire bytes of the unconditional 2.5D schedule.

    Returns a per-site breakdown plus "total".  Element size: collectives
    carry f32 partials when the compute dtype is narrower than 4 bytes (the
    kernels accumulate sub-4-byte dtypes in f32), else the compute dtype.
    """
    Px, Py, c, v = grid.Px, grid.Py, grid.c, grid.v
    s = 4.0 if compute_itemsize < 4 else float(compute_itemsize)
    si = 4.0  # pivot-index payloads are int32
    nbi = N // v
    R = (nbi // Px) * v  # local row extent
    C = (nbi // Py) * v  # local col extent
    caps: list[int | None]
    caps = _window_caps(nbi) if hotloop == "windowed" else [None] * nbi

    def wc(cap):  # window col extent owned locally (cols shard over py)
        return C if cap is None else min(-(-cap // Py) * v, C)

    def wr(cap):  # window row extent (rows shard over px; Cholesky only)
        return R if cap is None else min(-(-cap // Px) * v, R)

    out = {"panel": 0.0, "pivot": 0.0, "gids": 0.0, "a00": 0.0,
           "l10": 0.0, "r01": 0.0}
    for cap in caps:
        if kind == "cholesky":
            out["panel"] += _ar(wr(cap) * v * s, c)
            out["a00"] += _ar(v * v * s, Px * Py)
            out["l10"] += _ar(wr(cap) * v * s, Py)
            out["r01"] += _ar(v * wc(cap) * s, Px * c)
            continue
        # LU: rows keep full extent (masked pivot rows stay scattered).
        out["panel"] += _ar(R * v * s, c)
        if pivot == "tournament":
            # log2(Px) butterfly rounds; each exchanges the candidate block
            # (v x v values) and its row ids: wire = payload.
            out["pivot"] += math.log2(Px) * (v * v * s + v * si) if Px > 1 else 0.0
        else:
            # partial: per column, |max| + its owner are combined over px and
            # the pivot row (panel width v) is summed over px.
            out["pivot"] += v * (_ar(s, Px) + _ar(si, Px) + _ar(v * s, Px))
        out["gids"] += _ar(v * si, Py)
        out["a00"] += _ar(v * v * s, Py)
        out["l10"] += _ar(R * v * s, Py)
        out["r01"] += _ar(v * wc(cap) * s, Px * c)
    out["total"] = sum(out.values())
    return out
