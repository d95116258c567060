"""Per-primitive wall-time profiling of the factorization hot loop.

The profiler times each backend primitive standalone on the plan's
*representative local shapes*: the [R, v] panel, the [v, v] triangle, and
the mid-schedule trailing window (the power-of-two bucket at t = nsteps/2,
what an average step touches), best of `repeats`.  Each call is timed on
the host clock and, on a CUDA device, ends in `torch.cuda.synchronize()`:
the clock `FactorizationPlan.execute` stamps its measured wall with, so the
cost model's residual compares like with like.

Rows:
  panel_us        the panel factorization (LUP, or the Cholesky block)
  trsm_us         the triangular solve of the step
  schur_us        the rank-v update
  fused_us        the fused TRSM -> Schur primitive (trsm + schur in one call)
  gather_us       indexed pivot-row / diagonal-block movement (`index_select`,
                  or a slice for Cholesky)
  gather_dense_us the one-hot S.T @ A product the JAX package once used
                  for that movement (measured for the table; the port's
                  step never runs it)

The profiled shapes and primitives follow the strategy kind: LU plans time
panel_lup / trsm_left_lower(unit=True) / the row gather; Cholesky plans
(pivot == "none") time panel_chol / trsm_right_upper against L00^T / a
slice of the diagonal block's rows, and the fused call runs unit=False.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.windows import window_buckets


def _time_once(fn, args, sync) -> float:
    t0 = time.perf_counter()
    fn(*args)
    sync()
    return (time.perf_counter() - t0) * 1e6


def _best_of_interleaved(entries: list[tuple[str, object, tuple]], repeats: int = 3,
                         sync=lambda: None) -> dict[str, dict]:
    """Interleaved best-of-`repeats` over all primitives at once.

    A first pass over every entry, outside every timer, builds the kernels
    and warms the caches.  Then each round times every primitive once, so
    a load spike during one round lands on every primitive instead of
    skewing one primitive's ratio against the others; the per-primitive
    relative spread (worst/best - 1) tells the fitter how noisy each sample
    was.  `sync` waits for the device after each call.

    entries: (name, fn, args); returns {name: {"best_us", "spread"}}.
    """
    for _, fn, args in entries:  # build / warm up outside every timer
        fn(*args)
    sync()
    samples: dict[str, list[float]] = {name: [] for name, _, _ in entries}
    for _ in range(max(repeats, 1)):
        for name, fn, args in entries:
            samples[name].append(_time_once(fn, args, sync))
    out = {}
    for name, ts in samples.items():
        best = min(ts)
        spread = (max(ts) / best - 1.0) if best > 0 else 0.0
        out[name] = {"best_us": best, "spread": spread}
    return out


def profile_primitives(N: int, config, grid=None, repeats: int = 3, device=None) -> dict:
    """Wall-time the hot-loop primitives on the plan's local shapes.

    Returns microsecond floats keyed panel_us / trsm_us / schur_us /
    gather_us / gather_dense_us / fused_us, a `<name>_spread` relative
    best-to-worst spread per primitive (the cost-model fitter's noise
    weight), plus the shapes profiled.  Inputs come from
    `numpy.random.default_rng(0)`, on `device` (None: the CUDA card) in the
    compute dtype.
    """
    from repro_torch.api.config import resolve_dtype
    from repro_torch.device import resolve_device
    from repro_torch.kernels.backend import get_backend

    bk = get_backend(config.backend)
    dev = resolve_device(device)
    # profile in the dtype the kernels run in (mixed-precision plans compute
    # in config.compute_dtype, not the working dtype)
    dtype = resolve_dtype(getattr(config, "effective_compute_dtype", config.dtype))
    if grid is not None:
        v = grid.v
        R = (N // v // grid.Px) * v
        C = (N // v // grid.Py) * v
        nb = N // v
        # mid-schedule window: the bucket an average step lands in
        cap = min(b for b in window_buckets(nb) if b >= nb - nb // 2)
        wr = min(-(-cap // grid.Px), R // v) * v
        wc = min(-(-cap // grid.Py), C // v) * v
    else:
        v = config.v or 32
        R = C = N
        wr, wc = R, C
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(device=dev, dtype=dtype)

    panel = arr(R, v)
    weights = torch.ones(R, dtype=dtype, device=dev)
    eye = torch.eye(v, dtype=dtype, device=dev)
    tri = torch.tril(arr(v, v), -1) + 2.0 * eye
    A = arr(wr, wc)
    L10 = arr(wr, v)
    R01 = arr(v, wc)
    Afull = arr(R, C)
    lr = torch.arange(v, device=dev) * max(R // v, 1)
    own = torch.ones(v, dtype=dtype, device=dev)
    S = torch.nn.functional.one_hot(lr, R).to(dtype)  # [v, R]: the one-hot product

    if config.pivot == "none":
        spd = tri @ tri.T + eye
        panel_fn, panel_args = bk.panel_chol, (spd,)
        # step 4's solve: L10 = panel (L00^T)^-1
        trsm_fn, trsm_args = (lambda p, l: bk.trsm_right_upper(p, l.T)), (panel, tri)
        # diagonal-block rows live contiguously: a masked slice
        gather_fn, gather_args = (lambda a, i, o: a.narrow(0, i, v) * o), (Afull, R - v, own[0])
        unit = False
    else:
        panel_fn, panel_args = (lambda p, w: bk.panel_lup(p, w, v)), (panel, weights)
        trsm_fn, trsm_args = (lambda l, b: bk.trsm_left_lower(l, b, unit=True)), (tri, R01)
        gather_fn, gather_args = ((lambda a, i, o: a.index_select(0, i) * o[:, None]),
                                  (Afull, lr, own))
        unit = True

    entries = [
        ("panel", panel_fn, panel_args),
        ("trsm", trsm_fn, trsm_args),
        ("schur", bk.schur_update, (A, L10, R01)),
        ("fused", lambda a, l00, r01, l10: bk.fused_trsm_schur(a, l00, r01, l10, unit=unit),
         (A, tri, R01, L10)),
        ("gather", gather_fn, gather_args),
        ("gather_dense", torch.matmul, (S, Afull)),
    ]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    measured = _best_of_interleaved(entries, repeats=repeats, sync=sync)
    timings = {}
    for name, m in measured.items():
        timings[f"{name}_us"] = m["best_us"]
        timings[f"{name}_spread"] = m["spread"]
    timings["shapes"] = {"R": R, "C": C, "v": v, "wr": wr, "wc": wc}
    return timings
