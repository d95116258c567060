"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, `plan(N).execute(A).solve(b)` at N = 16384 in
float32, through its hand-written CUDA kernels, and holds each kernel against
its plain PyTorch version on the card.  Phases print JSON lines; any failure
raises, so the exit code is not 0.  The second-to-last line lists the kernels
with their launches, errors and times; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It needs a CUDA card and the repository's `src/` beside it, and builds the
kernels from `src/repro_torch/kernels/csrc/` at first use.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

N = 16384
# Published H100 SXM rates (NVIDIA data sheet, at the full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# fused_trsm_schur against its plain version: the two sum the v-term
# contraction in different orders, each term rounding by up to eps_f32 =
# 6e-8 of its size, so v = 32 terms drift by ~2e-6 of the result's scale.
# Five times that is the bound.
FUSED_REL_TOL = 1e-5
# Kernel path against plain path over a whole factorization at N = 1024:
# each path's factors drift from the exact ones by up to about
# N * eps_f32 * max|F| (the plain path on the CPU against a float64
# factorization of a standard normal matrix: 1.2e-4 of max|F| at N = 1024),
# and the two paths round differently.  Twice the sum of the two drifts is
# the bound.
LU_F_TOL_FACTOR = 4.0
HPL_RESIDUAL_MAX = 16.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def hpl_residual(A, x, b) -> float:
    """HPL's scaled residual ||Ax - b||_inf / (eps (||A||_inf ||x||_inf + ||b||_inf) N)."""
    A64, x64, b64 = A.double(), x.double(), b.double()
    r = (A64 @ x64 - b64).abs().max()
    norm_a = A64.abs().sum(dim=1).max()
    eps = torch.finfo(A.dtype).eps
    scale = eps * (norm_a * x64.abs().max() + b64.abs().max()) * A.shape[0]
    return float(r / scale)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import SolverConfig, plan
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import fused_schur as fs_mod
    from repro_torch.kernels import lu_panel as lp_mod

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=kind, torch=torch.__version__,
         cuda=torch.version.cuda, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build every kernel from the sources, one nvcc each, in parallel.
    build_s = _build.build()
    regs = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln]
            for name, text in _build.build_log.items()}
    emit("build", seconds=build_s, ptxas=regs)

    # 3. Each kernel against its plain version at the main path's shapes.
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(N, N, generator=gen, device=dev)
    v = 32

    panel = A[:, 2 * v:3 * v]  # a strided column slice, as the main path passes
    weights = (torch.rand(N, generator=gen, device=dev) > 0.1).float()
    F_k, order_k, ok_k = lp_mod.lu_panel(panel, weights)
    F_p, order_p, ok_p = ref.lu_panel(panel, weights)
    torch.cuda.synchronize()
    masked = weights == 0
    panel_check = {
        "order_equal": torch.equal(order_k, order_p),
        "ok_equal": torch.equal(ok_k, ok_p),
        "F_bit_identical": torch.equal(F_k, F_p),
        "masked_rows_untouched": torch.equal(F_k[masked], panel[masked]),
        "max_abs_err": float((F_k - F_p).abs().max()),
    }
    emit("kernel_lu_panel", shape=[N, v], weight0_rows=int(masked.sum()), **panel_check)
    if not all(panel_check[k] for k in
               ("order_equal", "ok_equal", "F_bit_identical", "masked_rows_untouched")):
        raise AssertionError(f"lu_panel disagrees with its plain version: {panel_check}")
    n_w1 = int((weights > 0).sum())
    panel_bytes = 4 * (2 * N * v + N) + 5 * v
    panel_ops = sum(N + max(n_w1 - k - 1, 0) * (1 + 2 * (v - k - 1)) for k in range(v))
    panel_row = {
        "name": "lu_panel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lu_panel.cu",
        "replaces": "src/repro/kernels/lu_panel.py:71",
        "max_abs_err": panel_check["max_abs_err"],
        "ms": time_ms(lambda: lp_mod.lu_panel(panel, weights)),
        "plain_ms": time_ms(lambda: ref.lu_panel(panel, weights), reps=3),
        "bound_ms": 1e3 * max(panel_bytes / HBM_BYTES_PER_S, panel_ops / FP32_FLOPS),
        "bound_by": ("bytes" if panel_bytes / HBM_BYTES_PER_S >= panel_ops / FP32_FLOPS
                     else "operations"),
        "library_ms": None,
        "library": "none: no single PyTorch call computes a masked LUP with row weights",
    }
    del F_k, F_p

    fused_rows = []
    for M, C, vv, unit in ((N, N, v, True), (2048, 1536, 16, False)):
        Am = A[:M, :C]
        L00 = (0.3 * torch.tril(torch.randn(vv, vv, generator=gen, device=dev), -1)
               + (1.0 if unit else 2.0) * torch.eye(vv, device=dev))
        R01 = torch.randn(vv, C, generator=gen, device=dev)
        L10 = torch.randn(M, vv, generator=gen, device=dev)
        out_k, U_k = ops.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
        out_p, U_p = ref.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
        torch.cuda.synchronize()
        err = max(float((out_k - out_p).abs().max()), float((U_k - U_p).abs().max()))
        scale = max(float(out_p.abs().max()), float(U_p.abs().max()))
        emit("kernel_fused_trsm_schur", shape=[M, C, vv], unit=unit, max_abs_err=err,
             rel_err=err / scale, tol_rel=FUSED_REL_TOL)
        if not err <= FUSED_REL_TOL * scale:
            raise AssertionError(f"fused_trsm_schur [{M}, {C}, {vv}] off by {err} (scale {scale})")
        del out_k, out_p, U_k, U_p
        if M != N:
            continue
        fused_bytes = 4 * (2 * M * C + vv * vv + 2 * vv * C + M * vv)
        fused_ops = 2 * M * C * vv + vv * vv * C

        def library():
            U = torch.linalg.solve_triangular(L00, R01, upper=False, unitriangular=True)
            return torch.addmm(Am, L10, U, alpha=-1.0)

        fused_rows.append({
            "name": "fused_trsm_schur", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_schur.cu",
            "replaces": "src/repro/kernels/fused_schur.py:83",
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.fused_trsm_schur(Am, L00, R01, L10)),
            "plain_ms": time_ms(lambda: ref.fused_trsm_schur(Am, L00, R01, L10)),
            "bound_ms": 1e3 * max(fused_bytes / HBM_BYTES_PER_S, fused_ops / FP32_FLOPS),
            "bound_by": ("bytes" if fused_bytes / HBM_BYTES_PER_S >= fused_ops / FP32_FLOPS
                         else "operations"),
            "library_ms": time_ms(library),
            "library": "torch.linalg.solve_triangular + torch.addmm (two calls)",
        })

    # 4. The main path, through the entry points, on the default config and device.
    A_main = torch.randn(N, N, generator=gen, device=dev)
    b_main = torch.randn(N, generator=gen, device=dev)
    p = plan(N)
    lp_mod.lu_panel.launches = 0
    fs_mod.fused_trsm_schur.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A_main)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = {"lu_panel": lp_mod.lu_panel.launches,
                "fused_trsm_schur": fs_mod.fused_trsm_schur.launches}
    t0 = time.perf_counter()
    x = fact.solve(b_main)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    resid = hpl_residual(A_main, x, b_main)
    emit("main_path", N=N, v=p.config.v, strategy=fact.strategy, backend=fact.backend,
         launches=launches, execute_s=execute_s, solve_s=solve_s, hpl_residual=resid,
         x_finite=bool(torch.isfinite(x).all()), x_shape=list(x.shape))
    if fact.backend != "cuda":
        raise AssertionError(f"main path ran backend {fact.backend!r}, not 'cuda'")
    if launches != {"lu_panel": N // v, "fused_trsm_schur": N // v}:
        raise AssertionError(f"expected {N // v} launches of each kernel, got {launches}")
    if not (torch.isfinite(x).all() and resid < HPL_RESIDUAL_MAX):
        raise AssertionError(f"HPL scaled residual {resid} >= {HPL_RESIDUAL_MAX}")
    rows_main = fact.rows
    del fact, x

    # Where the time goes: one more execute, under the profiler.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p.execute(A_main)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:60]
            entry = by_kernel.setdefault(name, [0.0, 0])
            entry[0] += ev.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    emit("profile_execute", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         top=[{"kernel": k, "ms": ms, "count": n} for k, (ms, n) in top])

    # The library's LU at the same N, as a yardstick only.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LU, piv = torch.linalg.lu_factor(A_main)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_lib = torch.linalg.lu_solve(LU, piv, b_main[:, None])[:, 0]
    torch.cuda.synchronize()
    emit("yardstick_torch_lu", factor_s=lib_factor_s, solve_s=time.perf_counter() - t0,
         hpl_residual=hpl_residual(A_main, x_lib, b_main),
         note="torch.linalg.lu_factor + lu_solve; the port never calls them")
    del LU, piv, x_lib

    # 5. The plain path on the card, against the kernel path.
    A_small = torch.randn(1024, 1024, generator=gen, device=dev)
    f_k = plan(1024).execute(A_small)
    f_p = plan(1024, SolverConfig(backend="ref")).execute(A_small)
    f_err = float((f_k.F - f_p.F).abs().max())
    f_tol = LU_F_TOL_FACTOR * 1024 * torch.finfo(torch.float32).eps * float(f_p.F.abs().max())
    rows_equal = torch.equal(f_k.rows, f_p.rows)
    emit("plain_path_1024", rows_equal=rows_equal, F_max_abs_err=f_err, tol=f_tol,
         F_max_abs=float(f_p.F.abs().max()))
    if not (rows_equal and f_err <= f_tol):
        raise AssertionError(f"kernel and plain paths differ at N=1024: rows_equal="
                             f"{rows_equal}, F error {f_err}")
    t0 = time.perf_counter()
    f_ref = plan(N, SolverConfig(backend="ref")).execute(A_main)
    torch.cuda.synchronize()
    ref_execute_s = time.perf_counter() - t0
    diff = (f_ref.rows != rows_main).nonzero()
    emit("plain_path_16384", execute_s=ref_execute_s,
         first_pivot_difference=int(diff[0]) if len(diff) else None,
         hpl_residual_plain=hpl_residual(A_main, f_ref.solve(b_main), b_main),
         hpl_residual_kernels=resid)

    panel_row["launches"] = launches["lu_panel"]
    for row in fused_rows:
        row["launches"] = launches["fused_trsm_schur"]
    for row in (panel_row, *fused_rows):
        row["kernel_ms"] = row["ms"]
    print(json.dumps({"kernels": [panel_row, *fused_rows],
                      "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
