"""Analysis: the plan auditor and the program trace it reads, the roofline,
and the trace-calibrated cost model behind `strategy="auto"`.

The JAX package's `analyze_hlo` / `HloReport` read StableHLO, which PyTorch
does not emit; the port's counterpart is `analyze_trace` over a plan's
`lowered_text("trace")`.
"""

from repro_torch.analysis.costmodel import (
    Calibration,
    PrimitiveFit,
    autotune_choice,
    fit_calibration,
    load_calibration,
    predict_wall,
    reset_calibration,
    set_calibration,
)
from repro_torch.analysis.roofline import H100_SXM, TPU_V5E, Hardware, RooflineResult, roofline
from repro_torch.analysis.trace import analyze_trace

# The auditor's names, imported when first read, so that `python -m
# repro_torch.analysis.audit` does not find its module already imported.
_AUDIT_NAMES = ("AuditFinding", "AuditReport", "run_audit", "bench_audit_rows",
                "check_cache_keys", "check_comm_conformance", "check_kernel_resources",
                "check_kernels", "check_mesh_uniformity", "executed_comm_bytes",
                "jax_executed_comm_bytes")


def __getattr__(name):
    if name in _AUDIT_NAMES:
        from repro_torch.analysis import audit

        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "analyze_trace", "roofline", "RooflineResult", "Hardware", "H100_SXM", "TPU_V5E",
    "AuditFinding", "AuditReport", "run_audit", "bench_audit_rows", "check_cache_keys",
    "check_comm_conformance", "check_kernel_resources", "check_kernels",
    "check_mesh_uniformity", "executed_comm_bytes", "jax_executed_comm_bytes",
    "Calibration", "PrimitiveFit", "autotune_choice", "fit_calibration",
    "load_calibration", "predict_wall", "reset_calibration", "set_calibration",
]
