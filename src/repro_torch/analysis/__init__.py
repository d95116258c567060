"""Analysis: the trace-calibrated cost model behind `strategy="auto"`.

The JAX package's `repro.analysis` also exports `analyze_hlo` / `HloReport`
(StableHLO accounting) and `roofline` / `RooflineResult`; those belong to
ROADMAP.md module item 11 and are not ported yet.
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

__all__ = [
    "Calibration", "PrimitiveFit", "autotune_choice", "fit_calibration",
    "load_calibration", "predict_wall", "reset_calibration", "set_calibration",
]
