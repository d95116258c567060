"""Three-term roofline of a per-device program.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_wire_bytes_per_device / link_bw

Per-device figures divided by per-chip rates equal the global / (chips x
rate) convention.  The port has no compiled artifact to read FLOPs and bytes
from (PyTorch emits no StableHLO): the caller passes counts, for example a
kernel's operations and bytes or `analysis.trace.analyze_trace`'s wire bytes.

`H100_SXM` (the default) holds the published rates of the card the port runs
on; `TPU_V5E` is the JAX package's chip, kept so the two packages' models can
be compared, and prices nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # per chip, bf16
    hbm_bw: float  # bytes/s per chip
    ici_bw: float  # bytes/s per link (conservative single-link figure)
    dcn_bw: float = 25.0e9 / 8  # inter-pod bytes/s per host NIC share
    hbm_per_chip: float = 16e9
    f32_flops: float = 0.0  # per chip, f32 without tensor cores (0: not given)


# NVIDIA H100 SXM5 80 GB, published data-sheet rates at its full 700 W limit:
# 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
# cores, 3.35 TB/s of HBM3.  `ici_bw` keeps the reference's field name; on
# Hopper it is NVLink 4, 450 GB/s each way per card (900 GB/s both ways).
H100_SXM = Hardware(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                    hbm_per_chip=80e9, f32_flops=67e12)

# The JAX package's chip, for the parity tests only.
TPU_V5E = Hardware(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float  # 6*N*D (dense) or 6*N_active*D (MoE), per device
    hlo_flops: float  # per device: the program's FLOPs (the reference's field name)
    hlo_bytes: float  # per device: the program's bytes to and from HBM
    collective_bytes: float  # per device, wire bytes
    hw: Hardware = field(default=H100_SXM)
    extras: dict = field(default_factory=dict)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower bound on step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the step-time bound: the score."""
        if self.step_time == 0:
            return 0.0
        return (self.model_flops / self.hw.peak_flops) / self.step_time

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "flops_ratio": self.flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            **self.extras,
        }


def roofline(
    *,
    arch: str,
    shape: str,
    mesh: str,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    model_flops: float,
    hw: Hardware = H100_SXM,
    extras: dict | None = None,
) -> RooflineResult:
    return RooflineResult(
        arch=arch,
        shape=shape,
        mesh=mesh,
        t_compute=hlo_flops / hw.peak_flops,
        t_memory=hlo_bytes / hw.hbm_bw,
        t_collective=collective_bytes / hw.ici_bw,
        model_flops=model_flops,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        hw=hw,
        extras=extras or {},
    )


def format_table(rows: list[dict]) -> str:
    """Markdown table of `RooflineResult.row()` dicts."""
    if not rows:
        return "(no rows)"
    cols = ["arch", "shape", "mesh", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "flops_ratio", "roofline_fraction"]
    out = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for r in rows:
        cells = []
        for c in cols:
            v = r.get(c, "")
            cells.append(f"{v:.3e}" if isinstance(v, float) and c.startswith("t_") else
                         (f"{v:.3f}" if isinstance(v, float) else str(v)))
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)
