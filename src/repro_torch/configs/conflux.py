"""The paper's own configuration: COnfLUX LU problem sizes (§8).

Problem sizes mirror the paper's evaluation: 4096 <= N <= 16384 on
P in {4, ..., 1024}, with memory for up to c = P^(1/3) replication layers."""

from dataclasses import dataclass


@dataclass(frozen=True)
class ConfluxBenchConfig:
    N: int
    P: int
    element_bytes: int = 8  # the paper measures with 8-byte elements

    @property
    def c_max(self) -> int:
        """Paper Fig. 6: enough memory (M >= N^2/P^(2/3)) for c = P^(1/3)."""
        c = max(int(round(self.P ** (1 / 3))), 1)
        p = 1
        while p * 2 <= c:
            p *= 2
        return p

    @property
    def M(self) -> float:
        return self.c_max * self.N**2 / self.P


TABLE2 = [
    ConfluxBenchConfig(N=4096, P=64),
    ConfluxBenchConfig(N=4096, P=1024),
    ConfluxBenchConfig(N=16384, P=64),
    ConfluxBenchConfig(N=16384, P=1024),
]

# paper-reported total communication volumes [GB] (measured / modeled)
TABLE2_PAPER_GB = {
    ("LibSci", 4096, 64): (1.17, 1.21),
    ("SLATE", 4096, 64): (1.18, 1.21),
    ("CANDMC", 4096, 64): (2.5, 4.9),
    ("COnfLUX", 4096, 64): (1.11, 1.08),
    ("LibSci", 4096, 1024): (4.45, 4.43),
    ("SLATE", 4096, 1024): (4.35, 4.43),
    ("CANDMC", 4096, 1024): (9.3, 12.13),
    ("COnfLUX", 4096, 1024): (3.13, 3.07),
    ("LibSci", 16384, 64): (18.79, 19.33),
    ("SLATE", 16384, 64): (18.84, 19.33),
    ("CANDMC", 16384, 64): (39.8, 78.74),
    ("COnfLUX", 16384, 64): (17.61, 17.19),
    ("LibSci", 16384, 1024): (70.91, 70.87),
    ("SLATE", 16384, 1024): (71.1, 70.87),
    ("CANDMC", 16384, 1024): (144.0, 194.09),
    ("COnfLUX", 16384, 1024): (45.42, 44.77),
}
