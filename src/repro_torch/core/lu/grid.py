"""Processor grid of the 2.5D schedules (paper §8).

COnfLUX decomposes P processors into [Px, Py, c] with c replication layers.
Only the type lives here for now: the single-device path carries `grid=None`,
and the grid optimizer arrives with the distributed slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GridConfig:
    Px: int
    Py: int
    c: int
    v: int
    N: int

    @property
    def P_used(self) -> int:
        return self.Px * self.Py * self.c

    def __str__(self):
        return f"[{self.Px}x{self.Py}x{self.c}] v={self.v} (P_used={self.P_used})"
