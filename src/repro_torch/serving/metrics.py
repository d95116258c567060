"""Serving metrics: fixed-size ring buffers with percentile summaries.

The async tier records one latency sample per served request, one depth
sample per enqueue, and one fill sample per flush.  A bounded ring keeps
the cost O(1) per sample and the memory constant under sustained traffic
(millions of requests must not grow a list); percentiles are computed on
demand over the *retained window* — the recent-traffic view a serving
dashboard wants — while `count` keeps the all-time total.
"""

from __future__ import annotations

import threading


class Ring:
    """Thread-safe fixed-capacity ring of float samples.

    `record` is O(1); `summary` sorts the retained window (capacity is a
    few thousand — microseconds, and only on a stats() pull, never on the
    request path).
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: list[float] = []
        self._head = 0  # next write position once the buffer is full
        self._count = 0  # all-time samples (>= len(_buf))
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        value = float(value)
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(value)
            else:
                self._buf[self._head] = value
                self._head = (self._head + 1) % self.capacity
            self._count += 1

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def count(self) -> int:
        """All-time samples recorded (retained window is min(count, capacity))."""
        return self._count

    def snapshot(self) -> list[float]:
        with self._lock:
            return list(self._buf)

    def summary(self, percentiles: tuple[int, ...] = (50, 95, 99)) -> dict:
        """{count, mean, max, p50, p95, p99} over the retained window.

        Empty ring -> zeros (a stats() pull before any traffic must not
        crash the dashboard).  Percentiles use the nearest-rank method on
        the sorted window.
        """
        with self._lock:
            buf = sorted(self._buf)
            count = self._count
        out = {"count": count}
        if not buf:
            out["mean"] = 0.0
            out["max"] = 0.0
            for q in percentiles:
                out[f"p{q}"] = 0.0
            return out
        out["mean"] = sum(buf) / len(buf)
        out["max"] = buf[-1]
        for q in percentiles:
            # nearest-rank: the smallest sample >= q% of the window
            idx = max(0, min(len(buf) - 1, -(-q * len(buf) // 100) - 1))
            out[f"p{q}"] = buf[idx]
        return out
