"""Multi-tenant request queues: bounded depth, weighted fair draining.

One `TenantQueues` instance sits behind the `AsyncSolveEngine` condition
lock (it is deliberately *not* self-locking — the engine already serializes
push/drain under its condition variable, and a second lock layer would only
invite ordering bugs).  Each tenant gets a bounded FIFO; the drain side runs
stride scheduling: every pop advances the tenant's virtual "pass" by
1/weight, and the next pop goes to the non-empty tenant with the smallest
pass — so over any busy window tenants are served proportionally to their
weights, a weight-2 tenant getting ~2x the slots of a weight-1 tenant, while
an idle tenant never banks credit (its pass is clamped to the scheduler's
virtual time when it re-activates).

Overload is the *caller's* policy: `push` raises `Overloaded` when the
tenant's queue is at capacity, and the engine translates that into shed
(fail the request) or spill (solve it inline on the in-core path).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any


class Overloaded(RuntimeError):
    """A tenant queue is at capacity; the request was not enqueued."""

    def __init__(self, tenant: str, depth: int, max_queue: int):
        self.tenant = tenant
        self.depth = depth
        self.max_queue = max_queue
        super().__init__(
            f"tenant {tenant!r} queue is full ({depth}/{max_queue} pending); "
            f"request shed — retry with backoff, raise max_queue, or use "
            f"overload='spill' to solve inline under overload"
        )


@dataclass
class Request:
    """One queued solve request: a prepared system plus its completion."""

    tenant: str
    prep: Any  # a prepared system or RHS of repro_torch.serving.solve_engine
    future: Any  # concurrent.futures.Future
    t_submit: float  # engine-clock timestamp (deadline + latency basis)


@dataclass
class _Tenant:
    name: str
    weight: float
    queue: deque = field(default_factory=deque)
    pass_: float = 0.0  # stride-scheduling virtual time
    submitted: int = 0  # accepted into the queue
    served: int = 0  # completed through a batched flush
    shed: int = 0  # rejected at capacity
    spilled: int = 0  # solved inline on the in-core path at capacity


class TenantQueues:
    """Bounded per-tenant FIFOs with stride-scheduled fair draining."""

    def __init__(self, max_queue: int, weights: dict[str, float] | None = None,
                 default_weight: float = 1.0):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.default_weight = default_weight
        self._weights = dict(weights or {})
        for name, w in self._weights.items():
            if not w > 0:
                raise ValueError(f"tenant {name!r} weight must be > 0, got {w}")
        self._tenants: dict[str, _Tenant] = {}
        self._vtime = 0.0  # pass of the most recently scheduled pop

    def tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            weight = self._weights.get(name, self.default_weight)
            t = self._tenants[name] = _Tenant(name, weight, pass_=self._vtime)
        return t

    def push(self, req: Request) -> int:
        """Enqueue; raises Overloaded at capacity.  Returns the new depth."""
        t = self.tenant(req.tenant)
        if len(t.queue) >= self.max_queue:
            t.shed += 1  # provisional: a spill policy re-labels it
            raise Overloaded(req.tenant, len(t.queue), self.max_queue)
        if not t.queue:
            # re-activation: no credit for idle time (classic stride clamp)
            t.pass_ = max(t.pass_, self._vtime)
        t.queue.append(req)
        t.submitted += 1
        return self.depth()

    def depth(self) -> int:
        """Total queued requests across tenants."""
        return sum(len(t.queue) for t in self._tenants.values())

    def oldest_t_submit(self) -> float | None:
        """Earliest queued submit timestamp (deadline trigger), or None."""
        heads = [t.queue[0].t_submit for t in self._tenants.values() if t.queue]
        return min(heads) if heads else None

    def drain(self, k: int) -> list[Request]:
        """Pop up to k requests, weighted-fair across non-empty tenants."""
        batch: list[Request] = []
        while len(batch) < k:
            busy = [t for t in self._tenants.values() if t.queue]
            if not busy:
                break
            t = min(busy, key=lambda t: (t.pass_, t.name))
            batch.append(t.queue.popleft())
            t.pass_ += 1.0 / t.weight
            self._vtime = t.pass_
        return batch

    def mark_spilled(self, name: str) -> None:
        """Re-label the tenant's latest shed as a spill (inline solve)."""
        t = self.tenant(name)
        t.shed -= 1
        t.spilled += 1

    def mark_served(self, name: str, k: int = 1) -> None:
        self.tenant(name).served += k

    def totals(self) -> dict:
        agg = {"submitted": 0, "served": 0, "shed": 0, "spilled": 0}
        for t in self._tenants.values():
            agg["submitted"] += t.submitted
            agg["served"] += t.served
            agg["shed"] += t.shed
            agg["spilled"] += t.spilled
        return agg

    def per_tenant(self) -> dict:
        return {
            name: {
                "weight": t.weight,
                "depth": len(t.queue),
                "submitted": t.submitted,
                "served": t.served,
                "shed": t.shed,
                "spilled": t.spilled,
            }
            for name, t in sorted(self._tenants.items())
        }
