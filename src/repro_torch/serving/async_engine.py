"""AsyncSolveEngine — the async serving tier over the batched solve path.

Port of `repro/serving/async_engine.py`, on the CUDA card unless built with
`device="cpu"`; futures resolve to tensors on that device.

`submit(A, b, tenant=...)` validates eagerly, enqueues onto the tenant's
bounded queue, and returns a `concurrent.futures.Future` immediately.
`submit_rhs(b, tenant=...)` does the same for RHS-only solves against the
engine's current factorization — the executor coalesces them into ONE
stacked [N, k] triangular-solve dispatch per batch (the
`SolveEngine.submit`/`flush` path).  A background executor thread coalesces
queued requests — weighted-fair across tenants — into the `SolveEngine`
power-of-two batch slots and flushes on a **size-OR-deadline** trigger: as
soon as `max_batch` requests are pending, or once the oldest queued request
has waited `max_delay_ms`.  That is the
classic serving trade: deep batches amortize dispatch (one batched plan
launches two kernels per panel step for the whole bucket, where a loop of
single plans launches them once per system), the deadline caps the latency
a lonely request pays for them.

Backpressure is per-tenant and explicit.  A tenant whose queue is at
`max_queue` either **sheds** (`overload="shed"`: `submit` raises
`Overloaded`, the caller retries with backoff) or **spills**
(`overload="spill"`: the request is solved synchronously in the caller's
thread on the in-core sequential strategy — degraded latency, no batching,
but the answer still comes back).  Both outcomes are counted per tenant in
`stats()`, which also reports p50/p95/p99 request latency and queue-depth
percentiles from bounded ring buffers plus the batch-fill ratio.

    eng = AsyncSolveEngine(N=512, max_batch=64, max_delay_ms=2.0)
    futs = [eng.submit(A_i, b_i, tenant="svc-a") for ...]
    xs = [f.result() for f in futs]      # batched behind the scenes
    print(eng.stats()["async"]["latency_ms"])
    eng.close()                          # drains, then stops the executor

Determinism for tests: pass `start=False` plus a fake `clock` and drive the
trigger with `pump(now)` — the executor logic runs without threads or real
timers, so deadline behavior is testable without sleeps (CI stays
timing-flake-free).

Distributed engines: on "conflux", "baseline2d" or "cholesky25d" the
underlying `SolveEngine` holds a plan over the default process group, and
its factorization is a collective, so the caller makes `engine.factor(A)`
on every rank, in the same order, with the same A.  Everything the executor
does is rank-local: whole systems flush through the batched plan of the
strategy's sequential sibling, RHS-only requests through the triangular
solves against the gathered factors every rank holds, and a spill solves on
the in-core sequential plan; so each rank's queues, batches and futures are
its own.

Threads: the executor flushes from its own thread and a spill solves in the
submitter's thread; both launch on PyTorch's current stream of the engine's
device.  Per-request refinement (`refine_tol`) rides the request through
the batch slots (or the spill) and resolves the future to the refined
solution in the working dtype.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import torch

from repro_torch.api import plan
from repro_torch.serving.metrics import Ring
from repro_torch.serving.queues import Overloaded, Request, TenantQueues
from repro_torch.serving.solve_engine import SolveEngine

OVERLOAD_POLICIES = ("shed", "spill")


class _PreparedRHS(NamedTuple):
    """A validated RHS-only request (solve against the engine's current
    factorization) riding the same tenant queues as whole systems."""

    b: torch.Tensor


class AsyncSolveEngine:
    """Futures + deadline batching + multi-tenant backpressure over SolveEngine.

    Args:
        N:            maximum system size; requests are ragged (any n <= N).
        config/device/**overrides: forwarded to the underlying `SolveEngine`
                      (`device=None` is the CUDA card).
        max_batch:    flush as soon as this many requests are queued (also
                      the per-flush drain bound, so one tenant burst cannot
                      starve the deadline of others past one batch).
        max_delay_ms: flush the oldest request after at most this wait, even
                      if the batch is not full.
        max_queue:    per-tenant pending bound; beyond it the overload
                      policy applies.
        overload:     "shed" (submit raises `Overloaded`) or "spill" (solve
                      inline on the in-core sequential strategy).
        weights:      tenant -> weight for the fair scheduler (default 1.0;
                      a weight-2 tenant gets ~2x the batch slots of a
                      weight-1 tenant while both are busy).
        clock:        monotonic-seconds callable (tests inject a fake).
        start:        spawn the background executor (False = drive `pump`).
    """

    def __init__(self, N: int, config=None, *, device=None, max_batch: int = 32,
                 max_delay_ms: float = 2.0, max_queue: int = 256,
                 overload: str = "shed", weights: dict[str, float] | None = None,
                 clock=None, start: bool = True, metrics_window: int = 4096,
                 **overrides):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not max_delay_ms >= 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"unknown overload policy {overload!r}; choose from "
                f"{OVERLOAD_POLICIES}"
            )
        self._engine = SolveEngine(N, config, device=device, **overrides)
        self.N = N
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.overload = overload
        self._clock = clock if clock is not None else time.monotonic
        self._cv = threading.Condition()
        self._queues = TenantQueues(max_queue, weights)
        self._lat_ms = Ring(metrics_window)
        self._depths = Ring(metrics_window)
        self._fills = Ring(min(metrics_window, 1024))
        self._flushes = 0
        self._served = 0
        self._failed = 0  # futures completed with the solver's exception
        self._closed = False
        self._stop = False
        self._thread: threading.Thread | None = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    @property
    def engine(self) -> SolveEngine:
        """The underlying batched engine (read its stats; don't feed its
        queues directly — the executor owns them)."""
        return self._engine

    def warm_slots(self, sizes=(None,), max_batch: int | None = None) -> int:
        """Prepare the batched slot plans (see SolveEngine.warm_slots).

        The executor drains at most `self.max_batch` requests per flush, so
        that is the default slot ceiling; the sync engine shares the same
        global plan cache, so warming through it covers the async path too.
        """
        return self._engine.warm_slots(
            sizes, max_batch=self.max_batch if max_batch is None else max_batch
        )

    def start(self) -> None:
        """Spawn the background executor (idempotent)."""
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="AsyncSolveEngine-executor", daemon=True
            )
            self._thread.start()

    def close(self, drain: bool = True, timeout: float | None = 30.0) -> None:
        """Stop accepting requests and shut the executor down.

        drain=True (default) serves everything still queued first;
        drain=False fails queued futures with a RuntimeError.
        """
        with self._cv:
            if self._closed and self._thread is None:
                return
            self._closed = True
            leftovers = [] if drain else self._queues.drain(self._queues.depth())
            self._stop = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        for req in leftovers:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    RuntimeError("engine closed before the request was served"))
        if thread is not None:
            thread.join(timeout)
        elif drain:
            # no executor (start=False): serve the leftovers inline
            while self.pump(force=True):
                pass

    def __enter__(self) -> "AsyncSolveEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    # -- request path --------------------------------------------------------

    def submit(self, A, b, tenant: str = "default", *,
               refine_tol: float | None = None,
               max_refine_iters: int = 25) -> Future:
        """Queue an n x n system solve (n <= N); returns its Future.

        Validation (square, real, n <= N, matching RHS) happens eagerly in
        the caller's thread — a malformed request raises here, never inside
        a batch holding other tenants' requests hostage.  At `max_queue`
        pending for this tenant the overload policy applies: "shed" raises
        `Overloaded`, "spill" solves inline and returns a completed future.

        `refine_tol` rides the request through the batch slots: the flush
        runs per-request iterative refinement on the lanes that asked for it
        (see `SolveEngine.submit_system`), and the future resolves to the
        refined, working-precision solution.  A bad tolerance raises here,
        before the request reaches a queue.
        """
        prep = self._engine._prepare_system(  # eager validation
            A, b, refine_tol, max_refine_iters)
        return self._enqueue(tenant, prep, self._spill)

    def submit_rhs(self, b, tenant: str = "default") -> Future:
        """Queue an RHS-only solve against the engine's current factorization.

        The futures-tier twin of `SolveEngine.submit`/`flush`: the request
        rides the same tenant queues, deadline trigger, and fair scheduler
        as whole-system submits, and the executor coalesces every RHS-only
        request in a drained batch into ONE stacked [N, k] triangular-solve
        dispatch.  Validation (shape [N], real dtype, a factorization must
        exist) happens eagerly in the caller's thread; overload applies the
        engine's shed/spill policy, a spill solving inline against the same
        factorization.
        """
        arr = self._engine._prepare_rhs(b)  # eager validation
        with self._engine._lock:
            has_fact = self._engine._last is not None
        if not has_fact:
            raise RuntimeError(
                "no factorization yet; submit_rhs solves against the "
                "engine's current factors — call engine.factor(A) first"
            )
        return self._enqueue(tenant, _PreparedRHS(arr), self._spill_rhs)

    def _enqueue(self, tenant: str, prep, spill_fn) -> Future:
        """Shared futures-tier enqueue: push onto the tenant queue, arm the
        executor trigger, and apply the overload policy via `spill_fn`."""
        fut: Future = Future()
        now = self._clock()
        req = Request(tenant=tenant, prep=prep, future=fut, t_submit=now)
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed; no new requests")
            try:
                depth = self._queues.push(req)
            except Overloaded:
                if self.overload == "shed":
                    raise
                self._queues.mark_spilled(tenant)
                spill = True
            else:
                spill = False
                self._depths.record(depth)
                # Wake the executor only when this submit changes its wait:
                # the first request arms the deadline timer, the max_batch-th
                # fires the size trigger.  In-between submits leave the
                # oldest-request deadline untouched, and skipping the notify
                # spares one GIL round trip per request on the hot path.
                if depth == 1 or depth >= self.max_batch:
                    self._cv.notify()
        if spill:
            x = spill_fn(prep)
            self._lat_ms.record((self._clock() - now) * 1e3)
            fut.set_result(x)
        return fut

    def _spill(self, prep) -> torch.Tensor:
        """Overload escape hatch: solve one system synchronously in the
        caller's thread on the single-system sequential plan of the
        engine's kind at the request's N slot (cached, so sustained
        overload builds no plans)."""
        cfg = self._engine.config.with_(strategy=self._engine._sequential_strategy(),
                                        grid=None, B=None)
        fact = plan(prep.slotN, cfg, device=self._engine.device).execute(prep.A)
        if prep.refine_tol is not None:
            x = fact.solve(prep.b, refine_tol=prep.refine_tol,
                           max_refine_iters=prep.max_refine_iters).x
        else:
            x = fact.solve(prep.b)
        self._engine._sync()
        return x[:prep.n]

    def _spill_rhs(self, prep: _PreparedRHS) -> torch.Tensor:
        """Overload escape hatch for RHS-only requests: solve synchronously
        against the engine's current factorization (no batching, degraded
        latency, but the answer still comes back)."""
        return self._engine.resolve(prep.b)

    # -- executor ------------------------------------------------------------

    def _trigger_wait_locked(self, now: float) -> float | None:
        """Seconds until the flush trigger fires: 0.0 = fire now, None =
        queue empty (wait for a submit).  Called with the cv lock held."""
        depth = self._queues.depth()
        if depth == 0:
            return None
        if depth >= self.max_batch:
            return 0.0
        oldest = self._queues.oldest_t_submit()
        remaining = self.max_delay_s - (now - oldest)
        return max(remaining, 0.0)

    def pump(self, now: float | None = None, force: bool = False) -> int:
        """Run one flush cycle if the size-or-deadline trigger has fired.

        Returns the number of requests served (0 = trigger not due).  This
        is the executor's step function: the background thread calls it on
        wakeup, and fake-clock tests call it directly with an explicit
        `now` to exercise deadline behavior without sleeping.  `force=True`
        flushes whatever is queued regardless of the trigger (drain path).
        """
        now = self._clock() if now is None else now
        with self._cv:
            if not force and self._trigger_wait_locked(now) != 0.0:
                return 0
            batch = self._queues.drain(self.max_batch)
        if not batch:
            return 0
        return self._serve(batch)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop:
                    wait = self._trigger_wait_locked(self._clock())
                    if wait == 0.0:
                        break
                    self._cv.wait(wait)
                if self._stop and self._queues.depth() == 0:
                    return
                batch = self._queues.drain(self.max_batch)
            if batch:
                self._serve(batch)

    def _serve(self, batch: list[Request]) -> int:
        """Flush one drained batch through the engine and complete the
        futures (results, or the solver's exception).

        Mixed batches split onto the engine's two dispatch paths: whole
        systems ride the batched factorize+solve slots (`flush_systems`),
        RHS-only requests ride the stacked [N, k] solve (`flush`).  Each
        half fails independently — a broken factorization failing the RHS
        half does not take down the systems half's futures.
        """
        active = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not active:
            return 0
        systems = [r for r in active if not isinstance(r.prep, _PreparedRHS)]
        rhs = [r for r in active if isinstance(r.prep, _PreparedRHS)]
        served = self._serve_group(
            systems, self._engine._enqueue_prepared,
            self._engine.flush_systems, self._engine._abort_pending_systems,
        )
        served += self._serve_group(
            rhs, lambda p: self._engine.submit(p.b),
            self._engine.flush, self._engine._abort_pending_rhs,
        )
        if served:
            with self._cv:
                self._flushes += 1
            self._fills.record(served / self.max_batch)
        return served

    def _serve_group(self, group: list[Request], enqueue, flush, abort) -> int:
        """Dispatch one homogeneous request group through (enqueue, flush)
        and complete its futures; on failure, abort the engine-side queue
        (the futures already carry the exception — leaving it populated
        would only poison the next batch's tickets with zombie entries)."""
        if not group:
            return 0
        try:
            tickets = [enqueue(r.prep) for r in group]
            xs = flush()
        except Exception as exc:  # noqa: BLE001 — propagate to every future
            abort()
            with self._cv:
                self._failed += len(group)
            for r in group:
                r.future.set_exception(exc)
            return 0
        done = self._clock()
        for r, t in zip(group, tickets):
            r.future.set_result(xs[t])
            self._lat_ms.record((done - r.t_submit) * 1e3)
        with self._cv:
            for r in group:
                self._queues.mark_served(r.tenant)
            self._served += len(group)
        return len(group)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Underlying engine stats plus the async tier's serving view:
        latency/queue-depth percentiles, batch-fill ratio, per-tenant
        shed/spill counters."""
        st = self._engine.stats()
        with self._cv:
            totals = self._queues.totals()
            per_tenant = self._queues.per_tenant()
            depth = self._queues.depth()
            flushes, served, failed = self._flushes, self._served, self._failed
        offered = totals["submitted"] + totals["shed"] + totals["spilled"]
        fills = self._fills.summary()
        st["async"] = {
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_s * 1e3,
            "overload": self.overload,
            "pending": depth,
            "flushes": flushes,
            "served": served,
            "failed": failed,
            "shed": totals["shed"],
            "spilled": totals["spilled"],
            "shed_rate": totals["shed"] / offered if offered else 0.0,
            "spill_rate": totals["spilled"] / offered if offered else 0.0,
            "batch_fill": fills["mean"],
            "latency_ms": self._lat_ms.summary(),
            "queue_depth": self._depths.summary(),
            "tenants": per_tenant,
        }
        return st
