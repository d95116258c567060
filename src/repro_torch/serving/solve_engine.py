"""SolveEngine — serving-scale repeated dense solves on cached plans, on the card.

Port of `repro/serving/solve_engine.py`.  Traffic is many requests of the
same shape (covariance solves, KKT systems, Gaussian-process updates ...),
so the plan is resolved once at engine construction and every request runs
it.  The engine runs on the CUDA card unless built with `device="cpu"`, and
its results are tensors on that device.

    eng = SolveEngine(N=4096)
    x = eng.solve(A, b)            # factorize + solve
    x2 = eng.resolve(b2)           # new RHS, reuse the last factorization
    print(eng.stats())

Batched multi-RHS: `submit` queues RHS vectors against the current
factorization and `flush` stacks all pending RHS into a single [N, k]
solve — one dispatch instead of k:

    eng.factor(A)
    t1, t2 = eng.submit(b1), eng.submit(b2)
    xs = eng.flush()               # one [N, 2] solve; xs[t1], xs[t2]

Batch slots (the many-small-systems path): `submit_system` queues whole
(A, b) systems and `flush_systems` factorizes each *size bucket* as ONE
batched plan execution (`plan((B, N))`: one launch of each batched kernel
per panel step for the whole bucket) instead of a Python loop of B small
factorizations that each leave most of the card idle.  Requests are
**ragged in N**: any n x n system with n <= the engine's N is accepted and
padded (identity diagonal, zero RHS tail) into the nearest power-of-two N
slot, then each slot's queue is padded to a power-of-two batch size — so
one cached plan serves a whole size range and the plan cache holds one
batched plan per (B-slot, N-slot) rather than one per request shape.  Each
bucket is stacked on the host and reaches the card as one [slotB, slotN,
slotN] copy (and one [slotB, slotN] copy of its RHS), not one per request.
The padding overhead is visible as `batch_pad_waste` in `stats()`:

    t1, t2, t3 = (eng.submit_system(A_i, b_i) for ...)   # mixed sizes OK
    xs = eng.flush_systems()       # one plan((B, Nslot)) execute per bucket

The engine is **thread-safe**: every queue mutation and counter increment
happens under one internal lock, so concurrent submitters (or a background
flusher — see `repro_torch.serving.async_engine`) never lose requests,
double-use tickets, or tear the stats.  `flush`/`flush_systems` hold the
lock through the solve: a submit landing mid-flush simply waits and joins
the *next* batch, which is exactly the backpressure a serving loop wants.

SPD traffic runs on a Cholesky engine: `SolveEngine(N,
strategy="sequential_chol")` factors every bucket with the batched blocked
Cholesky (identity padding keeps each padded system SPD).

Mixed precision: an engine on a `compute_dtype` plan factors every bucket
in the compute dtype, and `submit_system(A, b, refine_tol=...)` asks for
per-request iterative refinement against the request's working-precision
system.  The bucket still factorizes and solves as one batch; then the
lanes that asked run one batched refinement with per-lane tolerances.
Lanes that did not ask keep the plain solve, bit for bit.

Distributed engines: on "conflux", "baseline2d" and "cholesky25d" (or an
`auto` that resolves to one of them on a process group of several ranks)
the engine's plan runs on the default `torch.distributed` process group, as
`plan()` builds it; a 1x1x1 grid needs no group.  The SPMD contract is in
`SolveEngine`'s docstring.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api import Factorization, SolverConfig, plan, plan_cache_stats
from repro_torch.api.config import dtype_name, resolve_dtype
from repro_torch.api.result import _solve_dtype
from repro_torch.device import resolve_device

# Floor for the ragged-N power-of-two slot: below this the per-request
# padding waste is trivial anyway and smaller slots would only multiply
# cached batched plans (and collide with panel-width minimums).
MIN_N_SLOT = 8


def _next_pow2(k: int) -> int:
    """Smallest power of two >= k (k >= 1)."""
    return 1 << max(k - 1, 0).bit_length()


def _real_host(x, what: str) -> torch.Tensor:
    """A request's array as a CPU tensor; ValueError unless its dtype is real."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise ValueError(f"{what}; got dtype {dtype_name(x.dtype)}")
        return x.detach().cpu()
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiub":
        raise ValueError(f"{what}; got dtype {arr.dtype.name}")
    return torch.from_numpy(np.ascontiguousarray(arr))


class _PreparedSystem(NamedTuple):
    """A validated, slot-padded (A, b) system awaiting a batched flush.

    A is a CPU tensor [slotN, slotN] with the real n x n system in the
    leading block and an identity diagonal on the padded tail (trivially
    factorizable, exact: the trailing Schur updates of the zero off-diagonal
    blocks vanish, so padding never perturbs the leading block's factors or
    pivots); b is [slotN] with a zero tail, so the padded solution's tail is
    zero and `x[:n]` is the exact solution of the original system.

    refine_tol is the per-request iterative-refinement tolerance (None =
    the plain solve); the identity tail keeps refinement exact too, since
    the padded rows' residuals are identically zero.
    """

    A: torch.Tensor
    b: torch.Tensor
    n: int
    slotN: int
    refine_tol: float | None = None
    max_refine_iters: int = 25


class SolveEngine:
    """Repeated same-shape factorize/solve traffic over cached plans.

    `device=None` is the CUDA card (raises when there is none); pass
    `device="cpu"` for the plain PyTorch versions on the CPU.  `overrides`
    are SolverConfig fields; a `compute_dtype` plan (bf16 or f16 under f32,
    f32 under f64, LU or Cholesky) is served in that dtype, with per-request
    refinement on demand.

    On a distributed strategy the plan is built for the default process
    group, as `plan()` builds it, and the engine follows the SPMD contract:

    - `factor(A)` and `solve(A, b)` run `plan.execute`, a collective: every
      rank of the grid makes these calls in the same order with the same A.
    - The triangular solves after it (the second half of `solve`,
      `resolve`, `submit` / `flush`) are local, since every rank holds the
      gathered factors; their b may differ between ranks.
    - `submit_system` / `flush_systems` / `warm_slots` run the batched plan
      of the strategy's sequential sibling (`_batched_plan`), on this rank
      alone, so the ranks' queues may differ.
    """

    def __init__(self, N: int, config: SolverConfig | None = None, *, device=None,
                 **overrides):
        self.config = (config or SolverConfig()).with_(**overrides)
        self.device = resolve_device(device)
        self.plan = plan(N, self.config, device=self.device)
        self.N = N
        self._dtype = resolve_dtype(self.config.dtype)
        # One lock covers queues + counters: cheap (micro-ops) next to the
        # solves it guards, and it makes every stats() snapshot consistent.
        self._lock = threading.RLock()
        self._last: Factorization | None = None
        self._pending: list[torch.Tensor] = []  # queued RHS awaiting flush()
        # queued prepared systems awaiting flush_systems()
        self._pending_systems: list[_PreparedSystem] = []
        self._n_factor = 0
        self._n_solve = 0
        self._n_batched = 0  # batched solve dispatches (flush groups)
        self._n_batched_rhs = 0  # RHS vectors that rode a batched dispatch
        self._n_batched_factor = 0  # batched factorizations (bucket flushes)
        self._n_batched_systems = 0  # systems that rode a batched factorization
        self._n_batch_pad = 0  # identity systems added to fill batch slots
        self._n_refined = 0  # systems served with iterative refinement
        self._n_refine_iters = 0  # refinement iterations across those
        self._n_refine_nonconverged = 0  # refined systems that hit the cap
        self._cells_useful = 0  # sum of n^2 over real flushed systems
        self._cells_batched = 0  # sum of slotB * slotN^2 over bucket flushes
        self._t_factor = 0.0
        self._t_solve = 0.0
        self._t_batch = 0.0

    def _sync(self) -> None:
        """Wait for the card, so a timer stops when the work is done rather
        than when it was enqueued."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def factor(self, A) -> Factorization:
        """Factorize one N x N system on the engine's plan."""
        t0 = time.perf_counter()
        fact = self.plan.execute(A)
        self._sync()
        dt = time.perf_counter() - t0
        with self._lock:
            self._t_factor += dt
            self._n_factor += 1
            self._last = fact
        return fact

    def solve(self, A, b) -> torch.Tensor:
        """Factorize A and solve A x = b (b: [N] or [N, k] multi-RHS)."""
        fact = self.factor(A)
        t0 = time.perf_counter()
        x = fact.solve(b)
        self._sync()
        dt = time.perf_counter() - t0
        with self._lock:
            self._t_solve += dt
            self._n_solve += 1
        return x

    def resolve(self, b) -> torch.Tensor:
        """Solve against the most recent factorization (no re-factorize)."""
        with self._lock:
            last = self._last
        if last is None:
            raise RuntimeError("no factorization yet; call factor() or solve() first")
        t0 = time.perf_counter()
        x = last.solve(b)
        self._sync()
        dt = time.perf_counter() - t0
        with self._lock:
            self._t_solve += dt
            self._n_solve += 1
        return x

    def solve_many(self, systems) -> list[torch.Tensor]:
        """[(A, b), ...] -> [x, ...] — a request batch on one plan."""
        return [self.solve(A, b) for A, b in systems]

    def _prepare_rhs(self, b) -> torch.Tensor:
        """Validate a single RHS vector for the stacked-solve queue.

        Raises ValueError on malformed input (the eager-failure contract of
        `submit`); returns it as a CPU tensor in the engine's dtype, so the
        async tier's tenant queues can hold validated RHS-only requests
        without enqueueing them here yet.
        """
        b = _real_host(b, "submit takes a real RHS (factors are real)")
        if tuple(b.shape) != (self.N,):
            raise ValueError(f"submit takes a single [N] RHS with N={self.N}, "
                             f"got shape {tuple(b.shape)}")
        return b.to(self._dtype)

    def submit(self, b) -> int:
        """Queue a single-RHS solve against the current factorization.

        Returns the ticket index into the list `flush()` returns.  The RHS
        is validated eagerly (shape [N]) so a malformed request fails at
        submit time, not inside a batch holding other requests hostage.
        """
        b = self._prepare_rhs(b)
        with self._lock:
            self._pending.append(b)
            return len(self._pending) - 1

    def flush(self) -> list[torch.Tensor]:
        """Solve every pending RHS as one stacked [N, k] dispatch.

        All queued RHS share the engine's N, so one stack -> one copy to the
        card -> one triangular-solve pair covers the whole batch; results
        come back in submit order, as tensors on the engine's device.
        Counts one batched solve (plus k RHS) in `stats()`.  The lock is
        held through the solve, and the queue is cleared only after it
        succeeds: a failing batch leaves every request queued for a retry
        instead of silently dropping it, and a submit racing the flush waits
        and lands in the next batch with a fresh ticket.
        """
        with self._lock:
            if self._last is None:
                raise RuntimeError(
                    "no factorization yet; call factor() or solve() first")
            if not self._pending:
                return []
            pending = self._pending
            B = torch.stack(pending, dim=1).to(self.device)  # [N, k]
            t0 = time.perf_counter()
            X = self._last.solve(B)
            self._sync()
            self._pending = []
            self._t_solve += time.perf_counter() - t0
            self._n_solve += len(pending)
            self._n_batched += 1
            self._n_batched_rhs += len(pending)
        return [X[:, j] for j in range(X.shape[1])]

    def _prepare_system(self, A, b, refine_tol: float | None = None,
                        max_refine_iters: int = 25) -> _PreparedSystem:
        """Validate an (A, b) request and pad it into its power-of-two N slot.

        Raises ValueError on malformed input (the eager-failure contract
        of `submit_system`), a bad `refine_tol` or `max_refine_iters`
        included; returns the padded CPU tensors plus the real size n, so
        both the engine queue and the async tier's tenant queues hold
        ready-to-stack requests.
        """
        if refine_tol is not None:
            refine_tol = float(refine_tol)
            if not refine_tol > 0:
                raise ValueError(
                    f"refine_tol must be a positive relative-residual tolerance, "
                    f"got {refine_tol!r}"
                )
            if (not isinstance(max_refine_iters, int) or isinstance(max_refine_iters, bool)
                    or max_refine_iters < 0):
                raise ValueError(
                    f"max_refine_iters must be a non-negative int, got {max_refine_iters!r}"
                )
        A = _real_host(A, f"submit_system takes a real matrix (plan computes in "
                          f"{self.config.dtype})")
        b = _real_host(b, f"submit_system takes a real RHS (plan computes in "
                          f"{self.config.dtype})")
        n = A.shape[0] if A.ndim == 2 else 0
        if A.ndim != 2 or tuple(A.shape) != (n, n) or not 1 <= n <= self.N:
            raise ValueError(
                f"submit_system takes a square [N, N] matrix with "
                f"N <= {self.N} (the engine's size), got shape {tuple(A.shape)}"
            )
        if tuple(b.shape) != (n,):
            raise ValueError(
                f"submit_system takes a single [N] RHS matching its matrix "
                f"(N={n}), got shape {tuple(b.shape)}"
            )
        # Exact-size requests keep the engine's N as their slot even when it
        # is not a power of two; smaller systems bucket to the nearest
        # power-of-two >= max(MIN_N_SLOT, panel width).
        if n == self.N:
            slotN = self.N
        else:
            slotN = max(_next_pow2(n), MIN_N_SLOT, _next_pow2(self.config.v or 1))
            slotN = min(slotN, self.N)  # never exceed the engine's own size
        if slotN == n:
            return _PreparedSystem(A.to(self._dtype, copy=True), b.to(self._dtype, copy=True),
                                   n, slotN, refine_tol, max_refine_iters)
        Ap = torch.zeros((slotN, slotN), dtype=self._dtype)
        Ap[:n, :n] = A
        idx = torch.arange(n, slotN)
        Ap[idx, idx] = 1.0  # identity tail: trivially factorizable
        bp = torch.zeros(slotN, dtype=self._dtype)
        bp[:n] = b
        return _PreparedSystem(Ap, bp, n, slotN, refine_tol, max_refine_iters)

    def submit_system(self, A, b, *, refine_tol: float | None = None,
                      max_refine_iters: int = 25) -> int:
        """Queue a whole (A, b) system for a batched factorize+solve.

        Accepts any square n x n system with n <= the engine's N (ragged-N
        batching: the request is padded into the nearest power-of-two N
        slot, see `_prepare_system`).  Returns the ticket index into the
        list `flush_systems()` returns.  Both the matrix and the RHS are
        validated eagerly so a malformed request fails at submit time, not
        inside a batch holding other requests hostage.

        `refine_tol` asks for per-request iterative refinement: the bucket
        still factorizes and solves as one batch, then the lanes that asked
        run one batched refinement against their working-precision systems
        (per-lane tolerances, the largest `max_refine_iters` of them as the
        shared cap); lanes that did not ask keep the plain solve, bit for
        bit.
        """
        return self._enqueue_prepared(
            self._prepare_system(A, b, refine_tol, max_refine_iters)
        )

    def _enqueue_prepared(self, prep: _PreparedSystem) -> int:
        """Queue an already-validated system (async tier fast path)."""
        with self._lock:
            self._pending_systems.append(prep)
            return len(self._pending_systems) - 1

    @staticmethod
    def _slot(k: int) -> int:
        """Next power-of-two batch slot >= k (bounds plan-cache pollution:
        one batched plan per slot size instead of one per request count)."""
        return _next_pow2(k)

    def _batched_plan(self, slot: int, N: int | None = None):
        """The cached batched plan matching this engine's config at size slot.

        Batched plans are sequential-only, so the engine's plan (a
        distributed one too) maps to the sequential strategy of its kind
        ("sequential_chol" for a Cholesky engine); the plan runs on this
        rank alone.  N overrides the system size for ragged-N buckets (default:
        the engine's N).
        """
        return plan(
            (slot, self.N if N is None else N),
            self.config.with_(strategy=self._sequential_strategy(), grid=None, B=None),
            device=self.device,
        )

    def _sequential_strategy(self) -> str:
        """The in-core strategy of the engine's kind, for batched and spill plans."""
        return "sequential_chol" if self.plan.kind == "cholesky" else "sequential"

    def warm_slots(self, sizes=(None,), max_batch: int = 1) -> int:
        """Prepare the batched slot plans cold-start traffic would hit.

        Executes one identity batch plus solve through the cached plan of
        each request size in `sizes` (None = the engine's own N) crossed
        with every power-of-two batch slot up to `max_batch`, so the plans
        exist and the kernels are built and loaded before the first real
        request; returns the number of plans warmed.  Stats counters are
        untouched: warming is not traffic.
        """
        slotNs = set()
        for n in sizes:
            n = self.N if n is None else int(n)
            prep = self._prepare_system(torch.eye(n), torch.zeros(n))
            slotNs.add(prep.slotN)
        slots = []
        k = 1
        while k < max(1, int(max_batch)):
            slots.append(k)
            k *= 2
        slots.append(k)  # _next_pow2(max_batch): the full-drain slot
        warmed = 0
        for slotN in sorted(slotNs):
            for slotB in slots:
                bplan = self._batched_plan(slotB, slotN)
                eye = torch.eye(slotN, dtype=self._dtype, device=self.device)
                fact = bplan.execute(eye.expand(slotB, slotN, slotN).contiguous())
                fact.solve(torch.zeros((slotB, slotN), dtype=self._dtype, device=self.device))
                warmed += 1
        self._sync()
        return warmed

    def flush_systems(self) -> list[torch.Tensor]:
        """Factorize and solve every pending system, one batch per N slot.

        Groups the queue by its power-of-two N slot, stacks each group into
        a [slotB, slotN, slotN] block on the host (padded to the next
        power-of-two batch slot with identity systems and zero RHS), copies
        it to the card at once, runs ONE batched plan execution plus ONE
        batched solve per group, and returns the solutions (trimmed back to
        each request's real n, tensors on the engine's device) in submit
        order.  The lock is held throughout and the queue is cleared only
        after every bucket succeeds, so a failing dispatch leaves all
        requests queued for a retry instead of silently dropping them.
        """
        with self._lock:
            if not self._pending_systems:
                return []
            pending = self._pending_systems
            results: list[torch.Tensor | None] = [None] * len(pending)
            buckets: dict[int, list[tuple[int, _PreparedSystem]]] = {}
            for i, prep in enumerate(pending):
                buckets.setdefault(prep.slotN, []).append((i, prep))
            t0 = time.perf_counter()
            flushed = []  # (k, slotB, slotN) per bucket, applied on success
            refined = []  # (systems, iters, nonconverged) per refining bucket
            for slotN, items in sorted(buckets.items()):
                k = len(items)
                slotB = self._slot(k)
                A = torch.empty((slotB, slotN, slotN), dtype=self._dtype)
                rhs = torch.zeros((slotB, slotN), dtype=self._dtype)
                for j, (_, prep) in enumerate(items):
                    A[j] = prep.A
                    rhs[j] = prep.b
                A[k:] = torch.eye(slotN, dtype=self._dtype)  # identity pad systems
                bplan = self._batched_plan(slotB, slotN)
                fact = bplan.execute(A.to(self.device))
                rhs = rhs.to(self.device)
                # On a mixed-precision engine the plain solve returns its f32
                # arithmetic: hand it the RHS in that dtype, since the
                # downcast is the engine's contract (refine_tol is the
                # per-request way back), not a caller's mistake to warn of.
                mixed = fact.work_dtype != fact.dtype
                X = fact.solve(rhs.to(_solve_dtype(fact.dtype)) if mixed else rhs)
                for j, (i, prep) in enumerate(items):
                    results[i] = X[j, :prep.n]
                # Second pass: refinement of the lanes that asked for it, as
                # one batched refinement with per-lane tolerances.
                ridx = [j for j, (_, prep) in enumerate(items) if prep.refine_tol is not None]
                if ridx:
                    sel = torch.tensor(ridx, device=self.device)
                    sub = Factorization(
                        F=fact.F[sel], rows=fact.rows[sel], strategy=fact.strategy,
                        backend=fact.backend, kind=fact.kind, A_ref=fact.A_ref[sel],
                        work_dtype=fact.work_dtype,
                    )
                    tols = [items[j][1].refine_tol for j in ridx]
                    cap = max(items[j][1].max_refine_iters for j in ridx)
                    rs = sub.solve(rhs[sel], refine_tol=tols, max_refine_iters=cap)
                    for pos, j in enumerate(ridx):
                        i, prep = items[j]
                        results[i] = rs.x[pos, :prep.n]
                    refined.append((len(ridx), int(rs.refinement_iters.sum()),
                                    int((~rs.converged).sum())))
                flushed.append((k, slotB, slotN))
            self._sync()
            self._t_batch += time.perf_counter() - t0
            self._pending_systems = []
            for k, slotB, slotN in flushed:
                self._n_batched_factor += 1
                self._n_batched_systems += k
                self._n_batch_pad += slotB - k
                self._cells_batched += slotB * slotN * slotN
            for systems, iters, nonconverged in refined:
                self._n_refined += systems
                self._n_refine_iters += iters
                self._n_refine_nonconverged += nonconverged
            self._cells_useful += sum(p.n * p.n for p in pending)
        return results

    def _abort_pending_rhs(self) -> int:
        """Drop the queued RHS vectors (async-tier flush-failure twin of
        `_abort_pending_systems`: the futures already carry the exception).
        Returns the number of dropped requests."""
        with self._lock:
            dropped = len(self._pending)
            self._pending = []
            return dropped

    def _abort_pending_systems(self) -> int:
        """Drop the queued systems (async tier: after a flush failure has
        already propagated the exception to every request's future, retrying
        the same batch would only fail the *next* batch's tickets too).
        Returns the number of dropped requests."""
        with self._lock:
            dropped = len(self._pending_systems)
            self._pending_systems = []
            return dropped

    def stats(self) -> dict:
        """Engine counters + the global plan-cache hit/miss trajectory."""
        with self._lock:
            waste = (1.0 - self._cells_useful / self._cells_batched
                     if self._cells_batched else 0.0)
            return {
                "N": self.N,
                "device": str(self.device),
                "strategy": self.plan.config.strategy,
                "backend": self.plan.config.backend,
                "grid": str(self.plan.grid),
                "factorizations": self._n_factor,
                "solves": self._n_solve,
                "batched_solves": self._n_batched,
                "batched_rhs": self._n_batched_rhs,
                "batched_factorizations": self._n_batched_factor,
                "batched_systems": self._n_batched_systems,
                "batch_pad_systems": self._n_batch_pad,
                "refined_systems": self._n_refined,
                "refine_iters_total": self._n_refine_iters,
                "refine_nonconverged": self._n_refine_nonconverged,
                # fraction of batched compute cells spent on padding (both
                # the identity fill systems and the ragged-N identity tails)
                "batch_pad_waste": round(waste, 6),
                "pending": len(self._pending),
                "pending_systems": len(self._pending_systems),
                "trace_count": self.plan.trace_count,
                "factor_s_total": round(self._t_factor, 6),
                "solve_s_total": round(self._t_solve, 6),
                "batch_s_total": round(self._t_batch, 6),
                # includes the LRU hit/miss/eviction + size/capacity counters
                "plan_cache": plan_cache_stats(),
            }
