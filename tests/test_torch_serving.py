"""The port's serving tier (`repro_torch.serving`) on the CPU.

The cases of the JAX package's `tests/test_batched.py::TestEngineBatchSlots`
and `TestRaggedBatchSlots` (LU) and of `tests/test_serving_async.py`, run on
the port's engines with `device="cpu"`, where the kernels' plain versions
run.  `repro.serving` does not import on this jax, so the JAX side of the
parity test is the engine's factorization core,
`repro.core.lu.sequential.lu_masked_sequential_batched`, fed the padded
bucket the engine actually flushed.  SPD requests on Cholesky engines
(`strategy="sequential_chol"`) are held against `scipy.linalg.cho_solve` and
`repro.core.cholesky.sequential.chol_blocked_sequential_batched` within
1e-4 of the solution's scale.  Deadline behaviour runs on a fake clock
through `pump()`; one class drives the real background thread.  Residuals
are held to 5e-3 on diagonally dominant f32 systems, as in the JAX tests.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import repro.core.cholesky.sequential as jchol
import repro.core.lu.sequential as jseq
from repro_torch.api import GridConfig, SolverConfig, clear_plan_cache, plan
from repro_torch.core.cholesky import chol_blocked_sequential_batched
from repro_torch.serving import AsyncSolveEngine, Overloaded, Ring, SolveEngine, TenantQueues

ROOT = Path(__file__).resolve().parents[1]
ENGINE_CASES = ROOT / "tests" / "multidev" / "jax_engine_cases.py"
SUBPROCESS_TIMEOUT_S = 300
RNG = np.random.default_rng(7)
CFG = SolverConfig(strategy="sequential", v=8)


def _sys(n, rng=RNG):
    """A well-conditioned (diagonally dominant) n x n system."""
    A = rng.standard_normal((n, n)).astype(np.float32)
    A += n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return A, b


def _residual(A, b, x):
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    return float(np.abs(A @ x.numpy()[: A.shape[0]] - b).max())


def _engine(N=32, **kw):
    return SolveEngine(N, CFG, device="cpu", **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fake_engine(**kw):
    clock = FakeClock()
    defaults = dict(strategy="sequential", v=8, start=False, clock=clock, device="cpu")
    defaults.update(kw)
    return AsyncSolveEngine(32, **defaults), clock


# --------------------------------------------------------------------------
# SolveEngine batch slots (tests/test_batched.py::TestEngineBatchSlots)
# --------------------------------------------------------------------------


class TestEngineBatchSlots:
    def test_flush_systems_solves_all_in_submit_order(self):
        eng = _engine()
        systems = [_sys(32) for _ in range(5)]
        tickets = [eng.submit_system(A, b) for A, b in systems]
        assert tickets == list(range(5))
        xs = eng.flush_systems()
        assert len(xs) == 5
        for (A, b), x in zip(systems, xs):
            assert _residual(A, b, x) < 5e-3

    def test_power_of_two_slots_and_counters(self):
        eng = _engine()
        for A, b in (_sys(32) for _ in range(5)):
            eng.submit_system(A, b)
        eng.flush_systems()
        st = eng.stats()
        assert st["batched_factorizations"] == 1
        assert st["batched_systems"] == 5
        assert st["batch_pad_systems"] == 3  # 5 -> slot 8
        assert st["pending_systems"] == 0
        assert st["batch_s_total"] > 0.0 and st["device"] == "cpu"

    def test_slot_reuse_hits_plan_cache(self):
        clear_plan_cache()
        eng = _engine()
        for _ in range(2):
            for A, b in (_sys(32) for _ in range(3)):
                eng.submit_system(A, b)
            eng.flush_systems()
        # 3 -> slot 4 both times: the second flush reuses the cached plan
        bp = eng._batched_plan(4)
        assert bp.execute_count == 2 and bp.trace_count == 1 and bp.B == 4

    def test_submit_system_validates_eagerly(self):
        eng = _engine()
        with pytest.raises(ValueError, match=r"\[N, N\] matrix"):
            eng.submit_system(np.zeros((32, 16), np.float32), np.zeros(32))
        with pytest.raises(ValueError, match=r"\[N\] RHS"):
            eng.submit_system(np.zeros((32, 32), np.float32), np.zeros(16))
        with pytest.raises(ValueError, match="real"):
            eng.submit_system(np.zeros((32, 32), complex), np.zeros(32))
        with pytest.raises(ValueError, match="real"):
            eng.submit_system(torch.zeros(32, 32, dtype=torch.complex64), np.zeros(32))
        assert eng.stats()["pending_systems"] == 0  # nothing slipped in

    def test_submit_validates_rhs_length_against_plan_n(self):
        eng = _engine()
        with pytest.raises(ValueError, match="N=32"):
            eng.submit(np.zeros(16, np.float32))
        with pytest.raises(ValueError, match="N=32"):
            eng.submit_system(np.zeros((32, 32), np.float32), np.zeros(48, np.float32))

    def test_empty_flush_is_noop(self):
        assert _engine().flush_systems() == []

    def test_factor_solve_resolve_and_stacked_flush(self):
        eng = _engine()
        A, b = _sys(32)
        x = eng.solve(A, b)
        assert _residual(A, b, x) < 5e-3
        b2 = _sys(32)[1]
        assert _residual(A, b2, eng.resolve(b2)) < 5e-3
        rhs = [_sys(32)[1] for _ in range(3)]
        tickets = [eng.submit(torch.from_numpy(r)) for r in rhs]
        xs = eng.flush()
        for r, t in zip(rhs, tickets):
            assert _residual(A, r, xs[t]) < 5e-3
        st = eng.stats()
        assert st["factorizations"] == 1 and st["batched_solves"] == 1
        assert st["batched_rhs"] == 3 and st["solves"] == 5
        assert [tuple(x.shape) for x in eng.solve_many([_sys(32), _sys(32)])] == [(32,), (32,)]

    def test_flush_failure_keeps_the_queue_for_a_retry(self, monkeypatch):
        eng = _engine()
        for A, b in (_sys(32) for _ in range(2)):
            eng.submit_system(A, b)

        def boom(*args, **kwargs):
            raise RuntimeError("flush failed")

        monkeypatch.setattr(eng, "_batched_plan", boom)
        with pytest.raises(RuntimeError, match="flush failed"):
            eng.flush_systems()
        assert eng.stats()["pending_systems"] == 2
        monkeypatch.undo()
        assert len(eng.flush_systems()) == 2

    def test_bucket_factorization_matches_jax(self, monkeypatch):
        """The padded bucket the engine flushes, factorized by the JAX
        package's batched core, picks the same pivots as the engine did."""
        eng = _engine()
        flushed = []
        batched_plan = eng._batched_plan

        class Spy:
            def __init__(self, p):
                self.p = p

            def execute(self, A):
                fact = self.p.execute(A)
                flushed.append((A.clone(), fact))
                return fact

        monkeypatch.setattr(eng, "_batched_plan", lambda *a: Spy(batched_plan(*a)))
        systems = [_sys(n) for n in (12, 16, 9)]
        for A, b in systems:
            eng.submit_system(A, b)
        xs = eng.flush_systems()
        (A_stack, fact), = flushed  # one bucket: slot 16, batch slot 4
        assert tuple(A_stack.shape) == (4, 16, 16)
        _, jrows = jseq.lu_masked_sequential_batched(jnp.asarray(A_stack.numpy()), v=8,
                                                     backend="ref")
        np.testing.assert_array_equal(fact.rows.numpy(), np.asarray(jrows))
        for (A, b), x in zip(systems, xs):
            assert _residual(A, b, x) < 5e-3


# --------------------------------------------------------------------------
# ragged N (tests/test_batched.py::TestRaggedBatchSlots)
# --------------------------------------------------------------------------


class TestRaggedBatchSlots:
    def test_mixed_sizes_solve_exactly(self):
        eng = _engine()
        systems = [_sys(n) for n in (5, 8, 12, 17, 24, 32)]
        tickets = [eng.submit_system(A, b) for A, b in systems]
        xs = eng.flush_systems()
        for (A, b), t in zip(systems, tickets):
            x = xs[t]
            assert tuple(x.shape) == (A.shape[0],)  # trimmed to the real n
            # identity-tail padding is exact: the padded solve agrees with
            # the dense direct solve to f32 roundoff, not just in residual
            want = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
            assert np.abs(x.numpy() - want).max() < 5e-4

    def test_slot_assignment_and_bucket_counters(self):
        eng = _engine()
        # n=5 -> slot 8 (MIN_N_SLOT), 12 -> 16, 12 -> 16, 32 -> 32 (exact)
        for n in (5, 12, 12, 32):
            eng.submit_system(*_sys(n))
        assert [p.slotN for p in eng._pending_systems] == [8, 16, 16, 32]
        eng.flush_systems()
        st = eng.stats()
        assert st["batched_factorizations"] == 3  # one per distinct slot
        assert st["batched_systems"] == 4
        assert st["batch_pad_systems"] == 0  # 1, 2, 1 are power-of-two fills
        assert st["batch_pad_waste"] > 0.0  # ragged identity tails

    def test_exact_size_full_batch_has_zero_waste(self):
        eng = _engine()
        assert eng.stats()["batch_pad_waste"] == 0.0  # no batched work yet
        for _ in range(4):
            eng.submit_system(*_sys(32))
        eng.flush_systems()
        assert eng.stats()["batch_pad_waste"] == 0.0  # 4 -> slotB 4, no pad

    def test_slot_respects_panel_width_floor(self):
        eng = SolveEngine(64, CFG.with_(v=16), device="cpu")
        # next_pow2(5)=8 < panel width 16: the slot must hold a full panel
        assert eng._prepare_system(*_sys(5)).slotN == 16

    def test_ragged_buckets_reuse_cached_plans(self):
        clear_plan_cache()
        eng = _engine()
        for _ in range(2):
            eng.submit_system(*_sys(12))
            eng.flush_systems()
        bp = eng._batched_plan(1, 16)  # slotB=1, slotN=16 both rounds
        assert bp.execute_count == 2 and bp.trace_count == 1

    def test_oversize_system_rejected(self):
        with pytest.raises(ValueError, match="N <= 32"):
            _engine().submit_system(*_sys(48))

    def test_warm_slots_prepares_plans_without_touching_stats(self):
        clear_plan_cache()
        eng = _engine()
        assert eng.warm_slots(sizes=(None, 12), max_batch=3) == 6  # {16, 32} x {1, 2, 4}
        assert eng._batched_plan(4, 16).execute_count == 1
        st = eng.stats()
        assert st["batched_factorizations"] == 0 and st["batch_s_total"] == 0.0


# --------------------------------------------------------------------------
# SPD traffic on Cholesky engines (tests/test_cholesky.py's SPD SolveEngine)
# --------------------------------------------------------------------------

CHOL_CFG = SolverConfig(strategy="sequential_chol", v=8)


def _spd_sys(n, rng=RNG):
    """An SPD system: A = G^T G / n + I."""
    G = rng.standard_normal((n, n)).astype(np.float32)
    A = G.T @ G / np.float32(n) + np.eye(n, dtype=np.float32)
    return A, rng.standard_normal(n).astype(np.float32)


class TestCholeskyEngines:
    def test_sync_flush_of_ragged_spd_requests_matches_cho_solve(self):
        eng = SolveEngine(32, CHOL_CFG, device="cpu")
        systems = [_spd_sys(n) for n in (5, 8, 12, 17, 24, 32, 32, 9)]
        tickets = [eng.submit_system(A, b) for A, b in systems]
        assert [p.slotN for p in eng._pending_systems] == [8, 8, 16, 32, 32, 32, 32, 16]
        xs = eng.flush_systems()
        for (A, b), t in zip(systems, tickets):
            x = xs[t]
            assert tuple(x.shape) == (A.shape[0],)
            want = scipy.linalg.cho_solve(scipy.linalg.cho_factor(A.astype(np.float64)),
                                          b.astype(np.float64))
            assert np.abs(x.numpy() - want).max() < 1e-4 * max(1.0, np.abs(want).max())
        st = eng.stats()
        assert st["strategy"] == "sequential_chol" and st["batched_factorizations"] == 3
        bp = eng._batched_plan(4, 32)
        assert bp.kind == "cholesky" and bp.config.strategy == "sequential_chol"

    def test_flushed_bucket_factors_match_jax(self):
        eng = SolveEngine(16, CHOL_CFG, device="cpu")
        systems = [_spd_sys(n) for n in (16, 11, 16)]
        for A, b in systems:
            eng.submit_system(A, b)
        stack = torch.stack([p.A for p in eng._pending_systems]).numpy()
        eng.flush_systems()
        L = chol_blocked_sequential_batched(torch.from_numpy(stack), 8, device="cpu").numpy()
        jL = np.asarray(jchol.chol_blocked_sequential_batched(jnp.asarray(stack), v=8))
        np.testing.assert_allclose(L, jL, rtol=0, atol=1e-5 * np.abs(jL).max())

    def test_single_system_solve_and_resolve(self):
        eng = SolveEngine(32, CHOL_CFG, device="cpu")
        A, b = _spd_sys(32)
        assert _residual(A, b, eng.solve(A, b)) < 1e-4
        b2 = RNG.standard_normal(32).astype(np.float32)
        assert _residual(A, b2, eng.resolve(b2)) < 1e-4
        assert eng._last.kind == "cholesky"

    def test_async_engine_on_fake_clock_solves_spd_requests(self):
        eng, clock = _fake_engine(strategy="sequential_chol", max_batch=4, max_delay_ms=5.0)
        systems = [_spd_sys(n) for n in (32, 20, 7)]
        futs = [eng.submit(A, b, tenant=f"t{i}") for i, (A, b) in enumerate(systems)]
        assert eng.pump(now=0.0) == 0 and not futs[0].done()
        clock.t = 0.006
        assert eng.pump(now=clock.t) == 3
        for (A, b), fut in zip(systems, futs):
            assert _residual(A, b, fut.result(timeout=0)) < 1e-4
        assert eng.engine.stats()["strategy"] == "sequential_chol"
        eng.close()

    def test_async_spill_uses_the_cholesky_plan(self):
        clear_plan_cache()
        eng, _ = _fake_engine(strategy="sequential_chol", max_queue=1, overload="spill")
        A, b = _spd_sys(32)
        eng.submit(A, b)
        fut = eng.submit(A, b)  # over the tenant's bound: solved inline
        assert fut.done() and _residual(A, b, fut.result()) < 1e-4
        # the spill ran the engine's own cached Cholesky plan (slot 32 = N)
        assert eng.engine.plan.kind == "cholesky" and eng.engine.plan.execute_count == 1
        eng.close()


class TestUnportedRaise:
    def test_refine_tol_raises_at_submit_naming_item_7(self):
        """Per-request refinement is ported (ROADMAP.md module item 7): a bad
        tolerance or cap still raises at submit, before any queue."""
        eng = _engine()
        for bad in (dict(refine_tol=0.0), dict(refine_tol=-1e-6),
                    dict(refine_tol=1e-6, max_refine_iters=-1)):
            with pytest.raises(ValueError, match="refine_tol|max_refine_iters"):
                eng.submit_system(*_sys(32), **bad)
        assert eng.stats()["pending_systems"] == 0
        a, _ = _fake_engine()
        with pytest.raises(ValueError, match="refine_tol"):
            a.submit(*_sys(32), refine_tol=0.0)
        assert a.stats()["async"]["pending"] == 0  # it never reached a batch

    @pytest.mark.parametrize("strategy", ["sequential_chol", "cholesky25d"])
    def test_cholesky_engines_serve(self, strategy):
        """Both Cholesky strategies build engines (module item 8 ported the
        distributed ones; "cholesky25d" with no process group takes the
        1x1x1 grid) and answer an SPD system."""
        eng = SolveEngine(32, SolverConfig(strategy=strategy), device="cpu")
        assert eng.plan.kind == "cholesky" and eng.stats()["strategy"] == strategy
        a = AsyncSolveEngine(32, strategy=strategy, device="cpu", start=False)
        assert a.engine.plan.kind == "cholesky"
        A, b = _spd_sys(32, np.random.default_rng(5))
        np.testing.assert_allclose(eng.solve(A, b).numpy(), scipy.linalg.solve(A, b),
                                   rtol=0, atol=1e-4 * np.abs(scipy.linalg.solve(A, b)).max())
        if strategy == "cholesky25d":
            assert eng.stats()["grid"] == "[1x1x1] v=8 (P_used=1)"

    def test_engine_without_device_targets_cuda(self):
        if torch.cuda.is_available():
            assert SolveEngine(32).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                SolveEngine(32)

    def test_lm_engine_names_its_item(self):
        # The LM engine, a stub naming module item 13 until it was ported,
        # is now part of the public surface; unknown names still fail loudly.
        import repro_torch.serving as serving
        from repro_torch.serving import lm_engine

        assert serving.ServeEngine is lm_engine.ServeEngine
        assert serving.SamplerConfig is lm_engine.SamplerConfig
        assert {"ServeEngine", "SamplerConfig"} <= set(serving.__all__)
        with pytest.raises(AttributeError, match="public"):
            serving.EngineThatNeverWas  # noqa: B018


# --------------------------------------------------------------------------
# AsyncSolveEngine (tests/test_serving_async.py)
# --------------------------------------------------------------------------


class TestDeadlineTrigger:
    def test_below_batch_waits_for_deadline_then_flushes(self):
        eng, clock = _fake_engine(max_batch=8, max_delay_ms=10.0)
        A, b = _sys(32)
        fut = eng.submit(A, b)
        assert eng.pump(now=0.0) == 0
        assert eng.pump(now=0.0099) == 0
        assert not fut.done()
        clock.t = 0.0101
        assert eng.pump() == 1
        assert fut.done()
        assert _residual(A, b, fut.result()) < 5e-3

    def test_full_batch_flushes_without_waiting(self):
        eng, _ = _fake_engine(max_batch=4, max_delay_ms=1e6)
        reqs = [_sys(32) for _ in range(4)]
        futs = [eng.submit(A, b) for A, b in reqs]
        assert eng.pump(now=0.0) == 4
        for (A, b), f in zip(reqs, futs):
            assert _residual(A, b, f.result()) < 5e-3

    def test_trigger_wait_tracks_oldest_request(self):
        eng, clock = _fake_engine(max_batch=8, max_delay_ms=10.0)
        eng.submit(*_sys(32))
        clock.t = 0.004
        eng.submit(*_sys(32))  # a newer request must not extend the deadline
        with eng._cv:
            assert eng._trigger_wait_locked(0.004) == pytest.approx(0.006)
        assert eng.pump(now=0.0099) == 0
        assert eng.pump(now=0.0101) == 2

    def test_served_batch_records_latency_and_fill(self):
        eng, clock = _fake_engine(max_batch=4, max_delay_ms=10.0)
        for _ in range(2):
            eng.submit(*_sys(32))
        clock.t = 0.02
        assert eng.pump() == 2
        st = eng.stats()["async"]
        assert st["served"] == 2 and st["flushes"] == 1
        assert st["batch_fill"] == pytest.approx(0.5)
        assert st["latency_ms"]["count"] == 2
        assert st["latency_ms"]["p50"] == pytest.approx(20.0)

    def test_close_drains_pending_without_executor(self):
        eng, _ = _fake_engine(max_batch=8, max_delay_ms=1e6)
        A, b = _sys(24)
        fut = eng.submit(A, b)
        eng.close()
        assert _residual(A, b, fut.result()) < 5e-3
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(A, b)


class TestSubmitRhs:
    def test_rhs_batch_one_stacked_dispatch(self):
        eng, clock = _fake_engine(max_batch=8, max_delay_ms=10.0)
        A, _ = _sys(32)
        eng.engine.factor(A)
        reqs = [_sys(32)[1] for _ in range(3)]
        futs = [eng.submit_rhs(b, tenant="svc") for b in reqs]
        assert all(not f.done() for f in futs)
        clock.t = 0.02
        assert eng.pump() == 3
        for b, f in zip(reqs, futs):
            assert _residual(A, b, f.result()) < 5e-3
        st = eng.stats()
        assert st["batched_solves"] == 1 and st["batched_rhs"] == 3
        assert st["async"]["served"] == 3

    def test_mixed_batch_splits_onto_both_paths(self):
        eng, _ = _fake_engine(max_batch=4, max_delay_ms=1e6)
        A, _ = _sys(32)
        eng.engine.factor(A)
        b_rhs = _sys(32)[1]
        As, bs = _sys(24)
        f_rhs = eng.submit_rhs(b_rhs)
        f_sys = eng.submit(As, bs)
        assert eng.pump(force=True) == 2
        assert _residual(A, b_rhs, f_rhs.result()) < 5e-3
        assert _residual(As, bs, f_sys.result()) < 5e-3
        st = eng.stats()
        assert st["batched_rhs"] == 1 and st["batched_systems"] == 1

    def test_eager_validation(self):
        eng, _ = _fake_engine()
        with pytest.raises(RuntimeError, match="factorization"):
            eng.submit_rhs(np.zeros(32, np.float32))
        eng.engine.factor(_sys(32)[0])
        with pytest.raises(ValueError, match="single \\[N\\] RHS"):
            eng.submit_rhs(np.zeros(31, np.float32))
        with pytest.raises(ValueError, match="real"):
            eng.submit_rhs(np.zeros(32, np.complex64))
        assert eng.stats()["async"]["pending"] == 0

    def test_rhs_shed_and_spill(self):
        A, _ = _sys(32)
        eng, _ = _fake_engine(max_batch=64, max_queue=1, overload="shed")
        eng.engine.factor(A)
        eng.submit_rhs(_sys(32)[1], tenant="t")
        with pytest.raises(Overloaded):
            eng.submit_rhs(_sys(32)[1], tenant="t")
        assert eng.stats()["async"]["tenants"]["t"]["shed"] == 1

        eng, _ = _fake_engine(max_batch=64, max_queue=1, overload="spill")
        eng.engine.factor(A)
        b1, b2 = _sys(32)[1], _sys(32)[1]
        f1 = eng.submit_rhs(b1, tenant="t")
        f2 = eng.submit_rhs(b2, tenant="t")  # overflow: solved inline
        assert f2.done() and not f1.done()
        assert _residual(A, b2, f2.result()) < 5e-3
        assert eng.pump(force=True) == 1
        assert _residual(A, b1, f1.result()) < 5e-3
        assert eng.stats()["async"]["tenants"]["t"]["spilled"] == 1

    def test_rhs_failure_spares_system_half(self, monkeypatch):
        eng, _ = _fake_engine(max_batch=8, max_delay_ms=1e6)
        A, _ = _sys(32)
        eng.engine.factor(A)
        f_rhs = eng.submit_rhs(_sys(32)[1])
        As, bs = _sys(24)
        f_sys = eng.submit(As, bs)
        monkeypatch.setattr(
            eng.engine, "flush",
            lambda: (_ for _ in ()).throw(FloatingPointError("boom")))
        assert eng.pump(force=True) == 1  # the systems half still serves
        assert _residual(As, bs, f_sys.result()) < 5e-3
        with pytest.raises(FloatingPointError):
            f_rhs.result()
        st = eng.stats()
        assert st["async"]["failed"] == 1
        assert st["pending"] == 0  # the failed RHS queue was aborted, not leaked


class TestRaggedThroughAsync:
    def test_mixed_sizes_one_engine(self):
        eng, clock = _fake_engine(max_batch=8, max_delay_ms=1.0)
        reqs = [_sys(n) for n in (8, 12, 24, 32, 17)]
        futs = [eng.submit(A, b) for A, b in reqs]
        clock.t = 1.0
        assert eng.pump() == 5
        for (A, b), f in zip(reqs, futs):
            x = f.result()
            assert tuple(x.shape) == (A.shape[0],)
            assert _residual(A, b, x) < 5e-3
        assert eng.stats()["batch_pad_waste"] > 0.0

    def test_oversize_request_rejected_eagerly(self):
        eng, _ = _fake_engine()
        with pytest.raises(ValueError, match="N <= 32"):
            eng.submit(*_sys(48))
        assert eng.stats()["async"]["pending"] == 0


class TestBackpressure:
    def test_shed_raises_overloaded_and_counts(self):
        eng, _ = _fake_engine(max_queue=2, overload="shed")
        eng.submit(*_sys(32), tenant="hot")
        eng.submit(*_sys(32), tenant="hot")
        with pytest.raises(Overloaded, match="hot"):
            eng.submit(*_sys(32), tenant="hot")
        st = eng.stats()["async"]
        assert st["shed"] == 1 and st["spilled"] == 0
        assert st["tenants"]["hot"]["shed"] == 1
        assert st["shed_rate"] == pytest.approx(1 / 3)
        f = eng.submit(*_sys(32), tenant="cold")  # other tenants are unaffected
        assert not f.done()

    def test_spill_solves_inline_and_counts(self):
        eng, _ = _fake_engine(max_queue=1, overload="spill")
        eng.submit(*_sys(32), tenant="t")
        A, b = _sys(24)
        fut = eng.submit(A, b, tenant="t")  # over capacity -> inline solve
        assert fut.done()
        assert _residual(A, b, fut.result()) < 5e-3
        st = eng.stats()["async"]
        assert st["spilled"] == 1 and st["shed"] == 0
        assert st["tenants"]["t"]["spilled"] == 1
        assert st["spill_rate"] == pytest.approx(0.5)
        assert st["pending"] == 1

    def test_queue_depth_is_bounded_under_spill(self):
        eng, _ = _fake_engine(max_queue=3, overload="spill")
        for _ in range(10):
            eng.submit(*_sys(32), tenant="t")
        st = eng.stats()["async"]
        assert st["pending"] == 3
        assert st["spilled"] == 7
        assert st["queue_depth"]["max"] <= 3

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="overload policy"):
            AsyncSolveEngine(32, strategy="sequential", v=8, start=False, device="cpu",
                             overload="drop")


class TestWeightedFairness:
    def test_stride_drain_matches_weights(self):
        eng, clock = _fake_engine(max_batch=6, max_delay_ms=1.0,
                                  weights={"a": 2.0, "b": 1.0})
        for _ in range(6):
            eng.submit(*_sys(32), tenant="a")
            eng.submit(*_sys(32), tenant="b")
        clock.t = 1.0
        assert eng.pump() == 6
        st = eng.stats()["async"]["tenants"]
        assert st["a"]["served"] == 4 and st["b"]["served"] == 2
        assert eng.pump() == 6
        st = eng.stats()["async"]["tenants"]
        assert st["a"]["served"] == 6 and st["b"]["served"] == 6

    def test_idle_tenant_banks_no_credit(self):
        q = TenantQueues(max_queue=64, weights={"idle": 1.0, "busy": 1.0})

        class R:
            def __init__(self, tenant):
                self.tenant = tenant
                self.t_submit = 0.0

        for _ in range(8):
            q.push(R("busy"))
        q.drain(8)  # busy's pass advances to 8
        q.push(R("idle"))  # first activation: clamped to vtime, no backlog burst
        q.push(R("busy"))
        assert sorted(r.tenant for r in q.drain(2)) == ["busy", "idle"]


class TestFutureExceptionPropagation:
    def test_solver_failure_fails_every_future_in_batch(self, monkeypatch):
        eng, clock = _fake_engine(max_batch=4, max_delay_ms=1.0)
        futs = [eng.submit(*_sys(32)) for _ in range(3)]

        def boom():
            raise RuntimeError("solver exploded")

        monkeypatch.setattr(eng.engine, "flush_systems", boom)
        clock.t = 1.0
        assert eng.pump() == 0
        for f in futs:
            assert isinstance(f.exception(), RuntimeError)
            assert "solver exploded" in str(f.exception())
        assert eng.engine.stats()["pending_systems"] == 0
        assert eng.stats()["async"]["failed"] == 3
        monkeypatch.undo()  # the tier recovers
        A, b = _sys(16)
        f = eng.submit(A, b)
        clock.t = 2.0
        assert eng.pump() == 1
        assert _residual(A, b, f.result()) < 5e-3


class TestRealExecutor:
    """The real background thread and clock; generous timeouts (these assert
    completion, never timing)."""

    def test_futures_complete_under_threaded_load(self):
        eng = AsyncSolveEngine(32, strategy="sequential", v=8, device="cpu",
                               max_batch=4, max_delay_ms=5.0)
        try:
            reqs = [_sys((16, 24, 32)[i % 3]) for i in range(12)]
            futs = [eng.submit(A, b, tenant=f"t{i % 3}") for i, (A, b) in enumerate(reqs)]
            for (A, b), f in zip(reqs, futs):
                assert _residual(A, b, f.result(timeout=120)) < 5e-3
            st = eng.stats()["async"]
            assert st["served"] == 12 and st["latency_ms"]["count"] == 12
            assert st["flushes"] >= 3  # max_batch=4 forces several
            assert st["pending"] == 0
        finally:
            eng.close()

    def test_close_is_idempotent_and_rejects_new_work(self):
        eng = AsyncSolveEngine(32, strategy="sequential", v=8, device="cpu")
        eng.close()
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(*_sys(32))

    def test_context_manager_drains(self):
        with AsyncSolveEngine(32, strategy="sequential", v=8, device="cpu",
                              max_batch=64, max_delay_ms=1e5) as eng:
            A, b = _sys(32)
            fut = eng.submit(A, b)
        assert _residual(A, b, fut.result(timeout=0)) < 5e-3


class TestConcurrentSolveEngine:
    def test_two_threads_submitting_systems(self):
        eng = SolveEngine(16, CFG, device="cpu")
        k = 40
        tickets, systems = [[], []], [[], []]
        barrier = threading.Barrier(2)

        def worker(i):
            rng = np.random.default_rng(100 + i)
            barrier.wait()
            for _ in range(k):
                A, b = _sys(16, rng)
                systems[i].append((A, b))
                tickets[i].append(eng.submit_system(A, b))

        threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(tickets[0] + tickets[1]) == list(range(2 * k))
        xs = eng.flush_systems()
        assert len(xs) == 2 * k
        for i in (0, 1):
            for (A, b), t in zip(systems[i], tickets[i]):
                assert _residual(A, b, xs[t]) < 5e-3
        st = eng.stats()
        assert st["batched_systems"] == 2 * k and st["pending_systems"] == 0

    def test_concurrent_submit_and_flush_rhs(self):
        eng = SolveEngine(16, CFG, device="cpu")
        eng.factor(_sys(16)[0])
        per_thread, flushed = 30, [0, 0]
        barrier = threading.Barrier(2)

        def worker(i):
            rng = np.random.default_rng(200 + i)
            barrier.wait()
            for j in range(per_thread):
                eng.submit(rng.standard_normal(16).astype(np.float32))
                if j % 5 == 4:
                    flushed[i] += len(eng.flush())

        threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = sum(flushed) + len(eng.flush())
        st = eng.stats()
        assert total == 2 * per_thread
        assert st["batched_rhs"] == 2 * per_thread and st["solves"] == 2 * per_thread
        assert st["pending"] == 0


class TestMetricsRing:
    def test_percentiles_nearest_rank(self):
        r = Ring(200)
        for v in range(1, 101):
            r.record(v)
        s = r.summary()
        assert s["count"] == 100
        assert s["p50"] == 50 and s["p95"] == 95 and s["p99"] == 99
        assert s["mean"] == pytest.approx(50.5) and s["max"] == 100

    def test_window_bounds_memory(self):
        r = Ring(3)
        for v in (1, 2, 3, 4, 5):
            r.record(v)
        assert len(r) == 3 and r.count == 5
        assert sorted(r.snapshot()) == [3, 4, 5]

    def test_empty_summary_is_zeros(self):
        assert Ring(8).summary() == {"count": 0, "mean": 0.0, "max": 0.0,
                                     "p50": 0.0, "p95": 0.0, "p99": 0.0}

    def test_bad_capacity_rejected(self):
        with pytest.raises(ValueError, match="capacity"):
            Ring(0)


# --------------------------------------------------------------------------
# Engines on the distributed strategies (module item 8), 1x1x1 grids,
# against the JAX package's engines
# --------------------------------------------------------------------------


def _engine_cases():
    sys.path.insert(0, str(ENGINE_CASES.parent))
    try:
        import jax_engine_cases
    finally:
        sys.path.remove(str(ENGINE_CASES.parent))
    return jax_engine_cases


@pytest.fixture(scope="module")
def jax_engines_p1(tmp_path_factory):
    """The JAX engines' answers on the 1x1x1 grids, from
    `tests/multidev/jax_engine_cases.py p1` in a process of its own (the
    `enable_x64` shim stays there)."""
    out = tmp_path_factory.mktemp("engines") / "p1.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(ENGINE_CASES), "p1", str(out)], env=env,
                          capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return np.load(out)


def _assert_x_close(got, want, what):
    """Within 1e-4 of the solution's scale, the file's f32 tolerance."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)


class TestDistributedEngines:
    @pytest.mark.parametrize("strategy", ["conflux", "baseline2d", "cholesky25d"])
    def test_engines_match_the_jax_engines(self, strategy, jax_engines_p1):
        """`SolveEngine` and `AsyncSolveEngine` on a 1x1x1 grid: the same
        stats, pivot rows equal, every answer within 1e-4 of its scale."""
        cases = _engine_cases()
        N, v, table = cases.CASES["p1"]
        strat, shape = table[strategy]
        cfg = SolverConfig(strategy=strat, grid=GridConfig(*shape, v, N))
        got = cases.drive(SolveEngine, AsyncSolveEngine, N, cfg, cases.inputs(N, strat),
                          device="cpu")
        want = cases.unflatten(jax_engines_p1, strategy)
        assert got["stats"] == want["stats"]
        assert got["async_stats"] == want["async_stats"]
        np.testing.assert_array_equal(got["rows"], want["rows"])
        np.testing.assert_array_equal(got["async_rows"], want["async_rows"])
        for key in ("x", "x2", "flush", "async_rhs"):
            _assert_x_close(got[key], want[key], key)
        for key in ("systems", "async_systems"):
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                assert g.shape == w.shape
                _assert_x_close(g, w, f"{key}[{i}]")

    @pytest.mark.parametrize("strategy", ["conflux", "baseline2d", "cholesky25d"])
    def test_engine_answers_equal_its_plan_bit_for_bit(self, strategy):
        """`solve` is the plan's execute and solve; `resolve` and `flush`
        reuse its factors; the flushed systems run the sequential sibling's
        batched plan."""
        cases = _engine_cases()
        N, v, table = cases.CASES["p1"]
        cfg = SolverConfig(strategy=strategy, grid=GridConfig(1, 1, 1, v, N))
        inp = cases.inputs(N, strategy)
        eng = SolveEngine(N, cfg, device="cpu")
        x = eng.solve(inp["A"], inp["b"])
        fact = plan(N, cfg, device="cpu").execute(inp["A"])
        assert eng.plan is plan(N, cfg, device="cpu")
        assert torch.equal(x, fact.solve(inp["b"]))
        assert torch.equal(eng.resolve(2 * inp["b"]), fact.solve(2 * inp["b"]))
        t = eng.submit(inp["rhs"][0])
        assert torch.equal(eng.flush()[t], fact.solve(torch.from_numpy(inp["rhs"][:1].T))[:, 0])
        seq = "sequential_chol" if strategy == "cholesky25d" else "sequential"
        assert eng._batched_plan(2, 16).config.strategy == seq
        assert eng._batched_plan(2, 16).config.grid is None

    def test_distributed_engine_warms_its_sequential_slots(self):
        eng = SolveEngine(64, SolverConfig(strategy="conflux", grid=GridConfig(1, 1, 1, 8, 64)),
                          device="cpu")
        assert eng.warm_slots(sizes=(5, 40), max_batch=2) == 4
        assert eng.stats()["batched_factorizations"] == 0
