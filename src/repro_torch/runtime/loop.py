"""Fault-tolerant training loop, as the JAX package's `repro/runtime/loop.py`.

- checkpoint/restart: resumes from the latest atomic checkpoint; an injected
  (or real) failure rolls back to a fresh state from the seed, restores the
  latest checkpoint and replays.  With the step-keyed data pipeline the
  resumed run is bit-identical to an uninterrupted one, as long as every
  op the step runs is deterministic: the loop runs under
  `torch.use_deterministic_algorithms(True, warn_only=True)` unless
  `RunConfig.deterministic` is off (on the card the gathers' backward, a
  scatter-add, is atomic otherwise), and an op with no deterministic form
  warns instead of raising.
- straggler watchdog: rolling median step time; steps slower than
  `straggler_factor` x median raise an alarm counter.

The step boundary is `loss.item()`, which waits for the step's work on the
device, as the JAX loop's `float(metrics["loss"])` does.

Data parallelism (`group`: every rank of the process group calls
`run_training` with the same arguments): each rank builds the same global
batch from the step and runs the data-parallel step
(`repro_torch.training.make_train_step(group=...)`).  Rank 0 writes each
checkpoint and waits for the write to complete; a barrier then holds every
rank until it has, so every rank restores the same step.  The injected
failure is keyed by the step, so it fires on every rank at the same step
and all ranks roll back together.  A real failure of one rank leaves the
others waiting in a collective: the job ends there (the group's timeout),
and a restart (torchrun's) resumes every rank from the latest checkpoint.
The checkpoint directory must be one that every rank reads.

With `rules` as well (the JAX rules on the group's ("data", "model") mesh:
`mesh`, or (R, 1) by default, the launcher's), the state is sharded by
them (`init_train_state(rules=..., mesh=...)`, `repro_torch.parallel.
fsdp` and `.tensor`): every rank then calls the save, which gathers each
cut leaf whole, and rank 0 writes it; a restore places each rank's
blocks.  Under `make_rules(fsdp=False)` on (R, 1) the state stays whole on
every rank.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

log = logging.getLogger("repro_torch.runtime")


class StragglerWatchdog:
    def __init__(self, window: int = 32, factor: float = 3.0):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.alarms = 0
        self.slow_steps: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                self.alarms += 1
                self.slow_steps.append(step)
                slow = True
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
        self.times.append(dt)
        return slow


@dataclass
class RunConfig:
    total_steps: int
    ckpt_every: int = 10
    max_restarts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    metrics: list = field(default_factory=list)
    deterministic: bool = True  # the port's own: see the module docstring


@contextmanager
def _deterministic(on: bool):
    """`torch.use_deterministic_algorithms(True, warn_only=True)` while the
    block runs if `on`; the process's setting is restored after."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    if on:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def run_training(
    model,
    data_cfg: DataConfig,
    opt_cfg: OptConfig,
    run_cfg: RunConfig,
    ckpt: Checkpointer,
    *,
    seed: int = 0,
    fail_injector: Callable[[int], None] | None = None,
    train_step_kw: dict | None = None,
    group=None,
    rules=None,
    mesh=None,
) -> dict:
    """Run (or resume) training of `model` to total_steps; survives injected
    failures.  A fresh state draws the parameters from a generator on the
    model's device seeded with `seed`.  Runs under deterministic algorithms
    unless run_cfg.deterministic is off.  With `group`, data-parallel over
    its ranks, the state sharded by `rules` on `mesh` where they split it
    (module docstring)."""
    writer = group is None or dist.get_rank(group) == 0

    def save(step: int, state) -> None:
        if writer or state.params.fsdp is not None:  # a sharded save gathers on every rank
            ckpt.save(step, state)
        if group is not None:
            if writer:
                ckpt.wait()
            dist.barrier(group=group)
    watchdog = StragglerWatchdog(factor=run_cfg.straggler_factor)
    restarts = 0

    def fresh_state():
        return init_train_state(model, torch.Generator(device=model.device).manual_seed(seed),
                                opt_cfg, rules=rules if group is not None else None,
                                group=group, mesh=mesh if group is not None else None)

    with _deterministic(run_cfg.deterministic):
        state = fresh_state()
        # built on the sharded model: its ranks along "model" share the rows
        train_step = make_train_step(model, opt_cfg, group=group, **(train_step_kw or {}))
        start = ckpt.latest_step()
        if start is not None:
            state = ckpt.restore(state, step=start)
            log.info("resumed from step %d", start)
        step = int(state.step)

        while step < run_cfg.total_steps:
            try:
                batch = synthetic_batch(data_cfg, step, model.cfg)
                t0 = time.perf_counter()
                if fail_injector is not None:
                    fail_injector(step)
                state, metrics = train_step(state, batch)
                loss = metrics["loss"].item()  # waits for the step: its boundary
                watchdog.observe(step, time.perf_counter() - t0)
                step = int(state.step)
                run_cfg.metrics.append({"step": step, "loss": loss})
                if step % run_cfg.log_every == 0:
                    log.info("step %d loss %.4f", step, loss)
                if step % run_cfg.ckpt_every == 0 or step == run_cfg.total_steps:
                    save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # node failure, injected or real
                restarts += 1
                log.warning("failure at step %d (%s); restart %d", step, e, restarts)
                if restarts > run_cfg.max_restarts:
                    raise
                state = fresh_state()
                last = ckpt.latest_step()
                if last is not None:
                    state = ckpt.restore(state, step=last)
                step = int(state.step)

    ckpt.wait()
    return {
        "final_state": state,
        "restarts": restarts,
        "straggler_alarms": watchdog.alarms,
        "metrics": run_cfg.metrics,
    }
