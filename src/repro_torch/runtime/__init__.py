"""Fault-tolerant runtime: training loop with restart + straggler watchdog."""

from repro_torch.runtime.loop import RunConfig, StragglerWatchdog, run_training

__all__ = ["RunConfig", "run_training", "StragglerWatchdog"]
