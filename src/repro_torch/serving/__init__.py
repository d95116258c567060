"""Serving tier of the port — the single public import surface.

    `SolveEngine`       — thread-safe batched solves on cached plans
                          (multi-RHS flush + ragged-N batch slots).
    `AsyncSolveEngine`  — futures, size-or-deadline batching, weighted-fair
                          multi-tenant queues with shed/spill backpressure.
    `TenantQueues`      — the bounded per-tenant queues behind it.
    `Overloaded`        — raised by `submit` under the "shed" policy.
    `Ring`              — the fixed-window latency / depth / fill samples.

LM:
    `ServeEngine`, `SamplerConfig` — static-batch prefill/decode engine.

Engines run on the CUDA card unless built with `device="cpu"`.
"""

from repro_torch.serving.async_engine import AsyncSolveEngine
from repro_torch.serving.lm_engine import SamplerConfig, ServeEngine
from repro_torch.serving.metrics import Ring
from repro_torch.serving.queues import Overloaded, TenantQueues
from repro_torch.serving.solve_engine import SolveEngine

__all__ = [
    "AsyncSolveEngine",
    "Overloaded",
    "Ring",
    "SamplerConfig",
    "ServeEngine",
    "SolveEngine",
    "TenantQueues",
]


def __getattr__(name: str):
    raise AttributeError(
        f"module 'repro_torch.serving' has no attribute {name!r}; the public "
        f"surface is {__all__}"
    )
