"""Serving tier of the port — the single public import surface.

    `SolveEngine`       — thread-safe batched solves on cached plans
                          (multi-RHS flush + ragged-N batch slots).
    `AsyncSolveEngine`  — futures, size-or-deadline batching, weighted-fair
                          multi-tenant queues with shed/spill backpressure.
    `TenantQueues`      — the bounded per-tenant queues behind it.
    `Overloaded`        — raised by `submit` under the "shed" policy.
    `Ring`              — the fixed-window latency / depth / fill samples.

Engines run on the CUDA card unless built with `device="cpu"`.  The JAX
package's LM engine (`ServeEngine`, `SamplerConfig`) belongs to the LM
stack, which is not ported yet (ROADMAP.md module item 13).
"""

from repro_torch.serving.async_engine import AsyncSolveEngine
from repro_torch.serving.metrics import Ring
from repro_torch.serving.queues import Overloaded, TenantQueues
from repro_torch.serving.solve_engine import SolveEngine

__all__ = [
    "AsyncSolveEngine",
    "Overloaded",
    "Ring",
    "SolveEngine",
    "TenantQueues",
]


def __getattr__(name: str):
    if name in ("ServeEngine", "SamplerConfig"):
        raise AttributeError(
            f"{name} is the LM stack's engine, not ported yet: ROADMAP.md module item 13"
        )
    raise AttributeError(
        f"module 'repro_torch.serving' has no attribute {name!r}; the public "
        f"surface is {__all__}"
    )
