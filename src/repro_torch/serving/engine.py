"""Removed module: the LM serving engine lives in `repro_torch.serving.lm_engine`.

The serving package is laid out around the solver's serving tiers:
`solve_engine` (the batched SolveEngine), `async_engine` (AsyncSolveEngine:
futures, deadline batching, backpressure), `queues`, `metrics`, and
`lm_engine` (the static-batch LM ServeEngine).  Import from the package:

    from repro_torch.serving import ServeEngine, SamplerConfig
"""

raise ImportError(
    "repro_torch.serving.engine is not a module of the serving package: import "
    "ServeEngine and SamplerConfig from repro_torch.serving (the class lives in "
    "repro_torch.serving.lm_engine)"
)
