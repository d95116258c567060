"""Decorator-based strategy registry.

A *strategy* is a plan builder:
``(N, SolverConfig, device, mesh=None) -> FactorizationPlan``.
Registering one makes it addressable by name from `SolverConfig.strategy`
without touching any call site — a future QR or a new backend drops in with
a single decorated function:

    @register_strategy("qr25d")
    def _build(N, config, device, mesh=None):
        ...
        return FactorizationPlan(...)
"""

from __future__ import annotations

from typing import Callable

_STRATEGIES: dict[str, Callable] = {}


def register_strategy(name: str, *, overwrite: bool = False):
    """Class/function decorator adding a plan builder under `name`."""

    def deco(builder: Callable) -> Callable:
        if name in _STRATEGIES and not overwrite:
            raise ValueError(f"strategy {name!r} already registered; pass overwrite=True")
        builder.strategy_name = name
        _STRATEGIES[name] = builder
        return builder

    return deco


def get_strategy(name: str) -> Callable:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {available_strategies()}"
        ) from None


def available_strategies() -> list[str]:
    return sorted(_STRATEGIES)
