"""Scheduler-strategy registry.

Counterpart: ``kubernetes_simulator_tpu/framework/registry.py``. A
strategy factory receives the encoded cluster + workload and the
framework config and returns a replay engine exposing ``replay()``. The
port registers two strategies: ``"torch"``, the device engine
(:mod:`..sim.torch_runtime`), and ``"cpu"``, the CPU event engine
(:mod:`..sim.runtime`); each module registers its own on import.
"""

from __future__ import annotations

from typing import Callable, Dict

_STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str):
    def deco(factory: Callable) -> Callable:
        if name in _STRATEGIES:
            raise ValueError(f"strategy {name!r} already registered")
        _STRATEGIES[name] = factory
        return factory

    return deco


def get_strategy(name: str) -> Callable:
    if name not in _STRATEGIES and name == "torch":
        from ..sim import torch_runtime  # noqa: F401  (registers "torch")
    if name not in _STRATEGIES and name == "cpu":
        from ..sim import runtime  # noqa: F401  (registers "cpu")
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; registered: {sorted(_STRATEGIES)}"
        ) from None


def available_strategies():
    return sorted(_STRATEGIES)
