"""Scheduler configuration.

Counterpart: ``kubernetes_simulator_tpu/framework/framework.py`` — the
plugin list and Score weights of its :class:`FrameworkConfig`, and its
``enable_preemption`` switch (``profile.preemption``), which only the
reference's CPU event engine reads (its PostFilter); the port does not
carry that engine yet. The JAX package's host ``SchedulerFramework`` (the numpy
per-plugin chain) has its PyTorch counterpart in :mod:`..ops.reference`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class FrameworkConfig:
    plugins: Optional[List[dict]] = None  # [{"name":..., "args": {...}}]
    weights: Optional[Dict[str, float]] = None  # Score weights by plugin name
    # PostFilter preemption of the CPU event engine (profile.preemption).
    enable_preemption: bool = True
