"""The scenario mesh: the what-if batch's scenario axis over local devices.

Counterparts: ``kubernetes_simulator_tpu/parallel/mesh.py`` — ``make_mesh``
(:89) and ``fit_population`` (:198), in the one-process case (the DCN
factorisations of the latter belong to the fleet, ROADMAP queue A item
11).

The reference's scenario mesh is a 1-D ``jax.sharding.Mesh`` whose one
axis, ``"scenarios"``, shards every per-scenario tensor of the batch; its
chunk program runs collective-free under ``shard_map``. Scenarios are
independent, so here a mesh is an ordered list of torch devices: the
batch of S scenarios splits into contiguous blocks of S / ndev, block i on
device i (:class:`..sim.whatif.WhatIfEngine`), each running the chunk
route it would run unsplit, and the blocks' results come back in scenario
order. A device may appear more than once (``[cuda:0, cuda:0]`` splits the
batch on one card), which exercises the split where there is one device,
as the reference's tests exercise theirs on 8 virtual CPU devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils.metrics import log

#: The mesh's one axis (the reference's ``SCENARIO_AXIS``).
SCENARIO_AXIS = "scenarios"


def _normalize(dev) -> torch.device:
    """``dev`` as a torch device; a bare ``cuda`` names the current card."""
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None
              ) -> List[torch.device]:
    """The scenario mesh: every card that ``torch.cuda.device_count()``
    sees, in index order (or ``devices``, any torch devices, repeats
    allowed), cut to the first ``num_devices`` as the reference cuts
    ``jax.devices()``. Without ``devices`` a host with no card raises: the
    port never moves a batch to the CPU unless the caller asks."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA card is visible (torch.cuda.device_count() is 0); pass "
                "devices=[...] to build a mesh of other devices, e.g. [torch.device('cpu')]"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [_normalize(d) for d in devices]
    if num_devices is not None:
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return devs


def mesh_shape(mesh: Optional[Sequence]) -> Optional[dict]:
    """``{axis name: size}`` of ``mesh`` (None without one), as
    ``WhatIfResult.mesh_shape`` reports it."""
    return None if mesh is None else {SCENARIO_AXIS: len(mesh)}


def fit_population(population: int, per_candidate: int, mesh: Optional[Sequence]) -> int:
    """Smallest population >= ``population`` whose flat sweep axis
    (population x per_candidate scenarios) divides over the mesh's devices
    (the reference's one-process case): the policy tuner flattens
    (candidate, train scenario) pairs onto the scenario axis, a meshed
    batch needs that axis to divide evenly, and the extra candidates are
    fresh samples. A padded population is logged with the reference's
    line."""
    requested = population = max(int(population), 1)
    if mesh is None:
        return population
    ndev = len(mesh)
    while (population * per_candidate) % ndev:
        population += 1
    if population != requested:
        log.info(
            "fit_population: padded population %d -> %d (+%d rows) so the "
            "flat axis (%d x %d) divides over %s",
            requested, population, population - requested,
            population, per_candidate, f"{ndev} mesh devices",
        )
    return population
