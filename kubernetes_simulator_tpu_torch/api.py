"""High-level facade of the port: the one-stop API a user reaches for.

    sim = Simulator(cluster, pods)                    # the device engine, on the card
    result = sim.run()
    sim.run(checkpoint_path="ck.npz", checkpoint_every=16)
    sim.run(checkpoint_path="ck.npz", resume=True)
    whatif = sim.what_if(scenarios=256, fork_checkpoint="ck.npz")
    tuned = sim.tune(rounds=6, population=16)

    svc = SimulatorService(cluster, pods)
    svc.submit({"op": "defrag", "tenant": "a", "id": "q1",
                "nodes": [3, 4], "drainAt": 5.0, "recoverAt": 12.0})
    rows = svc.poll("a")
    svc.close()

Counterpart: ``kubernetes_simulator_tpu/api.py``, method for method. One
difference: the default strategy is the port's device engine (``"torch"``,
:mod:`.sim.torch_runtime`), as a config without ``strategy:`` runs it
(the reference's default is its CPU event engine); ``strategy="cpu"``
selects the CPU event engine (:mod:`.sim.runtime`), which runs on the
host. ``device`` (default ``"cuda"``: the kernels; ``"cpu"``: their plain
twins) goes to every device engine the facade builds: the replay, the
what-if batch, the tuner and the query service.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .framework.framework import FrameworkConfig
from .framework.registry import available_strategies, get_strategy
from .models.core import Cluster, Pod
from .models.encode import encode


class Simulator:
    def __init__(
        self,
        cluster: Cluster,
        pods: Sequence[Pod],
        strategy: str = "torch",
        plugins: Optional[List[dict]] = None,
        weights: Optional[dict] = None,
        enable_preemption: bool = True,
        device="cuda",
        **engine_kw,
    ):
        self.cluster = cluster
        self.pods = list(pods)
        self.strategy = strategy
        self.device = device
        self.config = FrameworkConfig(
            plugins=plugins, weights=weights, enable_preemption=enable_preemption
        )
        self.engine_kw = engine_kw
        from .plugins.builtin import inject_default_spread, resolved_default_constraints

        if resolved_default_constraints(self.config):
            # Copies of the pods with their own topology_spread lists (the
            # only field the injector appends to): the caller's Pod objects
            # are never changed.
            import dataclasses

            self.pods = [
                dataclasses.replace(p, topology_spread=list(p.topology_spread))
                for p in self.pods
            ]
            inject_default_spread(self.pods, self.config)
        self.ec, self.ep = encode(cluster, self.pods)

    def _device_kw(self) -> dict:
        """``device=`` for the strategy's engine (the CPU event engine has none)."""
        return {} if self.strategy == "cpu" else {"device": self.device}

    def run(self, timeline_out: Optional[str] = None, **replay_kw):
        """One replay with the configured strategy; ``replay_kw`` goes to
        ``replay`` (``checkpoint_path``, ``checkpoint_every``, ``resume``,
        ``node_events``). ``timeline_out`` writes the simulated cluster
        timeline as a Chrome trace JSON (Perfetto-loadable), forcing
        ``telemetry='timeline'`` unless the caller picked a granularity."""
        engine_kw = dict(self.engine_kw)
        if timeline_out and "telemetry" not in engine_kw:
            engine_kw["telemetry"] = "timeline"
        engine = get_strategy(self.strategy)(self.ec, self.ep, self.config,
                                             **self._device_kw(), **engine_kw)
        res = engine.replay(**replay_kw)
        if timeline_out and getattr(res, "telemetry", None) is not None:
            from .sim.telemetry import write_chrome_trace

            write_chrome_trace(timeline_out, res, arrival=self.ep.arrival,
                               duration=self.ep.duration)
        return res

    def what_if(
        self,
        scenarios=None,
        num_scenarios: int = 0,
        seed: int = 0,
        mesh: bool = False,
        collect_assignments: bool = False,
        fork_checkpoint: Optional[str] = None,
        **kw,
    ):
        """A what-if batch over cluster-state perturbations: explicit
        ``scenarios`` (a list of :class:`.sim.whatif.Scenario`) or
        ``num_scenarios`` from the uniform sampler; ``fork_checkpoint``
        starts every scenario from a replay's checkpoint. Repeated calls of
        the same shape reuse ONE resident engine, whose scenario stacks swap
        in place (:meth:`.sim.whatif.WhatIfEngine.set_scenarios`, no new
        set-up); a batch that engine refuses builds a new one."""
        from .parallel.mesh import make_mesh
        from .sim.whatif import WhatIfEngine, uniform_scenarios

        if scenarios is None:
            scenarios = uniform_scenarios(self.ec, num_scenarios, seed=seed)
        scenarios = list(scenarios)
        key = (len(scenarios), bool(mesh), bool(collect_assignments), fork_checkpoint,
               repr(sorted(kw.items())))
        cached = getattr(self, "_whatif_cache", None)
        if cached is not None and cached[0] == key:
            try:
                cached[1].set_scenarios(scenarios)
                return cached[1].run()
            except ValueError:
                self._whatif_cache = None
        eng = WhatIfEngine(
            self.ec, self.ep, scenarios, self.config,
            mesh=make_mesh() if mesh else None,
            collect_assignments=collect_assignments,
            fork_checkpoint=fork_checkpoint, device=self.device, **kw,
        )
        self._whatif_cache = (key, eng)
        return eng.run()

    def tune(
        self,
        algo: str = "cem",
        population: int = 16,
        rounds: int = 6,
        seed: int = 0,
        objective: Optional[dict] = None,
        mesh: bool = False,
        output: Optional[str] = None,
        **kw,
    ):
        """Policy tuning (:class:`.sim.tuner.PolicyTuner`): a seeded search
        over the Score-plugin weights and the NodeResourcesFit strategy,
        each round's candidates evaluated in one what-if batch. ``output``
        streams the trajectory as schema-v3 JSONL; ``kw`` goes to the
        tuner."""
        from .parallel.mesh import make_mesh
        from .sim.tuner import PolicyTuner
        from .utils.metrics import JsonlWriter

        tuner = PolicyTuner(
            self.ec, self.ep, self.config, algo=algo, population=population, rounds=rounds,
            seed=seed, objective=objective, mesh=make_mesh() if mesh else None,
            device=self.device, **kw,
        )
        if output is None:
            return tuner.run()
        with JsonlWriter(output) as out:
            return tuner.run(writer=out)

    def chaos_timeline(
        self,
        seed: int = 0,
        mtbf: float = 200.0,
        mttr: float = 20.0,
        node_fraction: float = 0.2,
        horizon: Optional[float] = None,
        max_events: Optional[int] = None,
    ):
        """A seeded MTBF/MTTR failure and recovery timeline for this
        cluster, for ``run(node_events=...)`` or ``Scenario(events=...)``;
        the horizon defaults to the trace's last arrival."""
        from .sim.synthetic import make_chaos_timeline

        if horizon is None:
            horizon = float(self.ep.arrival.max())
        return make_chaos_timeline(
            self.ec.num_nodes, seed=seed, horizon=horizon, mtbf=mtbf, mttr=mttr,
            node_fraction=node_fraction, max_events=max_events,
        )

    @staticmethod
    def strategies() -> List[str]:
        for name in ("cpu", "torch"):
            get_strategy(name)  # registers the built-in strategies
        return available_strategies()


class SimulatorService:
    """The resident what-if query service (:class:`.sim.service.QueryService`)
    behind the facade: the cluster and the trace are encoded once and the
    engines stay resident between queries; tenants submit queries and poll
    their results, bind / release / evict deltas change the live base
    state. ``service_kw`` (``max_batch``, ``batch_deadline_s``,
    ``max_engines``, ``granularity``, ``retry_buffer``, ``wave_width``,
    ``chunk_waves``, ``writer``, ``flight``, ``device``) goes to the
    service."""

    def __init__(
        self,
        cluster: Cluster,
        pods: Sequence[Pod],
        plugins: Optional[List[dict]] = None,
        weights: Optional[dict] = None,
        **service_kw,
    ):
        from .sim.service import QueryService

        config = FrameworkConfig(plugins=plugins, weights=weights)
        ec, ep = encode(cluster, list(pods))
        self._svc = QueryService(ec, ep, config, **service_kw)

    def submit(self, query: dict):
        """Admit one query dict; returns ``(tenant, id)``."""
        return self._svc.submit(query)

    def poll(self, tenant: Optional[str] = None) -> List[dict]:
        """Drain finished results (one tenant, or all)."""
        return self._svc.poll(tenant)

    def flush(self) -> int:
        """Answer every pending query now (ignore the deadline)."""
        return self._svc.flush()

    def stats(self) -> dict:
        return self._svc.stats()

    def apply_bind(self, bind_id: str, node, requests) -> None:
        self._svc.apply_bind(bind_id, node, requests)

    def apply_release(self, bind_id: str) -> None:
        self._svc.apply_release(bind_id)

    def apply_evict(self, node) -> List[str]:
        return self._svc.apply_evict(node)

    def close(self) -> List[dict]:
        """Flush, drop the engine pool, return undelivered results."""
        return self._svc.close()

    def __enter__(self) -> "SimulatorService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
