"""YAML configuration.

Counterpart: ``kubernetes_simulator_tpu/utils/config.py`` (``SimConfig``,
``WhatIfSpec``, ``build_case``, ``build_encoded_case``) — the sections the
port runs: the synthetic ``cluster``/``workload``, the ``profile``
(plugins, weights, ``preemption``), ``telemetry`` (with ``timelineOut``,
which promotes the granularity to ``timeline``), ``output``,
``strategy`` (``jax`` and ``torch`` run the port's engine; ``cpu``, the
reference's CPU event engine, is refused by name; a config without the key
runs the port's engine), ``waveWidth``,
``chunkWaves``, ``devicePreemption`` (``true`` / ``"tier"``: tier
preemption; ``"kube"`` is refused) and ``whatIf`` (``scenarios``,
``seed``, ``nodeDownP``, ``capacityP``, ``taintP``, ``completions``,
``retryBuffer``: the unschedulable-retry buffer of ``run`` and
``what-if``) and ``tune`` (the policy tuner; ``mesh: true`` and
``evaluator: cpu`` are refused by name). Parsing is the reference's, key
for key, so one YAML file yields the same encoded case and the same
scenario batch in both packages; the reference's ``validate`` refusals of a retry buffer
(kubernetes_simulator_tpu/cli.py:705-730) raise ``ValueError`` here.

Every other section of the JAX package's schema belongs to a mode the port
does not carry yet; :meth:`SimConfig.from_dict` refuses it with an error
naming the section instead of silently running something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

from ..framework.framework import FrameworkConfig


@dataclass
class SyntheticClusterSpec:
    nodes: int = 100
    seed: int = 0
    taint_fraction: float = 0.0
    zones: int = 8
    extended_resources: Optional[Dict[str, Any]] = None


@dataclass
class SyntheticWorkloadSpec:
    pods: int = 1000
    seed: int = 0
    affinity: bool = False
    spread: bool = False
    tolerations: bool = False
    gang_fraction: float = 0.0
    gang_size: int = 4
    arrival_rate: float = 100.0
    duration_mean: Optional[float] = None
    num_apps: int = 20


@dataclass
class WhatIfSpec:
    scenarios: int = 0
    seed: int = 0
    node_down_p: float = 0.02
    capacity_p: float = 0.3
    taint_p: float = 0.1
    # None = default-on completions; True/False are the explicit forms.
    completions: Optional[bool] = None
    # Unschedulable-retry buffer slots per scenario (0 = off).
    retry_buffer: int = 0


@dataclass
class TuneSpec:
    """Policy-tuner section (``tune:`` YAML; the reference's ``TuneSpec``,
    utils/config.py:115-170): a seeded search over the Score policy
    surface of the ``profile:`` scheduler against scenarios derived from
    the config's cluster/workload (:mod:`..sim.tuner`). ``objective`` maps
    metric name → weight (maximized; costs use negative weights);
    ``output`` is the trajectory JSONL sink (falls back to the top-level
    ``output``). ``mesh: true`` and ``evaluator: cpu`` are refused."""

    algo: str = "cem"
    population: int = 16
    rounds: int = 6
    seed: int = 0
    elite_frac: float = 0.25
    objective: Optional[Dict[str, float]] = None
    constraints: Optional[List[Dict[str, float]]] = None
    evaluator: str = "auto"
    train_scenarios: int = 4
    heldout_scenarios: int = 2
    scenario_seed: int = 0
    node_down_p: float = 0.02
    capacity_p: float = 0.3
    taint_p: float = 0.1
    weight_bounds: Optional[List[float]] = None
    tune_strategy: bool = True
    cpu_oracle: bool = True
    cpu_envelope: float = 1e-6
    output: Optional[str] = None


def _tune_spec(tu: dict) -> TuneSpec:
    """The reference's parsing of ``tune:`` (utils/config.py:435-460), key
    for key; ``mesh: true`` and ``evaluator: cpu`` are refused by name."""
    if bool(tu.get("mesh", False)):
        _refuse("tune.mesh", "a policy sweep over several cards, queue A item 10")
    if str(tu.get("evaluator", "auto")) == "cpu":
        _refuse("tune.evaluator: cpu",
                "the host evaluator on the CPU event engine, queue A item 13")
    sc = tu.get("scenarios", {}) or {}
    wb = tu.get("weightBounds")
    return TuneSpec(
        algo=str(tu.get("algo", "cem")),
        population=int(tu.get("population", 16)),
        rounds=int(tu.get("rounds", 6)),
        seed=int(tu.get("seed", 0)),
        elite_frac=float(tu.get("eliteFrac", 0.25)),
        objective=tu.get("objective"),
        constraints=tu.get("constraints"),
        evaluator=str(tu.get("evaluator", "auto")),
        train_scenarios=int(sc.get("train", 4)),
        heldout_scenarios=int(sc.get("heldout", 2)),
        scenario_seed=int(sc.get("seed", 0)),
        node_down_p=float(sc.get("nodeDownP", 0.02)),
        capacity_p=float(sc.get("capacityP", 0.3)),
        taint_p=float(sc.get("taintP", 0.1)),
        weight_bounds=[float(wb[0]), float(wb[1])] if wb is not None else None,
        tune_strategy=bool(tu.get("tuneStrategy", True)),
        cpu_oracle=bool(tu.get("cpuOracle", True)),
        cpu_envelope=float(tu.get("cpuEnvelope", 1e-6)),
        output=tu.get("output"),
    )


def _coerce_completions(v: object) -> Optional[bool]:
    """None stays None (default on); bool/int coerce to bool; anything
    else is a config error."""
    if v is None:
        return None
    if isinstance(v, (bool, int)):
        return bool(v)
    raise ValueError(f"whatIf.completions: must be true or false, got {v!r}")


#: Sections of the JAX package's schema the port refuses, with the mode
#: each one selects.
_REFUSED_SECTIONS = {
    "chaos": "chaos node-event timelines",
    "dcn": "the multi-process fleet",
    "service": "the resident query service",
    "flightRecorder": "the flight recorder",
    "faultline": "fleet fault injection",
    "overlap": "the stall-hiding overlap gates",
}


#: Strategies whose configs the port runs on its engine (the reference's
#: device strategy and the port's own).
STRATEGIES = ("jax", "torch")


def _strategy(v) -> str:
    """``strategy:`` of a config: ``jax`` / ``torch`` run; ``cpu`` (the
    reference's default, its CPU event engine with the PostFilter) is not
    ported; any other name raises as the reference's registry does."""
    s = "torch" if v is None else str(v)
    if s == "cpu":
        raise NotImplementedError(
            "strategy 'cpu' (the CPU event engine, CpuReplayEngine, with its PostFilter "
            "preemption) is not ported yet (queue A item 13); run it with the JAX package "
            "(python -m kubernetes_simulator_tpu), or set strategy: jax"
        )
    if s not in STRATEGIES:
        raise KeyError(f"unknown strategy {s!r}; registered: {sorted(STRATEGIES + ('cpu',))}")
    return s


def _refuse(section: str, what: str) -> None:
    raise NotImplementedError(
        f"config section {section!r} ({what}) is not supported by the "
        "PyTorch port yet; run it with the JAX package "
        "(python -m kubernetes_simulator_tpu)"
    )


@dataclass
class SimConfig:
    strategy: str = "torch"
    cluster: SyntheticClusterSpec = field(default_factory=SyntheticClusterSpec)
    workload: SyntheticWorkloadSpec = field(default_factory=SyntheticWorkloadSpec)
    framework: FrameworkConfig = field(default_factory=FrameworkConfig)
    telemetry: str = "summary"
    # Chrome-trace path of the simulated cluster timeline (telemetry.timelineOut).
    timeline_out: Optional[str] = None
    output: Optional[str] = None
    wave_width: int = 8
    chunk_waves: int = 1024
    whatif: WhatIfSpec = field(default_factory=WhatIfSpec)
    # False, or tier preemption (True / "tier"); "kube" is refused.
    device_preemption: object = False
    tune: Optional[TuneSpec] = None

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        wi = d.get("whatIf") or {}
        if wi.get("mesh", False):
            _refuse("whatIf.mesh", "the scenario axis over several cards")
        for section, what in _REFUSED_SECTIONS.items():
            if d.get(section) is not None:
                _refuse(section, what)
        dp = d.get("devicePreemption", False)
        if dp == "kube":
            _refuse("devicePreemption: kube",
                    "kube preemption, the boundary PostFilter pass with the retry buffer")
        if dp not in (True, False, "tier"):
            raise ValueError(
                f"devicePreemption: must be true/false/'tier'/'kube', got {dp!r}"
            )
        rb = int(wi.get("retryBuffer", 0) or 0)
        if rb < 0:
            raise ValueError("whatIf.retryBuffer: must be >= 0")
        if rb and dp in (True, "tier"):
            raise ValueError("whatIf.retryBuffer is not supported with tier devicePreemption")
        if rb and _coerce_completions(wi.get("completions")) is False:
            raise ValueError(
                "whatIf.retryBuffer requires the device-release path; remove "
                "whatIf.completions: false (the retry pass runs at completion boundaries)"
            )
        if int(d.get("nodeShards", 0) or 0) > 1:
            _refuse("nodeShards", "node-sharded replay")
        if d.get("pagedWaves", False):
            _refuse("pagedWaves", "paged pod waves")
        cfg = cls()
        cfg.strategy = _strategy(d.get("strategy"))
        cl = d.get("cluster", {})
        syn = cl.get("synthetic", cl) or {}
        cfg.cluster = SyntheticClusterSpec(
            nodes=int(syn.get("nodes", 100)),
            seed=int(syn.get("seed", 0)),
            taint_fraction=float(syn.get("taintFraction", 0.0)),
            zones=int(syn.get("zones", 8)),
            extended_resources=syn.get("extendedResources"),
        )
        wl = d.get("workload", {})
        if "borg" in wl:
            _refuse("workload.borg", "Borg-shaped traces")
        syn = wl.get("synthetic", wl) or {}
        cfg.workload = SyntheticWorkloadSpec(
            pods=int(syn.get("pods", 1000)),
            seed=int(syn.get("seed", 0)),
            affinity=bool(syn.get("affinity", False)),
            spread=bool(syn.get("spread", False)),
            tolerations=bool(syn.get("tolerations", False)),
            gang_fraction=float(syn.get("gangFraction", 0.0)),
            gang_size=int(syn.get("gangSize", 4)),
            arrival_rate=float(syn.get("arrivalRate", 100.0)),
            duration_mean=syn.get("durationMean"),
            num_apps=int(syn.get("numApps", 20)),
        )
        prof = d.get("profile", {})
        cfg.framework = FrameworkConfig(
            plugins=prof.get("plugins"), weights=prof.get("weights"),
            enable_preemption=bool(prof.get("preemption", True)),
        )
        tl = d.get("telemetry")
        if tl is not None:
            cfg.telemetry = str(tl.get("granularity", "summary"))
            cfg.timeline_out = tl.get("timelineOut")
            if cfg.timeline_out and cfg.telemetry != "off":
                cfg.telemetry = "timeline"  # a timeline sink needs timeline events
        cfg.output = d.get("output")
        ww = d.get("waveWidth", 8)
        cfg.wave_width = 8 if ww == "auto" else int(ww)
        cfg.chunk_waves = int(d.get("chunkWaves", 1024))
        cfg.device_preemption = dp if isinstance(dp, str) else bool(dp)
        cfg.whatif = WhatIfSpec(
            scenarios=int(wi.get("scenarios", 0)),
            seed=int(wi.get("seed", 0)),
            node_down_p=float(wi.get("nodeDownP", 0.02)),
            capacity_p=float(wi.get("capacityP", 0.3)),
            taint_p=float(wi.get("taintP", 0.1)),
            completions=_coerce_completions(wi.get("completions")),
            retry_buffer=rb,
        )
        if d.get("tune") is not None:
            cfg.tune = _tune_spec(d["tune"])
        return cfg

    @classmethod
    def load(cls, path: str) -> "SimConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


def build_case(cfg: SimConfig):
    """Materialize (cluster, pods) from a SimConfig."""
    from ..plugins.builtin import inject_default_spread
    from ..sim.synthetic import make_cluster, make_workload

    ext = None
    if cfg.cluster.extended_resources:
        ext = {k: tuple(v) for k, v in cfg.cluster.extended_resources.items()}
    cluster = make_cluster(
        cfg.cluster.nodes,
        seed=cfg.cluster.seed,
        num_zones=cfg.cluster.zones,
        taint_fraction=cfg.cluster.taint_fraction,
        extended_resources=ext,
    )
    wl = cfg.workload
    pods, _ = make_workload(
        wl.pods,
        seed=wl.seed,
        arrival_rate=wl.arrival_rate,
        duration_mean=wl.duration_mean,
        with_affinity=wl.affinity,
        with_spread=wl.spread,
        with_tolerations=wl.tolerations,
        num_apps=wl.num_apps,
        gang_fraction=wl.gang_fraction,
        gang_size=wl.gang_size,
    )
    inject_default_spread(pods, cfg.framework)
    return cluster, pods


def build_encoded_case(cfg: SimConfig):
    """(EncodedCluster, EncodedPods) for a SimConfig."""
    from ..models.encode import encode

    return encode(*build_case(cfg))
