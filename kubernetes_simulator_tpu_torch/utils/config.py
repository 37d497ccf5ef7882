"""YAML configuration.

Counterpart: ``kubernetes_simulator_tpu/utils/config.py`` (``SimConfig``,
``BorgWorkloadSpec``, ``WhatIfSpec``, ``build_case``, ``build_encoded_case``)
— the sections the port runs: the synthetic ``cluster``/``workload`` or a
Borg-shaped ``workload.borg`` (generated from its seed, read from a
task-event CSV, ``tracePath``, or from the 2019 tables, ``instanceEvents``
/ ``collectionEvents``; :mod:`..sim.borg`, :mod:`..sim.borg_etl`), the ``profile``
(plugins, weights, ``preemption``), ``telemetry`` (with ``timelineOut``,
which promotes the granularity to ``timeline``), ``output``,
``strategy`` (``jax`` and ``torch`` run the port's device engine, ``cpu``
the CPU event engine, :class:`..sim.runtime.CpuReplayEngine`; a config
without the key runs the port's device engine), ``waveWidth``,
``chunkWaves``, ``devicePreemption`` (``true`` / ``"tier"``: tier
preemption; ``"kube"``: kube preemption through the retry buffer),
``nodeShards`` / ``pagedWaves``,
``whatIf`` (``scenarios``, ``seed``, ``mesh``: the scenario axis over the
local cards, ``nodeDownP``, ``capacityP``, ``taintP``, ``completions``,
``retryBuffer``: the unschedulable-retry buffer of ``run`` and
``what-if``), ``tune`` (the policy tuner, with ``mesh`` and the host
evaluator, ``evaluator: cpu``), ``service`` (:class:`ServiceSpec`: the
resident query service of ``serve``), ``flightRecorder`` (a path or ``{path,
every}``: the single replay's flight recorder) and ``overlap``
(``pagerThread``, ``twoPhaseExchange``; ``backgroundPublisher: true`` is
refused by name: it moves checkpoint publication, which the port does not
have yet) and ``chaos`` (:class:`ChaosSpec`: a seeded MTBF/MTTR node
failure timeline for ``run``, one a scenario past 0 for ``what-if``). Parsing is the reference's, key for key (utils/config.py
:213-270, :543-570), so one YAML file yields the same encoded case and the
same scenario batch in both packages; the reference's ``validate``
refusals of a retry buffer (kubernetes_simulator_tpu/cli.py:705-730) raise
``ValueError`` here, and its checks of the recorder and of ``overlap:``
(cli.py:487-517, :860-882) are :func:`flight_errors` and
:func:`overlap_errors`, those of kube (:718-729) :func:`kube_errors`, and
those of ``chaos:`` (:759-781) :func:`chaos_errors`, those of
``service:`` (:571-630) :func:`service_errors`.

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
class BorgWorkloadSpec:
    nodes: int = 10_000
    tasks: int = 1_000_000
    seed: int = 0
    gang_fraction: float = 0.08
    max_gang: int = 8
    num_apps: int = 48  # template/app vocabulary (clip bound for app_id)
    trace_path: Optional[str] = None  # external task-event CSV (sim.borg)
    # Real Borg-2019 schema ingest (sim.borg_etl): instance_events CSV
    # (required for the ETL path) + optional collection_events fallback.
    instance_events: Optional[str] = None
    collection_events: Optional[str] = None
    cpu_scale: float = 8.0
    mem_scale: float = 16.0 * 2**30


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
    # The scenario axis over the local cards (parallel.mesh).
    mesh: bool = False


@dataclass
class FlightRecorderSpec:
    """``flightRecorder:`` (the reference's, utils/config.py:212-222):
    ``path`` is the JSONL sink, ``every`` the chunk-row cadence (page rows
    always emit). The single replay only."""

    path: str = "flight.jsonl"
    every: int = 1


@dataclass
class OverlapSpec:
    """``overlap:`` (the reference's, utils/config.py:250-273); a gate left
    None keeps the engine's default (on). ``pagerThread`` is the pager's
    worker thread (``TorchReplayEngine(pager_thread=)``; it needs
    ``pagedWaves``); ``twoPhaseExchange`` selects the reference's selection
    exchange under ``nodeShards``, and either value runs K9's one exchange
    inside the thread-block cluster (in the reference the flag changes the
    transport, not a placement); ``backgroundPublisher: true`` is refused
    (checkpoint publication is not ported)."""

    pager_thread: Optional[bool] = None
    background_publisher: Optional[bool] = None
    two_phase_exchange: Optional[bool] = None


@dataclass
class ServiceSpec:
    """``service:`` (the reference's, utils/config.py:277-300; the ``serve``
    command): ``maxBatch`` query slots coalesced onto the scenario axis (the
    batch is maxBatch + 1 scenarios, slot 0 the clean baseline),
    ``batchDeadlineS`` the admission queue's flush deadline, ``maxEngines``
    the LRU engine pool's cap (``KSIM_SERVICE_MAX_ENGINES`` wins),
    ``granularity`` the default telemetry level of a query's result,
    ``retryBuffer`` the kube retry pass's slots, ``input`` an NDJSON query
    file or named pipe (None: stdin). Results go to the top-level
    ``output``."""

    max_batch: int = 3
    batch_deadline_s: float = 0.05
    max_engines: int = 4
    granularity: str = "summary"
    retry_buffer: int = 64
    input: Optional[str] = None


@dataclass
class ChaosSpec:
    """Seeded chaos campaign (``chaos:`` YAML section; the reference's,
    utils/config.py:99-112): MTBF/MTTR-style failure injection. ``run``
    turns this into a single ``node_events`` timeline; ``what-if`` gives
    each scenario s > 0 its own ``seed + s`` timeline (scenario 0 stays the
    clean reference)."""

    enabled: bool = False
    seed: int = 0
    mtbf: float = 200.0
    mttr: float = 20.0
    node_fraction: float = 0.2
    horizon: Optional[float] = None  # None → workload makespan
    max_events: Optional[int] = None


@dataclass
class TuneSpec:
    """Policy-tuner section (``tune:`` YAML; the reference's ``TuneSpec``,
    utils/config.py:115-170): a seeded search over the Score policy
    surface of the ``profile:`` scheduler against scenarios derived from
    the config's cluster/workload (:mod:`..sim.tuner`). ``objective`` maps
    metric name → weight (maximized; costs use negative weights);
    ``output`` is the trajectory JSONL sink (falls back to the top-level
    ``output``); ``mesh`` sweeps over the scenario mesh. ``evaluator: cpu``
    is refused."""

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
    mesh: bool = False


def _tune_spec(tu: dict) -> TuneSpec:
    """The reference's parsing of ``tune:`` (utils/config.py:435-460), key
    for key."""
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
        mesh=bool(tu.get("mesh", False)),
    )


def _overlap_spec(ov: dict) -> OverlapSpec:
    """The reference's parsing of ``overlap:`` (utils/config.py:551-568):
    each gate None, or true/false; ``backgroundPublisher: true`` is refused
    by name."""

    def tristate(key: str) -> Optional[bool]:
        v = ov.get(key)
        if v is None:
            return None
        if isinstance(v, (bool, int)):
            return bool(v)
        raise ValueError(f"overlap.{key}: must be true or false, got {v!r}")

    spec = OverlapSpec(
        pager_thread=tristate("pagerThread"),
        background_publisher=tristate("backgroundPublisher"),
        two_phase_exchange=tristate("twoPhaseExchange"),
    )
    if spec.background_publisher:
        _refuse("overlap.backgroundPublisher: true",
                "the fleet's checkpoint publication off the loop thread, ROADMAP queue A item "
                "11")
    return spec


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
    "dcn": "the multi-process fleet, ROADMAP queue A item 11",
    "faultline": "fleet fault injection, ROADMAP queue A item 11",
}


#: Strategies whose configs the port runs on its device engine (the
#: reference's device strategy and the port's own).
STRATEGIES = ("jax", "torch")


def _strategy(v) -> str:
    """``strategy:`` of a config: ``jax`` / ``torch`` run the device
    engine, ``cpu`` (the reference's default) the CPU event engine; any
    other name raises as the reference's registry does."""
    s = "torch" if v is None else str(v)
    if s not in STRATEGIES + ("cpu",):
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
    # None under workload.borg (then ``borg`` is set), as in the reference.
    workload: Optional[SyntheticWorkloadSpec] = field(default_factory=SyntheticWorkloadSpec)
    borg: Optional[BorgWorkloadSpec] = None
    framework: FrameworkConfig = field(default_factory=FrameworkConfig)
    telemetry: str = "summary"
    # Chrome-trace path of the simulated cluster timeline (telemetry.timelineOut).
    timeline_out: Optional[str] = None
    output: Optional[str] = None
    wave_width: int = 8
    chunk_waves: int = 1024
    whatif: WhatIfSpec = field(default_factory=WhatIfSpec)
    # False, tier preemption (True / "tier") or kube preemption ("kube").
    device_preemption: object = False
    # Node-plane shards of the single replay (0/1: the replicated layout) and
    # paged pod waves (the reference's round-14 Borg-scale mode).
    node_shards: int = 0
    paged_waves: bool = False
    tune: Optional[TuneSpec] = None
    # The flight recorder (None: off) and the overlap gates (None: defaults).
    flight_recorder: Optional[FlightRecorderSpec] = None
    overlap: Optional[OverlapSpec] = None
    # The chaos campaign (None: no chaos: section).
    chaos: Optional[ChaosSpec] = None
    # The resident query service (None: not a service config).
    service: Optional["ServiceSpec"] = None

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        """Parse a config document (:meth:`parse`) and raise on the first
        setting the engines cannot run: an unknown strategy, then
        :func:`value_errors`' first entry."""
        cfg = cls.parse(d)
        _strategy(cfg.strategy)
        errors = value_errors(cfg)
        if errors:
            raise ValueError(errors[0])
        return cfg

    @classmethod
    def parse(cls, d: dict) -> "SimConfig":
        """Parse a config document, its values as written, for ``validate``
        to report in the reference's order (:func:`..cli.validate_config`).
        Sections the port refuses and malformed values raise here."""
        wi = d.get("whatIf") or {}
        for section, what in _REFUSED_SECTIONS.items():
            if d.get(section) is not None:
                _refuse(section, what)
        dp = d.get("devicePreemption", False)
        cfg = cls()
        cfg.strategy = str(d.get("strategy") or "torch")
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
            b = wl["borg"]
            cfg.workload = None
            cfg.borg = BorgWorkloadSpec(
                nodes=int(b.get("nodes", 10_000)),
                tasks=int(b.get("tasks", 1_000_000)),
                seed=int(b.get("seed", 0)),
                gang_fraction=float(b.get("gangFraction", 0.08)),
                max_gang=int(b.get("maxGang", 8)),
                num_apps=int(b.get("numApps", 48)),
                trace_path=b.get("tracePath"),
                instance_events=b.get("instanceEvents"),
                collection_events=b.get("collectionEvents"),
                cpu_scale=float(b.get("cpuScale", 8.0)),
                mem_scale=float(b.get("memScale", 16.0 * 2**30)),
            )
        else:
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
        cfg.node_shards = int(d.get("nodeShards", 0) or 0)
        cfg.paged_waves = bool(d.get("pagedWaves", False))
        cfg.whatif = WhatIfSpec(
            scenarios=int(wi.get("scenarios", 0)),
            seed=int(wi.get("seed", 0)),
            node_down_p=float(wi.get("nodeDownP", 0.02)),
            capacity_p=float(wi.get("capacityP", 0.3)),
            taint_p=float(wi.get("taintP", 0.1)),
            completions=_coerce_completions(wi.get("completions")),
            retry_buffer=int(wi.get("retryBuffer", 0) or 0),
            mesh=bool(wi.get("mesh", False)),
        )
        if d.get("tune") is not None:
            cfg.tune = _tune_spec(d["tune"])
        fr = d.get("flightRecorder")
        if fr is not None:
            if isinstance(fr, str):
                fr = {"path": fr}
            cfg.flight_recorder = FlightRecorderSpec(
                path=str(fr.get("path", "flight.jsonl")), every=int(fr.get("every", 1)))
        if d.get("overlap") is not None:
            cfg.overlap = _overlap_spec(d["overlap"])
        ch = d.get("chaos")
        if ch is not None:
            cfg.chaos = ChaosSpec(
                enabled=bool(ch.get("enabled", True)),
                seed=int(ch.get("seed", 0)),
                mtbf=float(ch.get("mtbf", 200.0)),
                mttr=float(ch.get("mttr", 20.0)),
                node_fraction=float(ch.get("nodeFraction", 0.2)),
                horizon=float(ch["horizon"]) if ch.get("horizon") is not None else None,
                max_events=int(ch["maxEvents"]) if ch.get("maxEvents") is not None else None,
            )
        sv = d.get("service")
        if sv is not None:
            if not isinstance(sv, dict):
                sv = {}
            cfg.service = ServiceSpec(
                max_batch=int(sv.get("maxBatch", 3)),
                batch_deadline_s=float(sv.get("batchDeadlineS", 0.05)),
                max_engines=int(sv.get("maxEngines", 4)),
                granularity=str(sv.get("granularity", "summary")),
                retry_buffer=int(sv.get("retryBuffer", 64)),
                input=sv.get("input"),
            )
        return cfg

    @classmethod
    def load(cls, path: str) -> "SimConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


def workload_seed(cfg: SimConfig) -> int:
    """The seed a result row is stamped with: ``workload.borg.seed`` under
    a Borg workload, else ``workload.seed`` (kubernetes_simulator_tpu/cli.py
    :39-44)."""
    if cfg.borg is not None:
        return int(cfg.borg.seed)
    return int(cfg.workload.seed) if cfg.workload is not None else 0


def borg_errors(cfg: SimConfig) -> List[str]:
    """The reference's structural checks of a ``workload.borg`` section
    (kubernetes_simulator_tpu/cli.py:671-693 ``validate_config``), as
    actionable error strings (empty: ok)."""
    import os

    b = cfg.borg
    if b is None:
        return []
    errors = []
    if b.nodes <= 0:
        errors.append("workload.borg.nodes: must be > 0")
    if b.tasks <= 0:
        errors.append("workload.borg.tasks: must be > 0")
    if b.max_gang > cfg.wave_width:
        errors.append(
            f"workload.borg.maxGang ({b.max_gang}) exceeds waveWidth ({cfg.wave_width}): a "
            "gang must fit in one wave"
        )
    for attr, key in (("trace_path", "tracePath"), ("instance_events", "instanceEvents"),
                      ("collection_events", "collectionEvents")):
        path = getattr(b, attr)
        if path and not os.path.exists(path):
            errors.append(f"workload.borg.{key}: file not found: {path}")
    if b.cpu_scale <= 0 or b.mem_scale <= 0:
        errors.append("workload.borg.cpuScale/memScale: must be > 0")
    return errors


def shard_errors(cfg: SimConfig) -> List[str]:
    """The reference's checks of ``nodeShards`` and ``pagedWaves``
    (kubernetes_simulator_tpu/cli.py:735-757 ``validate_config``), as
    error strings (empty: ok). Both device strategies take them; the CPU
    event engine refuses them."""
    errors = []
    tier_on = cfg.device_preemption in (True, "tier")
    if cfg.node_shards < 0:
        errors.append("nodeShards: must be >= 0 (0/1 = replicated planes)")
    if cfg.node_shards > 1 and cfg.strategy == "cpu":
        errors.append(
            "nodeShards: intra-scenario node-plane sharding is a strategy: jax feature (the "
            "what-if batch spends the mesh on the scenario axis)"
        )
    if cfg.node_shards > 1 and tier_on:
        errors.append(
            "nodeShards is not supported with tier devicePreemption (the sharded chunk "
            "program is the node-space engine; use devicePreemption: kube)"
        )
    if cfg.paged_waves and cfg.strategy == "cpu":
        errors.append("pagedWaves: requires strategy: jax")
    if cfg.paged_waves and (cfg.whatif.retry_buffer or cfg.device_preemption == "kube"):
        errors.append(
            "pagedWaves is not supported with whatIf.retryBuffer / devicePreemption: kube "
            "yet (the boundary mirror pre-stages the whole wave index tensor)"
        )
    return errors


def flight_errors(cfg: SimConfig) -> List[str]:
    """The reference's checks of ``flightRecorder:``
    (kubernetes_simulator_tpu/cli.py:860-882), as error strings (empty:
    ok); both strategies the port runs have the chunk loop it records."""
    import os

    fr = cfg.flight_recorder
    if fr is None:
        return []
    errors = []
    d = os.path.dirname(fr.path) or "."
    if not os.path.isdir(d):
        errors.append(f"flightRecorder.path: directory not found: {d}")
    elif not os.access(d, os.W_OK):
        errors.append(f"flightRecorder.path: directory not writable: {d}")
    if fr.every <= 0:
        errors.append("flightRecorder.every: must be > 0")
    if cfg.borg is not None and cfg.node_shards <= 1:
        errors.append(
            "flightRecorder on a borg headline workload without nodeShards: the replicated "
            "planes bust one device at Borg scale — set nodeShards > 1 (and usually "
            "pagedWaves: true)"
        )
    return errors


def overlap_errors(cfg: SimConfig) -> List[str]:
    """The reference's refusals of ``overlap:`` (kubernetes_simulator_tpu
    /cli.py:487-517 ``_overlap_errors``): a gate explicitly on where the
    machinery it overlaps is absent. ``backgroundPublisher: true`` never
    gets here (:func:`_overlap_spec` refuses it)."""
    ov = cfg.overlap
    if ov is None or not ov.pager_thread or cfg.paged_waves:
        return []
    return [
        "overlap.pagerThread: true requires pagedWaves: true — without paged pod waves "
        "there is no pager (and no page fetch) to move off the chunk-loop thread"
    ]


def value_errors(cfg: SimConfig) -> List[str]:
    """The values the engines cannot run, in the reference's words
    (kubernetes_simulator_tpu/cli.py:706-733): a negative
    ``whatIf.retryBuffer``, an unknown ``devicePreemption``, the retry
    buffer with tier preemption or with ``whatIf.completions: false``.
    :meth:`SimConfig.from_dict` raises the first, ``validate`` reports them
    all."""
    wi, dp = cfg.whatif, cfg.device_preemption
    errors = []
    if wi.retry_buffer < 0:
        errors.append("whatIf.retryBuffer: must be >= 0")
    if dp not in (True, False, "tier", "kube"):
        errors.append(f"devicePreemption: must be true/false/'tier'/'kube', got {dp!r}")
    if wi.retry_buffer and dp in (True, "tier"):
        errors.append("whatIf.retryBuffer is not supported with tier devicePreemption")
    if wi.retry_buffer and wi.completions is False:
        errors.append("whatIf.retryBuffer requires the device-release path; remove "
                      "whatIf.completions: false (the retry pass runs at completion boundaries)")
    return errors


def kube_errors(cfg: SimConfig) -> List[str]:
    """The reference's checks of ``devicePreemption: kube``
    (kubernetes_simulator_tpu/cli.py:718-729; paged is
    :func:`shard_errors`'), as error strings (empty: ok)."""
    if cfg.device_preemption != "kube":
        return []
    errors = []
    if not cfg.whatif.retry_buffer:
        errors.append(
            "devicePreemption: kube requires whatIf.retryBuffer > 0 (failed pods reach the "
            "PostFilter through the boundary retry pass)"
        )
    if cfg.whatif.mesh:
        errors.append(
            "devicePreemption: kube requires a no-mesh what-if batch (the eager per-chunk "
            "folds would serialize the scenario axis); tier preemption runs under a mesh"
        )
    return errors


def chaos_errors(cfg: SimConfig) -> List[str]:
    """The reference's checks of an enabled ``chaos:`` section
    (kubernetes_simulator_tpu/cli.py:759-781), as error strings (empty: ok):
    the campaign's parameters, ``whatIf.retryBuffer > 0`` on the device
    engine (both device strategies are the reference's ``jax``; the CPU
    event engine evicts without one) and kube for a what-if sweep."""
    ch = cfg.chaos
    if ch is None or not ch.enabled:
        return []
    errors = []
    if ch.mtbf <= 0:
        errors.append("chaos.mtbf: must be > 0")
    if ch.mttr < 0:
        errors.append("chaos.mttr: must be >= 0")
    if not 0.0 < ch.node_fraction <= 1.0:
        errors.append("chaos.nodeFraction: must be in (0, 1]")
    if ch.horizon is not None and ch.horizon <= 0:
        errors.append("chaos.horizon: must be > 0 (or omitted)")
    if ch.max_events is not None and ch.max_events < 0:
        errors.append("chaos.maxEvents: must be >= 0")
    if cfg.strategy != "cpu" and not cfg.whatif.retry_buffer:
        errors.append(
            f"chaos with strategy: {cfg.strategy} requires whatIf.retryBuffer > 0 — without "
            "the boundary retry pass node_down only blocks future placements (no NoExecute "
            "eviction of bound pods)"
        )
    if cfg.whatif.scenarios > 0 and cfg.device_preemption != "kube":
        errors.append(
            "chaos what-if sweeps require devicePreemption: kube (per-scenario timelines "
            "apply at chunk boundaries through the kube pass's eviction and requeue)"
        )
    return errors


def service_errors(cfg: SimConfig) -> List[str]:
    """The reference's refusals of a ``service:`` section
    (kubernetes_simulator_tpu/cli.py:571-630 ``_service_errors``), as error
    strings (empty: ok): every envelope a defrag batch rides on (the device
    strategy, kube preemption with the retry buffer, no node shards, no
    mesh) must hold before the first query is admitted."""
    import os

    from ..sim.telemetry import _LEVELS

    sv = cfg.service
    if sv is None:
        return []
    errors = []
    if cfg.strategy not in STRATEGIES:
        errors.append(
            "service: requires strategy: jax or torch (the resident engine pool is the "
            "what-if batch on the device)"
        )
    if cfg.device_preemption != "kube":
        errors.append(
            "service: defrag queries drain nodes through chaos eviction, which needs "
            "devicePreemption: kube (the boundary host mirror applies per-scenario timelines)"
        )
    if not cfg.whatif.retry_buffer:
        errors.append(
            "service: requires whatIf.retryBuffer > 0 — without the boundary retry pass a "
            "drained node's pods are never rescheduled, so every defrag answer degenerates"
        )
    if cfg.node_shards > 1:
        errors.append(
            "service: nodeShards > 1 is not supported — the query batch spends the device on "
            "the scenario axis, and set_scenarios refuses sliced engines"
        )
    if cfg.whatif.mesh:
        errors.append(
            "service: whatIf.mesh is not supported (resident engines are single-process; "
            "set_scenarios refuses meshed engines)"
        )
    if sv.max_batch < 1:
        errors.append("service.maxBatch: must be >= 1")
    if sv.batch_deadline_s <= 0:
        errors.append(
            "service.batchDeadlineS: must be > 0 (the admission queue needs a flush "
            "deadline; use maxBatch: 1 for per-query dispatch)"
        )
    if sv.max_engines < 1:
        errors.append("service.maxEngines: must be >= 1")
    if sv.retry_buffer < 1:
        errors.append("service.retryBuffer: must be >= 1")
    if sv.granularity not in _LEVELS:
        errors.append(f"service.granularity: must be one of {', '.join(_LEVELS)}, "
                      f"got {sv.granularity!r}")
    if sv.input is not None and not os.path.exists(sv.input):
        errors.append(f"service.input: file not found: {sv.input}")
    return errors


def config_errors(cfg: SimConfig) -> List[str]:
    """Every check of the reference's ``validate`` that the port's sections
    have (:func:`kube_errors`, :func:`borg_errors`, :func:`shard_errors`,
    :func:`flight_errors`, :func:`overlap_errors`, :func:`chaos_errors`,
    :func:`service_errors`); empty: the config is valid."""
    return (kube_errors(cfg) + borg_errors(cfg) + shard_errors(cfg) + flight_errors(cfg)
            + overlap_errors(cfg) + chaos_errors(cfg) + service_errors(cfg))


def build_case(cfg: SimConfig):
    """Materialize (cluster, pods) from a SimConfig (a Borg workload through
    the object-model generator, which caps at 200k tasks)."""
    from ..plugins.builtin import inject_default_spread
    from ..sim.synthetic import make_cluster, make_workload

    if cfg.borg is not None:
        from ..sim.borg import make_borg_trace

        return make_borg_trace(cfg.borg)
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
    """(EncodedCluster, EncodedPods) for a SimConfig. Borg workloads use the
    vectorized template-expansion fast path (the object-model generator caps
    at 200k tasks), from an external task-event trace
    (``workload.borg.tracePath``) or the 2019 tables
    (``instanceEvents``) where given; everything else goes through
    build_case + encode."""
    from ..models.encode import encode

    if cfg.borg is not None:
        from ..plugins.builtin import resolved_default_constraints
        from ..sim.borg import BorgSpec, load_trace_csv, make_borg_encoded

        if resolved_default_constraints(cfg.framework):
            import warnings

            warnings.warn(
                "PodTopologySpread cluster-default constraints apply only to "
                "object-model workloads; the encoded Borg fast path ignores "
                "them (Borg tasks carry no controller labels to select on).",
                stacklevel=2,
            )
        spec = BorgSpec.from_spec(cfg.borg)
        if cfg.borg.instance_events:
            from ..sim.borg_etl import load_borg2019

            ec, ep, _ = load_borg2019(
                cfg.borg.instance_events, spec,
                collection_events=cfg.borg.collection_events,
                cpu_scale=cfg.borg.cpu_scale,
                mem_scale=cfg.borg.mem_scale,
            )
        elif cfg.borg.trace_path:
            ec, ep, _ = load_trace_csv(cfg.borg.trace_path, spec)
        else:
            ec, ep, _ = make_borg_encoded(spec)
        return ec, ep
    return encode(*build_case(cfg))
