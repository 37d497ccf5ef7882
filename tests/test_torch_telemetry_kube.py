"""Series and timeline telemetry under kube preemption and chaos node events
in the port (``TorchReplayEngine(telemetry="series"|"timeline")`` with
``preemption="kube"`` and/or ``replay(node_events=)``, and the kube
``WhatIfEngine``'s per-scenario latency, fragmentation and
``scenario_telemetry``), held against the JAX package on the CPU, on the
plain twins.

The same encoded trace (the JAX package's, carried across as numpy arrays
by tests/torch_port_case.py) goes through both engines; compared exactly:
assignments, the latency dict, ``reasons``, ``rejection_attempts``, the
series dict, the ordered ``events`` list and the Chrome trace; per what-if
scenario the latency quantiles, ``stranded_cpu``, ``frag_index_cpu``,
``packing_efficiency`` and the scenario's telemetry. The traces are
tests/test_telemetry.py's and tests/test_utilization.py's shapes, rebuilt
here, and crafted cases for each rule of the reference's episodes and
events: a pod the PostFilter rescues is not charged, a victim that fails
again starts a new episode, a wave-bound pod preempted later keeps its
wave ``bind`` event, an evicted pod binds again, a preemption on the
trailing boundary takes the last finite boundary's time."""

import json

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.runtime import NodeEvent as J_Event
from kubernetes_simulator_tpu.sim.synthetic import make_chaos_timeline as j_timeline
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu.sim.telemetry import write_chrome_trace as j_write_trace
from kubernetes_simulator_tpu.utils.metrics import whatif_rows as j_rows
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import torch_runtime as TR
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent
from kubernetes_simulator_tpu_torch.sim.telemetry import write_chrome_trace
from kubernetes_simulator_tpu_torch.utils.metrics import whatif_rows

from torch_port_case import port_case

FIT_ONLY = [{"name": "NodeResourcesFit"}]
WHATIF_FIELDS = ("latency_p50", "latency_p90", "latency_p99", "stranded_cpu",
                 "frag_index_cpu", "packing_efficiency")


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _light_trace(num_pods=28, num_nodes=5, duration=30.0, seed=None):
    """tests/test_telemetry.py's queue-trivial shape."""
    rng = np.random.default_rng(seed) if seed is not None else None
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(num_nodes)]
    pods = []
    for i in range(num_pods):
        d = duration if rng is None else float(rng.integers(30, 61))
        pods.append(Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=d))
    return encode(Cluster(nodes=nodes), pods)


def _random_case(seed, nodes=6, pods=260):
    """tests/test_kube_preempt.py's over-committed shape: priorities, spread,
    tolerations, taints, durations."""
    return encode(make_cluster(nodes, seed=seed, taint_fraction=0.2),
                  make_workload(pods, seed=seed, with_spread=True, with_tolerations=True,
                                duration_mean=60.0, arrival_rate=8.0)[0])


def _events(spec, cls=NodeEvent):
    return [cls(time=t, kind=k, node=n, **({"scale": x[0]} if x else {}))
            for t, k, n, *x in spec]


def _timeline(ec, ep, seed, mtbf_span=0.5, mttr_span=0.125):
    span = float(ep.arrival.max())
    return [(e.time, e.kind, e.node) for e in j_timeline(
        ec.num_nodes, seed=seed, horizon=span, mtbf=span * mtbf_span, mttr=span * mttr_span,
        node_fraction=0.34)]


def replays(ec, ep, spec, granularity, mode="kube", W=1, C=1, rb=64, plugins=FIT_ONLY):
    """(the JAX engine's result, the port's) of one trace under the timeline
    ``spec`` (a list of (time, kind, node[, scale]); empty: none); ``mode``
    "kube", "retry" (the buffer alone) or "plain"."""
    kw = dict(wave_width=W, chunk_waves=C, telemetry=granularity)
    if mode != "plain":
        kw["retry_buffer"] = rb
    if mode == "kube":
        kw["preemption"] = "kube"
    want = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), **kw).replay(
        node_events=_events(spec, J_Event) or None)
    pec, pep = port_case(ec, ep)
    got = TR.TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu",
                               **kw).replay(node_events=_events(spec) or None)
    return want, got


def assert_same(want, got):
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for name in ("placed", "preemptions", "retry_dropped", "evictions", "evict_rescheduled",
                 "evict_stranded", "evict_latency_mean"):
        assert getattr(got, name) == getattr(want, name), name
    a, b = want.telemetry, got.telemetry
    assert b.granularity == a.granularity
    assert b.latency == a.latency
    assert b.bind_latency == a.bind_latency
    assert b.reasons == a.reasons
    assert b.rejection_attempts == a.rejection_attempts
    assert b.series == a.series
    assert b.events == a.events
    sa, sb = want.summary()["telemetry"], got.summary()["telemetry"]
    for k in ("latency", "reasons", "rejection_attempts", "series_samples", "timeline_events"):
        assert sb.get(k) == sa.get(k), k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_chaos_telemetry_parity(seed):
    """tests/test_telemetry.py's seeded chaos slice (kube, series, mttr 0)."""
    ec, ep = _light_trace(num_pods=28, num_nodes=6, seed=seed)
    spec = [(e.time, e.kind, e.node) for e in j_timeline(
        ec.num_nodes, seed=seed, horizon=float(ep.arrival.max()), mtbf=12.0, mttr=0.0,
        node_fraction=0.34)]
    want, got = replays(ec, ep, spec, "series")
    assert_same(want, got)


@pytest.mark.parametrize("mode,chaos,C,granularity", [
    ("kube", False, 1, "timeline"), ("kube", False, 4, "series"),
    ("retry", True, 1, "timeline"), ("retry", True, 4, "series"),
    ("kube", True, 4, "timeline"),
])
def test_random_traces_equal_jax(mode, chaos, C, granularity):
    """Over-committed traces with the full plugin set: kube without chaos,
    the retry buffer under chaos and both together, W = 1, C = 1 and 4."""
    ec, ep = _random_case(2)
    want, got = replays(ec, ep, _timeline(ec, ep, 2) if chaos else [], granularity, mode, C=C,
                        plugins=None)
    assert_same(want, got)
    tel = got.telemetry
    assert sum(tel.rejection_attempts.values()) >= sum(tel.reasons.values()) > 0
    if granularity == "timeline":
        kinds = {e[0] for e in tel.events}
        assert ("preempt" in kinds) == (mode == "kube")
        assert ("evict" in kinds) == chaos and ("node_down" in kinds) == chaos


@pytest.mark.parametrize("C", [1, 4])
def test_plain_path_node_events(C):
    """No buffer: the rows alone change; the timeline holds the node_down /
    node_up events at their own times, and the series gauges read each
    boundary's own rows (a capacity_scale included)."""
    ec, ep = _light_trace(num_pods=40, num_nodes=3)
    spec = [(4.0, "node_down", 0), (9.5, "capacity_scale", 1, 0.5), (12.0, "node_up", 0),
            (20.0, "node_down", 2)]
    want, got = replays(ec, ep, spec, "timeline", "plain", C=C)
    assert_same(want, got)
    assert [e[0] for e in got.telemetry.events] == ["node_down", "node_up", "node_down"]
    assert len(set(got.telemetry.series["frag_cpu"])) > 1


def _crafted(pods, nodes=1, cpu=2.0):
    return encode(Cluster(nodes=[Node(f"n{i}", {"cpu": cpu}) for i in range(nodes)]),
                  [Pod(name, requests={"cpu": 1.0}, arrival_time=t, duration=d, priority=pr)
                   for name, t, d, pr in pods])


def test_postfilter_rescue_charges_nothing():
    """h (priority 10) fails in its wave (the chunk fold charges it) and the
    PostFilter rescues it at the next boundary: that attempt charges
    nothing; its victim l0 fails in the same pass and is charged as a new
    episode, z's wave failure and the trailing pass's attempts after. The
    wave-bound victim keeps its wave bind."""
    ec, ep = _crafted([("l0", 0.0, 100.0, 0), ("l1", 1.0, 100.0, 0), ("h", 2.0, 100.0, 10),
                       ("z", 3.0, 100.0, 0)])
    want, got = replays(ec, ep, [], "timeline", rb=8)
    assert_same(want, got)
    tel = got.telemetry
    assert tel.reasons == {"NodeResourcesFit": 3}
    assert tel.rejection_attempts == {"NodeResourcesFit": 5}
    assert tel.events == [("bind", 0.0, 0, 0), ("bind", 1.0, 1, 0), ("preempt", 3.0, 0, 0),
                          ("bind", 3.0, 2, 0)]
    assert list(got.assignments) == [-1, 0, 0, -1]


def test_victim_is_charged_again_as_a_new_episode():
    """v fails in its wave (charged), binds at the next boundary after l0's
    release (its episode ends), then h preempts it (priority 0 below l1's
    1): v fails again and is charged to ``reasons`` a second time."""
    ec, ep = _crafted([("l0", 0.0, 2.5, 0), ("l1", 1.0, 100.0, 1), ("v", 2.0, 100.0, 0),
                       ("x", 3.0, 0.1, 0), ("h", 4.0, 100.0, 10), ("y", 5.0, 0.1, 5)])
    want, got = replays(ec, ep, [], "timeline", rb=8)
    assert_same(want, got)
    tel = got.telemetry
    v = 2
    assert ("bind", 3.0, v, 0) in tel.events and ("preempt", 5.0, v, 0) in tel.events
    # six episodes, two of them v's: its mark is cleared when h preempts it
    assert tel.reasons == {"NodeResourcesFit": 6}
    assert tel.rejection_attempts == {"NodeResourcesFit": 10}


def test_evicted_pod_binds_again():
    """p0 binds in its wave, node n0 goes down (p0 evicted, re-bound on n1 in
    the same boundary's pass), n0 comes back, n1 goes down for good (p0
    evicted and re-bound on n0): each bind is an event, the evictions at
    their boundaries, the node events at their own times; the episode marks
    clear at each eviction."""
    ec, ep = _crafted([("p0", 0.0, 100.0, 0)] + [(f"f{i}", 1.0 + i, 100.0, 0)
                                                 for i in range(5)], nodes=2, cpu=8.0)
    spec = [(1.5, "node_down", 0), (3.2, "node_up", 0), (4.5, "node_down", 1)]
    for mode in ("retry", "kube"):
        want, got = replays(ec, ep, spec, "timeline", mode, rb=8)
        assert_same(want, got)
        binds = [e for e in got.telemetry.events if e[0] == "bind" and e[2] == 0]
        assert len(binds) >= 3 and got.evictions >= 2


def test_trailing_boundary_preempt_time():
    """h arrives last and fails in the last chunk: the trailing boundary
    (t = inf) preempts for it; its preempt and bind take the last finite
    boundary's time."""
    ec, ep = _crafted([("l0", 0.0, 100.0, 0), ("l1", 1.0, 100.0, 0), ("h", 2.0, 100.0, 10)])
    want, got = replays(ec, ep, [], "timeline", rb=8)
    assert_same(want, got)
    assert got.telemetry.events[-2:] == [("preempt", 2.0, 0, 0), ("bind", 2.0, 2, 0)]
    assert got.telemetry.bind_latency == {}


def test_chrome_trace_equals_reference(tmp_path):
    """The Chrome trace of a kube run under chaos: a node<n> down span for a
    node that comes back and one, unrecovered, that runs to the makespan;
    preempt and evict instants on the node rows."""
    ec, ep = _random_case(3, pods=120)
    spec = [(2.0, "node_down", 0), (5.0, "node_up", 0), (9.0, "node_down", 1)]
    want, got = replays(ec, ep, spec, "timeline", plugins=None)
    assert_same(want, got)
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    nj = j_write_trace(pj, want, arrival=ep.arrival, duration=ep.duration, requests=ep.requests,
                       rindex=ec.vocab._r)
    pec, pep = port_case(ec, ep)
    nt = write_chrome_trace(pt, got, arrival=pep.arrival, duration=pep.duration,
                            requests=pep.requests, rindex=pec.vocab._r)
    doc = json.load(open(pt))
    assert nj == nt and doc == json.load(open(pj))
    spans = [e for e in doc["traceEvents"] if e["pid"] == 1 and e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["node0 down", "node1 down"]
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "i"} >= {"evict", "bind"}


def test_whatif_kube_scenario_latency_quantiles():
    """tests/test_telemetry.py's case: the clean scenario's quantiles equal
    the single replay's; the plain batch reports none."""
    ec, ep = _light_trace(num_pods=20, num_nodes=4)
    evs = [(e.time, e.kind, e.node) for e in j_timeline(
        ec.num_nodes, seed=7, horizon=float(ep.arrival.max()), mtbf=10.0, mttr=0.0,
        node_fraction=0.5)]
    pec, pep = port_case(ec, ep)
    cfg = FrameworkConfig(plugins=FIT_ONLY)
    kw = dict(wave_width=1, chunk_waves=1, preemption="kube", retry_buffer=64)
    single = TR.TorchReplayEngine(pec, pep, cfg, device="cpu", **kw).replay()
    res = T.WhatIfEngine(pec, pep, [T.Scenario(), T.Scenario(events=_events(evs))], cfg,
                         telemetry="series", device="cpu", **kw).run()
    want = J.WhatIfEngine(ec, ep, [J.Scenario(), J.Scenario(events=_events(evs, J_Event))],
                          J_Config(plugins=FIT_ONLY), telemetry="series", **kw).run()
    assert res.latency_p50.shape == (2,)
    st = single.telemetry.latency
    assert float(res.latency_p50[0]) == st["p50"] and float(res.latency_p99[0]) == st["p99"]
    assert res.scenario_telemetry[1].latency["count"] > 0
    for f in WHATIF_FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f), err_msg=f)
    plain = T.WhatIfEngine(pec, pep, [T.Scenario()], cfg, chunk_waves=4, device="cpu").run()
    assert plain.latency_p50 is None and plain.scenario_telemetry is None
    assert plain.stranded_cpu is None


@pytest.mark.parametrize("granularity", ["summary", "timeline"])
def test_chaos_whatif_batch_equals_jax(granularity):
    """A kube batch of four scenarios — clean, two timelines, a static
    node_down with a timeline — at summary (quantiles and gauges) and at
    timeline: the per-scenario fields, the rows' fields and each scenario's
    telemetry (latency, reasons, attempts, series, events with each
    node_down just before its evictions, as the reference's batch) equal
    the JAX batch's."""
    ec, ep = _random_case(2, pods=200)

    def scenarios(mod, Ev):
        down = mod.Perturbation("node_down", nodes=np.array([2]))
        return [mod.Scenario(), mod.Scenario(events=_events(_timeline(ec, ep, 1), Ev)),
                mod.Scenario(events=_events(_timeline(ec, ep, 5), Ev)),
                mod.Scenario([down], events=_events(_timeline(ec, ep, 9), Ev))]

    kw = dict(wave_width=8, chunk_waves=4, preemption="kube", retry_buffer=64,
              collect_assignments=True, telemetry=granularity)
    want = J.WhatIfEngine(ec, ep, scenarios(J, J_Event), J_Config(), **kw).run()
    pec, pep = port_case(ec, ep)
    got = T.WhatIfEngine(pec, pep, scenarios(T, NodeEvent), FrameworkConfig(), device="cpu",
                         **kw).run()
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for f in WHATIF_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    pick = lambda rows: [{k: r.get(k) for k in WHATIF_FIELDS} for r in rows
                         if r["kind"] == "whatif-scenario"]
    assert pick(whatif_rows(got)) == pick(j_rows(want))
    if granularity == "summary":
        assert got.scenario_telemetry is None and want.scenario_telemetry is None
        return
    assert len(got.scenario_telemetry) == 4
    for s, (a, b) in enumerate(zip(want.scenario_telemetry, got.scenario_telemetry)):
        assert (b.latency, b.reasons, b.rejection_attempts, b.series, b.events) == (
            a.latency, a.reasons, a.rejection_attempts, a.series, a.events), s
    assert any(e[0] == "evict" for e in got.scenario_telemetry[1].events)


def _log_case():
    ec, ep = _crafted([("l0", 0.0, 100.0, 0), ("l1", 1.0, 100.0, 0), ("h", 2.0, 100.0, 10)])
    pec, pep = port_case(ec, ep)
    return TR.TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT_ONLY), wave_width=1,
                                chunk_waves=1, preemption="kube", retry_buffer=8,
                                telemetry="timeline", device="cpu")


def test_full_event_log_raises(monkeypatch):
    """A run whose event log fills again on its second run (the capacity
    held at 1 whatever the first run reported) raises after its fetch; no
    event is dropped silently."""
    eng = _log_case()
    monkeypatch.setattr(TR, "log_capacity", lambda plan, RB, need=0: 1)
    with pytest.raises(RuntimeError, match="event log of scenario 0 filled: 2 records"):
        eng.replay()
    monkeypatch.undo()
    assert len(eng.replay().telemetry.events) == 4


def test_full_event_log_runs_again_with_the_reported_count(monkeypatch):
    """A run whose event log fills (the kernels count on past it) runs once
    more with a log of the count reported, and keeps every event."""
    want = _log_case().replay()
    needs = []

    def cap(plan, RB, need=0):
        needs.append(need)
        return max(1, need)

    monkeypatch.setattr(TR, "log_capacity", cap)
    got = _log_case().replay()
    assert needs == [0, 2]
    assert got.telemetry.events == want.telemetry.events
    np.testing.assert_array_equal(got.assignments, want.assignments)


def test_refusals_that_stay_name_their_queue_items():
    """Series and timeline run under kube and chaos; the per-slot route
    still refuses kube (6a), and node shards and paged waves refuse chaos
    (6b) at any granularity."""
    ec, ep = _light_trace(num_pods=8, num_nodes=3)
    pec, pep = port_case(ec, ep)
    cfg = FrameworkConfig(plugins=FIT_ONLY)
    ev = _events([(2.0, "node_down", 0)])
    eng = TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8,
                               telemetry="timeline", device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 6a"):
        eng._run(series=True, route="slot", timeline=True)
    with pytest.raises(NotImplementedError, match="queue A item 6a"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8, node_shards=2,
                             telemetry="series", device="cpu")
    for kw in (dict(node_shards=2), dict(paged=True)):
        with pytest.raises(NotImplementedError, match="queue A item 6b"):
            TR.TorchReplayEngine(pec, pep, cfg, telemetry="timeline", device="cpu",
                                 **kw).replay(node_events=ev)
    with pytest.raises(NotImplementedError, match="queue A item 6b"):
        TR.TorchReplayEngine(pec, pep, cfg, retry_buffer=8, telemetry="series", plain=True,
                             device="cpu").replay(node_events=ev)
