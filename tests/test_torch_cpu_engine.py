"""The port's CPU event engine (kubernetes_simulator_tpu_torch.sim.runtime
``CpuReplayEngine``, strategy ``"cpu"``) and its scheduling queue against
the JAX package's, on the CPU.

Every case of tests/test_replay_cpu.py (config1's shape, the full plugin
set, completions, gangs, PostFilter preemption, node_down eviction and
requeue, priority order, backoff, the no-progress gang, gang members that
do not preempt), plus a seeded chaos case with capacity_scale events, runs
through both engines at telemetry ``timeline`` (which collects everything
``series`` does): the assignments, every counter, the latency summary, the
reasons, the series and the timeline events must be exactly equal. The
queue is held to the JAX queue on a seeded push / pop / backoff / flush
script, and the host attribution helper ``first_reject_counts_host`` to
the JAX one. The cross-engine checks of tests/test_utilization.py (the
series at common instants and the end gauges) run between the port's event
engine and the port's device engine on its twins."""

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.framework.queue import SchedulingQueue as J_Queue
from kubernetes_simulator_tpu.models.core import (
    Cluster,
    LabelSelector,
    Node,
    Pod,
    PodAffinitySpec,
    PodAffinityTerm,
)
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.runtime import CpuReplayEngine as J_Engine
from kubernetes_simulator_tpu.sim.runtime import NodeEvent as J_Event
from kubernetes_simulator_tpu.sim.synthetic import (
    config1,
    make_chaos_timeline,
    make_cluster,
    make_workload,
)
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.framework.queue import SchedulingQueue
from kubernetes_simulator_tpu_torch.framework.registry import get_strategy
from kubernetes_simulator_tpu_torch.sim.runtime import CpuReplayEngine, NodeEvent
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

FIT = [{"name": "NodeResourcesFit"}]


def _config1():
    cluster, pods, plugins = config1(num_nodes=50, num_pods=300)
    return cluster, pods, dict(plugins=plugins), {}, None


def _full_plugins():
    cluster = make_cluster(30, seed=1, taint_fraction=0.2)
    pods, _ = make_workload(150, seed=1, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    return cluster, pods, {}, {}, None


def _completions():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    pods = [Pod("a", requests={"cpu": 2}, arrival_time=0.0, duration=10.0),
            Pod("b", requests={"cpu": 2}, arrival_time=1.0)]
    return cluster, pods, {}, {}, None


def _gang(cpu):
    def build():
        cluster = Cluster(nodes=[Node("n0", {"cpu": cpu})])
        pods = [Pod(f"g{i}", requests={"cpu": 1}, arrival_time=float(i), pod_group="gang")
                for i in range(3)]
        return cluster, pods, {}, {}, None
    return build


def _preemption():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    pods = [Pod("low", requests={"cpu": 2}, priority=0, arrival_time=0.0),
            Pod("high", requests={"cpu": 2}, priority=1000, arrival_time=1.0)]
    return cluster, pods, {}, {}, None


def _node_down():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 4}), Node("n1", {"cpu": 4})])
    pods = [Pod("a", requests={"cpu": 2}, arrival_time=0.0)]
    return cluster, pods, dict(plugins=FIT), {}, [(5.0, "node_down", 0, 1.0)]


def _priority_order():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [Pod("low", requests={"cpu": 1}, priority=0, arrival_time=0.0),
            Pod("high", requests={"cpu": 1}, priority=100, arrival_time=0.0)]
    return cluster, pods, dict(plugins=FIT, enable_preemption=False), {}, None


def _backoff():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    aff = PodAffinitySpec(required=(
        PodAffinityTerm(LabelSelector.make({"app": "b"}), "kubernetes.io/hostname"),))
    pods = [Pod("a", labels={"app": "a"}, requests={"cpu": 1}, arrival_time=0.0,
                pod_affinity=aff),
            Pod("b", labels={"app": "b"}, requests={"cpu": 1}, arrival_time=0.5),
            Pod("c", requests={"cpu": 1}, arrival_time=0.9)]
    return cluster, pods, {}, {}, None


def _gang_no_progress():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [Pod(f"g{i}", requests={"cpu": 1}, arrival_time=0.0, pod_group="gang")
            for i in range(2)]
    return cluster, pods, {}, dict(permit_timeout=50.0), None


def _gang_no_preempt():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [Pod("victim", requests={"cpu": 1}, priority=0, arrival_time=0.0),
            Pod("ga", requests={"cpu": 1}, priority=1000, arrival_time=1.0, pod_group="gang"),
            Pod("gb", requests={"cpu": 1}, priority=1000, arrival_time=1.0, pod_group="gang")]
    return cluster, pods, {}, {}, None


def _chaos():
    """Gangs, completions, affinity, spread and priorities under a seeded
    node_down / node_up timeline with capacity_scale events spliced in."""
    cluster = make_cluster(6, seed=3, taint_fraction=0.2)
    pods, _ = make_workload(300, seed=3, with_affinity=True, with_spread=True,
                            with_tolerations=True, gang_fraction=0.15, gang_size=3,
                            duration_mean=30.0, arrival_rate=100.0)
    for i, p in enumerate(pods):
        p.priority = (i * 37) % 3 * 100
    evs = make_chaos_timeline(6, seed=4, horizon=3.2, mtbf=2.0, mttr=0.5, node_fraction=0.5)
    raw = [(e.time, e.kind, e.node, e.scale) for e in evs]
    raw += [(0.75, "capacity_scale", 2, 0.5), (1.5, "capacity_scale", 4, 1.5)]
    raw.sort(key=lambda e: e[0])
    return cluster, pods, {}, {}, raw


CASES = {
    "config1": _config1, "full_plugins": _full_plugins, "completions": _completions,
    "gang_all_or_nothing": _gang(2), "gang_commits": _gang(4), "preemption": _preemption,
    "node_down": _node_down, "priority_order": _priority_order, "backoff": _backoff,
    "gang_no_progress": _gang_no_progress, "gang_no_preempt": _gang_no_preempt,
    "chaos": _chaos,
}

COUNTERS = ("placed", "unschedulable", "preemptions", "attempts", "virtual_makespan",
            "retry_dropped", "evictions", "evict_rescheduled", "evict_stranded",
            "evict_latency_mean", "utilization", "fragmentation")


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.assignments, b.assignments)
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.state.used, b.state.used)
    np.testing.assert_array_equal(a.state.bound, b.state.bound)
    ta, tb = a.telemetry, b.telemetry
    assert (ta is None) == (tb is None)
    if ta is None:
        return
    for f in ("granularity", "latency", "reasons", "rejection_attempts", "series",
              "bind_latency", "zero_latency_binds", "events"):
        assert getattr(ta, f) == getattr(tb, f), f
    assert set(ta.phases) == set(tb.phases)


@pytest.mark.parametrize("name", sorted(CASES))
def test_event_engine_equals_reference(name):
    cluster, pods, cfg, kw, raw = CASES[name]()
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    for gran in ("timeline", "off"):
        want = J_Engine(ec, ep, J_Config(**cfg), telemetry=gran, **kw).replay(
            node_events=[J_Event(*e) for e in raw] if raw else None)
        got = get_strategy("cpu")(pec, pep, FrameworkConfig(**cfg), telemetry=gran, **kw).replay(
            node_events=[NodeEvent(*e) for e in raw] if raw else None)
        assert got.route is None
        _assert_same_result(want, got)
        if gran == "timeline":
            got_timeline = got
    if name == "chaos":
        assert got.evictions > 0 and got.preemptions > 0 and got.evict_rescheduled > 0
        kinds = {e[0] for e in got_timeline.telemetry.events}
        assert {"bind", "evict", "node_down", "node_up", "preempt"} <= kinds
    if name in ("gang_all_or_nothing", "gang_no_progress"):
        assert got.placed == 0 and np.allclose(got.state.used, 0.0)
    if name == "backoff":
        assert got.placed == 2 and got.unschedulable == 1
    # The engine restores the cluster it mutated under node events.
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)


def test_scheduling_queue_equals_reference():
    """A seeded script of pushes, pops, backoff requeues, unschedulable
    marks with and without a failure time, flushes and backoff expiries:
    every pop and every queue depth equal the JAX queue's."""
    rng = np.random.default_rng(7)
    qs = (J_Queue(), SchedulingQueue())
    now = 0.0
    trace = ([], [])
    for _ in range(600):
        op = int(rng.integers(0, 7))
        pod, prio = int(rng.integers(0, 40)), int(rng.integers(0, 4)) * 10
        now += float(rng.choice([0.0, 0.25, 1.0, 3.0]))
        for q, out in zip(qs, trace):
            if op == 0 or op == 1:
                q.push(pod, prio)
            elif op == 2:
                out.append(("pop", q.pop()))
            elif op == 3:
                q.requeue_backoff(pod, prio, now)
            elif op == 4:
                q.mark_unschedulable(pod, prio, now if pod % 2 else None)
            elif op == 5:
                q.flush_unschedulable(now if pod % 3 else None)
            else:
                q.flush_backoff(now)
            out.append((len(q), q.num_unschedulable, q.num_backoff, q.next_backoff_time()))
    assert trace[0] == trace[1]
    assert any(x[0] == "pop" and x[1] is not None for x in trace[0])


# -- the cross-engine checks of tests/test_utilization.py, within the port --

def _release_trace(num_nodes=3, num_pods=12, duration=5.0):
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(num_nodes)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=duration)
            for i in range(num_pods)]
    return port_case(*encode(Cluster(nodes=nodes), pods))


def _series_at(tel):
    s = tel.series
    return {t: (u, f) for t, u, f in zip(s["t"], s["util_cpu"], s["frag_cpu"])}


def test_plain_series_utilization_bit_parity():
    """The device engine samples at every chunk boundary (post-release,
    pre-dispatch), the event engine after each instant's events: at common
    instants the utilization series agree bit for bit."""
    ec, ep = _release_trace()
    cfg = FrameworkConfig(plugins=FIT)
    cpu = CpuReplayEngine(ec, ep, cfg, telemetry="series").replay()
    dev = TorchReplayEngine(ec, ep, cfg, wave_width=1, chunk_waves=1, telemetry="series",
                            device="cpu").replay()
    np.testing.assert_array_equal(cpu.assignments, dev.assignments)
    ca, da = _series_at(cpu.telemetry), _series_at(dev.telemetry)
    common = sorted(set(ca) & set(da))
    assert len(common) >= 8
    for t in common:
        assert ca[t] == da[t], t
    assert max(ca[t][0] for t in common) > 0.0


def test_boundary_series_and_end_gauges_match_cpu():
    """The retry path: a failed pod retries at the next boundary; the end
    gauges and the t = 5 sample equal the event engine's."""
    nodes = [Node("n0", {"cpu": 1.0})]
    pods = [Pod("p0", requests={"cpu": 1.0}, arrival_time=0.0, duration=1.5),
            Pod("p1", requests={"cpu": 1.0}, arrival_time=1.0, duration=2.0),
            Pod("p2", requests={"cpu": 0.0}, arrival_time=2.0),
            Pod("p3", requests={"cpu": 0.0}, arrival_time=5.0)]
    ec, ep = port_case(*encode(Cluster(nodes=nodes), pods))
    cfg = FrameworkConfig(plugins=FIT)
    cpu = CpuReplayEngine(ec, ep, cfg, telemetry="series").replay()
    dev = TorchReplayEngine(ec, ep, cfg, wave_width=1, chunk_waves=1, retry_buffer=8,
                            telemetry="series", device="cpu").replay()
    np.testing.assert_array_equal(cpu.assignments, dev.assignments)
    assert cpu.utilization == dev.utilization
    assert cpu.fragmentation == dev.fragmentation
    assert _series_at(cpu.telemetry)[5.0] == _series_at(dev.telemetry)[5.0] == (0.0, 0.0)


def test_chaos_eviction_utilization_parity():
    """Chaos evictions (kube preemption, mttr = 0 timelines): evicted pods
    re-bind through the boundary retry pass; the end utilization and
    fragmentation equal the event engine's."""
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(6)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i)) for i in range(28)]
    ec, ep = port_case(*encode(Cluster(nodes=nodes), pods))
    evs = [NodeEvent(e.time, e.kind, e.node, e.scale) for e in make_chaos_timeline(
        ec.num_nodes, seed=2, horizon=float(ep.arrival.max()), mtbf=12.0, mttr=0.0,
        node_fraction=0.34)]
    cfg = FrameworkConfig(plugins=FIT)
    cpu = CpuReplayEngine(ec, ep, cfg, telemetry="series").replay(node_events=evs)
    dev = TorchReplayEngine(ec, ep, cfg, wave_width=1, chunk_waves=1, preemption="kube",
                            retry_buffer=64, telemetry="series", device="cpu"
                            ).replay(node_events=evs)
    assert dev.evictions > 0
    np.testing.assert_array_equal(cpu.assignments, dev.assignments)
    assert cpu.utilization == dev.utilization
    assert cpu.fragmentation == dev.fragmentation


def test_first_reject_counts_host_equals_reference():
    """The host attribution helper: the JAX helper's mask and counts, and the
    counts ``feasible_mask(reject_counts=)`` charges, pod by pod on a state
    part-way through the full-plugin trace."""
    from kubernetes_simulator_tpu.framework.framework import SchedulerFramework as J_Framework
    from kubernetes_simulator_tpu.models.state import bind as j_bind
    from kubernetes_simulator_tpu.models.state import init_state as j_init
    from kubernetes_simulator_tpu.sim.telemetry import first_reject_counts_host as j_counts
    from kubernetes_simulator_tpu_torch.framework.framework import SchedulerFramework
    from kubernetes_simulator_tpu_torch.models.state import bind, init_state
    from kubernetes_simulator_tpu_torch.sim.telemetry import first_reject_counts_host

    cluster, pods, _, _, _ = _full_plugins()
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    jfw, fw = J_Framework(ec, ep, J_Config()), SchedulerFramework(pec, pep, FrameworkConfig())
    jst, st = j_init(ec, ep), init_state(pec, pep)
    charged = 0
    for p in range(ep.num_pods):
        jm, jc = j_counts(jfw.plugins, jfw.ctx, jst, p, ec.num_nodes)
        m, c = first_reject_counts_host(fw.plugins, fw.ctx, st, p, pec.num_nodes)
        np.testing.assert_array_equal(m, jm)
        assert c == jc
        rc = {}
        fw.feasible_mask(st, p, reject_counts=rc)
        assert rc == {k: v for k, v in c.items() if k in rc}
        charged += sum(c.values())
        n = fw.schedule_one(st, p, allow_preemption=False).node
        if n >= 0:
            bind(pec, pep, st, p, n)
            j_bind(ec, ep, jst, p, n)
    assert charged > 0
