"""Chaos node events in the port — node_down / node_up / capacity_scale at
chunk boundaries, with node_down's NoExecute eviction (K10 on the card; its
plain twin here, on the CPU) before the boundary's releases — held against
the JAX package.

Every case runs one encoded trace (the JAX package's, carried into the port
as numpy arrays, tests/torch_port_case.py) through the JAX
``JaxReplayEngine`` or ``WhatIfEngine`` and through the port's
``TorchReplayEngine(device="cpu")`` or ``WhatIfEngine(device="cpu")`` with
the same timeline; equal means equal assignments, placed, preemptions,
retry_dropped and the four eviction counters, ``evict_latency_mean`` bit for
bit (``==`` on the f64), and the summary rows equal but for their wall-clock
fields. The traces are tests/test_chaos.py's ``_light_trace`` and ``EVS``,
re-created here, and crafted cases for the hazards of the schedule: a
release due at the node_down boundary, a gang victim, a pre-bound victim,
a full retry buffer, two node_down events at one boundary."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.runtime import NodeEvent as J_Event
from kubernetes_simulator_tpu.sim.runtime import validate_node_events as j_validate
from kubernetes_simulator_tpu.sim.synthetic import make_chaos_timeline as j_timeline
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent, validate_node_events
from kubernetes_simulator_tpu_torch.sim.synthetic import make_chaos_timeline
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

FIT_ONLY = [{"name": "NodeResourcesFit"}]
COUNTERS = ("placed", "unschedulable", "preemptions", "retry_dropped", "evictions",
            "evict_rescheduled", "evict_stranded", "evict_latency_mean")
TIMING = ("wall_clock_s", "placements_per_sec", "telemetry")


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _light_trace(num_pods=28, num_nodes=5, duration=30.0, seed=None):
    """tests/test_chaos.py's queue-trivial shape: distinct strictly
    increasing integer arrivals, priority 0, load that fits the cluster
    even under the injected failures."""
    rng = np.random.default_rng(seed) if seed is not None else None
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(num_nodes)]
    pods = []
    for i in range(num_pods):
        d = duration if rng is None else float(rng.integers(30, 61))
        pods.append(Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=d))
    return encode(Cluster(nodes=nodes), pods)


# tests/test_chaos.py's timeline: every event below the last arrival (27).
EVS = [(8.0, "node_down", 0), (18.0, "node_up", 0), (24.0, "node_down", 1)]


def _events(spec, cls=NodeEvent):
    return [cls(time=t, kind=k, node=n, **({"scale": x[0]} if x else {}))
            for t, k, n, *x in spec]


def _contended(num_pods=48, num_nodes=3):
    """Three 4-cpu nodes under a steady 1-cpu load of 6-unit pods every
    half unit (12 running: the cluster full), so a down node's victims wait
    for later releases: a re-bind lands at a later boundary than its
    eviction, and the latency mean is not 0."""
    nodes = [Node(f"n{i}", {"cpu": 4.0}) for i in range(num_nodes)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=0.5 * i, duration=6.0)
            for i in range(num_pods)]
    return encode(Cluster(nodes=nodes), pods)


def _replays(ec, ep, spec, mode, W=1, C=1, rb=64, plugins=FIT_ONLY):
    """(the JAX engine's result, the port's result, the port's engine) of
    one replay under the timeline ``spec``; ``mode`` is "kube", "retry"
    (the buffer alone) or "plain"."""
    kw = dict(wave_width=W, chunk_waves=C)
    if mode != "plain":
        kw["retry_buffer"] = rb
    if mode == "kube":
        kw["preemption"] = "kube"
    want = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), **kw).replay(
        node_events=_events(spec, J_Event))
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu", **kw)
    alloc0 = pec.allocatable.copy()
    got = eng.replay(node_events=_events(spec))
    # the rows the run rewrote are restored
    np.testing.assert_array_equal(eng.ec.allocatable, alloc0)
    np.testing.assert_array_equal(eng._cluster.allocatable.numpy(), alloc0)
    return want, got, eng


def _same(want, got):
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    sw, sg = want.summary(), got.summary()
    for k in TIMING:
        sw.pop(k, None)
        sg.pop(k, None)
    assert sg == sw


@pytest.mark.parametrize("mode", ["kube", "retry"])
@pytest.mark.parametrize("C", [1, 4])
def test_single_replay_equals_jax(mode, C):
    ec, ep = _light_trace()
    want, got, eng = _replays(ec, ep, EVS, mode, C=C)
    _same(want, got)
    assert got.evictions > 0 and got.preemptions == 0


@pytest.mark.parametrize("mode", ["kube", "retry"])
def test_reschedule_latency_is_not_zero(mode):
    """The victims of a full cluster wait for releases: their re-binds land
    at later boundaries, and the f64 latency mean matches bit for bit."""
    ec, ep = _contended()
    spec = [(5.0, "node_down", 0), (12.0, "node_up", 0), (14.0, "node_down", 2)]
    want, got, _ = _replays(ec, ep, spec, mode, W=2, C=2)
    _same(want, got)
    assert got.evict_latency_mean > 0.0 and got.evict_rescheduled > 0


def test_plain_path_rewrites_allocatable():
    """Without the retry buffer node events only rewrite the allocatable
    rows (no eviction): node_down, node_up back to the t = 0 row and
    capacity_scale of that row, as the JAX plain replay."""
    ec, ep = _contended(num_pods=40, num_nodes=4)
    spec = [(2.0, "node_down", 1), (4.0, "capacity_scale", 2, 0.5), (6.5, "node_up", 1),
            (9.0, "capacity_scale", 2, 1.5), (11.0, "node_down", 3)]
    for C in (1, 4):
        want, got, eng = _replays(ec, ep, spec, "plain", W=2, C=C)
        _same(want, got)
        assert got.evictions == 0
        # the per-slot route (the plain twins) places alike
        pec, pep = port_case(ec, ep)
        slot = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT_ONLY), device="cpu",
                                 wave_width=2, chunk_waves=C, plain=True)
        np.testing.assert_array_equal(slot.replay(node_events=_events(spec)).assignments,
                                      got.assignments)


@pytest.mark.parametrize("mode", ["kube", "retry"])
def test_release_due_at_the_down_boundary_is_evicted(mode):
    """Pod 0 (node n0, arrival 0, duration 5) releases at boundary 5; a
    node_down of n0 at t = 5 fires there first: pod 0 is evicted and
    requeued, not released (the reference's order, eviction -> pending
    release -> static release -> retry pass)."""
    nodes = [Node(f"n{i}", {"cpu": 2.0}) for i in range(3)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=5.0)
            for i in range(10)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    want, got, eng = _replays(ec, ep, [(5.0, "node_down", 0)], mode)
    _same(want, got)
    rt = eng.last_tables.retry
    assert int(rt.first_b[0, 0]) == ref.FIRST_IN_WAVE  # pod 0 was a victim
    assert got.evictions == want.evictions >= 1


def test_gang_victim_is_stranded():
    """A gang member on a down node is evicted and not requeued: it stays
    displaced and counts as stranded."""
    nodes = [Node(f"n{i}", {"cpu": 4.0}) for i in range(3)]
    pods = [Pod("g0", requests={"cpu": 2.0}, arrival_time=0.0, duration=50.0, pod_group="g"),
            Pod("g1", requests={"cpu": 2.0}, arrival_time=0.0, duration=50.0, pod_group="g")]
    pods += [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=1.0 + i, duration=50.0)
             for i in range(8)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    for mode in ("kube", "retry"):
        want, got, _ = _replays(ec, ep, [(3.0, "node_down", 0), (4.0, "node_down", 1)], mode,
                                W=2, C=1)
        _same(want, got)
        assert got.evict_stranded > 0


def test_prebound_victim_is_evicted():
    """A pre-bound pod on a down node is evicted (its tail column cleared)
    and re-placed through the retry pass; its re-placement is not counted in
    ``placed``, as the reference's."""
    nodes = [Node(f"n{i}", {"cpu": 4.0}) for i in range(3)]
    pods = [Pod("b0", requests={"cpu": 1.0}, node_name="n0", duration=float("inf")),
            Pod("b1", requests={"cpu": 2.0}, node_name="n1", duration=20.0)]
    pods += [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=6.0)
             for i in range(12)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    for spec in ([(0.0, "node_down", 0)], [(3.0, "node_down", 1), (5.0, "node_down", 0)]):
        for mode in ("kube", "retry"):
            want, got, _ = _replays(ec, ep, spec, mode, W=1, C=2)
            _same(want, got)
            assert got.evictions > 0


def test_full_buffer_drops_victims():
    """A retry buffer of 2 slots cannot take a down node's victims: the
    rest count in retry_dropped and stay stranded."""
    ec, ep = _light_trace()
    for mode in ("kube", "retry"):
        want, got, _ = _replays(ec, ep, EVS, mode, rb=2)
        _same(want, got)
        assert got.retry_dropped > 0 and got.evict_stranded > 0


def test_two_node_downs_at_one_boundary():
    """Two node_down events due at one boundary evict in timeline order
    (the second node's victims after the first's in the buffer)."""
    ec, ep = _light_trace(num_pods=30, num_nodes=6)
    spec = [(7.5, "node_down", 3), (8.0, "node_down", 0), (15.0, "node_up", 3),
            (20.0, "node_down", 1), (20.0, "node_down", 4)]
    for mode in ("kube", "retry"):
        for C in (1, 3):
            want, got, _ = _replays(ec, ep, spec, mode, W=1, C=C)
            _same(want, got)
            assert got.evictions > 0


def test_whatif_batch_equals_jax():
    """The kube batch of the JAX engine's per-scenario timelines: a clean
    scenario, tests/test_chaos.py's EVS, a late node_down, and a static
    node_down with a timed node_up of the same node (it comes back to its
    scenario's own t = 0 row: still 0). Assignments and the counters per
    scenario; a second run() gives the same (the stacks are restored)."""
    ec, ep = _light_trace()
    late = [(25.0, "node_down", 0)]
    static = [(8.0, "node_down", 2), (16.0, "node_up", 2)]

    def scenarios(mod, Ev):
        down = mod.Perturbation("node_down", nodes=np.array([2]))
        return [mod.Scenario(), mod.Scenario(events=_events(EVS, Ev)),
                mod.Scenario(events=_events(late, Ev)),
                mod.Scenario([down], events=_events(static, Ev))]

    kw = dict(wave_width=1, chunk_waves=2, preemption="kube", retry_buffer=64,
              collect_assignments=True)
    want = J.WhatIfEngine(ec, ep, scenarios(J, J_Event), J_Config(plugins=FIT_ONLY),
                          **kw).run()
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, scenarios(T, NodeEvent), FrameworkConfig(plugins=FIT_ONLY),
                         device="cpu", **kw)
    got = eng.run()
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for name in ("placed", "preemptions", "retry_dropped", "evictions", "evict_rescheduled",
                 "evict_stranded", "evict_latency_mean"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert int(got.evictions[0]) == 0 and int(got.evictions[1]) > 0
    again = eng.run()
    np.testing.assert_array_equal(again.assignments, got.assignments)
    np.testing.assert_array_equal(again.evictions, got.evictions)
    cpu = pec.vocab._r["cpu"]
    assert float(eng.sset.alloc[3, 2, cpu]) == 0.0 and float(eng.sset.alloc[1, 0, cpu]) > 0


def test_whatif_timeline_guards():
    ec, ep = port_case(*_light_trace(num_pods=4, num_nodes=2))
    with pytest.raises(ValueError, match="kube"):
        T.WhatIfEngine(ec, ep, [T.Scenario(events=_events(EVS[:1]))],
                       FrameworkConfig(plugins=FIT_ONLY), wave_width=1, chunk_waves=1,
                       device="cpu")
    with pytest.raises(ValueError, match="scenario 1"):
        T.WhatIfEngine(ec, ep, [T.Scenario(), T.Scenario(events=_events([(1.0, "node_down", 99)]))],
                       FrameworkConfig(plugins=FIT_ONLY), wave_width=1, chunk_waves=1,
                       preemption="kube", retry_buffer=8, device="cpu")


BAD = {
    "unknown kind": [(1.0, "node_reboot", 0)],
    "out of range": [(1.0, "node_down", 7)],
    "must be sorted": [(5.0, "node_down", 0), (1.0, "node_down", 1)],
    "finite value": [(-2.0, "node_down", 0)],
    "without a prior node_down": [(1.0, "node_up", 0)],
    "capacity_scale factor": [(1.0, "capacity_scale", 0, -1.0)],
}


@pytest.mark.parametrize("pat", sorted(BAD))
def test_validation_messages_equal_the_reference(pat):
    ec, ep = _light_trace(num_pods=4, num_nodes=2)
    with pytest.raises(ValueError, match=pat) as want:
        j_validate(_events(BAD[pat], J_Event), ec.num_nodes)
    with pytest.raises(ValueError, match=pat) as got:
        validate_node_events(_events(BAD[pat]), ec.num_nodes)
    assert str(got.value) == str(want.value)
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match=pat):
        TorchReplayEngine(pec, pep, device="cpu", wave_width=1, chunk_waves=1).replay(
            node_events=_events(BAD[pat]))


@pytest.mark.parametrize("seed,max_events,mttr", [(0, None, 20.0), (3, 9, 10.0), (7, 64, 8.0),
                                                  (11, None, 0.0), (5, 4, 30.0)])
def test_chaos_timeline_equals_the_reference(seed, max_events, mttr):
    kw = dict(seed=seed, horizon=120.0, mtbf=25.0, mttr=mttr, node_fraction=0.3,
              max_events=max_events)
    want = [(e.time, e.kind, e.node, e.scale) for e in j_timeline(40, **kw)]
    got = [(e.time, e.kind, e.node, e.scale) for e in make_chaos_timeline(40, **kw)]
    assert got == want and got
    with pytest.raises(ValueError, match="mtbf"):
        make_chaos_timeline(10, mtbf=0.0)


def _refusal(kind):
    ec, ep = port_case(*_light_trace(num_pods=8, num_nodes=3))
    ev = _events([(2.0, "node_down", 0)])
    cfg = FrameworkConfig(plugins=FIT_ONLY)
    if kind == "shards":
        return lambda: TorchReplayEngine(ec, ep, cfg, device="cpu", node_shards=2).replay(
            node_events=ev)
    if kind == "paged":
        return lambda: TorchReplayEngine(ec, ep, cfg, device="cpu", paged=True).replay(
            node_events=ev)
    if kind == "slot":
        return lambda: TorchReplayEngine(ec, ep, cfg, device="cpu", retry_buffer=8,
                                         plain=True).replay(node_events=ev)
    if kind == "series":  # series runs under chaos; the per-slot retry route still refuses it
        return lambda: TorchReplayEngine(ec, ep, cfg, device="cpu", retry_buffer=8,
                                         telemetry="series", plain=True).replay(node_events=ev)
    import os
    import tempfile

    ck = os.path.join(tempfile.mkdtemp(), "ck.npz")
    return lambda: (TorchReplayEngine(ec, ep, cfg, device="cpu", retry_buffer=8, wave_width=1,
                                      chunk_waves=1).replay(node_events=ev, checkpoint_path=ck,
                                                            checkpoint_every=3), ck)


@pytest.mark.parametrize("kind,item", [("shards", "6b"), ("paged", "6b"), ("slot", "6b"),
                                       ("series", "6b"), ("checkpoint", "6d")])
def test_refused_modes_name_their_queue_item(kind, item):
    if kind == "checkpoint":
        # Ported since (queue A item 6d, tests/test_torch_checkpoint_boundary.py):
        # a chaos replay under the retry buffer checkpoints, and resumes to its
        # uninterrupted result.
        full, ck = _refusal(kind)()
        ec, ep = port_case(*_light_trace(num_pods=8, num_nodes=3))
        ev = _events([(2.0, "node_down", 0)])
        res = TorchReplayEngine(ec, ep, FrameworkConfig(plugins=FIT_ONLY), device="cpu",
                                retry_buffer=8, wave_width=1, chunk_waves=1).replay(
            node_events=ev, checkpoint_path=ck, resume=True)
        np.testing.assert_array_equal(res.assignments, full.assignments)
        assert res.evictions == full.evictions > 0
        return
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        _refusal(kind)()


def test_config_chaos_section_and_cli(tmp_path, monkeypatch):
    """The chaos: section parses as the reference's and its checks are the
    reference's; the CLI run injects one timeline and the what-if one a
    scenario past 0."""
    import json

    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, config_errors

    raw = yaml.safe_load("chaos: {seed: 3, mtbf: 5, mttr: 2, nodeFraction: 0.5, maxEvents: 6}")
    got, want = SimConfig.from_dict(raw).chaos, J_SimConfig.from_dict(raw).chaos
    assert got.__dict__ == want.__dict__
    errs = config_errors(SimConfig.from_dict({"chaos": {"mtbf": 0, "mttr": -1}}))
    assert any("chaos.mtbf" in e for e in errs) and any("retryBuffer" in e for e in errs)
    errs = config_errors(SimConfig.from_dict({"chaos": {}, "whatIf": {"scenarios": 2,
                                                                        "retryBuffer": 8}}))
    assert any("devicePreemption: kube" in e for e in errs)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.yaml").write_text(
        "cluster: {synthetic: {nodes: 6, seed: 0}}\n"
        "workload: {synthetic: {pods: 40, seed: 0, durationMean: 20.0, arrivalRate: 2.0}}\n"
        "chunkWaves: 2\ndevicePreemption: kube\noutput: out.jsonl\n"
        "whatIf: {scenarios: 3, retryBuffer: 16}\n"
        "chaos: {seed: 1, mtbf: 4.0, mttr: 2.0, nodeFraction: 0.5}\n")
    assert cli.main(["run", "c.yaml", "--device", "cpu"]) == 0
    row = json.loads((tmp_path / "out.jsonl").read_text().splitlines()[-1])
    assert row["evictions"] > 0
    assert cli.main(["what-if", "c.yaml", "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in (tmp_path / "out.jsonl").read_text().splitlines()]
    sc = [r for r in rows if r["kind"] == "whatif-scenario"][-3:]
    assert sc[0]["evictions"] == 0 and sum(r["evictions"] for r in sc[1:]) > 0
