"""The port's resident query service (kubernetes_simulator_tpu_torch.sim.service)
and ``WhatIfEngine.set_scenarios`` against the JAX package's, on the CPU.

- the service's rows (after the reference's timing scrub) and stats equal
  the JAX service's on the same queries: the admission checks, the base
  state mirror's perturbations, batched multi-tenant answers at series
  telemetry, warm batches, the LRU pool, ``serve_lines`` on a stream with
  torn and malformed lines (every row valid schema v7), the CLI ``serve``,
  and a 16 x 256 cluster at maxBatch 2;
- a batched answer equals a one-off run of its scenario on a fresh engine
  (the reference's parity bar), and a warm batch sets nothing up;
- ``set_scenarios`` refuses where the reference refuses, with the
  reference's message, and a swapped batch runs as a fresh engine does.
"""

import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import service as JS
from kubernetes_simulator_tpu.sim import whatif as JW
from kubernetes_simulator_tpu.sim.runtime import NodeEvent as J_Event
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import service as TS
from kubernetes_simulator_tpu_torch.sim import whatif as TW
from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent

from torch_port_case import port_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from check_metrics_schema import validate_file  # noqa: E402

FIT = [{"name": "NodeResourcesFit"}]
ENGINE_KW = dict(wave_width=1, chunk_waves=1)
TIMING = ("latency_s", "queue_wait_s", "ts")


def _tiny_trace(num_pods=12, num_nodes=4):
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(num_nodes)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=30.0)
            for i in range(num_pods)]
    return encode(Cluster(nodes=nodes), pods)


class _Writer:
    def __init__(self):
        self.rows = []

    def write(self, row, stamp_ts=True):
        self.rows.append(dict(row))


def _services(ec, ep, **kw):
    """(JAX service, port service, their writers) on one case."""
    kw.setdefault("max_batch", 3)
    kw.setdefault("batch_deadline_s", 60.0)
    kw.setdefault("retry_buffer", 64)
    kw.setdefault("wave_width", 1)
    kw.setdefault("chunk_waves", 1)
    pec, pep = port_case(ec, ep)
    wj, wt = _Writer(), _Writer()
    j = JS.QueryService(ec, ep, J_Config(plugins=FIT), writer=wj, **kw)
    t = TS.QueryService(pec, pep, FrameworkConfig(plugins=FIT), writer=wt, device="cpu", **kw)
    return j, t, wj, wt


def _scrub(rows):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in rows]


WIRE = [
    {"op": "defrag", "tenant": "team-a", "id": "q1", "nodes": [3], "drainAt": 4.0,
     "recoverAt": 12.0},
    {"op": "defrag", "tenant": "team-b", "id": "q1", "nodes": [0, 1], "drainAt": 2.0},
    {"op": "defrag", "tenant": "team-a", "id": "q2", "nodes": ["n2"], "drainAt": 6.0,
     "recoverAt": 20.0},
]


def _bad_queries():
    return [
        ({"op": "repack", "nodes": [0]}, "unknown query family"),
        (["defrag"], "JSON object"),
        ({"op": "defrag"}, "nodes"),
        ({"op": "defrag", "nodes": [99]}, "out of range"),
        ({"op": "defrag", "nodes": ["nope"]}, "unknown node name"),
        ({"op": "defrag", "nodes": [0], "drainAt": -1.0}, "drainAt"),
        ({"op": "defrag", "nodes": [0], "drainAt": 5.0, "recoverAt": 5.0}, "recoverAt"),
        ({"op": "defrag", "nodes": [0], "granularity": "verbose"}, "granularity"),
    ]


def test_parse_query_refusals():
    ec, ep = _tiny_trace(num_pods=2, num_nodes=2)
    j, t, _, _ = _services(ec, ep)
    for q, match in _bad_queries():
        msgs = []
        for svc in (j, t):
            with pytest.raises(ValueError, match=match) as e:
                svc.parse_query(q)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    dj = j.parse_query({"op": "defrag", "nodes": ["n1", 0, 1], "drainAt": 5.0})
    dt = t.parse_query({"op": "defrag", "nodes": ["n1", 0, 1], "drainAt": 5.0})
    assert dataclasses.asdict(dj) == dataclasses.asdict(dt) and dt.nodes == [0, 1]
    for svc in (j, t):
        svc.submit({"op": "defrag", "tenant": "a", "id": "q1", "nodes": [0], "drainAt": 5.0})
        with pytest.raises(ValueError, match="duplicate query id"):
            svc.submit({"op": "defrag", "tenant": "a", "id": "q1", "nodes": [1]})


def test_ctor_refusals_and_engine_cap(monkeypatch):
    ec, ep = _tiny_trace(num_pods=2, num_nodes=2)
    pec, pep = port_case(ec, ep)
    for kw, match in ((dict(max_batch=0), "max_batch"), (dict(batch_deadline_s=0.0),
                      "batch_deadline_s"), (dict(retry_buffer=0), "retry_buffer")):
        msgs = []
        for Q, e, p, c in ((JS.QueryService, ec, ep, J_Config()),
                           (TS.QueryService, pec, pep, FrameworkConfig())):
            with pytest.raises(ValueError, match=match) as err:
                Q(e, p, c, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert TS.max_engines_cap(4) == JS.max_engines_cap(4) == 4
    monkeypatch.setenv("KSIM_SERVICE_MAX_ENGINES", "2")
    assert TS.max_engines_cap(4) == 2
    assert TS.QueryService(pec, pep, FrameworkConfig(), max_engines=8).max_engines == 2


def test_base_state_mirror():
    """bind / release / evict deltas give the reference's scale_capacity
    perturbations: the same nodes, resources and f32-derived factors."""
    ec, ep = _tiny_trace(num_pods=2, num_nodes=3)
    j, t, _, _ = _services(ec, ep)

    def perts(svc):
        return [(p.op, [int(n) for n in p.nodes], p.resource, p.factor)
                for p in svc.base_perturbations()]

    for svc in (j, t):
        svc.apply_bind("b1", "n0", {"cpu": 2.0})
        svc.apply_bind("b2", 0, {"cpu": 2.5})
        svc.apply_bind("b3", 1, {"cpu": 4.0 / 3.0})
    assert perts(t) == perts(j) and len(perts(t)) == 2
    assert t.base_state() == j.base_state() == {"binds": 3, "nodes_used": 2}
    for svc in (j, t):
        svc.apply_release("b2")
        assert svc.apply_evict("n1") == ["b3"]
    assert perts(t) == perts(j) and len(perts(t)) == 1
    for svc in (j, t):
        with pytest.raises(ValueError, match="already active"):
            svc.apply_bind("b1", 0, {"cpu": 1.0})
        with pytest.raises(ValueError, match="unknown bind"):
            svc.apply_release("b2")
        with pytest.raises(ValueError, match="unknown resource"):
            svc.apply_bind("b9", 0, {"unobtainium": 1.0})


def test_batched_multitenant_parity_bitmatch():
    """Three coalesced queries from two tenants on a live base state at
    series telemetry: each row equals a one-off S = 1 run of its scenario on
    a fresh port engine, and the rows equal the JAX service's."""
    ec, ep = _tiny_trace()
    pec, pep = port_case(ec, ep)
    j, t, wj, wt = _services(ec, ep, granularity="series")
    for svc in (j, t):
        svc.apply_bind("web-1", 0, {"cpu": 3.0})
        svc.apply_bind("web-2", 2, {"cpu": 2.0})
    scens = [t.query_scenario(t.parse_query(dict(q))) for q in WIRE]
    for svc in (j, t):
        for q in WIRE:
            svc.submit(dict(q))
    rows_a, rows_b = t.poll("team-a"), t.poll("team-b")
    assert [r["query"] for r in rows_a] == ["q1", "q2"] and len(rows_b) == 1
    for row, scen in zip([rows_a[0], rows_b[0], rows_a[1]], scens):
        assert row["warm"] is False and row["batch"] == 1
        one = TW.WhatIfEngine(pec, pep, [scen], FrameworkConfig(plugins=FIT), preemption="kube",
                              retry_buffer=64, telemetry="series", device="cpu",
                              **ENGINE_KW).run()
        assert row["placed"] == int(one.placed[0])
        assert row["evictions"] == int(one.evictions[0])
        assert row["evict_latency_mean"] == float(one.evict_latency_mean[0])
        assert row["stranded_cpu"] == float(one.stranded_cpu[0])
        assert row["telemetry"]["series"] == one.scenario_telemetry[0].query_view()["series"]
    assert sum(r["evictions"] for r in rows_a + rows_b) > 0
    assert _scrub(wt.rows) == _scrub(wj.rows)
    assert t.stats() == j.stats()
    assert t.stats()["compile_counts"] == {"defrag/series": 1}


def test_warm_queries_zero_recompile():
    """The second batch swaps its scenarios into the resident engine: the
    same engine object, one set-up, and the reference's stats."""
    ec, ep = _tiny_trace()
    j, t, wj, wt = _services(ec, ep)
    for svc in (j, t):
        svc.submit({"op": "defrag", "tenant": "a", "id": "q1", "nodes": [1], "drainAt": 3.0})
        assert svc.flush() == 1
    (r1,), _ = t.poll("a"), j.poll("a")
    assert r1["warm"] is False and r1["batch_occupancy"] < 1.0
    eng = next(iter(t._pool.values()))
    for svc in (j, t):
        svc.submit({"op": "defrag", "tenant": "a", "id": "q2", "nodes": [0, 2],
                    "drainAt": 5.0, "recoverAt": 15.0})
        svc.flush()
    (r2,), _ = t.poll("a"), j.poll("a")
    assert r2["warm"] is True and next(iter(t._pool.values())) is eng
    assert eng.setups == 1
    assert t.stats() == j.stats()
    assert t.stats()["compile_counts"] == {"defrag/summary": 1}
    assert _scrub(wt.rows) == _scrub(wj.rows)
    assert t.close() == [] and j.close() == []
    with pytest.raises(ValueError, match="closed"):
        t.submit({"op": "defrag", "nodes": [0]})


STREAM = "\n".join([
    '{"op": "defrag", "tenant": "a", "id": "q1", "nodes": [1], "drainAt": 3.0}',
    '{"op": "defrag", "tenant": "a", "id": "q2", "nodes": [',  # torn
    "not json at all",
    '{"op": "warp", "nodes": [0]}',
    '{"op": "defrag", "nodes": [99]}',
    "",
    '{"op": "defrag", "tenant": "b", "id": "q9", "nodes": [0, 2], "drainAt": 2.0, '
    '"recoverAt": 9.0}',
]) + "\n"


def test_serve_lines_and_schema_v7(tmp_path):
    """Torn and malformed lines become query-error rows and the loop keeps
    serving; the port's rows equal the reference's and validate as schema
    v7, the flight recorder's query rows too."""
    from kubernetes_simulator_tpu_torch.sim.flight import FlightRecorder, FlightRecorderConfig
    from kubernetes_simulator_tpu_torch.utils.metrics import JsonlWriter

    ec, ep = _tiny_trace()
    pec, pep = port_case(ec, ep)
    out_path, fl_path = str(tmp_path / "serve.jsonl"), str(tmp_path / "flight.jsonl")
    flight = FlightRecorder(FlightRecorderConfig(path=fl_path), meta={"mode": "serve"})
    with JsonlWriter(out_path, context={"seed": 0, "engine": "torch",
                                        "config_hash": "t" * 12}) as out:
        svc = TS.QueryService(pec, pep, FrameworkConfig(plugins=FIT), max_batch=1,
                              retry_buffer=64, writer=out, flight=flight, device="cpu",
                              **ENGINE_KW)
        stats = TS.serve_lines(svc, io.StringIO(STREAM), out)
    flight.close()
    wj = _Writer()
    jsvc = JS.QueryService(ec, ep, J_Config(plugins=FIT), max_batch=1, retry_buffer=64,
                           writer=wj, **ENGINE_KW)
    assert stats == JS.serve_lines(jsvc, io.StringIO(STREAM), wj)
    assert stats["queries"] == 2 and stats["errors"] == 4 and stats["batches"] == 2
    rows = [json.loads(line) for line in open(out_path)]
    assert _scrub([{k: v for k, v in r.items() if k not in ("schema", "seed", "engine",
                                                               "config_hash")}
                   for r in rows]) == _scrub(wj.rows)
    kinds = [r["kind"] for r in rows]
    assert kinds.count("query-error") == 4 and kinds[-1] == "query-result"
    assert rows[-1]["query"] == "q9" and rows[-1]["schema"] == 7
    assert validate_file(out_path) == [] and validate_file(fl_path) == []
    q_events = [r for r in map(json.loads, open(fl_path)) if r.get("event") == "query"]
    assert [e["warm"] for e in q_events] == [False, True] and q_events[1]["engines"] == 1


def test_engine_pool_lru_soak():
    """A two-granularity mix under a pool of one engine: every switch builds
    cold, re-asks answer alike, and the stats equal the reference's."""
    ec, ep = _tiny_trace()
    j, t, wj, wt = _services(ec, ep, max_engines=1)
    for svc in (j, t):
        for round_i in range(2):
            for gran in ("summary", "series"):
                svc.submit({"op": "defrag", "tenant": "t", "id": f"{gran}-{round_i}",
                            "nodes": [1], "drainAt": 3.0, "recoverAt": 10.0,
                            "granularity": gran})
                svc.flush()
                assert len(svc._pool) <= 1
        svc.close()
    assert t.stats() == j.stats()
    assert t.stats()["cold_builds"] == 4 and t.stats()["evicted_engines"] == 3
    assert _scrub(wt.rows) == _scrub(wj.rows)


def test_service_16x256_equals_reference():
    """A 16-node, 256-pod synthetic trace (completions, gangs off) at
    maxBatch 2, the engine's default waves: four queries in three batches
    (one at series telemetry), rows and stats equal the reference's."""
    cluster = make_cluster(16, seed=4)
    pods, _ = make_workload(256, seed=4, duration_mean=20.0, arrival_rate=40.0)
    ec, ep = encode(cluster, pods)
    j, t, wj, wt = _services(ec, ep, max_batch=2, wave_width=8, chunk_waves=4)
    wire = [
        {"op": "defrag", "tenant": "x", "id": "1", "nodes": [3, "node-4"], "drainAt": 1.5,
         "recoverAt": 4.0},
        {"op": "defrag", "tenant": "y", "id": "1", "nodes": [0], "drainAt": 2.5},
        {"op": "defrag", "tenant": "x", "id": "2", "nodes": [7, 8, 9], "drainAt": 0.5,
         "granularity": "series"},
        {"op": "defrag", "tenant": "z", "id": "1", "nodes": ["node-12"], "drainAt": 3.0,
         "recoverAt": 5.0},
    ]
    for svc in (j, t):
        svc.apply_bind("sys", 5, {"cpu": 1.5, "memory": 2.0 ** 30})
        for q in wire:
            svc.submit(dict(q))
        svc.close()
    assert _scrub(wt.rows) == _scrub(wj.rows)
    assert t.stats() == j.stats()
    results = [r for r in wt.rows if r["kind"] == "query-result"]
    assert len(results) == 4 and sum(r["evictions"] for r in results) > 0


def test_cli_serve_equals_reference(tmp_path, monkeypatch):
    """``serve`` on a small kube config through each package's CLI (the
    port on --device cpu), the stream on stdin: the same rows under the
    deterministic JSONL stamp."""
    from kubernetes_simulator_tpu.cli import main as j_cli
    from kubernetes_simulator_tpu_torch.cli import main as t_cli

    monkeypatch.setenv("KSIM_DETERMINISTIC_JSONL", "1")
    cfg = tmp_path / "svc.yaml"
    cfg.write_text(
        "strategy: jax\ndevicePreemption: kube\nchunkWaves: 2\n"
        "cluster: {synthetic: {nodes: 6, seed: 1}}\n"
        "workload: {synthetic: {pods: 48, seed: 1, durationMean: 6.0, arrivalRate: 12.0}}\n"
        "whatIf: {retryBuffer: 16}\n"
        "service: {maxBatch: 2, retryBuffer: 16}\n"
        f"output: {tmp_path / 'out.jsonl'}\n")
    lines = ('{"op": "defrag", "tenant": "a", "nodes": [1], "drainAt": 1.0}\n'
             "{bad\n"
             '{"op": "defrag", "tenant": "b", "nodes": ["node-2", 3], "drainAt": 0.5, '
             '"recoverAt": 2.0}\n')
    got = {}
    for name, cli in (("jax", j_cli), ("torch", t_cli)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        argv = ["serve", str(cfg)] + (["--device", "cpu"] if name == "torch" else [])
        assert cli(argv) == 0
        got[name] = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                     for line in (tmp_path / "out.jsonl").read_text().splitlines()]
        (tmp_path / "out.jsonl").unlink()
    assert got["torch"] == got["jax"]
    assert [r["kind"] for r in got["torch"]].count("query-error") == 1


# -- set_scenarios ---------------------------------------------------------

def _engines(ec, ep, scens_j, scens_t, **kw):
    pec, pep = port_case(ec, ep)
    j = JW.WhatIfEngine(ec, ep, scens_j, J_Config(plugins=FIT), **ENGINE_KW, **kw)
    t = TW.WhatIfEngine(pec, pep, scens_t, FrameworkConfig(plugins=FIT), device="cpu",
                        **ENGINE_KW, **kw)
    return j, t


def _both(mod_scen, mod_pert, mod_event, spec):
    """A scenario list of ``spec``: per scenario a list of perturbations
    (op, kwargs) and of events (time, kind, node)."""
    out = []
    for perts, events in spec:
        out.append(mod_scen(
            perturbations=[mod_pert(op=op, **kw) for op, kw in perts],
            events=[mod_event(time=tm, kind=k, node=n) for tm, k, n in events]))
    return out


KUBE = dict(preemption="kube", retry_buffer=16)
CLEAN = [([], [])] * 2
REFUSALS = {
    "count": (KUBE, CLEAN, [([], [])] * 3, "scenario count"),
    "timeline_without_kube": ({}, CLEAN, [([], []), ([], [(2.0, "node_down", 0)])],
                              "require preemption='kube'"),
    "invalid_timeline": (KUBE, CLEAN, [([], []), ([], [(2.0, "node_up", 1)])],
                         "scenario 1: node_events"),
    "labels_in_batch": (KUBE, CLEAN, [([], []), ([("set_label", dict(
        nodes=np.array([0]), key="topology.kubernetes.io/zone", value="z9"))], [])],
        "does not support label perturbations"),
    "labels_at_build": ({}, [([], []), ([("set_label", dict(
        nodes=np.array([0]), key="topology.kubernetes.io/zone", value="z9"))], [])], CLEAN,
        "engines built with label perturbations"),
    "prefer_taint": (KUBE, CLEAN, [([], []), ([("add_taint", dict(
        nodes=np.array([1]), key="k", value="v", effect="PreferNoSchedule"))], [])],
        "prefer-taints"),
    "pods_scale_up": (KUBE, CLEAN, [([], []), ([("scale_capacity", dict(
        nodes=np.array([1]), resource="pods", factor=2.0))], [])], "'pods' capacity up"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_set_scenarios_refuses_like_reference(name):
    kw, build, swap, match = REFUSALS[name]
    nodes = [Node(f"n{i}", {"cpu": 8.0, "pods": 110}, labels={
        "topology.kubernetes.io/zone": f"z{i % 2}"}) for i in range(4)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=30.0)
            for i in range(12)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    j, t = _engines(ec, ep, _both(JW.Scenario, JW.Perturbation, J_Event, build),
                    _both(TW.Scenario, TW.Perturbation, NodeEvent, build), **kw)
    msgs = []
    for eng, mods in ((j, (JW.Scenario, JW.Perturbation, J_Event)),
                      (t, (TW.Scenario, TW.Perturbation, NodeEvent))):
        with pytest.raises(ValueError, match=match) as e:
            eng.set_scenarios(_both(*mods, swap))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert t.setups == 1


def test_set_scenarios_v2_and_mesh_refused():
    """The v2 fallback (a relabel outside the DynTables envelope: pre-bound
    pods) refuses in both packages; a meshed port engine refuses (the
    reference's service refuses meshes)."""
    nodes = [Node(f"n{i}", {"cpu": 8.0}, labels={"topology.kubernetes.io/zone": f"z{i % 2}"})
             for i in range(4)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i)) for i in range(8)]
    pods.append(Pod("pre", requests={"cpu": 1.0}, node_name="n0"))
    ec, ep = encode(Cluster(nodes=nodes), pods)
    spec = [([], []), ([("set_label", dict(nodes=np.array([1]), key="topology.kubernetes.io/zone",
                                           value="z7"))], [])]
    j, t = _engines(ec, ep, _both(JW.Scenario, JW.Perturbation, J_Event, spec),
                    _both(TW.Scenario, TW.Perturbation, NodeEvent, spec), completions=False)
    assert j.engine == t.engine == "v2"
    msgs = []
    for eng in (j, t):
        with pytest.raises(ValueError, match="requires the v3 engine") as e:
            eng.set_scenarios([])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    pec, pep = port_case(*_tiny_trace())
    meshed = TW.WhatIfEngine(pec, pep, [TW.Scenario()] * 2, FrameworkConfig(plugins=FIT),
                             mesh=["cpu", "cpu"], device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="single-process only"):
        meshed.set_scenarios([TW.Scenario()] * 2)


def test_set_scenarios_runs_as_a_fresh_engine():
    """A kube engine swapped to a batch with capacity cuts, an injected
    taint and chaos timelines runs as a fresh engine on that batch, with
    no new set-up, and as the JAX engine does after its own swap."""
    ec, ep = _tiny_trace(num_pods=16)
    pec, pep = port_case(ec, ep)
    first = [([], []), ([], [(3.0, "node_down", 1)]), ([], [])]
    second = [([("scale_capacity", dict(nodes=np.array([0, 2]), resource="cpu", factor=0.5))],
               []),
              ([("add_taint", dict(nodes=np.array([3]), key="k", value="v"))],
               [(2.0, "node_down", 2), (6.0, "node_up", 2)]),
              ([], [(1.0, "node_down", 0), (1.0, "node_down", 3)])]
    kw = dict(preemption="kube", retry_buffer=16, telemetry="series")
    j, t = _engines(ec, ep, _both(JW.Scenario, JW.Perturbation, J_Event, first),
                    _both(TW.Scenario, TW.Perturbation, NodeEvent, first), **kw)
    t.run()
    j.set_scenarios(_both(JW.Scenario, JW.Perturbation, J_Event, second))
    t.set_scenarios(_both(TW.Scenario, TW.Perturbation, NodeEvent, second))
    got, want = t.run(), j.run()
    fresh = TW.WhatIfEngine(pec, pep, _both(TW.Scenario, TW.Perturbation, NodeEvent, second),
                            FrameworkConfig(plugins=FIT), device="cpu", **ENGINE_KW, **kw).run()
    assert t.setups == 1
    for f in ("placed", "unschedulable", "evictions", "evict_rescheduled", "evict_stranded",
              "evict_latency_mean", "stranded_cpu", "frag_index_cpu", "packing_efficiency",
              "latency_p99"):
        np.testing.assert_array_equal(getattr(got, f), getattr(fresh, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert int(got.evictions.sum()) > 0
    for a, b in zip(got.scenario_telemetry, want.scenario_telemetry):
        assert a.query_view() == b.query_view()
