"""Series and timeline telemetry of the port's single replay
(``TorchReplayEngine(telemetry="series"|"timeline")``, CLI ``run``) against
``JaxReplayEngine`` on the CPU, on the plain twins.

The same encoded trace (the JAX package's, carried across as numpy arrays
by tests/torch_port_case.py) goes through both engines. Compared exactly:
assignments, ``reasons``, ``rejection_attempts``, the first-bind latency,
the timeline ``events`` and the Chrome trace; in ``series`` the sample
times and depths exactly and the utilization gauges within the ``used``
tolerance of tests/test_jax_parity.py::assert_parity (atol 1e-3: f32 sums,
exact on these bucketed traces). The plain path (in-scan attribution,
every failure terminal) and the retry path (chunk-fold attribution against
the chunk's start state, retry-pass attempts, episode semantics) are both
walked, at W=1/C=1 and at W=8 with C>1, with engine v2 and v3, on the
chunk route (the plain path's attribution inside K6's attributed mode) and
on the per-slot route (``_run(route="slot")``: K5 after each slot's K2)."""

import json
import logging

import numpy as np
import pytest
import torch
import yaml

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod, Taint
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu.sim.telemetry import TelemetryCollector as J_Collector
from kubernetes_simulator_tpu.sim.telemetry import write_chrome_trace as j_write_trace
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.sim.telemetry import TelemetryCollector
from kubernetes_simulator_tpu_torch.sim.telemetry import write_chrome_trace
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

FIT_ONLY = [{"name": "NodeResourcesFit"}]
USED_ATOL = 1e-3
EXACT_KEYS = ("t", "retry_depth", "pend_depth")


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def both(ec, ep, plugins=None, route="chunk", **kw):
    """(JaxReplayEngine result, port result) of one trace and settings, the
    port's replay on ``route`` ("chunk", the route its mode takes, or
    "slot", forced through ``_run(route=...)``)."""
    j = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), **kw).replay()
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu", **kw)
    if route != "chunk":
        run = eng._run
        eng._run = lambda *a, **k: run(*a, route=route, **k)
    t = eng.replay()
    assert t.route == route
    return j, t


def assert_same_telemetry(j, t):
    np.testing.assert_array_equal(t.assignments, j.assignments)
    assert (t.placed, t.retry_dropped) == (j.placed, j.retry_dropped)
    a, b = j.telemetry, t.telemetry
    assert b.granularity == a.granularity
    assert b.reasons == a.reasons
    assert b.rejection_attempts == a.rejection_attempts
    assert b.latency == a.latency
    assert b.bind_latency == a.bind_latency
    assert b.zero_latency_binds == a.zero_latency_binds
    assert b.events == a.events
    if a.series is None:
        assert b.series is None
        return
    assert list(b.series) == list(a.series)
    for k, v in a.series.items():
        if k in EXACT_KEYS:
            assert b.series[k] == v, k
        else:
            np.testing.assert_allclose(b.series[k], v, rtol=0, atol=USED_ATOL, err_msg=k)
    s = t.summary()["telemetry"]
    for k in ("reasons", "rejection_attempts", "series_samples", "timeline_events"):
        assert s.get(k) == j.summary()["telemetry"].get(k), k
    qa, qb = a.query_view(), b.query_view()
    assert list(qb["series"]) == list(qa["series"])
    assert {k: v for k, v in qb.items() if k != "series"} == {
        k: v for k, v in qa.items() if k != "series"}


def _reject_trace(num_pods=10):
    """tests/test_telemetry.py:124: n0 (cpu=2) fills after two pods; n1 is
    big but tainted NoSchedule. Every later pod fails with a two-plugin
    breakdown: NodeResourcesFit is charged n0, TaintToleration n1."""
    nodes = [
        Node("n0", {"cpu": 2.0}),
        Node("n1", {"cpu": 100.0}, taints=[Taint("dedicated", "infra", "NoSchedule")]),
    ]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i)) for i in range(num_pods)]
    return encode(Cluster(nodes=nodes), pods)


ROUTES = ["chunk", "slot"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("engine", ["v2", "v3"])
@pytest.mark.parametrize("W,C", [(1, 1), (8, 4)])
def test_reject_trace_matches_reference(engine, W, C, route):
    ec, ep = _reject_trace()
    j, t = both(ec, ep, wave_width=W, chunk_waves=C, engine=engine, telemetry="series",
                route=route)
    assert_same_telemetry(j, t)
    if (W, C) == (1, 1):
        assert t.telemetry.reasons == {"NodeResourcesFit": 8, "TaintToleration": 8}
    # Plain-path failures are terminal: attempts == reasons.
    assert t.telemetry.rejection_attempts == t.telemetry.reasons


def test_boundary_retry_coincidence_trace():
    """tests/test_telemetry.py:187 with the timeline: p1 fails at t=1, the
    slot frees at t=1.5 and the boundary at t=2 retries it — one failed
    attempt, the latency multiset {0, 0, 1.0}, a retried bind event."""
    nodes = [Node("n0", {"cpu": 1.0})]
    pods = [
        Pod("p0", requests={"cpu": 1.0}, arrival_time=0.0, duration=1.5),
        Pod("p1", requests={"cpu": 1.0}, arrival_time=1.0),
        Pod("p2", requests={"cpu": 0.0}, arrival_time=2.0),
    ]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    j, t = both(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1, retry_buffer=8,
                telemetry="timeline")
    assert_same_telemetry(j, t)
    tel = t.telemetry
    assert tel.reasons == tel.rejection_attempts == {"NodeResourcesFit": 1}
    assert tel.bind_latency == {1: 1.0} and tel.zero_latency_binds == 2
    assert ("bind", 2.0, 1, 0) in tel.events
    assert {"retry_depth", "pend_depth", "util_cpu", "frag_cpu"} <= set(tel.series)


def _seeded(seed):
    """A contended seeded trace with the full default plugin set, gangs and
    completions: 3 nodes, 240 pods arriving at 60/s, durationMean 1.5."""
    cluster = make_cluster(3, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(240, seed=seed, arrival_rate=60.0, duration_mean=1.5,
                            with_affinity=True, with_spread=True, with_tolerations=True,
                            gang_fraction=0.1, gang_size=3)
    return encode(cluster, pods)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("C", [2, 4])
def test_seeded_plain_path(seed, C, route):
    ec, ep = _seeded(seed)
    j, t = both(ec, ep, wave_width=8, chunk_waves=C, telemetry="timeline", route=route)
    assert_same_telemetry(j, t)
    # Each charged pod's nodes sum to N; gang members the rollback reverted
    # are unschedulable but not charged.
    charged, rest = divmod(sum(t.telemetry.reasons.values()), ec.num_nodes)
    assert rest == 0 and 0 < charged <= t.unschedulable
    assert t.telemetry.events == []  # no chaos on the plain path


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed,C,RB", [(11, 2, 16), (11, 4, 64), (12, 2, 16), (12, 3, 8)])
def test_seeded_retry_path(seed, C, RB, route):
    ec, ep = _seeded(seed)
    j, t = both(ec, ep, wave_width=8, chunk_waves=C, retry_buffer=RB, telemetry="timeline",
                route=route)
    assert_same_telemetry(j, t)
    tel = t.telemetry
    # Retries grow the attempts past the episodes.
    assert sum(tel.rejection_attempts.values()) > sum(tel.reasons.values()) > 0
    assert len(tel.events) == t.placed


@pytest.mark.parametrize("route", ROUTES)
def test_chrome_trace_equals_reference(tmp_path, route):
    ec, ep = _seeded(11)
    j, t = both(ec, ep, wave_width=8, chunk_waves=2, retry_buffer=16, telemetry="timeline",
                route=route)
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    nj = j_write_trace(pj, j, arrival=ep.arrival, duration=ep.duration, requests=ep.requests,
                       rindex=ec.vocab._r)
    pec, pep = port_case(ec, ep)
    nt = write_chrome_trace(pt, t, arrival=pep.arrival, duration=pep.duration,
                            requests=pep.requests, rindex=pec.vocab._r)
    assert nj == nt > 0
    assert json.load(open(pt)) == json.load(open(pj))


def test_tier_preemption_keeps_placements_with_the_reference_note(caplog):
    """Under tier preemption the reference logs that attribution is not
    available; placements equal the summary run's and ``reasons`` is
    empty, with the latency still collected."""
    ec, ep = _reject_trace()
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=1, chunk_waves=1, preemption=True)
    base = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", **kw).replay()
    with caplog.at_level(logging.INFO):
        res = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", telemetry="series",
                                **kw).replay()
    assert "not available with in-scan tier preemption" in caplog.text
    np.testing.assert_array_equal(base.assignments, res.assignments)
    assert res.telemetry.reasons == {} and res.telemetry.series == {}
    assert res.telemetry.latency["count"] == res.placed
    jres = JaxReplayEngine(ec, ep, J_Config(), telemetry="series", **kw).replay()
    assert (jres.telemetry.reasons, jres.telemetry.series) == ({}, {})
    np.testing.assert_array_equal(jres.assignments, res.assignments)


def test_v3_series_logs_the_v2_note(caplog):
    ec, ep = _reject_trace()
    pec, pep = port_case(ec, ep)
    with caplog.at_level(logging.INFO):
        TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", telemetry="series").replay()
    assert "(v2)" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", telemetry="series",
                          engine="v2").replay()
    assert "(v2)" not in caplog.text


@pytest.mark.parametrize("retry_buffer", [0, 16])
def test_summary_runs_no_first_reject_and_equals_off(monkeypatch, retry_buffer):
    """The default granularity enqueues what it enqueued before (no K5
    call, no attributed K6 launch), and series places exactly as summary
    and off."""
    calls = []
    real, real_k6 = K.first_reject, K.chunk_replay
    monkeypatch.setattr(K, "first_reject", lambda *a: (calls.append(1), real(*a)))

    def k6(*a, reject=None, **kw):
        if reject is not None:
            calls.append(1)
        real_k6(*a, reject=reject, **kw)
    monkeypatch.setattr(K, "chunk_replay", k6)
    ec, ep = _seeded(11)
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=8, chunk_waves=2, retry_buffer=retry_buffer, device="cpu")
    runs = {}
    for g in ("off", "summary", "series"):
        calls.clear()
        runs[g] = TorchReplayEngine(pec, pep, FrameworkConfig(), telemetry=g, **kw).replay()
        assert bool(calls) == (g == "series"), g
    assert runs["off"].telemetry is None
    for g in ("summary", "series"):
        np.testing.assert_array_equal(runs[g].assignments, runs["off"].assignments)
        assert runs[g].telemetry.latency == runs["summary"].telemetry.latency


@pytest.mark.parametrize("kw", [dict(retry_buffer=16), dict()])
def test_engine_v2_with_completions_and_the_buffer(kw):
    """engine="v2" against JaxReplayEngine(engine="v2") with completions,
    with and without the retry buffer."""
    ec, ep = _seeded(12)
    j, t = both(ec, ep, wave_width=8, chunk_waves=2, engine="v2", telemetry="series", **kw)
    assert_same_telemetry(j, t)


def test_engine_names_and_tier_need_v3():
    ec, ep = _reject_trace()
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match="'v2' or 'v3'"):
        TorchReplayEngine(pec, pep, device="cpu", engine="v4")
    with pytest.raises(ValueError, match="engine='v3'"):
        TorchReplayEngine(pec, pep, device="cpu", engine="v2", preemption=True)


def test_collector_episode_semantics_equal_reference():
    """Random sequences of attempts through the K5 twin (``ref.first_reject``)
    give the reference collector's counters: each failed attempt charges
    ``rejection_attempts``, a pod's first charges ``reasons``; a placed
    gate and a pod some node admits charge nothing. The latency rides the
    port's collector as the reference's."""
    from kubernetes_simulator_tpu_torch.ops import reference as ref
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import spec_plugin_names

    from kubernetes_simulator_tpu.models.state import init_state
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec

    from torch_port_case import port_state

    ec, ep = _seeded(11)
    pec, pep = port_case(ec, ep)
    spec = StepSpec.from_config(pec, FrameworkConfig(), pep)
    names, P = spec_plugin_names(spec), ep.num_pods
    tb = ref.Tables(
        cluster=ref.cluster_to(pec, "cpu"), pods=ref.pods_to(pep, "cpu"),
        state=port_state(init_state(ec, ep)).planes,
        scratch=ref.new_scratch(1, ec.num_nodes, "cpu"), consts=spec.consts(),
        reject=ref.new_reject(len(names), P, 1, "cpu"),
    )
    ids = torch.arange(P, dtype=torch.int32)
    ch = torch.full((1, P), -1, dtype=torch.int32)
    for p in range(P):  # fill the cluster so that later attempts fail
        ref.filter_score(tb, p)
        ref.normalize_select(tb, p, ch, p)
        ref.apply_placements(tb, ids[p : p + 1], ids[p : p + 1], ch, 1.0)
    rng = np.random.default_rng(5)
    a, b = J_Collector("timeline"), TelemetryCollector("timeline")
    charged = 0
    for _ in range(300):
        p, op = int(rng.integers(0, P)), int(rng.integers(0, 4))
        if op <= 1:
            gate = torch.full((1, 1), 0 if op == 1 else -1, dtype=torch.int32)
            ref.first_reject(tb, ids[p : p + 1], gate)
            counts, feasible = ref.first_reject_counts(ref.filter_masks(tb, p))
            if op == 0 and not bool(feasible[0]):
                a.rejection(p, dict(zip(names, counts[0].tolist())))
                charged += 1
        else:
            for c in (a, b):
                if op == 2:
                    c.bind_latency(p, float(p) / 4)
                else:
                    c.bind_zero(2)
    b.rejection_totals(names, tb.reject.reasons[0], tb.reject.attempts[0])
    ra, rb = a.result(), b.result()
    assert charged > 0 and ra.reasons
    assert (ra.reasons, ra.rejection_attempts, ra.latency) == (
        rb.reasons, rb.rejection_attempts, rb.latency)


def test_whatif_series_matches_the_reference_shape():
    """Off the kube path the reference's batch records the granularity in
    its fleet telemetry and has no per-scenario reasons list."""
    from kubernetes_simulator_tpu.sim.whatif import WhatIfEngine as J_WhatIf
    from kubernetes_simulator_tpu.sim.whatif import uniform_scenarios as j_uniform
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _seeded(11)
    pec, pep = port_case(ec, ep)
    for g in ("series", "timeline"):
        jr = J_WhatIf(ec, ep, j_uniform(ec, 3, seed=2), J_Config(), chunk_waves=4,
                      telemetry=g).run()
        tr = WhatIfEngine(pec, pep, uniform_scenarios(pec, 3, seed=2), FrameworkConfig(),
                          chunk_waves=4, telemetry=g, device="cpu").run()
        np.testing.assert_array_equal(tr.placed, jr.placed)
        assert jr.scenario_telemetry is None and tr.scenario_telemetry is None
        for r in (jr, tr):
            assert r.fleet_telemetry.granularity == g
            assert r.fleet_telemetry.reasons is None and r.fleet_telemetry.series is None


def _cli_config(tmp_path, name, output):
    d = {
        "strategy": "jax",
        "cluster": {"synthetic": {"nodes": 3, "seed": 11, "taintFraction": 0.2}},
        "workload": {"synthetic": {"pods": 240, "seed": 11, "arrivalRate": 60.0,
                                   "durationMean": 1.5, "affinity": True, "spread": True,
                                   "tolerations": True, "gangFraction": 0.1, "gangSize": 3}},
        "chunkWaves": 2,
        "whatIf": {"retryBuffer": 16},
        "telemetry": {"granularity": "series", "timelineOut": str(tmp_path / f"{name}.json")},
        "output": str(tmp_path / output),
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


def test_run_through_both_clis(tmp_path, monkeypatch):
    """``run`` with ``telemetry: series`` and ``timelineOut`` through both
    packages' CLIs: equal telemetry fields but the wall-clock phases, rows
    that pass scripts/check_metrics_schema.py, equal Chrome traces."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "check_metrics_schema", Path(__file__).resolve().parent.parent / "scripts"
        / "check_metrics_schema.py")
    schema = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(schema)
    from kubernetes_simulator_tpu import cli as j_cli
    from kubernetes_simulator_tpu_torch import cli

    monkeypatch.setenv("KSIM_DETERMINISTIC_JSONL", "1")
    assert j_cli.main(["run", _cli_config(tmp_path, "j", "j.jsonl")]) == 0
    assert cli.main(["run", _cli_config(tmp_path, "t", "t.jsonl"), "--device", "cpu"]) == 0
    rows = {}
    for k in ("j", "t"):
        path = str(tmp_path / f"{k}.jsonl")
        assert schema.validate_file(path) == []
        rows[k] = json.loads(open(path).read().splitlines()[-1])
    tj, tt = rows["j"]["telemetry"], rows["t"]["telemetry"]
    assert tt["granularity"] == tj["granularity"] == "timeline"
    for k in ("latency", "reasons", "rejection_attempts", "series_samples",
              "timeline_events"):
        assert tt[k] == tj[k], k
    assert rows["t"]["placed"] == rows["j"]["placed"]
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))


def test_timeline_out_flag_promotes_the_granularity(tmp_path):
    from kubernetes_simulator_tpu_torch import cli

    cfg = _cli_config(tmp_path, "f", "f.jsonl")
    d = yaml.safe_load(open(cfg))
    d["telemetry"] = {"granularity": "summary"}
    open(cfg, "w").write(yaml.safe_dump(d))
    out = tmp_path / "flag.json"
    assert cli.main(["run", cfg, "--device", "cpu", "--timeline-out", str(out)]) == 0
    row = json.loads((tmp_path / "f.jsonl").read_text().splitlines()[-1])
    assert row["telemetry"]["granularity"] == "timeline"
    doc = json.load(open(out))
    assert any(e["name"] == "bind" for e in doc["traceEvents"])


@pytest.mark.parametrize("strategy,ok", [
    ("jax", True), ("torch", True), (None, True),
    pytest.param("cpu", True, id="cpu-NotImplementedError"), ("gpu", KeyError)])
def test_config_reads_strategy(strategy, ok):
    """``strategy:``: jax and torch run the port's engine (as does a config
    without the key); cpu (ported since) the CPU event engine; an unknown
    name raises as the reference's registry does."""
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    d = {"cluster": {"synthetic": {"nodes": 4}}}
    if strategy is not None:
        d["strategy"] = strategy
    if ok is True:
        assert SimConfig.from_dict(d).strategy == (strategy or "torch")
        return
    with pytest.raises(ok, match="CPU event engine.*queue A item 13" if strategy == "cpu"
                       else "unknown strategy"):
        SimConfig.from_dict(d)


def test_config_reads_profile_preemption_and_timeline_out():
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    d = {"strategy": "jax", "profile": {"preemption": False},
         "telemetry": {"granularity": "series", "timelineOut": "t.json"}}
    got, want = SimConfig.from_dict(d), J_SimConfig.from_dict(d)
    assert got.framework.enable_preemption is want.framework.enable_preemption is False
    assert got.telemetry == want.telemetry.granularity == "timeline"
    assert got.timeline_out == want.telemetry.timeline_out == "t.json"
    d["telemetry"]["granularity"] = "off"
    assert SimConfig.from_dict(d).telemetry == J_SimConfig.from_dict(d).telemetry.granularity


def test_reject_tables_are_checked_as_k5_takes_them():
    """K5's binding check (run once per Tables on the card) accepts the
    engine's reject tables and refuses a wrong type or plugin count."""
    from kubernetes_simulator_tpu_torch.ops import reference as ref

    ec, ep = _seeded(11)
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", telemetry="series")
    tb = eng._tables(attribute=True)
    K.check_reject(tb)
    S, P = 1, pep.num_pods
    bad = tb._replace(reject=tb.reject._replace(attributed=torch.zeros((S, P), dtype=torch.bool)))
    with pytest.raises(ValueError, match="attributed"):
        K.check_reject(bad)
    short = tb._replace(reject=ref.new_reject(1, P, S, "cpu"))
    with pytest.raises(ValueError, match="plugins"):
        K.check_reject(short)
