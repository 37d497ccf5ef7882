"""The port's facade (kubernetes_simulator_tpu_torch/api.py), its CLI
``validate`` and its profiling hooks (utils/profiling.py) against the JAX
package's, on the CPU.

- ``Simulator`` places as the JAX facade: its device engine as the
  reference's ``jax`` strategy, ``strategy="cpu"`` as the reference's CPU
  engine, ``what_if`` (a resident engine reused through
  ``set_scenarios``), checkpoints through ``run`` and a fork through
  ``what_if``; ``SimulatorService`` answers as the reference's;
- ``validate`` prints the reference's JSON report and exit code for every
  shipped config the port runs and for tests/test_scale_aux.py's broken
  configs; a fleet config gets the port's refusal;
- a ``torch.profiler`` run with ``KSIM_PROFILE_DIR`` set places as one
  without, and its trace holds the chunk loop's annotations."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from kubernetes_simulator_tpu import api as JA
from kubernetes_simulator_tpu.cli import main as j_main
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch import api as TA
from kubernetes_simulator_tpu_torch.cli import main as t_main
from kubernetes_simulator_tpu_torch.models import core as TC
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster as t_cluster
from kubernetes_simulator_tpu_torch.sim.synthetic import make_workload as t_workload
from kubernetes_simulator_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _cases():
    kw = dict(with_affinity=True, with_spread=True)
    return ((make_cluster(10, seed=4), make_workload(120, seed=4, **kw)[0]),
            (t_cluster(10, seed=4), t_workload(120, seed=4, **kw)[0]))


#: NodeResourcesFit alone for the facade's plumbing (the JAX package's
#: programs then compile in seconds); the engines' plugins are held elsewhere
FIT = [{"name": "NodeResourcesFit"}]


def test_simulator_run_what_if_and_resident_reuse():
    (jc, jp), (tc, tp) = _cases()
    js = JA.Simulator(jc, jp, strategy="jax", plugins=FIT, chunk_waves=4)
    ts = TA.Simulator(tc, tp, device="cpu", plugins=FIT, chunk_waves=4)
    assert ts.strategy == "torch" and TA.Simulator.strategies() == ["cpu", "torch"]
    np.testing.assert_array_equal(ts.run().assignments, js.run().assignments)
    np.testing.assert_array_equal(TA.Simulator(tc, tp, strategy="cpu").run().assignments,
                                  JA.Simulator(jc, jp).run().assignments)  # all plugins
    for seed in (1, 2):
        a = js.what_if(num_scenarios=4, seed=seed, collect_assignments=True)
        b = ts.what_if(num_scenarios=4, seed=seed, collect_assignments=True)
        np.testing.assert_array_equal(b.assignments, a.assignments)
        np.testing.assert_array_equal(b.placed, a.placed)
    assert ts._whatif_cache[1].setups == 1  # the second batch swapped in place


def test_simulator_checkpoint_resume_and_fork(tmp_path):
    """Checkpoint, resume and fork through the facade: the resumed run and
    the fork's scenario 0 equal the uninterrupted run, and the JAX facade
    forks the port's file alike."""
    (jc, jp), (tc, tp) = _cases()
    ck = str(tmp_path / "ck.npz")
    ts = TA.Simulator(tc, tp, device="cpu", plugins=FIT, chunk_waves=2)
    full = ts.run(checkpoint_path=ck, checkpoint_every=3)
    np.testing.assert_array_equal(ts.run(checkpoint_path=ck, resume=True).assignments,
                                  full.assignments)
    scen = lambda M: [M.Scenario(), M.Scenario([M.Perturbation("node_down",
                                                               nodes=np.arange(3))])]
    from kubernetes_simulator_tpu.sim import whatif as J
    from kubernetes_simulator_tpu_torch.sim import whatif as T

    b = ts.what_if(scenarios=scen(T), collect_assignments=True, fork_checkpoint=ck,
                   chunk_waves=2)
    a = JA.Simulator(jc, jp, strategy="jax", plugins=FIT).what_if(
        scenarios=scen(J), collect_assignments=True, fork_checkpoint=ck, chunk_waves=2)
    np.testing.assert_array_equal(b.assignments[0], full.assignments)
    np.testing.assert_array_equal(b.assignments, a.assignments)


def test_simulator_chaos_timeline_and_timeline_out(tmp_path):
    """``chaos_timeline`` draws the reference's events from the same seed,
    and ``run(timeline_out=)`` collects at timeline and writes the Chrome
    trace (its node events among them) for a run with those events."""
    (jc, jp), (tc, tp) = _cases()
    js = JA.Simulator(jc, jp)
    ts = TA.Simulator(tc, tp, device="cpu", plugins=FIT, chunk_waves=2, retry_buffer=16)
    key = lambda evs: [(e.time, e.kind, e.node, e.scale) for e in evs]
    evs = ts.chaos_timeline(seed=3, mtbf=0.5, mttr=0.2, node_fraction=0.5)
    assert evs and key(evs) == key(js.chaos_timeline(seed=3, mtbf=0.5, mttr=0.2,
                                                     node_fraction=0.5))
    res = ts.run(timeline_out=str(tmp_path / "t.json"), node_events=evs)
    assert res.telemetry.granularity == "timeline"
    names = {e.get("name", "") for e in json.load(open(tmp_path / "t.json"))["traceEvents"]}
    assert any("down" in n for n in names)


def test_simulator_service_equals_reference():
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(4)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=30.0)
            for i in range(12)]
    tnodes = [TC.Node(f"n{i}", {"cpu": 8.0}) for i in range(4)]
    tpods = [TC.Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=30.0)
             for i in range(12)]
    kw = dict(plugins=[{"name": "NodeResourcesFit"}], max_batch=2, batch_deadline_s=60.0,
              retry_buffer=64, wave_width=1, chunk_waves=1)
    wire = [{"op": "defrag", "tenant": "a", "id": "q1", "nodes": [3], "drainAt": 4.0,
             "recoverAt": 12.0},
            {"op": "defrag", "tenant": "b", "id": "q1", "nodes": [0, 1], "drainAt": 2.0}]
    timing = ("latency_s", "queue_wait_s", "ts")
    scrub = lambda rows: [{k: v for k, v in r.items() if k not in timing} for r in rows]
    with JA.SimulatorService(Cluster(nodes=nodes), pods, **kw) as j, \
            TA.SimulatorService(TC.Cluster(nodes=tnodes), tpods, device="cpu", **kw) as t:
        for svc in (j, t):
            svc.apply_bind("web", 0, {"cpu": 3.0})
            for q in wire:
                svc.submit(dict(q))
        assert scrub(t.poll("a") + t.poll("b")) == scrub(j.poll("a") + j.poll("b"))
        assert t.stats() == j.stats()


#: The shipped configs the port runs (the fleet's 14, 16, 17 and 19 are
#: refused: ROADMAP queue A item 11).
RUNNABLE = sorted(p for p in glob.glob(os.path.join(ROOT, "examples", "config*.yaml"))
                  if not any(f"config{n}_" in p for n in (14, 16, 17, 19)))

#: tests/test_scale_aux.py's broken configs (TestValidate, :185-265)
BROKEN = {
    "unknown_plugin_bad_gang": {
        "strategy": "jax", "waveWidth": 4,
        "workload": {"borg": {"nodes": 10, "tasks": 100, "maxGang": 8}},
        "profile": {"plugins": [{"name": "NoSuchPlugin"}]}},
    "missing_trace_file": {
        "workload": {"borg": {"nodes": 10, "tasks": 10, "instanceEvents": "/no/such/file.csv"}}},
    "retry_buffer_completions_off": {
        "strategy": "jax", "whatIf": {"scenarios": 4, "retryBuffer": 64, "completions": False}},
}


def _validate(main, path, capsys):
    rc = main(["validate", path])
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("name", [os.path.basename(p) for p in RUNNABLE] + sorted(BROKEN))
def test_validate_matches_reference(name, tmp_path, capsys, monkeypatch):
    """The same JSON report and exit code. One documented difference: a
    config without ``strategy:`` runs the port's device engine, whose name
    (``torch``) the report carries where the reference's says ``cpu``."""
    monkeypatch.chdir(ROOT)
    path = os.path.join(ROOT, "examples", name)
    if name in BROKEN:
        path = str(tmp_path / "cfg.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump(BROKEN[name]))
    jrc, jrep = _validate(j_main, path, capsys)
    trc, trep = _validate(t_main, path, capsys)
    assert trc == jrc
    if name == "missing_trace_file":
        assert (jrep.pop("strategy"), trep.pop("strategy")) == ("cpu", "torch")
    assert trep == jrep
    assert (trc == 0) == (name in [os.path.basename(p) for p in RUNNABLE])


def test_validate_reports_the_fleet_refusal(capsys):
    rc, rep = _validate(t_main, os.path.join(ROOT, "examples", "config17_workqueue.yaml"),
                        capsys)
    assert rc == 1 and len(rep["errors"]) == 1 and "queue A item 11" in rep["errors"][0]


def test_profiling_annotations_and_unchanged_results(tmp_path, monkeypatch):
    """A CLI run with ``--profile-dir`` (which arms ``KSIM_PROFILE_DIR``)
    writes a Chrome trace holding ``chunk:0``, ``dispatch`` and
    ``device_wait``, and its row's placements equal a run without it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("KSIM_PROFILE_DIR", raising=False)
    (tmp_path / "c.yaml").write_text(
        "cluster: {synthetic: {nodes: 6, seed: 1}}\n"
        "workload: {synthetic: {pods: 40, seed: 1, spread: true}}\n"
        "chunkWaves: 2\n")
    rows = {}
    try:
        for tag, extra in (("plain", []),
                           ("profiled", ["--profile-dir", str(tmp_path / "prof")])):
            doc = yaml.safe_load((tmp_path / "c.yaml").read_text())
            doc["output"] = str(tmp_path / f"{tag}.jsonl")
            (tmp_path / f"{tag}.yaml").write_text(yaml.safe_dump(doc))
            assert t_main(["run", f"{tag}.yaml", "--device", "cpu", *extra]) == 0
            rows[tag] = json.loads((tmp_path / f"{tag}.jsonl").read_text().splitlines()[-1])
        assert os.environ.get("KSIM_PROFILE_DIR") == str(tmp_path / "prof")
    finally:
        os.environ.pop("KSIM_PROFILE_DIR", None)
    assert rows["plain"]["placed"] == rows["profiled"]["placed"] > 0
    traces = glob.glob(str(tmp_path / "prof" / "ksim_trace.*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert {"chunk:0", "dispatch", "device_wait"} <= names
    assert profiling.live_buffer_stats() == {}
    out, secs = profiling.timed(lambda x: x + 1, 1)
    assert out == 2 and secs >= 0.0
