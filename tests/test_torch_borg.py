"""The port's Borg-shaped traces against the JAX package's: the generator
(``sim/borg.py``), the task-event CSV round trip, the 2019-schema ETL
(``sim/borg_etl.py``, on tiny files written here in that schema), the
``workload.borg`` config section, a cut config4 replay against
``JaxReplayEngine`` and ``greedy_replay``, and the CLI ``run`` of a small
Borg config. Inputs come from seeds (numpy); every comparison is exact."""

import dataclasses
import json

import numpy as np
import pytest
import yaml

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.sim import borg as J_borg
from kubernetes_simulator_tpu.sim import borg_etl as J_etl
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.utils import config as J_config
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import borg as T_borg
from kubernetes_simulator_tpu_torch.sim import borg_etl as T_etl
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine
from kubernetes_simulator_tpu_torch.utils import config as T_config

from torch_port_case import assert_same

#: BorgSpec keyword sets: gangs on (the defaults, larger gangs), off, and a
#: small app vocabulary with many gangs.
SPECS = {
    "gangs": dict(nodes=60, tasks=2000, seed=1),
    "no_gangs": dict(nodes=40, tasks=1500, seed=2, gang_fraction=0.0),
    "max_gang6": dict(nodes=100, tasks=3000, seed=3, max_gang=6),
    "apps12": dict(nodes=30, tasks=800, seed=4, num_apps=12, gang_fraction=0.2),
}


def _same_trace(j, t, where):
    (jec, jep, jmeta), (tec, tep, tmeta) = j, t
    assert_same(jec, tec, f"{where}.ec")
    assert_same(jep, tep, f"{where}.ep")
    assert jmeta == tmeta, where


@pytest.mark.parametrize("name", sorted(SPECS))
def test_make_borg_encoded_equals_reference(name):
    kw = SPECS[name]
    j = J_borg.make_borg_encoded(J_borg.BorgSpec(**kw))
    t = T_borg.make_borg_encoded(T_borg.BorgSpec(**kw))
    _same_trace(j, t, name)
    gid = t[1].group_id
    assert (gid >= 0).any() == (kw.get("gang_fraction", 0.08) > 0)


def test_object_model_trace_equals_reference():
    """make_borg_trace (the object-model variant for small task counts)
    encodes to the reference's arrays."""
    from kubernetes_simulator_tpu.models.encode import encode as j_encode
    from kubernetes_simulator_tpu_torch.models.encode import encode as t_encode

    spec = dict(nodes=30, tasks=300, seed=3, gang_fraction=0.1, max_gang=4)
    jec, jep = j_encode(*J_borg.make_borg_trace(J_borg.BorgSpec(**spec)))
    tec, tep = t_encode(*T_borg.make_borg_trace(T_borg.BorgSpec(**spec)))
    assert_same(jec, tec, "ec")
    assert_same(jep, tep, "ep")
    assert (tep.group_id >= 0).any()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_csv_round_trip_across_packages(tmp_path, writer):
    """A task-event CSV written by either package loads to the same encoded
    trace through both packages' readers, and the port's own round trip
    gives the generator's trace."""
    kw = SPECS["gangs"]
    path = tmp_path / "trace.csv"
    exporter = T_borg.export_trace_csv if writer == "port" else J_borg.export_trace_csv
    spec_cls = T_borg.BorgSpec if writer == "port" else J_borg.BorgSpec
    cols = exporter(spec_cls(**kw), str(path))
    assert len(cols["arrival"]) == kw["tasks"]
    j = J_borg.load_trace_csv(str(path), J_borg.BorgSpec(**kw))
    t = T_borg.load_trace_csv(str(path), T_borg.BorgSpec(**kw))
    _same_trace(j, t, writer)
    # The file keeps the generator's trace up to its formats (memory as %g).
    gen = T_borg.make_borg_encoded(T_borg.BorgSpec(**kw))[1]
    np.testing.assert_array_equal(t[1].group_id, gen.group_id)
    np.testing.assert_array_equal(t[1].priority, gen.priority)
    r = t[0].vocab._r
    np.testing.assert_array_equal(t[1].requests[:, r["cpu"]], gen.requests[:, r["cpu"]])
    mem = np.array([float("%g" % m) for m in gen.requests[:, r["memory"]]], np.float32)
    np.testing.assert_array_equal(t[1].requests[:, r["memory"]], mem)


# ---------------------------------------------------------------------------
# The 2019-schema ETL (the cases of tests/test_borg_etl.py)
# ---------------------------------------------------------------------------

_US = 1_000_000


def _write_trace(tmp_path, n_jobs=6, tasks_per_job=4):
    """Tiny trace in the v3 export schema: jobs 100..; jobs 0/2/4 live in
    alloc set 9000+j (gangs); instance 0 of every job FINISHes; plus a
    duplicate SUBMIT, an EVICT -> re-SUBMIT -> FINISH cycle, a re-SUBMIT
    after KILL, mixed-case type names and a task with no priority or alloc
    fields (the collection_events fallback)."""
    inst = tmp_path / "instance_events.csv"
    coll = tmp_path / "collection_events.csv"
    with open(coll, "w") as f:
        f.write("time,type,collection_id,priority,alloc_collection_id\n")
        for j in range(n_jobs):
            alloc = 9000 + j if j % 2 == 0 else 0
            f.write(f"{600 * _US},SUBMIT,{100 + j},{(j % 5) * 100},{alloc}\n")
    with open(inst, "w") as f:
        f.write("time,type,collection_id,instance_index,priority,alloc_collection_id,"
                "resource_request.cpus,resource_request.memory\n")
        for j in range(n_jobs):
            alloc = 9000 + j if j % 2 == 0 else 0
            for i in range(tasks_per_job):
                f.write(f"{(600 + 10 * j + i) * _US},0,{100 + j},{i},{(j % 5) * 100},{alloc},"
                        "0.05,0.01\n")
            f.write(f"{(700 + 10 * j) * _US},FINISH,{100 + j},0,,,,\n")
        f.write(f"{900 * _US},0,100,1,400,0,0.9,0.9\n")
        f.write(f"{800 * _US},EVICT,101,2,,,,\n")
        f.write(f"{820 * _US},SUBMIT,101,2,100,0,0.05,0.01\n")
        f.write(f"{880 * _US},FINISH,101,2,,,,\n")
        f.write(f"{730 * _US},Kill,102,3,,,,\n")
        f.write(f"{760 * _US},submit,102,3,,,0.05,0.01\n")
        f.write(f"{910 * _US},SUBMIT,104,9,,,0.2,0.1\n")
    return str(inst), str(coll)


def _same_cols(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_etl_roundtrip_shapes_and_mapping(tmp_path):
    """tests/test_borg_etl.py::test_roundtrip_shapes_and_mapping's trace
    (with the tricky event patterns): the port's columns equal the
    reference's DictReader path and its read_cols, and the encoded trace
    of load_borg2019 equals the reference's."""
    inst, coll = _write_trace(tmp_path)
    kw = dict(cpu_scale=8.0, mem_scale=16 * 2**30)
    cols = T_etl.Borg2019Etl(inst, coll, **kw).read_cols()
    ref = J_etl.Borg2019Etl(inst, coll, **kw)
    _same_cols(cols, ref._cols_dictreader())
    _same_cols(cols, ref.read_cols())
    assert len(cols["arrival"]) == 25 and cols["arrival"].min() == 0.0
    assert (cols["group_id"] >= 0).sum() == 13  # job 104's task joins 9004 by fallback
    assert ((cols["tolerates"] == 1) == (cols["priority"] <= 119)).all()
    spec = dict(nodes=20, tasks=25, seed=0)
    _same_trace(J_etl.load_borg2019(inst, J_borg.BorgSpec(**spec), collection_events=coll),
                T_etl.load_borg2019(inst, T_borg.BorgSpec(**spec), collection_events=coll),
                "load_borg2019")


def test_etl_rescheduled_instance_duration_uses_last_submit(tmp_path):
    inst = tmp_path / "inst.csv"
    with open(inst, "w") as f:
        f.write("time,type,collection_id,instance_index,priority,alloc_collection_id,"
                "resource_request.cpus,resource_request.memory\n")
        f.write(f"{600 * _US},0,1,0,100,0,0.1,0.1\n")
        f.write(f"{700 * _US},4,1,0,,,,\n")  # EVICT
        f.write(f"{1600 * _US},0,1,0,100,0,0.1,0.1\n")  # re-SUBMIT
        f.write(f"{1700 * _US},6,1,0,,,,\n")  # FINISH
    cols = T_etl.Borg2019Etl(str(inst)).read_cols()
    _same_cols(cols, J_etl.Borg2019Etl(str(inst))._cols_dictreader())
    assert cols["arrival"][0] == 0.0 and np.isclose(cols["duration"][0], 100.0)


def test_etl_missing_submit_rejected(tmp_path):
    p = tmp_path / "empty.csv"
    p.write_text("time,type,collection_id,instance_index\n")
    with pytest.raises(ValueError, match="no instance SUBMIT"):
        T_etl.Borg2019Etl(str(p)).read_cols()
    with pytest.raises(ValueError, match="no instance SUBMIT"):
        J_etl.Borg2019Etl(str(p))._cols_dictreader()


# ---------------------------------------------------------------------------
# The config section, a cut config4 replay and the CLI
# ---------------------------------------------------------------------------


def _config4(**borg):
    d = yaml.safe_load(open("examples/config4_borg_1m.yaml"))
    d["workload"]["borg"].update(borg)
    return d


@pytest.mark.parametrize("source", ["generated", "trace_path", "instance_events"])
def test_config4_parses_and_builds_as_reference(tmp_path, source):
    """SimConfig.from_dict / build_encoded_case of config4 with its counts
    cut, generated from its seed, read from a task-event CSV or from 2019
    tables: the same section values and the same encoded trace."""
    borg = dict(nodes=50, tasks=1200)
    if source == "trace_path":
        path = tmp_path / "t.csv"
        T_borg.export_trace_csv(T_borg.BorgSpec(nodes=50, tasks=1200), str(path))
        borg["tracePath"] = str(path)
    elif source == "instance_events":
        inst, coll = _write_trace(tmp_path)
        borg.update(instanceEvents=inst, collectionEvents=coll, cpuScale=4.0)
    d = _config4(**borg)
    jc, tc = J_config.SimConfig.from_dict(d), T_config.SimConfig.from_dict(d)
    assert dataclasses.asdict(tc.borg) == dataclasses.asdict(jc.borg)
    assert tc.workload is None and jc.workload is None
    assert (tc.chunk_waves, tc.wave_width, tc.strategy) == (jc.chunk_waves, jc.wave_width,
                                                            jc.strategy)
    assert T_config.workload_seed(tc) == jc.borg.seed == 0
    jec, jep = J_config.build_encoded_case(jc)
    tec, tep = T_config.build_encoded_case(tc)
    assert_same(jec, tec, "ec")
    assert_same(jep, tep, "ep")


@pytest.mark.parametrize("bad, field", [
    (dict(nodes=0), "workload.borg.nodes"),
    (dict(tasks=-1), "workload.borg.tasks"),
    (dict(maxGang=16), "workload.borg.maxGang"),
    (dict(tracePath="/nonexistent/trace.csv"), "workload.borg.tracePath"),
    (dict(cpuScale=0.0), "workload.borg.cpuScale/memScale"),
])
def test_borg_errors_equal_reference_validation(tmp_path, bad, field):
    """The port's checks of a workload.borg section give the reference's
    validate_config messages, and its CLI refuses such a config."""
    from kubernetes_simulator_tpu import cli as J_cli
    from kubernetes_simulator_tpu_torch import cli

    d = _config4(**{"nodes": 50, "tasks": 500, **bad})
    got = T_config.borg_errors(T_config.SimConfig.from_dict(d))
    want = [e for e in J_cli.validate_config(J_config.SimConfig.from_dict(d))
            if e.startswith("workload.borg")]
    assert got == want and got and got[0].startswith(field)
    cfg = tmp_path / "bad.yaml"
    cfg.write_text(yaml.safe_dump(d))
    with pytest.raises(ValueError, match=field.replace(".", r"\.")):
        cli.main(["run", str(cfg), "--device", "cpu"])


def test_cut_config4_replay_equals_jax_and_greedy():
    """config4's generator cut to 10 nodes x 3,000 tasks, chunkWaves 16
    (24 chunks, releases at most boundaries, gangs; contended: 315 pods
    unschedulable): the port on the CPU equals JaxReplayEngine and
    greedy_replay — assignments and placed."""
    kw = dict(nodes=10, tasks=3000, seed=0)
    jec, jep, _ = J_borg.make_borg_encoded(J_borg.BorgSpec(**kw))
    tec, tep, _ = T_borg.make_borg_encoded(T_borg.BorgSpec(**kw))
    eng = TorchReplayEngine(tec, tep, FrameworkConfig(), chunk_waves=16, device="cpu")
    res = eng.replay()
    assert res.route == "chunk" and eng.plan.C == 16 and len(eng.plan.buckets) > 20
    assert sum(b is not None for b in eng.plan.buckets) > 10 and eng.plan.gang_wave.any()
    jres = JaxReplayEngine(jec, jep, J_Config(), chunk_waves=16).replay()
    gres = greedy_replay(jec, jep, J_Config(), wave_width=8, completions_chunk_waves=16)
    for other in (jres, gres):
        np.testing.assert_array_equal(res.assignments, other.assignments)
        assert res.placed == other.placed
    assert 0 < res.unschedulable < 3000


def test_cli_run_small_borg(tmp_path, capsys):
    """tests/test_scale_aux.py::TestBorg::test_cli_run_small_borg through
    the port's CLI on the CPU: one replay row stamped with the Borg seed,
    placing what the JAX CLI places."""
    from kubernetes_simulator_tpu import cli as J_cli
    from kubernetes_simulator_tpu_torch import cli

    cfgp = tmp_path / "b.yaml"
    cfgp.write_text(yaml.safe_dump({
        "strategy": "jax",
        "workload": {"borg": {"nodes": 50, "tasks": 2000, "seed": 3}},
    }))

    def row(main, extra):
        capsys.readouterr()
        assert main(["run", str(cfgp)] + extra) == 0
        lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
        return json.loads(lines[-1])

    got = row(cli.main, ["--device", "cpu"])
    want = row(J_cli.main, [])
    assert got["kind"] == "replay-torch" and want["kind"] == "replay-jax"
    assert got["seed"] == want["seed"] == 3
    for k in ("placed", "unschedulable", "attempts"):
        assert got[k] == want[k], k
