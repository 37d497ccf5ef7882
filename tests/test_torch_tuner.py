"""The port's policy tuner (kubernetes_simulator_tpu_torch.sim.tuner, the
``tune`` CLI) against the JAX package's, on the CPU at small sizes.

The search surface, the objective, the population fit and the tunable
parameters are compared as values; ``PolicyTuner`` on
tests/test_tuner.py's fragmentation case must give the JAX tuner's winner,
objectives and trajectory rows exactly (the same numpy draws, the same
placements); the CLI trajectory must be byte-identical across two runs and
to the JAX CLI's for the same config file. The CPU oracle's envelope is
held to 1e-6, the bound tests/test_tuner.py holds the JAX tuner to."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.cli import main as j_cli
from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.parallel.mesh import fit_population as j_fit_population
from kubernetes_simulator_tpu.plugins.builtin import tunable_parameters as j_tunable
from kubernetes_simulator_tpu.sim import tuner as JT
from kubernetes_simulator_tpu_torch.cli import main as t_cli
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.plugins.builtin import tunable_parameters as t_tunable
from kubernetes_simulator_tpu_torch.sim import tuner as TT

from torch_port_case import port_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)

from check_metrics_schema import validate_file  # noqa: E402

ENVELOPE = 1e-6


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


_CONFIGS = [
    None,
    dict(weights={"NodeAffinity": 0.0, "TaintToleration": 5.0}),
    dict(plugins=[{"name": "NodeResourcesFit", "args": {"strategy": "MostAllocated"}},
                  {"name": "TaintToleration"}]),
    dict(plugins=[{"name": "NodeResourcesFit",
                   "args": {"strategy": "RequestedToCapacityRatio"}}]),
]


@pytest.mark.parametrize("kw", _CONFIGS, ids=["default", "weights", "two-plugins", "ratio"])
def test_search_surface_equals_reference(kw):
    jcfg = J_Config(**kw) if kw is not None else None
    tcfg = FrameworkConfig(**kw) if kw is not None else None
    assert t_tunable(tcfg) == j_tunable(jcfg)
    for bounds, strat in ((None, True), ((0.5, 4.0), False)):
        js = JT.SearchSpace.from_config(jcfg, weight_bounds=bounds, tune_strategy=strat)
        ts = TT.SearchSpace.from_config(tcfg, weight_bounds=bounds, tune_strategy=strat)
        for f in ("lo", "hi", "defaults", "weight_mask"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
        assert ts.tune_strategy == js.tune_strategy
        vecs = np.random.default_rng(3).normal(3.0, 4.0, size=(7, 6)).astype(np.float32)
        np.testing.assert_array_equal(ts.clip(vecs), js.clip(vecs))
        assert [ts.describe(v) for v in vecs] == [js.describe(v) for v in vecs]


@pytest.mark.parametrize("weights,constraints", [
    (None, None),
    ({"placementRate": 1.0, "unschedulable": -0.001}, None),
    ({"utilizationCpu": 1.0}, [{"metric": "latencyP99", "max": 2.0, "penalty": 10.0},
                               {"metric": "packingEfficiency", "min": 0.9}]),
])
def test_objective_equals_reference(weights, constraints):
    from types import SimpleNamespace

    jw, jc, jfn = JT.make_objective(weights, constraints)
    tw, tc, tfn = TT.make_objective(weights, constraints)
    assert (tw, tc) == (jw, jc)
    assert TT.normalize_constraints(constraints) == JT.normalize_constraints(constraints)
    res = SimpleNamespace(
        placed=np.array([10, 7, 0]), unschedulable=np.array([0, 3, 0]),
        utilization_cpu=np.array([0.5, 0.25, 0.0]), latency_p99=np.array([1.0, 4.0, np.nan]),
        packing_efficiency=np.array([1.0, 0.4, 0.95]),
    )
    np.testing.assert_array_equal(tfn(res), jfn(res))


@pytest.mark.parametrize("bad", [{"nope": 1.0}, {}])
def test_objective_validation_equals_reference(bad):
    with pytest.raises(ValueError) as je:
        JT.make_objective(bad)
    with pytest.raises(ValueError) as te:
        TT.make_objective(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("pop,per", [(5, 3), (2, 1), (16, 4)])
def test_fit_population_equals_reference(pop, per):
    assert TT.fit_population(pop, per, None) == j_fit_population(pop, per, None)


def _fragmentation_case():
    """tests/test_tuner.py's case: 4 identical nodes × 4 cpu; 8 one-cpu
    pods arrive before two 4-cpu pods. LeastAllocated spreads the small
    pods (2 unschedulable), MostAllocated packs them (all placed)."""
    nodes = [Node(f"n{i}", capacity={"cpu": 4.0, "memory": 16.0}) for i in range(4)]
    pods = [Pod(f"small-{i}", requests={"cpu": 1.0, "memory": 1.0}, arrival_time=float(i))
            for i in range(8)]
    pods += [Pod(f"large-{i}", requests={"cpu": 4.0, "memory": 4.0},
                 arrival_time=float(8 + i)) for i in range(2)]
    return encode(Cluster(nodes=nodes), pods)


@pytest.mark.parametrize("algo,kw", [
    ("cem", dict(population=8, rounds=4, seed=0, train_scenarios=2, heldout_scenarios=2)),
    ("random", dict(population=8, rounds=3, seed=2, train_scenarios=2, heldout_scenarios=1)),
])
def test_tuner_equals_reference_on_fragmentation(algo, kw):
    ec, ep = _fragmentation_case()
    common = dict(algo=algo, scenario_seed=1, p_node_down=0.0, p_capacity=0.25, p_taint=0.0,
                  chunk_waves=4, **kw)
    jres = JT.PolicyTuner(ec, ep, J_Config(), **common).run()
    pec, pep = port_case(ec, ep)
    tres = TT.PolicyTuner(pec, pep, FrameworkConfig(), device="cpu", **common).run()
    assert tres.best_policy == jres.best_policy
    assert tres.best_policy["fitStrategy"] == "MostAllocated"
    np.testing.assert_array_equal(tres.best_vector, jres.best_vector)
    for f in ("train_objective", "heldout_objective", "default_heldout_objective",
              "cpu_objective", "cpu_envelope", "evaluations", "population"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.trajectory == jres.trajectory
    assert tres.improved()
    assert tres.cpu_envelope is not None and tres.cpu_envelope <= ENVELOPE
    assert tres.compile_count == 1  # one set-up across the whole search
    assert set(tres.phase_s) == {"setup", "search", "heldout", "oracle"}


def _write_config(path, out, nodes=8, pods=40, extra=""):
    path.write_text(
        "strategy: jax\n"
        f"cluster:\n  synthetic: {{nodes: {nodes}, seed: 0, taintFraction: 0.1}}\n"
        f"workload:\n  synthetic: {{pods: {pods}, seed: 1, affinity: true, spread: true, "
        "tolerations: true}\n"
        "chunkWaves: 8\n"
        "tune:\n"
        "  algo: cem\n  population: 4\n  rounds: 2\n  seed: 3\n"
        "  objective: {placementRate: 1.0, unschedulable: -0.001}\n"
        "  scenarios: {train: 2, heldout: 1, seed: 0}\n"
        f"{extra}"
        f"  output: {out}\n"
    )


def test_cli_trajectory_deterministic_and_equal_to_reference(tmp_path):
    """Two port runs of one config file give the same bytes, the JAX CLI's
    bytes on the same file, and schema-v3 rows with no wall clock."""
    cfg = tmp_path / "tune.yaml"
    out = tmp_path / "traj.jsonl"
    _write_config(cfg, out)
    assert t_cli(["tune", str(cfg), "--device", "cpu"]) == 0
    first = out.read_bytes()
    out.unlink()  # the writer appends
    assert t_cli(["tune", str(cfg), "--device", "cpu"]) == 0
    assert out.read_bytes() == first
    out.unlink()
    assert j_cli(["tune", str(cfg)]) == 0
    assert out.read_bytes() == first
    assert validate_file(str(out)) == []
    rows = [json.loads(line) for line in first.decode().splitlines()]
    assert all(r["schema"] == 3 and r["run_type"] == "tune" and "ts" not in r for r in rows)
    assert {r["kind"] for r in rows} == {"tune-candidate", "tune-round", "tune-result"}
    assert rows[-1]["cpu_envelope"] is not None and rows[-1]["cpu_envelope"] <= ENVELOPE


@pytest.mark.parametrize("extra,match", [
    ("  evaluator: cpu\n", "cpu"),
    ("  mesh: true\n", "mesh"),
])
def test_cli_refuses_host_evaluator_and_mesh(tmp_path, extra, match):
    """``evaluator: cpu`` (ported since: the host evaluator on the CPU event
    engine) writes the JAX CLI's bytes, with no card work; ``tune.mesh``
    (ported since) runs the sweep over a one-device mesh on ``--device cpu``
    and writes the unmeshed run's rows (the config's hash apart)."""
    cfg = tmp_path / "tune.yaml"
    out = tmp_path / "o.jsonl"
    _write_config(cfg, out, extra=extra)
    if match == "mesh":
        def rows():
            got = [json.loads(line) for line in out.read_text().splitlines()]
            out.unlink()
            return [{k: v for k, v in r.items() if k != "config_hash"} for r in got]

        assert t_cli(["tune", str(cfg), "--device", "cpu"]) == 0
        meshed = rows()
        _write_config(cfg, out)
        assert t_cli(["tune", str(cfg), "--device", "cpu"]) == 0
        assert rows() == meshed
        return
    # The default device is the card's: the host evaluator never touches it.
    assert t_cli(["tune", str(cfg)]) == 0
    got = out.read_bytes()
    out.unlink()
    assert j_cli(["tune", str(cfg)]) == 0
    assert out.read_bytes() == got
    rows = [json.loads(line) for line in got.decode().splitlines()]
    assert rows[-1]["evaluator"] == match and rows[-1]["cpu_objective"] is None


@pytest.mark.parametrize("kw,exc,match", [
    # Ported since (the host evaluator): auto with a host term, and cpu,
    # resolve to the CPU event engine, as the reference's tuner does.
    pytest.param(dict(objective={"utilizationCpu": 1.0},
                      constraints=[{"metric": "latencyP99", "max": 1.0}]), "cpu", "auto",
                 id="kw0-NotImplementedError-queue A item 13"),
    pytest.param(dict(evaluator="cpu"), "cpu", "cpu",
                 id="kw1-NotImplementedError-queue A item 13"),
    (dict(mesh=["cpu"] * 3), None, "fit_population"),
    (dict(objective={"latencyP99": -1.0}, evaluator="device"), ValueError, "evaluator='cpu'"),
    (dict(evaluator="gpu"), ValueError, "evaluator must be"),
])
def test_tuner_refusals(kw, exc, match):
    ec, ep = _fragmentation_case()
    pec, pep = port_case(ec, ep)
    if exc is None:
        # A mesh (ported since): the population is padded until the flat
        # (population x 4 train scenarios) axis divides over 3 devices.
        tuner = TT.PolicyTuner(pec, pep, FrameworkConfig(), population=2, rounds=1,
                               device="cpu", **kw)
        assert (tuner.population_requested, tuner.population) == (2, 3)
        return
    if exc == "cpu":
        tuner = TT.PolicyTuner(pec, pep, FrameworkConfig(), population=2, rounds=1,
                               device="cpu", **kw)
        want = JT.PolicyTuner(ec, ep, J_Config(), population=2, rounds=1, **kw)
        assert tuner.evaluator == want.evaluator == "cpu"
        return
    with pytest.raises(exc, match=match):
        TT.PolicyTuner(pec, pep, FrameworkConfig(), population=2, rounds=1, device="cpu",
                       **kw)


def test_cli_validates_tune_section(tmp_path):
    """The reference's validate errors return 2, as its CLI does."""
    for extra in ("  evaluator: device\n  constraints: [{metric: latencyP99, max: 1.0}]\n",
                  "  constraints: [{metric: latencyP99}]\n", "  weightBounds: [3.0, 1.0]\n"):
        cfg = tmp_path / "bad.yaml"
        _write_config(cfg, tmp_path / "o.jsonl", extra=extra)
        assert t_cli(["tune", str(cfg), "--device", "cpu"]) == 2


def _shipped_config11(tmp_path, cut=None):
    """examples/config11_tune.yaml, as shipped (``cut`` None) or with its
    cluster, workload and population cut: (the config path, the
    trajectory it writes when run from ``tmp_path``)."""
    src = os.path.join(ROOT, "examples", "config11_tune.yaml")
    if cut is None:
        return src, tmp_path / "tune_trajectory.jsonl"
    text = open(src).read()
    for old, new in cut:
        assert old in text, old
        text = text.replace(old, new)
    dst = tmp_path / "config11_cut.yaml"
    dst.write_text(text)
    return str(dst), tmp_path / "tune_trajectory.jsonl"


#: config11 with 100 nodes, 1,000 pods, population 8 and 2 rounds;
#: everything else as shipped.
CONFIG11_CUT = (("nodes: 500", "nodes: 100"), ("pods: 5000", "pods: 1000"),
                ("population: 16", "population: 8"), ("rounds: 6", "rounds: 2"))


def _run_both_in(tmp_path, cfg, out, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert t_cli(["tune", cfg, "--device", "cpu"]) == 0
    port = out.read_bytes()
    out.unlink()
    assert j_cli(["tune", cfg]) == 0
    return port, out.read_bytes()


def test_config11_cut_equals_reference(tmp_path, monkeypatch):
    cfg, out = _shipped_config11(tmp_path, CONFIG11_CUT)
    port, jax_bytes = _run_both_in(tmp_path, cfg, out, monkeypatch)
    assert port == jax_bytes
    final = json.loads(port.decode().splitlines()[-1])
    assert final["cpu_envelope"] <= ENVELOPE and final["population"] == 8


@pytest.mark.slow
def test_config11_as_shipped_pin(tmp_path, monkeypatch):
    """The sha256 chip_smoke.py holds the card's config11 trajectory to
    (TUNE_PINS), recomputed by the JAX CLI on config11 as shipped (≈3 min
    on a CPU host, so ``slow``; the port's own CPU twins take ≈7 min a
    round there, so the port is held to the JAX bytes on the cut above and
    to this pin on the card)."""
    import hashlib

    import chip_smoke

    cfg, out = _shipped_config11(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert j_cli(["tune", cfg]) == 0
    data = out.read_bytes()
    pin = chip_smoke.TUNE_PINS["config11"]
    assert hashlib.sha256(data).hexdigest() == pin["sha256"]
    assert len(data.decode().splitlines()) == pin["rows"]
