"""Per-scenario policy rows (row B1w) in the port's what-if engine against
the JAX package's ``WhatIfEngine(policies=...)`` and against
``greedy_replay`` with each row materialized as an ordinary config, on the
CPU at small sizes (mirroring tests/test_tuner.py:51-170).

Inputs are made from seeds by the JAX package's generators and carried
into the port as numpy arrays (tests/torch_port_case.py). Tolerance: none
— assignments and placed counts are integers; the totals that pick them
are f32 sums of f32 products in one order in all three."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Taint
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops.policy import (
    IDX_FIT_LEAST,
    POLICY_COLS,
    POLICY_WEIGHT_COLS,
)
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.tuner import SearchSpace

from torch_port_case import port_case

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

K = len(POLICY_COLS)


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def port_scenarios(scen):
    return [
        T.Scenario([T.Perturbation(**dataclasses.asdict(pt)) for pt in sc.perturbations])
        for sc in scen
    ]


def objects(seed=2, n=6, p=220, **wl):
    cluster = make_cluster(n, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(p, seed=seed, with_affinity=True, with_spread=True,
                            with_tolerations=True, **wl)
    return cluster, pods


def case(seed=2, n=6, p=220, **wl):
    return encode(*objects(seed, n, p, **wl))


def default_row(plugins=None):
    return SearchSpace.from_config(FrameworkConfig(plugins=plugins)).defaults


def row_config(row, plugins=None):
    """A policy row as the reference's config: the exact f32 weights and,
    under a static Least/MostAllocated, the selector's strategy."""
    base = J_Config(plugins=plugins)
    weights = {name: float(row[i]) for i, name in enumerate(POLICY_WEIGHT_COLS)}
    strat = None
    for e in plugins or [{"name": "NodeResourcesFit"}]:
        if e["name"] == "NodeResourcesFit":
            s = e.get("args", {}).get("strategy", "LeastAllocated")
            if s in ("LeastAllocated", "MostAllocated"):
                strat = "LeastAllocated" if row[IDX_FIT_LEAST] > 0.5 else "MostAllocated"
    return base.with_policy(weights, fit_strategy=strat)


def run_three(ec, ep, scen, pol, plugins=None, greedy_scen=None, **kw):
    """(port result, JAX result, greedy results per scenario, port engine)
    of one policy batch; greedy replays each scenario's perturbed host
    cluster (or ``greedy_scen``'s explicitly relabelled clusters) with its
    row as a config."""
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, port_scenarios(scen), FrameworkConfig(plugins=plugins),
                         policies=pol, device="cpu", collect_assignments=True, **kw)
    res = eng.run()
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(plugins=plugins), policies=pol,
                          collect_assignments=True, **kw).run()
    chunk = eng.chunk_waves if eng.completions_on else None
    if greedy_scen is None:
        clusters = J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec)
        greedy = [greedy_replay(ec_s, ep, row_config(pol[s], plugins),
                                completions_chunk_waves=chunk)
                  for s, ec_s in enumerate(clusters)]
    else:
        greedy = [greedy_replay(*greedy_scen(s), row_config(pol[s], plugins),
                                completions_chunk_waves=chunk) for s in range(len(scen))]
    return res, jres, greedy, eng


def assert_all_equal(res, jres, greedy):
    bad = np.argwhere(res.assignments != jres.assignments)
    assert bad.size == 0, f"vs the JAX what-if: first (scenario, pod) {bad[:5].tolist()}"
    np.testing.assert_array_equal(res.placed, jres.placed)
    for s, g in enumerate(greedy):
        bad = np.nonzero(res.assignments[s] != g.assignments)[0]
        assert bad.size == 0, f"scenario {s} vs greedy_replay: first pods {bad[:5].tolist()}"
        assert int(res.placed[s]) == g.placed


def tile(row, S):
    return np.repeat(np.asarray(row, np.float32)[None], S, axis=0)


# -- the cases of tests/test_tuner.py --------------------------------------------


def test_default_row_equals_static():
    """A row equal to the config's own weights reproduces the static run
    bit for bit (the normalize extrema never depend on the weights)."""
    ec, ep = case()
    pec, pep = port_case(ec, ep)
    static = T.WhatIfEngine(pec, pep, [T.Scenario()] * 3, FrameworkConfig(), device="cpu",
                            collect_assignments=True).run()
    res, jres, greedy, _ = run_three(ec, ep, [J.Scenario()] * 3, tile(default_row(), 3))
    np.testing.assert_array_equal(res.assignments, static.assignments)
    assert_all_equal(res, jres, greedy)
    assert int(res.unschedulable[0]) > 0  # contended: the scores decide


def test_nondefault_weights_most_allocated_equal_static_config():
    ec, ep = case(seed=3)
    weights = {"NodeResourcesFit": 2.5, "TaintToleration": 0.5, "NodeAffinity": 4.0,
               "InterPodAffinity": 1.5, "PodTopologySpread": 3.0}
    row = np.array([weights[n] for n in POLICY_WEIGHT_COLS] + [0.0], np.float32)
    pec, pep = port_case(ec, ep)
    static_cfg = FrameworkConfig().with_policy(weights, fit_strategy="MostAllocated")
    static = T.WhatIfEngine(pec, pep, [T.Scenario()] * 2, static_cfg, device="cpu",
                            collect_assignments=True).run()
    res, jres, greedy, _ = run_three(ec, ep, [J.Scenario()] * 2, tile(row, 2))
    np.testing.assert_array_equal(res.assignments, static.assignments)
    assert_all_equal(res, jres, greedy)


def test_per_scenario_rows_differ_as_they_should():
    """Distinct rows in one batch, non-integer weights among them, each
    equal to its own anchor; Least and Most rows place differently."""
    ec, ep = case(seed=1)
    rng = np.random.default_rng(7)
    pol = rng.uniform(0.0, 10.0, size=(4, K)).astype(np.float32)
    pol[:2] = tile(default_row(), 2)
    pol[1, IDX_FIT_LEAST] = 0.0
    pol[2:, IDX_FIT_LEAST] = [1.0, 0.0]
    scen = J.uniform_scenarios(ec, 4, seed=1, p_node_down=0.3, p_taint=0.3)
    res, jres, greedy, _ = run_three(ec, ep, scen, pol)
    assert_all_equal(res, jres, greedy)
    assert not np.array_equal(res.assignments[0], res.assignments[1])
    assert len({a.tobytes() for a in res.assignments}) >= 3


def test_zero_weight_adds_an_exact_zero():
    """A zero weight in traced mode keeps the row in the total (0·row);
    greedy skips the plugin: both must place alike."""
    ec, ep = case(seed=4)
    pol = tile(default_row(), 3)
    pol[0, 1] = 0.0  # TaintToleration
    pol[1, 4] = 0.0  # PodTopologySpread
    pol[2, :3] = [0.0, 0.0, 1.25]
    res, jres, greedy, _ = run_three(ec, ep, [J.Scenario()] * 3, pol)
    assert_all_equal(res, jres, greedy)


RATIO = [{"name": "NodeResourcesFit", "args": {"strategy": "RequestedToCapacityRatio"}},
         {"name": "TaintToleration"}, {"name": "NodeAffinity"},
         {"name": "InterPodAffinity"}, {"name": "PodTopologySpread"}]


def test_requested_to_capacity_ratio_ignores_the_selector():
    ec, ep = case(seed=5)
    row = np.array([1.5, 3.0, 2.0, 2.0, 2.0, 1.0], np.float32)
    pol = np.stack([row, row])
    pol[1, IDX_FIT_LEAST] = 0.0
    res, jres, greedy, _ = run_three(ec, ep, [J.Scenario()] * 2, pol, plugins=RATIO)
    np.testing.assert_array_equal(res.assignments[0], res.assignments[1])
    assert_all_equal(res, jres, greedy)


def test_completions_on():
    ec, ep = case(seed=6, n=8, p=260, duration_mean=1.5, arrival_rate=40.0)
    pol = tile(default_row(), 3)
    pol[1] = [3.25, 0.5, 1.0, 0.75, 6.5, 0.0]
    pol[2] = [0.1, 7.0, 2.5, 0.0, 1.0, 1.0]
    scen = J.uniform_scenarios(ec, 3, seed=6)
    res, jres, greedy, eng = run_three(ec, ep, scen, pol, chunk_waves=4)
    assert res.completions_on and jres.completions_on and eng.chunk_waves == 4
    assert_all_equal(res, jres, greedy)


def test_set_label_batch_reads_the_rows():
    """The label-row path (row B11) under policy rows: relabelled
    scenarios, each held against the JAX what-if and greedy_replay on its
    explicitly relabelled, re-encoded cluster."""
    cluster, pods = objects(seed=5, n=18, p=90)
    ec, ep = encode(cluster, pods)
    zone = "topology.kubernetes.io/zone"
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("set_label", nodes=np.array([0, 4]), key=zone,
                                   value="zone-1")]),
        J.Scenario([J.Perturbation("set_label", nodes=np.array([1, 9]), key=zone,
                                   value="zz-fresh")]),
    ]
    pol = tile(default_row(), 3)
    pol[1] = [2.75, 1.0, 0.0, 3.5, 5.0, 0.0]
    pol[2] = [0.5, 4.0, 1.0, 1.0, 9.0, 1.0]

    def relabelled(s):
        return encode(chip_smoke.explicit_cluster(cluster, scen[s], Taint), pods)

    res, jres, greedy, eng = run_three(ec, ep, scen, pol, greedy_scen=relabelled,
                                       chunk_waves=4)
    assert res.engine == jres.engine == "v3" and eng.sset.labels_dirty
    assert_all_equal(res, jres, greedy)


def test_set_policies_swaps_values_with_one_setup():
    ec, ep = case(seed=3, n=10, p=60)
    pec, pep = port_case(ec, ep)
    S = 4
    eng = T.WhatIfEngine(pec, pep, [T.Scenario()] * S, FrameworkConfig(), device="cpu",
                         collect_assignments=True, policies=tile(default_row(), S))
    wrow = eng._wrow
    eng.run()
    rng = np.random.default_rng(0)
    for _ in range(3):
        vals = rng.uniform(0.0, 10.0, size=(S, K)).astype(np.float32)
        vals[:, IDX_FIT_LEAST] = rng.random(S) < 0.5
        eng.set_policies(vals)
        assert eng._wrow is wrow and torch.equal(wrow, torch.from_numpy(vals))
        res = eng.run()
        fresh = T.WhatIfEngine(pec, pep, [T.Scenario()] * S, FrameworkConfig(), device="cpu",
                               collect_assignments=True, policies=vals).run()
        np.testing.assert_array_equal(res.assignments, fresh.assignments)
    assert eng.setups == 1


# -- shape checks and refusals ---------------------------------------------------


def _small():
    cluster = make_cluster(8, seed=0)
    pods, _ = make_workload(32, seed=0, duration_mean=0.5)
    return port_case(*encode(cluster, pods))


@pytest.mark.parametrize("shape", [(2, 3), (3, K), (2,)])
def test_policies_shape_checked(shape):
    pec, pep = _small()
    with pytest.raises(ValueError, match="policies"):
        T.WhatIfEngine(pec, pep, [T.Scenario()] * 2, FrameworkConfig(), device="cpu",
                       policies=np.zeros(shape, np.float32))


def test_set_policies_checks():
    pec, pep = _small()
    plain = T.WhatIfEngine(pec, pep, [T.Scenario()] * 2, FrameworkConfig(), device="cpu")
    with pytest.raises(ValueError, match="without policies"):
        plain.set_policies(tile(default_row(), 2))
    eng = T.WhatIfEngine(pec, pep, [T.Scenario()] * 2, FrameworkConfig(), device="cpu",
                         policies=tile(default_row(), 2))
    for bad in (np.zeros((3, K), np.float32), np.zeros((2, 3), np.float32)):
        with pytest.raises(ValueError, match="shape"):
            eng.set_policies(bad)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(preemption="kube"), ValueError, "kube preemption"),
    (dict(preemption="tier"), ValueError, "tier preemption"),
    (dict(retry_buffer=8), ValueError, "retry_buffer"),
    (dict(fork_checkpoint="ck.npz"), ValueError, "fork checkpoints"),
    (dict(mesh=object()), NotImplementedError, "queue A item 10"),
])
def test_policies_refused_where_the_reference_refuses(kw, exc, match):
    pec, pep = _small()
    with pytest.raises(exc, match=match):
        T.WhatIfEngine(pec, pep, [T.Scenario()] * 2, FrameworkConfig(), device="cpu",
                       policies=tile(default_row(), 2), **kw)
    if exc is ValueError and "fork" not in match and "kube" not in match:
        cluster = make_cluster(8, seed=0)
        pods, _ = make_workload(32, seed=0, duration_mean=0.5)
        ec, ep = encode(cluster, pods)
        with pytest.raises(ValueError, match="policies"):
            J.WhatIfEngine(ec, ep, [J.Scenario()] * 2, J_Config(),
                           policies=tile(default_row(), 2), **kw)
