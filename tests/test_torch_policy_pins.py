"""The constants chip_smoke.py holds the card's policy-row what-if against
(POLICY_PINS), recomputed on the CPU: on chip_smoke.POLICY_CUT (500
nodes, 5,000 pods of the headline's generators, chunkWaves 64), each row
of chip_smoke.POLICY_ROWS materialized as an ordinary config (its exact
f32 weights; its selector's NodeResourcesFit strategy) and replayed by
``greedy_replay(completions_chunk_waves=64)`` on each of the first four
``uniform_scenarios``' perturbed clusters: placed pods per scenario and
the sha256 of the [4, P] assignments.

The JAX package's greedy_replay recomputes every pin (≈1 min a row on a
CPU host), so the card is held against an anchor independent of the
port; the port's greedy_replay recomputes them too, marked ``slow``
(another ≈1 min a row: tests/test_torch_greedy.py already holds it
against the JAX package's), and the port's encoded case and scenario
clusters must equal the JAX package's."""

import os
import sys

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay as j_greedy
from kubernetes_simulator_tpu.sim.synthetic import make_cluster as j_cluster
from kubernetes_simulator_tpu.sim.synthetic import make_workload as j_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops.policy import POLICY_WEIGHT_COLS
from kubernetes_simulator_tpu_torch.sim.greedy import greedy_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _policy(row):
    weights = {n: float(np.float32(row[i])) for i, n in enumerate(POLICY_WEIGHT_COLS)}
    return weights, "LeastAllocated" if row[5] > 0.5 else "MostAllocated"


def _pinned(results):
    return dict(placed=[r.placed for r in results],
                sha256=chip_smoke.assignments_sha256(np.stack([r.assignments for r in results])))


def _port_clusters():
    pc = chip_smoke.POLICY_CUT
    ec, ep = chip_smoke.case(pc["nodes"], pc["pods"])
    scen, pol = chip_smoke.policy_cut_batch(ec)
    assert pol.shape == (len(chip_smoke.POLICY_ROWS) * pc["scenarios"], 6)
    return chip_smoke.ScenarioSet(ec, scen[: pc["scenarios"]]).host_clusters(), ep


def _reference_clusters():
    pc = chip_smoke.POLICY_CUT
    jc = j_cluster(pc["nodes"], seed=chip_smoke.SEED, taint_fraction=0.1)
    jw, _ = j_workload(pc["pods"], seed=chip_smoke.SEED, with_affinity=True, with_spread=True,
                       with_tolerations=True, duration_mean=50.0, gang_fraction=0.02,
                       gang_size=4)
    ec, ep = j_encode(jc, jw)
    scen = J.uniform_scenarios(ec, pc["scenarios"], seed=chip_smoke.SEED)
    return J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec), ep


@pytest.mark.slow
@pytest.mark.parametrize("name", list(chip_smoke.POLICY_ROWS))
def test_pinned_policy_constants_port(name):
    weights, strategy = _policy(chip_smoke.POLICY_ROWS[name])
    cfg = FrameworkConfig().with_policy(weights, fit_strategy=strategy)
    clusters, ep = _port_clusters()
    res = [greedy_replay(ec_s, ep, cfg, wave_width=8,
                         completions_chunk_waves=chip_smoke.POLICY_CUT["chunk_waves"])
           for ec_s in clusters]
    assert _pinned(res) == chip_smoke.POLICY_PINS[name]


def test_policy_cut_case_equals_reference():
    """The port's encoded cut and its scenarios' perturbed clusters are
    the JAX package's, array for array."""
    port, pep = _port_clusters()
    ref, rep = _reference_clusters()
    for name in ("requests", "arrival", "duration", "group_id", "spread_g", "na_pref"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(rep, name), err_msg=name)
    for a, b in zip(port, ref):
        for name in ("allocatable", "taint_key", "taint_kv", "taint_effect", "node_domain"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("name", list(chip_smoke.POLICY_ROWS))
def test_pinned_policy_constants_reference(name):
    weights, strategy = _policy(chip_smoke.POLICY_ROWS[name])
    cfg = J_Config().with_policy(weights, fit_strategy=strategy)
    clusters, ep = _reference_clusters()
    res = [j_greedy(ec_s, ep, cfg, wave_width=8,
                    completions_chunk_waves=chip_smoke.POLICY_CUT["chunk_waves"])
           for ec_s in clusters]
    assert _pinned(res) == chip_smoke.POLICY_PINS[name]
