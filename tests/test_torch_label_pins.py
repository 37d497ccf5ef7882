"""The constants chip_smoke.py holds the card's relabel what-if against,
recomputed on the CPU: on chip_smoke.LABEL_CUT (500 nodes, 5,000 pods of
the headline's generators, chunkWaves 64), each relabelled scenario of
``chip_smoke.relabel_scenarios`` — a zone move, a new zone and a tier
flip, each beside its uniform_scenarios perturbations — applied
explicitly to the JAX package's object-model cluster, re-encoded and
replayed by ``greedy_replay(completions_chunk_waves=64)``: placed pods
and the sha256 of the assignments. The port's explicitly relabelled case
must encode what the JAX package encodes."""

import os
import sys

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Taint
from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.synthetic import make_cluster as j_cluster
from kubernetes_simulator_tpu.sim.synthetic import make_workload as j_workload
from kubernetes_simulator_tpu_torch.models.encode import encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("kind", chip_smoke.LABEL_KINDS)
def test_pinned_label_constants(kind):
    lc = chip_smoke.LABEL_CUT
    cluster, workload = chip_smoke.case_objects(lc["nodes"], lc["pods"])
    pec, pep = encode(cluster, workload)
    scen = chip_smoke.relabel_scenarios(pec, lc["scenarios"])
    s = chip_smoke.first_of_each_kind(lc["scenarios"])[kind]
    ops = [pt.op for pt in scen[s].perturbations]
    assert ops[-1] == "set_label" and (kind != "tier_hot") == (
        scen[s].perturbations[-1].key == chip_smoke.ZONE)
    jc = j_cluster(lc["nodes"], seed=chip_smoke.SEED, taint_fraction=0.1)
    jw, _ = j_workload(lc["pods"], seed=chip_smoke.SEED, with_affinity=True, with_spread=True,
                       with_tolerations=True, duration_mean=50.0, gang_fraction=0.02,
                       gang_size=4)
    ec, ep = j_encode(chip_smoke.explicit_cluster(jc, scen[s], Taint), jw)
    pec_s, pep_s = encode(chip_smoke.explicit_cluster(cluster, scen[s]), workload)
    for name in ("allocatable", "taint_key", "node_domain", "num_domains"):
        np.testing.assert_array_equal(getattr(pec_s, name), getattr(ec, name), err_msg=name)
    for name in ("requests", "arrival", "duration", "group_id", "spread_g", "na_pref"):
        np.testing.assert_array_equal(getattr(pep_s, name), getattr(ep, name), err_msg=name)
    res = greedy_replay(ec, ep, J_Config(), wave_width=8,
                        completions_chunk_waves=lc["chunk_waves"])
    got = dict(placed=res.placed, sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.LABEL_PINS[kind]
