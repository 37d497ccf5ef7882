"""The constants chip_smoke.py holds the card's tier-preemption runs
against, recomputed on the CPU: ``greedy_replay(preemption=True)`` of the
JAX package on examples/config6_preempt_defaults.yaml (500 nodes, 26,000
pods) and on the what-if shape (the same with durationMean 200 and gangs
of 4, ``completions_chunk_waves=512``): placed pods, victims and the
sha256 of the assignments. The case chip_smoke.py builds through the
port's config must encode what the JAX package's config builds."""

import os
import sys

import numpy as np
import pytest

from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("shape", ["config6", "whatif"])
def test_pinned_greedy_constants(shape):
    import yaml

    whatif = shape == "whatif"
    with open(os.path.join(ROOT, chip_smoke.CONFIG6)) as f:
        d = yaml.safe_load(f)
    if whatif:
        pw = chip_smoke.PREEMPT_WHATIF
        d["workload"]["synthetic"].update(durationMean=pw["duration_mean"],
                                          gangFraction=pw["gang_fraction"],
                                          gangSize=pw["gang_size"])
    cfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(cfg)
    _, pec, pep = chip_smoke.config6_case(whatif=whatif)
    for name in ("requests", "priority", "arrival", "duration", "group_id", "tol_key",
                 "spread_g", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(ep, name), err_msg=name)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    np.testing.assert_array_equal(pec.taint_key, ec.taint_key)
    res = greedy_replay(ec, ep, cfg.framework, wave_width=cfg.wave_width, preemption=True,
                        completions_chunk_waves=pw["chunk_waves"] if whatif else None)
    got = dict(placed=res.placed, victims=res.preemptions,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.PREEMPT_PINS[shape]
    assert res.preemptions > 0
