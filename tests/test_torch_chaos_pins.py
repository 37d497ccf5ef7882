"""The constants chip_smoke.py holds the card's chaos run against,
recomputed on the CPU from the JAX package on
examples/config9_chaos_whatif.yaml as shipped (60 nodes x 3,000 pods,
chunkWaves 16, retryBuffer 256, devicePreemption kube): what ``python -m
kubernetes_simulator_tpu run`` of that config runs (``JaxReplayEngine``
under one chaos timeline, chaos.seed) and what its ``what-if`` runs (the
kube ``WhatIfEngine`` over 8 ``uniform_scenarios``, scenario s > 0 on the
timeline chaos.seed + s): placed, unschedulable, victims, drops, the four
eviction counters and the sha256 of the assignments. The case and the
timelines chip_smoke.py builds through the port must be the JAX package's."""

import os
import sys

import numpy as np
import yaml

from kubernetes_simulator_tpu.cli import _chaos_timeline
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.whatif import WhatIfEngine, uniform_scenarios
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

COUNTERS = ("placed", "unschedulable", "preemptions", "retry_dropped", "evictions",
            "evict_rescheduled", "evict_stranded", "evict_latency_mean")


def _case():
    with open(os.path.join(ROOT, chip_smoke.CONFIG9)) as f:
        cfg = J_SimConfig.from_dict(yaml.safe_load(f))
    ec, ep = build_encoded_case(cfg)
    return cfg, ec, ep


def test_config9_case_and_timelines_equal_the_reference():
    cfg, ec, ep = _case()
    pcfg, pec, pep = chip_smoke.config9_case()
    for name in ("requests", "arrival", "duration", "priority", "group_id", "tol_key",
                 "aff_req", "anti_req", "spread_g", "spread_dns", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(ep, name), err_msg=name)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    assert (pcfg.device_preemption, pcfg.whatif.retry_buffer, pcfg.chunk_waves,
            pcfg.wave_width, pcfg.whatif.scenarios) == (
        cfg.device_preemption, cfg.whatif.retry_buffer, cfg.chunk_waves, cfg.wave_width,
        cfg.whatif.scenarios) == ("kube", 256, 16, 8, 8)
    assert pcfg.chaos.__dict__ == cfg.chaos.__dict__
    for seed in range(cfg.chaos.seed, cfg.chaos.seed + chip_smoke.CHAOS_WHATIF["scenarios"],
                      17):
        want = [(e.time, e.kind, e.node, e.scale) for e in _chaos_timeline(cfg, ec, ep, seed)]
        got = [(e.time, e.kind, e.node, e.scale)
               for e in chip_smoke.chaos_timeline(pcfg, pec, pep, seed)]
        assert got == want


def test_pinned_chaos_run():
    cfg, ec, ep = _case()
    events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed)
    res = JaxReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                          chunk_waves=cfg.chunk_waves, preemption=cfg.device_preemption,
                          retry_buffer=cfg.whatif.retry_buffer).replay(node_events=events)
    got = {k: getattr(res, k) for k in COUNTERS}
    got.update(events=len(events), sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.CHAOS_PINS["run"]


def test_pinned_chaos_whatif():
    cfg, ec, ep = _case()
    scen = uniform_scenarios(ec, cfg.whatif.scenarios, seed=cfg.whatif.seed,
                             p_node_down=cfg.whatif.node_down_p,
                             p_capacity=cfg.whatif.capacity_p, p_taint=cfg.whatif.taint_p)
    for s in range(1, len(scen)):
        scen[s].events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed + s)
    res = WhatIfEngine(ec, ep, scen, cfg.framework, wave_width=cfg.wave_width,
                       chunk_waves=cfg.chunk_waves, preemption=cfg.device_preemption,
                       retry_buffer=cfg.whatif.retry_buffer, collect_assignments=True).run()
    got = {k: np.asarray(getattr(res, k)).tolist() for k in COUNTERS}
    got["sha256"] = chip_smoke.assignments_sha256(res.assignments)
    assert got == chip_smoke.CHAOS_PINS["whatif"]
