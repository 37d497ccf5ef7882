"""The constants chip_smoke.py holds the card's telemetry runs under kube
preemption and chaos against (TELEMETRY_KUBE_PINS), recomputed on the CPU
from the JAX package: what ``python -m kubernetes_simulator_tpu run`` of
examples/config10_telemetry.yaml (kube, a chaos timeline of chaos.seed,
series with timelineOut: collected at timeline) and of
examples/config12_utilization.yaml (kube, series with timelineOut) runs —
``JaxReplayEngine`` at timeline and the Chrome trace its CLI writes
(chip_smoke.telemetry_digest) — and the per-scenario latency quantiles and
fragmentation gauges of the rows its ``what-if`` writes for
examples/config9_chaos_whatif.yaml at series (the kube ``WhatIfEngine``
over 8 ``uniform_scenarios``, scenario s > 0 on the timeline chaos.seed +
s). The cases chip_smoke.py builds through the port's config must encode
what the JAX package's config builds."""

import os
import sys

import numpy as np
import pytest
import yaml

from kubernetes_simulator_tpu.cli import _chaos_timeline
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.telemetry import write_chrome_trace
from kubernetes_simulator_tpu.sim.whatif import WhatIfEngine, uniform_scenarios
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case
from kubernetes_simulator_tpu.utils.metrics import whatif_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

RUNS = {"config10": chip_smoke.CONFIG10, "config12": chip_smoke.CONFIG12}


def _case(path):
    with open(os.path.join(ROOT, path)) as f:
        cfg = J_SimConfig.from_dict(yaml.safe_load(f))
    ec, ep = build_encoded_case(cfg)
    return cfg, ec, ep


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cases_equal_the_reference(name):
    cfg, ec, ep = _case(RUNS[name])
    pcfg, pec, pep = chip_smoke.telemetry_case(RUNS[name])
    for f in ("requests", "arrival", "duration", "priority", "group_id", "tol_key", "aff_req",
              "anti_req", "spread_g", "spread_dns", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, f), getattr(ep, f), err_msg=f)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    # timelineOut promotes series to timeline in both parsers
    assert (pcfg.device_preemption, pcfg.whatif.retry_buffer, pcfg.chunk_waves,
            pcfg.wave_width, pcfg.telemetry, pcfg.timeline_out) == (
        cfg.device_preemption, cfg.whatif.retry_buffer, cfg.chunk_waves, cfg.wave_width,
        cfg.telemetry.granularity, cfg.telemetry.timeline_out)
    assert pcfg.device_preemption == "kube" and pcfg.telemetry == "timeline"
    if name == "config10":
        assert pcfg.chaos.__dict__ == cfg.chaos.__dict__
        want = [(e.time, e.kind, e.node, e.scale)
                for e in _chaos_timeline(cfg, ec, ep, cfg.chaos.seed)]
        got = [(e.time, e.kind, e.node, e.scale)
               for e in chip_smoke.chaos_timeline(pcfg, pec, pep, pcfg.chaos.seed)]
        assert got == want and got
    else:
        assert cfg.chaos is None and pcfg.chaos is None


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pinned_run(name, tmp_path):
    cfg, ec, ep = _case(RUNS[name])
    events = (_chaos_timeline(cfg, ec, ep, cfg.chaos.seed)
              if cfg.chaos is not None and cfg.chaos.enabled else None)
    res = JaxReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                          chunk_waves=cfg.chunk_waves, preemption=cfg.device_preemption,
                          retry_buffer=cfg.whatif.retry_buffer, telemetry="timeline").replay(
                              node_events=events)
    n = write_chrome_trace(str(tmp_path / "t.json"), res, arrival=ep.arrival,
                           duration=ep.duration, requests=ep.requests, rindex=ec.vocab._r)
    got = chip_smoke.telemetry_digest(res, n)
    print(name, got)
    assert got == chip_smoke.TELEMETRY_KUBE_PINS[name]


def test_pinned_config9_whatif_at_series():
    cfg, ec, ep = _case(chip_smoke.CONFIG9)
    scen = uniform_scenarios(ec, cfg.whatif.scenarios, seed=cfg.whatif.seed,
                             p_node_down=cfg.whatif.node_down_p,
                             p_capacity=cfg.whatif.capacity_p, p_taint=cfg.whatif.taint_p)
    for s in range(1, len(scen)):
        scen[s].events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed + s)
    res = WhatIfEngine(ec, ep, scen, cfg.framework, wave_width=cfg.wave_width,
                       chunk_waves=cfg.chunk_waves, preemption=cfg.device_preemption,
                       retry_buffer=cfg.whatif.retry_buffer, telemetry="series").run()
    got = chip_smoke.whatif_telemetry_fields(list(whatif_rows(res)))
    print(got)
    assert got == chip_smoke.TELEMETRY_KUBE_PINS["config9_whatif"]
