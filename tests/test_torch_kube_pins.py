"""The constants chip_smoke.py holds the card's kube-preemption run against,
recomputed on the CPU: ``JaxReplayEngine(preemption="kube")`` of the JAX
package on examples/config8_kube_preempt.yaml as shipped (60 nodes x 4,000
pods, chunkWaves 16, retryBuffer 256) — what ``python -m
kubernetes_simulator_tpu run`` of that config runs: placed, unschedulable,
victims, drops, the summary latency's count and the sha256 of the
assignments. The case chip_smoke.py builds through the port's config must
encode what the JAX package's config builds."""

import os
import sys

import numpy as np
import yaml

from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_pinned_kube_constants():
    with open(os.path.join(ROOT, chip_smoke.CONFIG8)) as f:
        cfg = J_SimConfig.from_dict(yaml.safe_load(f))
    ec, ep = build_encoded_case(cfg)
    pcfg, pec, pep = chip_smoke.config8_case()
    for name in ("requests", "arrival", "duration", "priority", "group_id", "tol_key",
                 "aff_req", "anti_req", "spread_g", "spread_dns", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(ep, name), err_msg=name)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    np.testing.assert_array_equal(pec.taint_key, ec.taint_key)
    assert (pcfg.device_preemption, pcfg.whatif.retry_buffer, pcfg.chunk_waves,
            pcfg.wave_width) == (cfg.device_preemption, cfg.whatif.retry_buffer,
                                 cfg.chunk_waves, cfg.wave_width) == ("kube", 256, 16, 8)
    res = JaxReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                          chunk_waves=cfg.chunk_waves, preemption="kube",
                          retry_buffer=cfg.whatif.retry_buffer).replay()
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               preemptions=res.preemptions, retry_dropped=res.retry_dropped,
               latency_count=res.telemetry.latency["count"],
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.KUBE_PINS
