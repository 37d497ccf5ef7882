"""The constants chip_smoke.py holds the card's series-telemetry runs
against, recomputed on the CPU with the JAX package's JaxReplayEngine:
CONFIG6's trace with devicePreemption off at ``series`` (500 nodes x
26,000 pods, the plain path's in-scan attribution), CONFIG7 as shipped at
``timeline`` (the telemetry its ``run`` collects with ``timelineOut``; 500
nodes x 20,000 pods, retryBuffer 256: the retry path) with the Chrome
trace its CLI writes, and CONFIG7's cluster cut to 150 nodes at
``timeline``: reasons, rejection attempts and the sha256 of the series,
the events and the trace (chip_smoke.series_digest). The cases
chip_smoke.py builds through the port's config must encode what the JAX
package's config builds."""

import os
import sys

import numpy as np
import pytest
import yaml

from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.telemetry import write_chrome_trace
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("shape", ["config6", "config7", "cut150"])
def test_pinned_reject_constants(shape, tmp_path):
    path = chip_smoke.CONFIG6 if shape == "config6" else chip_smoke.CONFIG7
    with open(os.path.join(ROOT, path)) as f:
        d = yaml.safe_load(f)
    d["devicePreemption"] = False
    nodes = chip_smoke.RETRY_CUT_NODES if shape == "cut150" else None
    if nodes:
        d["cluster"]["synthetic"]["nodes"] = nodes
    cfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(cfg)
    if shape == "config6":
        _, pec, pep = chip_smoke.config6_case()
    else:
        _, pec, pep = chip_smoke.config7_case(nodes=nodes)
    for name in ("requests", "arrival", "duration", "group_id", "tol_key", "aff_req",
                 "spread_g", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(ep, name), err_msg=name)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    res = JaxReplayEngine(
        ec, ep, cfg.framework, wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        retry_buffer=cfg.whatif.retry_buffer,
        telemetry="series" if shape == "config6" else "timeline",
    ).replay()
    got = chip_smoke.series_digest(res.telemetry)
    if shape == "config7":
        trace = str(tmp_path / "timeline.json")
        write_chrome_trace(trace, res, arrival=ep.arrival, duration=ep.duration,
                           requests=ep.requests, rindex=ec.vocab._r)
        got["trace_sha256"] = chip_smoke.file_sha256(trace)
    print(shape, got)
    assert got == chip_smoke.REJECT_PINS[shape]
