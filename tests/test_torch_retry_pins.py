"""The constants chip_smoke.py holds the card's retry-buffer runs against,
recomputed on the CPU: ``greedy_replay(retry_buffer=256,
completions_chunk_waves=256)`` of the JAX package (and the same without
the buffer) on examples/config7_retry_completions.yaml — scenario 0 of its
what-if, 500 nodes x 20,000 pods — and on its cluster cut to 150 nodes:
placed pods, drops and the sha256 of the assignments. The case
chip_smoke.py builds through the port's config must encode what the JAX
package's config builds."""

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


@pytest.mark.parametrize("shape", ["config7", "config7_no_retry", "cut150", "cut150_no_retry"])
def test_pinned_greedy_constants(shape):
    import yaml

    with open(os.path.join(ROOT, chip_smoke.CONFIG7)) as f:
        d = yaml.safe_load(f)
    nodes = chip_smoke.RETRY_CUT_NODES if shape.startswith("cut") else None
    if nodes:
        d["cluster"]["synthetic"]["nodes"] = nodes
    cfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(cfg)
    pcfg, pec, pep = chip_smoke.config7_case(nodes=nodes)
    for name in ("requests", "arrival", "duration", "group_id", "tol_key", "aff_req",
                 "anti_req", "spread_g", "bound_node"):
        np.testing.assert_array_equal(getattr(pep, name), getattr(ep, name), err_msg=name)
    np.testing.assert_array_equal(pec.allocatable, ec.allocatable)
    np.testing.assert_array_equal(pec.taint_key, ec.taint_key)
    assert pcfg.whatif.retry_buffer == cfg.whatif.retry_buffer == 256
    rb = 0 if shape.endswith("no_retry") else cfg.whatif.retry_buffer
    res = greedy_replay(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                        completions_chunk_waves=cfg.chunk_waves, retry_buffer=rb)
    got = dict(placed=res.placed, retry_dropped=res.retry_dropped,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.RETRY_PINS[shape]
