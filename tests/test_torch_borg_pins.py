"""The constants chip_smoke.py holds the card's Borg cut against,
recomputed on the CPU: config4's generator (``BorgSpec`` at seed 0) on
chip_smoke.BORG_CUT (12 nodes x 5,000 tasks, chunkWaves 32 — contended)
through the JAX package's ``greedy_replay(completions_chunk_waves=32)``:
placed, unschedulable and the sha256 of the assignments. The port's encoded
trace must equal the JAX package's, and the port's replay on the CPU must
give the same constants."""

import os
import sys

import numpy as np

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.sim import borg as J_borg
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import borg as T_borg
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _cut(mod):
    bc = chip_smoke.BORG_CUT
    return mod.make_borg_encoded(mod.BorgSpec(nodes=bc["nodes"], tasks=bc["tasks"],
                                              seed=chip_smoke.SEED))


def test_pinned_borg_constants_from_greedy():
    ec, ep, _ = _cut(J_borg)
    res = greedy_replay(ec, ep, J_Config(), wave_width=8,
                        completions_chunk_waves=chip_smoke.BORG_CUT["chunk_waves"])
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.BORG_PINS


def test_port_cpu_replay_gives_the_pins():
    jec, jep, _ = _cut(J_borg)
    ec, ep, _ = _cut(T_borg)
    for name in ("requests", "arrival", "duration", "group_id", "spread_g", "tol_key"):
        np.testing.assert_array_equal(getattr(ep, name), getattr(jep, name), err_msg=name)
    np.testing.assert_array_equal(ec.allocatable, jec.allocatable)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu",
                            chunk_waves=chip_smoke.BORG_CUT["chunk_waves"])
    res = eng.replay()
    assert eng.plan.C == chip_smoke.BORG_CUT["chunk_waves"] and res.route == "chunk"
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.BORG_PINS
