"""What-if forks from a checkpoint, continued (tests/test_torch_fork.py):
a file without a released mask and a relabelled batch, each forked by both
packages and held equal, on the CPU twins."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import checkpoint as C
from kubernetes_simulator_tpu_torch.sim import whatif as T

from test_torch_fork import FIT, SPREAD, _completions_case, fork_both
from torch_port_case import port_case


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_maskless_checkpoint_reconstructs_released(tmp_path):
    """A file written before the released field (no ``released`` key): the
    fork reconstructs the mask from the saved outs with the no-slack rule,
    as the reference does, and both packages fork it alike."""
    ec, ep = _completions_case()
    ck = str(tmp_path / "fork.npz")
    JaxReplayEngine(ec, ep, J_Config(plugins=FIT), chunk_waves=4).replay(checkpoint_path=ck,
                                                                         checkpoint_every=3)
    old = C.ReplayCheckpoint.load(ck)
    old.released = None
    old.save(ck)
    pec, pep = port_case(ec, ep)
    rj = J.WhatIfEngine(ec, ep, [J.Scenario()], J_Config(plugins=FIT), chunk_waves=4,
                        collect_assignments=True, fork_checkpoint=ck, completions=True).run()
    eng = T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(plugins=FIT), chunk_waves=4,
                         collect_assignments=True, fork_checkpoint=ck, completions=True,
                         device="cpu")
    np.testing.assert_array_equal(eng.run().assignments, rj.assignments)
    assert eng.fork.released.any()


def test_relabelled_fork_takes_the_v2_fallback(tmp_path):
    """A label-perturbed batch with a fork runs outside the DynTables
    envelope, on the v2 fallback, as the reference's (its fork state is the
    file's domain-space planes in every scenario)."""
    cluster = make_cluster(10, seed=4)
    pods, _ = make_workload(160, seed=4, with_affinity=True, with_spread=True)
    ec, ep = encode(cluster, pods)
    assert "topology.kubernetes.io/zone" in ec.vocab.keys

    def scen(M):
        return [M.Scenario(), M.Scenario([M.Perturbation(
            "set_label", nodes=np.arange(3), key="topology.kubernetes.io/zone",
            value="zone-x")])]

    full, rj, rt, _ = fork_both(tmp_path, ec, ep, 5, 3, scen=scen, plugins=SPREAD)
    assert rj.engine == rt.engine == "v2"
    np.testing.assert_array_equal(rt.assignments[0], full)
