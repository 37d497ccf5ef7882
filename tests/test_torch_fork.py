"""What-if forks from a checkpoint (``WhatIfEngine(fork_checkpoint=)``)
against the JAX package's (kubernetes_simulator_tpu/sim/whatif.py
:1854-1900 and the fork paths of its run) and its uninterrupted replay,
on the CPU twins: tests/test_events_fork.py:38, :63 and :86, a fork
re-chunked on another grid, a relabelled batch on the v2 fallback, and the
reference's refusals."""

import os

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
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

#: NodeResourcesFit alone where a case is about the fork's state, not the
#: plugins (the JAX package's program then compiles in seconds)
FIT = [{"name": "NodeResourcesFit"}]
#: with PodTopologySpread: the forked count planes are read
SPREAD = FIT + [{"name": "PodTopologySpread"}]

@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _scen(M, down=5):
    return [M.Scenario(), M.Scenario([M.Perturbation("node_down", nodes=np.arange(down))])]


def fork_both(tmp_path, ec, ep, C_src, every, C_fork=None, scen=_scen, writer="jax",
              jax_fork=True, plugins=None, **kw):
    """(the source's uninterrupted assignments, the JAX fork's result or
    None, the port's result, its engine) of one fork; the source replay
    (``writer``'s package) checkpoints every ``every`` of its chunks of
    ``C_src`` waves, the batches run on chunks of ``C_fork``; with
    ``jax_fork`` the JAX package forks the same file and the two results
    are held equal."""
    pec, pep = port_case(ec, ep)
    ck = str(tmp_path / "fork.npz")
    if writer == "jax":
        full = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), chunk_waves=C_src).replay(
            checkpoint_path=ck, checkpoint_every=every)
    else:
        full = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu",
                                 chunk_waves=C_src).replay(checkpoint_path=ck,
                                                           checkpoint_every=every)
    C_fork = C_fork or C_src
    eng = T.WhatIfEngine(pec, pep, scen(T), FrameworkConfig(plugins=plugins), chunk_waves=C_fork,
                         collect_assignments=True, fork_checkpoint=ck, device="cpu", **kw)
    rt = eng.run()
    rj = None
    if jax_fork:
        rj = J.WhatIfEngine(ec, ep, scen(J), J_Config(plugins=plugins), chunk_waves=C_fork,
                            collect_assignments=True, fork_checkpoint=ck, **kw).run()
        np.testing.assert_array_equal(rt.assignments, rj.assignments)
        np.testing.assert_array_equal(rt.placed, rj.placed)
        np.testing.assert_array_equal(rt.unschedulable, rj.unschedulable)
        assert rt.engine == rj.engine
    return full.assignments, rj, rt, eng


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_whatif_fork_from_checkpoint(writer, tmp_path):
    """tests/test_events_fork.py:38 from a mid-trace checkpoint of either
    package: scenario 0 equals the uninterrupted replay, the perturbed
    branch shares the prefix and places no more; the port's file forks
    alike in both packages."""
    cluster = make_cluster(10, seed=4)
    pods, _ = make_workload(160, seed=4, with_affinity=True, with_spread=True)
    ec, ep = encode(cluster, pods)
    full, _, rt, eng = fork_both(tmp_path, ec, ep, 5, 3, writer=writer,
                                 jax_fork=writer == "torch", plugins=SPREAD)
    assert 0 < eng.fork.waves_done < eng.waves.idx.shape[0]
    np.testing.assert_array_equal(rt.assignments[0], full)
    prefix = eng.waves.idx[: eng.fork.waves_done].reshape(-1)
    prefix = prefix[prefix >= 0]
    np.testing.assert_array_equal(rt.assignments[1][prefix], full[prefix])
    assert rt.placed[1] <= rt.placed[0]


def test_whatif_fork_from_padded_checkpoint(tmp_path):
    """tests/test_events_fork.py:63: a checkpoint past the real wave count
    (the source padded its waves to whole chunks) is clamped; it covered
    the whole trace, so the fork reproduces it."""
    cluster = make_cluster(12, seed=7)
    pods, _ = make_workload(90, seed=7, with_affinity=True, with_spread=True)
    ec, ep = encode(cluster, pods)
    full, _, rt, eng = fork_both(tmp_path, ec, ep, 5, 1, scen=lambda M: [M.Scenario()] * 2,
                                 jax_fork=False, plugins=FIT)
    assert eng.fork.waves_done == eng.waves.idx.shape[0] == 12
    np.testing.assert_array_equal(rt.assignments[0], full)
    assert rt.placed.tolist() == [0, 0]


def _completions_case():
    cluster = make_cluster(8, seed=7)
    pods, _ = make_workload(200, seed=7, with_affinity=False, with_spread=True)
    for i, p in enumerate(pods):
        p.duration = 0.5 + (i % 5) * 0.2
    return encode(cluster, pods)


@pytest.mark.parametrize("C_fork", [4, 3])
def test_whatif_fork_with_completions_no_double_release(C_fork, tmp_path):
    """tests/test_events_fork.py:86: the fork seeds its released mask from
    the file, so no pre-fork release is subtracted twice, and the source's
    last chunk releases one chunk behind; on the source's grid scenario 0
    equals the uninterrupted completions-on replay, on another grid the
    fork still equals the reference's."""
    ec, ep = _completions_case()
    full, _, rt, eng = fork_both(tmp_path, ec, ep, 4, 3, C_fork=C_fork,
                                 scen=lambda M: [M.Scenario()], jax_fork=C_fork != 4,
                                 plugins=FIT, completions=True)
    ck = C.ReplayCheckpoint.load(str(tmp_path / "fork.npz"))
    assert ck.released is not None and ck.released.any()
    assert not eng.fork.released[eng.plan.prebound[eng.plan.tail_node >= 0]].all()
    if C_fork == 4:
        np.testing.assert_array_equal(rt.assignments[0], full)


def test_fork_refusals(tmp_path):
    """The reference's refusals of a fork: kube, tier preemption, the retry
    buffer and per-scenario policies."""
    cluster = make_cluster(6, seed=1)
    pods, _ = make_workload(40, seed=1, duration_mean=20.0)
    pec, pep = port_case(*encode(cluster, pods))
    ck = str(tmp_path / "ck.npz")
    TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=1).replay(
        checkpoint_path=ck, checkpoint_every=2)
    assert os.path.exists(ck)
    mk = lambda **kw: T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(),
                                     fork_checkpoint=ck, device="cpu", **kw)
    with pytest.raises(ValueError, match="fork checkpoints"):
        mk(preemption="kube", retry_buffer=8)
    with pytest.raises(ValueError, match="no fork checkpoint"):
        mk(preemption=True)
    with pytest.raises(ValueError, match="fork checkpoint"):
        mk(retry_buffer=8)
    with pytest.raises(ValueError, match="fork checkpoints"):
        mk(policies=np.ones((1, 6), np.float32))
