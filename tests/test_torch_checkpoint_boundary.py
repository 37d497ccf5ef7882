"""Checkpoint/resume of the port's single replay under the retry buffer,
kube preemption and chaos node events, against the JAX package's
boundary-mode checkpoints (kubernetes_simulator_tpu/sim/boundary.py
``to_blob`` / ``restore`` and sim/jax_runtime.py:1614-1640, :1853-1876).

The port keeps no host mirror: its file's ``bd_*`` blob is derived from the
device retry tables at the save point, and a resume rebuilds those tables
from a blob. Each case holds (a), (b) and (c) of
tests/test_torch_checkpoint.py: the port resumes its own file, the two
packages resume each other's, and the files are equal key by key. The
cases are those where the port and ``JaxReplayEngine(retry_buffer=...)``
already agree (ROADMAP C, PR 9)."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import checkpoint as C
from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from test_torch_checkpoint import triple
from torch_port_case import port_case

FIT = [{"name": "NodeResourcesFit"}]


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _kube_case():
    """tests/test_kube_preempt.py:343's trace: priorities, taints, spread,
    tolerations, completions and a contended cluster."""
    cluster = make_cluster(6, seed=2, taint_fraction=0.2)
    pods, _ = make_workload(260, seed=2, with_spread=True, with_tolerations=True,
                            duration_mean=60.0, arrival_rate=8.0)
    return encode(cluster, pods)


def _light_trace(num_pods, num_nodes, duration=30.0):
    """tests/test_chaos.py's queue-trivial shape."""
    nodes = [Node(f"n{i}", {"cpu": 8.0}) for i in range(num_nodes)]
    pods = [Pod(f"p{i}", requests={"cpu": 1.0}, arrival_time=float(i), duration=duration)
            for i in range(num_pods)]
    return encode(Cluster(nodes=nodes), pods)


def test_kube_resume_identity_and_mode_guards(tmp_path):
    """tests/test_kube_preempt.py:343: the resumed kube replay equals the
    uninterrupted one (assignments, placed, victims, drops) from a cursor
    inside the trace, with victims and pending releases in the blob; a
    resume on another mode or buffer is refused in the reference's words."""
    ec, ep = _kube_case()
    kw = dict(chunk_waves=4, preemption="kube", retry_buffer=64)
    jfull, tfull, tck, _ = triple(tmp_path, ec, ep, 2, kw)
    assert jfull.preemptions == tfull.preemptions > 0
    ck = C.ReplayCheckpoint.load(tck)
    bd = ck.boundary
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", **kw)
    assert ck.outs == [] and 0 < ck.chunk_cursor < len(eng.plan.buckets)
    assert bd["counters"][1] > 0 and len(bd["pend"]) > 0
    res = eng.replay(checkpoint_path=tck, resume=True)
    assert (res.placed, res.preemptions, res.retry_dropped) == (
        tfull.placed, tfull.preemptions, tfull.retry_dropped)
    with pytest.raises(ValueError, match="retry_buffer=64"):
        TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=4,
                          retry_buffer=64).replay(checkpoint_path=tck, resume=True)
    with pytest.raises(ValueError, match="same"):
        TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=4,
                          preemption="kube", retry_buffer=128).replay(checkpoint_path=tck,
                                                                      resume=True)
    with pytest.raises(ValueError, match="chunk grid"):
        TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=3,
                          preemption="kube", retry_buffer=64).replay(checkpoint_path=tck,
                                                                     resume=True)


def test_retry_buffer_resume(tmp_path):
    """The retry buffer without kube, saved at two cadences: a retried pod's
    pending release (listed, fired or lost to a full list) comes back from
    the blob."""
    from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
    from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine

    ec, ep = _kube_case()
    kw = dict(chunk_waves=4, retry_buffer=16)
    jeng = JaxReplayEngine(ec, ep, J_Config(), **kw)
    for every in (3, 4):
        jfull, _, tck, _ = triple(tmp_path, ec, ep, every, kw, jeng=jeng)
        bd = C.ReplayCheckpoint.load(tck).boundary
        assert jfull.retry_dropped > 0 and bd["bind_chunk"].max() == C.BIND_NEVER


def test_kube_blob_telemetry_purity(tmp_path):
    """tests/test_telemetry.py:246 and tests/test_double_buffer.py:114: the
    kube blob is the same with telemetry off and at timeline, and equals
    the reference's; both resume across packages."""
    ec, ep = _light_trace(24, 4)
    kw = dict(wave_width=1, chunk_waves=4, preemption="kube", retry_buffer=64)
    pec, pep = port_case(ec, ep)
    blobs = {}
    for gran in ("off", "timeline"):
        p = str(tmp_path / f"ck_{gran}.npz")
        TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT), device="cpu", telemetry=gran,
                          **kw).replay(checkpoint_path=p, checkpoint_every=3)
        blobs[gran] = np.load(p)
    assert sorted(blobs["off"].files) == sorted(blobs["timeline"].files)
    for k in blobs["off"].files:
        np.testing.assert_array_equal(blobs["off"][k], blobs["timeline"][k])
    cluster = make_cluster(8, seed=9)
    pods, _ = make_workload(64, seed=9, duration_mean=20.0, arrival_rate=4.0)
    triple(tmp_path, *encode(cluster, pods), 2,
           dict(chunk_waves=2, preemption="kube", retry_buffer=64, granularity_guard=False),
           plugins=FIT)


EVS = [(8.0, "node_down", 0), (20.0, "node_up", 0), (30.0, "node_down", 2),
       (44.0, "node_up", 2)]


@pytest.mark.parametrize("mode", ["kube", "retry"])
def test_chaos_resume_and_timeline_guard(mode, tmp_path):
    """tests/test_chaos.py:101: the applied-event cursor and the timeline's
    hash ride the blob; a resumed chaos replay equals the uninterrupted one
    (evictions, re-binds, their mean latency), the events before the
    cursor re-shape the allocatable without evicting again, and a resume
    under a different or missing timeline is refused."""
    from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
    from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine

    ec, ep = _light_trace(60, 4)
    kw = dict(wave_width=1, chunk_waves=4, retry_buffer=64,
              **({"preemption": "kube"} if mode == "kube" else {}))
    jeng = JaxReplayEngine(ec, ep, J_Config(plugins=FIT), **kw)
    for every, fired in ((2, 4), (9, 3)):  # cursors 14 and 9 of 15 chunks
        jfull, tfull, tck, _ = triple(tmp_path, ec, ep, every, kw, plugins=FIT, events=EVS,
                                      jeng=jeng)
        assert jfull.evictions == tfull.evictions > 0
        bd = C.ReplayCheckpoint.load(tck).boundary
        assert int(bd["ev_cursor"][0]) == fired
    pec, pep = port_case(ec, ep)
    mk = lambda: TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT), device="cpu", **kw)
    res = mk().replay(node_events=[NodeEvent(t, k, n) for t, k, n in EVS],
                      checkpoint_path=tck, resume=True)
    for f in ("evictions", "evict_rescheduled", "evict_stranded", "evict_latency_mean"):
        assert getattr(res, f) == getattr(tfull, f), f
    changed = [NodeEvent(t, k, n) for t, k, n in EVS[:-1]] + [NodeEvent(45.0, "node_down", 2)]
    with pytest.raises(ValueError, match="different node_events"):
        mk().replay(node_events=changed, checkpoint_path=tck, resume=True)
    with pytest.raises(ValueError, match="different node_events"):
        mk().replay(checkpoint_path=tck, resume=True)


def test_plain_and_boundary_guards(tmp_path):
    """tests/test_kube_preempt.py:386: a plain file does not resume on a
    boundary engine nor a boundary file on a plain engine, and a what-if
    fork refuses a boundary file, in the reference's words."""
    from kubernetes_simulator_tpu_torch.sim.whatif import Scenario, WhatIfEngine

    cluster = make_cluster(4, seed=1)
    pods, _ = make_workload(60, seed=1, duration_mean=20.0)
    pec, pep = port_case(*encode(cluster, pods))
    cfg = FrameworkConfig()
    plain_ck = str(tmp_path / "plain.npz")
    TorchReplayEngine(pec, pep, cfg, device="cpu", chunk_waves=2).replay(
        checkpoint_path=plain_ck, checkpoint_every=1)
    with pytest.raises(ValueError, match="boundary"):
        TorchReplayEngine(pec, pep, cfg, device="cpu", chunk_waves=2, retry_buffer=8).replay(
            checkpoint_path=plain_ck, resume=True)
    bd_ck = str(tmp_path / "bd.npz")
    TorchReplayEngine(pec, pep, cfg, device="cpu", chunk_waves=2, retry_buffer=8).replay(
        checkpoint_path=bd_ck, checkpoint_every=1)
    with pytest.raises(ValueError, match="boundary-mode"):
        TorchReplayEngine(pec, pep, cfg, device="cpu", chunk_waves=2).replay(
            checkpoint_path=bd_ck, resume=True)
    with pytest.raises(ValueError, match="boundary-mode"):
        WhatIfEngine(pec, pep, [Scenario()], cfg, fork_checkpoint=bd_ck, device="cpu").run()
