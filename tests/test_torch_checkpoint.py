"""Checkpoint/resume of the port's single replay on its plain path, against
the JAX package's (kubernetes_simulator_tpu/sim/checkpoint.py and the
checkpoints of JaxReplayEngine.replay).

Each case mirrors a reference test and holds three things on the CPU twins:
(a) the port resumes its own checkpoint to its uninterrupted result
(assignments, placed, planes); (b) a file the JAX engine wrote resumes on
the port, and a file the port wrote resumes on JaxReplayEngine, each to the
other's uninterrupted result; (c) the port's file equals the reference's
key by key: integers and masks exactly, the f32 planes within
tests/test_jax_parity.py ``assert_parity``'s tolerances (used 1e-3, the
count planes 1e-5)."""

import hashlib
import logging
import os

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.jax_runtime import rebuild_fork_state as j_rebuild
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import checkpoint as C
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (
    TorchReplayEngine,
    rebuild_fork_state,
    wave_start_times,
)

from torch_port_case import port_case

FIT = [{"name": "NodeResourcesFit"}]
#: NodeResourcesFit and PodTopologySpread: count planes that a plugin reads,
#: a program the JAX package compiles faster than the full set's
SPREAD = FIT + [{"name": "PodTopologySpread"}]
#: f32 tolerances of tests/test_jax_parity.py assert_parity
ATOL = {"used": 1e-3}
PLANE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def assert_blobs_equal(path_a, path_b):
    """(c): the two files hold the same keys, dtypes and shapes, integers and
    masks equal, f32 planes within the parity tolerances."""
    with np.load(path_a) as za, np.load(path_b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=0, atol=ATOL.get(k, PLANE_ATOL),
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(x, y, err_msg=k)


def assert_same_result(a, b, planes=True):
    np.testing.assert_array_equal(a.assignments, b.assignments)
    assert a.placed == b.placed
    if planes:
        np.testing.assert_allclose(a.state.used, b.state.used, rtol=0, atol=ATOL["used"])
        for f in ("match_count", "anti_active", "pref_wsum"):
            np.testing.assert_allclose(getattr(a.state, f), getattr(b.state, f), rtol=0,
                                       atol=PLANE_ATOL, err_msg=f)


def triple(tmp_path, ec, ep, every, jkw=None, tkw=None, plugins=None, events=None,
           tname="t.npz", jeng=None):
    """(a), (b) and (c) of one case (module docstring); ``events`` a list of
    (time, kind, node) the replays take as node_events; ``jeng`` a JAX
    engine of the case to reuse (its program compiled once for the
    module). Returns (the JAX replay's result, the port's, the port's file,
    the JAX file)."""
    from kubernetes_simulator_tpu.sim.runtime import NodeEvent as J_Event
    from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent

    jkw = dict(jkw or {})
    tkw = dict(jkw if tkw is None else tkw)
    pec, pep = port_case(ec, ep)
    jev = {} if events is None else dict(node_events=[J_Event(t, k, n) for t, k, n in events])
    tev = {} if events is None else dict(node_events=[NodeEvent(t, k, n) for t, k, n in events])
    jck, tck = str(tmp_path / "j.npz"), str(tmp_path / tname)
    # One engine of each package serves its runs (a replay is re-entrant;
    # the JAX engine then compiles once).
    jeng = jeng or JaxReplayEngine(ec, ep, J_Config(plugins=plugins), **jkw)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu", **tkw)
    jfull = jeng.replay(checkpoint_path=jck, checkpoint_every=every, **jev)
    tfull = eng.replay(checkpoint_path=tck, checkpoint_every=every, **tev)
    assert eng.last_saves and eng.last_saves[-1][1] == os.path.getsize(tck)
    np.testing.assert_array_equal(tfull.assignments, jfull.assignments)
    assert_blobs_equal(tck, jck)
    ck = C.ReplayCheckpoint.load(tck)
    nchunks = len(eng.plan.buckets)
    assert 0 < ck.chunk_cursor <= nchunks
    own = eng.replay(checkpoint_path=tck, resume=True, **tev)
    assert_same_result(own, tfull)
    from_jax = eng.replay(checkpoint_path=jck, resume=True, **tev)
    assert_same_result(from_jax, tfull)
    on_jax = jeng.replay(checkpoint_path=tck, resume=True, **jev)
    np.testing.assert_array_equal(on_jax.assignments, jfull.assignments)
    assert on_jax.placed == jfull.placed
    return jfull, tfull, tck, jck


def _case5(n_pods=240, seed=5):
    """tests/test_tpu3_equiv.py's ``_case``: taints, affinity, spread,
    tolerations and gangs."""
    cluster = make_cluster(30, seed=seed, taint_fraction=0.3)
    pods, _ = make_workload(n_pods, seed=seed, with_affinity=True, with_spread=True,
                            with_tolerations=True, gang_fraction=0.1, gang_size=3)
    return encode(cluster, pods)


@pytest.fixture(scope="module")
def case5():
    """The full-plugin case and its JAX v3 engine, compiled once a module."""
    ec, ep = _case5()
    return ec, ep, JaxReplayEngine(ec, ep, J_Config(), chunk_waves=4)


@pytest.mark.parametrize("engine", ["v3", "v2"])
def test_resume_identical_v3_v2(engine, case5, tmp_path):
    """tests/test_tpu3_equiv.py:122 on the port's v3 and v2 engines, against
    the JAX v3 engine (its v2 writes the same file: host-layout planes)."""
    ec, ep, jeng = case5
    triple(tmp_path, ec, ep, 3, dict(chunk_waves=4), dict(chunk_waves=4, engine=engine),
           jeng=jeng)


def test_completions_resume_identical(tmp_path):
    """tests/test_completions_device.py:96: completions fire before and after
    the save point, and the resumed run neither repeats nor drops one."""
    cluster = make_cluster(10, seed=5)
    pods, _ = make_workload(120, seed=5, arrival_rate=20.0, duration_mean=1.5)
    ec, ep = encode(cluster, pods)
    jfull, _, tck, _ = triple(tmp_path, ec, ep, 3, dict(wave_width=4, chunk_waves=4),
                              plugins=FIT)
    ck = C.ReplayCheckpoint.load(tck)
    assert ck.released is not None and ck.released.any() and ck.chunk_cursor == 6


def test_completions_resume_with_prebound(tmp_path):
    """tests/test_completions_device.py:135: a pre-bound pod's release is in
    the saved planes and its mask, and is not subtracted again."""
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2}), Node("n1", {"cpu": 2})])
    pods = [Pod("pre", requests={"cpu": 1}, arrival_time=0.0, duration=1.0, node_name="n0")] + [
        Pod(f"p{i}", requests={"cpu": 1}, arrival_time=2.0 + i, duration=1.5) for i in range(8)]
    ec, ep = encode(cluster, pods)
    _, _, tck, _ = triple(tmp_path, ec, ep, 3, dict(wave_width=1, chunk_waves=2), plugins=FIT)
    ck = C.ReplayCheckpoint.load(tck)
    assert ck.released[0] and ck.chunk_cursor == 3


def test_padded_checkpoint_resumes(tmp_path):
    """A save after the last chunk, whose choices hold the padded tail waves
    (tests/test_events_fork.py:63's trace, 12 waves on chunks of 5, without
    its affinity and spread terms: NodeResourcesFit alone)."""
    cluster = make_cluster(12, seed=7)
    pods, _ = make_workload(90, seed=7)
    ec, ep = encode(cluster, pods)
    _, _, tck, _ = triple(tmp_path, ec, ep, 1, dict(chunk_waves=5), plugins=FIT)
    ck = C.ReplayCheckpoint.load(tck)
    assert [o.shape for o in ck.outs] == [(5, 8)] * 3 and (ck.outs[-1][2:] == -1).all()


def _shard_case():
    """tests/test_node_sharding.py's ``_case``: the full plugin surface with
    gangs and completions."""
    cluster = make_cluster(24, seed=7, taint_fraction=0.2)
    pods, _ = make_workload(220, seed=7, with_affinity=True, with_spread=True,
                            with_tolerations=True, gang_fraction=0.1, gang_size=4,
                            duration_mean=40.0)
    return encode(cluster, pods)


def test_shard_blobs_identical_and_cross_resume(tmp_path):
    """tests/test_node_sharding.py:98 and tests/test_overlap.py:157: the file
    is in host layout, byte for byte the same from the replicated and the
    node-sharded engine (the reference's, at 2 shards, too, key by key), and
    a replicated file resumes on the sharded engine and the reverse."""
    ec, ep = _shard_case()
    pec, pep = port_case(ec, ep)
    triple(tmp_path, ec, ep, 2, dict(chunk_waves=4, node_shards=2), plugins=SPREAD)
    digests, results = {}, {}
    for s in (1, 2):
        p = tmp_path / f"ck{s}.npz"
        results[s] = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=4,
                                       node_shards=s).replay(checkpoint_path=str(p),
                                                             checkpoint_every=2)
        digests[s] = hashlib.sha256(p.read_bytes()).hexdigest()
    assert digests[1] == digests[2]
    np.testing.assert_array_equal(results[1].assignments, results[2].assignments)
    for s, other in ((2, 1), (1, 2)):
        res = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=4,
                                node_shards=s).replay(checkpoint_path=str(tmp_path / f"ck{other}.npz"),
                                                      resume=True)
        np.testing.assert_array_equal(res.assignments, results[1].assignments)


def test_recorder_paged_resume_and_pager_jump(tmp_path):
    """tests/test_flight.py:98 and tests/test_overlap.py:294: the file is the
    same recorder on and off, the recorder's ``checkpoint`` rows carry the
    file's size, a sharded recorded file resumes on a paged engine, whose
    pager starts at the cursor's page with one miss (no staged page to
    drop); paged saves and resumes (a) (b) (c) against the reference's."""
    from kubernetes_simulator_tpu_torch.sim.flight import read_stream

    ec, ep = _shard_case()
    pec, pep = port_case(ec, ep)
    mk = lambda **kw: TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu",
                                        chunk_waves=4, **kw)
    ref = mk().replay()
    digests = {}
    for tag, rec in (("off", None), ("on", str(tmp_path / "fl.jsonl"))):
        p = tmp_path / f"ck_{tag}.npz"
        res = mk(node_shards=2, flight_recorder=rec).replay(checkpoint_path=str(p),
                                                            checkpoint_every=3)
        np.testing.assert_array_equal(res.assignments, ref.assignments)
        digests[tag] = hashlib.sha256(p.read_bytes()).hexdigest()
    assert digests["on"] == digests["off"]
    rows = [r for r in read_stream(str(tmp_path / "fl.jsonl")) if r["event"] == "checkpoint"]
    nchunks = -(-mk().waves.idx.shape[0] // 4)
    assert [r["chunk"] for r in rows] == list(range(3, nchunks + 1, 3)) and nchunks % 3
    assert rows[-1]["ckpt_bytes"] == os.path.getsize(tmp_path / "ck_on.npz")
    eng = mk(paged=True)
    res = eng.replay(checkpoint_path=str(tmp_path / "ck_on.npz"), resume=True)
    np.testing.assert_array_equal(res.assignments, ref.assignments)
    assert (eng.last_pager.stalls, eng.last_pager.invalidations) == (1, 0)
    cluster = make_cluster(24, seed=7, taint_fraction=0.2)
    pods, _ = make_workload(220, seed=7, with_tolerations=True, gang_fraction=0.1, gang_size=4,
                            duration_mean=40.0)
    triple(tmp_path, *encode(cluster, pods), 3, dict(chunk_waves=4, paged=True), plugins=FIT,
           tname="paged.npz")


def test_blob_independent_of_telemetry(tmp_path, caplog):
    """The file is the same with telemetry off and at timeline (tests/
    test_telemetry.py:246's purity, on the plain path), and series
    attribution is off under checkpoints with the reference's log line."""
    ec, ep = _case5(n_pods=120)
    pec, pep = port_case(ec, ep)
    blobs = {}
    for gran in ("off", "timeline"):
        p = str(tmp_path / f"ck_{gran}.npz")
        with caplog.at_level(logging.INFO, logger="k8sim"):
            res = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", chunk_waves=2,
                                    telemetry=gran).replay(checkpoint_path=p,
                                                           checkpoint_every=3)
        blobs[gran] = np.load(p)
        if gran == "timeline":
            assert res.telemetry.reasons in (None, {}) and res.telemetry.latency is not None
    assert "disabled under checkpoint/resume" in caplog.text
    assert sorted(blobs["off"].files) == sorted(blobs["timeline"].files)
    for k in blobs["off"].files:
        np.testing.assert_array_equal(blobs["off"][k], blobs["timeline"][k])


def test_resume_guards(tmp_path):
    """The reference's refusals (tier planes are not checkpointed; a
    boundary-mode file on a plain engine) and the port's own checks of a
    file against its plan (another chunk grid; a released mask written
    with completions off)."""
    cluster = make_cluster(10, seed=5)
    pods, _ = make_workload(120, seed=5, arrival_rate=20.0, duration_mean=1.5)
    pec, pep = port_case(*encode(cluster, pods))
    cfg = FrameworkConfig(plugins=FIT)
    mk = lambda **kw: TorchReplayEngine(pec, pep, cfg, device="cpu", wave_width=4, **kw)
    ck = str(tmp_path / "ck.npz")
    mk(chunk_waves=4).replay(checkpoint_path=ck, checkpoint_every=3)
    with pytest.raises(ValueError, match="tier planes are not checkpointed"):
        mk(chunk_waves=4, preemption=True).replay(checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="chunk grid"):
        mk(chunk_waves=3).replay(checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="released mask"):
        mk(chunk_waves=4, completions=False).replay(checkpoint_path=ck, resume=True)
    bd = str(tmp_path / "bd.npz")
    mk(chunk_waves=4, retry_buffer=8).replay(checkpoint_path=bd, checkpoint_every=3)
    with pytest.raises(ValueError, match="boundary-mode"):
        mk(chunk_waves=4).replay(checkpoint_path=bd, resume=True)


def test_converters_and_rebuild_fork_state():
    """The numpy helpers against the reference's: the domain / node-space
    converters round-trip, and ``rebuild_fork_state`` reconstructs the
    reference's (host_assign, released) from saved outs at slack 1 and 0."""
    from kubernetes_simulator_tpu.ops import tpu as JT

    ec, ep = _case5(n_pods=120)
    gt = np.clip(ec.group_topo, 0, None)
    gdom = np.where(ec.group_topo[:, None] >= 0, ec.node_domain[gt], -1)
    rng = np.random.default_rng(0)
    D = int(max(ec.max_domains, 1))
    dom = rng.integers(0, 5, (gdom.shape[0], D)).astype(np.float32)
    node = C.domain_to_node_space(dom, gdom)
    np.testing.assert_array_equal(node, JT.domain_to_node_space(dom, gdom))
    np.testing.assert_array_equal(C.node_space_to_domain(node, gdom, D),
                                  JT.node_space_to_domain(node, gdom, D))
    cluster = make_cluster(10, seed=5)
    pods, _ = make_workload(120, seed=5, arrival_rate=20.0, duration_mean=1.5)
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT), device="cpu", wave_width=4,
                            chunk_waves=2)
    res = eng.replay()
    idx, Cw = eng.plan.idx, eng.plan.C
    flat = res.assignments[np.clip(idx, 0, None)]
    outs = [np.where(idx >= 0, flat, -1)[c * Cw:(c + 1) * Cw] for c in range(len(eng.plan.buckets))]
    wt = wave_start_times(pep, idx)
    for slack in (1, 0):
        mine = rebuild_fork_state(pep, idx, Cw, outs, wt, 4, slack=slack)
        theirs = j_rebuild(ep, idx, Cw, outs, wt, 4, slack=slack)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        assert mine[1].any()
