"""The unschedulable-retry buffer in the port's single replay
(``TorchReplayEngine(retry_buffer=...)``) against the JAX package, on the
CPU at small sizes.

Every case of tests/test_retry_device.py is ported to the single replay,
and each is held against ``greedy_replay(retry_buffer=...)`` (the anchor)
and, where it runs, ``JaxReplayEngine(retry_buffer=...)`` (the reference's
host boundary pass). Inputs come from seeds through the JAX package's
generators and are carried into the port as numpy arrays
(tests/torch_port_case.py). Assignments, placed, ``retry_dropped`` and the
summary latency histogram are compared exactly."""

import json

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import PAD, encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

FIT_ONLY = [{"name": "NodeResourcesFit"}]


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def port_replay(ec, ep, plugins=None, **kw):
    pec, pep = port_case(ec, ep)
    return TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu",
                             **kw).replay()


def anchor(ec, ep, plugins=None, W=8, C=1024, RB=0):
    return greedy_replay(ec, ep, J_Config(plugins=plugins), wave_width=W,
                         completions_chunk_waves=C, retry_buffer=RB)


def assert_same(got, want, what):
    bad = np.nonzero(got.assignments != want.assignments)[0]
    assert bad.size == 0, (f"{what}: {bad.size} pods differ, first {bad[:5].tolist()}: "
                           f"port {got.assignments[bad[:5]]} other {want.assignments[bad[:5]]}")
    assert got.placed == want.placed, what
    assert got.retry_dropped == want.retry_dropped, what


def _contended(seed=11, pods=120, **kw):
    cluster = make_cluster(3, seed=seed)
    workload, _ = make_workload(pods, seed=seed, arrival_rate=60.0, duration_mean=1.5,
                                with_spread=True, with_tolerations=True, **kw)
    return encode(cluster, workload)


# -- the cases of tests/test_retry_device.py, in the single replay ---------------


def test_retry_places_after_release_tiny():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=3.0),
        Pod("b", requests={"cpu": 1}, arrival_time=1.0),
        Pod("f1", requests={}, arrival_time=6.0),
        Pod("f2", requests={}, arrival_time=8.0),
    ]
    ec, ep = encode(cluster, pods)
    want = anchor(ec, ep, FIT_ONLY, W=1, C=1, RB=1)
    got = port_replay(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1, retry_buffer=1)
    assert got.assignments[1] == 0 and got.placed == 4
    assert_same(got, want, "greedy_replay")
    off = port_replay(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1)
    assert off.placed == 3  # b permanently missed


def test_retry_parity_random_contended():
    ec, ep = _contended()
    W, C, RB = 4, 4, 8
    want = anchor(ec, ep, W=W, C=C, RB=RB)
    got = port_replay(ec, ep, wave_width=W, chunk_waves=C, retry_buffer=RB)
    assert_same(got, want, "greedy_replay")
    off = port_replay(ec, ep, wave_width=W, chunk_waves=C)
    assert got.placed > off.placed
    retried = (got.assignments >= 0) & (off.assignments == PAD)
    assert retried.any()


def test_retry_buffer_overflow_drops_newest():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=2.0),
        Pod("b", requests={"cpu": 1}, arrival_time=0.5, duration=100.0),
        Pod("c", requests={"cpu": 1}, arrival_time=0.6, duration=100.0),
        Pod("f1", requests={}, arrival_time=5.0),
        Pod("f2", requests={}, arrival_time=8.0),
    ]
    ec, ep = encode(cluster, pods)
    want = anchor(ec, ep, FIT_ONLY, W=1, C=1, RB=1)
    got = port_replay(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1, retry_buffer=1)
    assert got.assignments[1] == 0 and got.assignments[2] == PAD
    assert got.placed == 4 and got.retry_dropped == 1
    assert_same(got, want, "greedy_replay")


def test_retry_placed_pod_releases_later():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=2.0),
        Pod("b", requests={"cpu": 1}, arrival_time=0.5, duration=1.0),
        Pod("f1", requests={}, arrival_time=4.0),
        Pod("f2", requests={}, arrival_time=6.0),
        Pod("c", requests={"cpu": 1}, arrival_time=5.0),
        Pod("f3", requests={}, arrival_time=8.0),
        Pod("f4", requests={}, arrival_time=10.0),
        Pod("f5", requests={}, arrival_time=12.0),
    ]
    ec, ep = encode(cluster, pods)
    want = anchor(ec, ep, FIT_ONLY, W=1, C=1, RB=2)
    got = port_replay(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1, retry_buffer=2)
    # b placed on retry releases through the pending list; c then fits.
    assert got.assignments[1] == 0 and got.assignments[4] == 0
    assert_same(got, want, "greedy_replay")


def test_retry_gang_pods_excluded():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    pods = [
        Pod("a", requests={"cpu": 2}, arrival_time=0.0, duration=2.0),
        Pod("g0", requests={"cpu": 1}, arrival_time=0.5, pod_group="g"),
        Pod("g1", requests={"cpu": 1}, arrival_time=0.5, pod_group="g"),
        Pod("s", requests={"cpu": 1}, arrival_time=0.7),
        Pod("f1", requests={}, arrival_time=5.0),
        Pod("f2", requests={}, arrival_time=8.0),
        Pod("f3", requests={}, arrival_time=10.0),
    ]
    ec, ep = encode(cluster, pods)
    want = anchor(ec, ep, FIT_ONLY, W=2, C=1, RB=2)
    got = port_replay(ec, ep, FIT_ONLY, wave_width=2, chunk_waves=1, retry_buffer=2)
    assert got.assignments[3] == 0
    assert got.assignments[1] == PAD and got.assignments[2] == PAD
    assert_same(got, want, "greedy_replay")


def test_retry_full_plugin_envelope_parity():
    """Anti/pref count planes, multi-topology spread and hostname rows: the
    pending release moves every plane; retry matters."""
    cluster = make_cluster(3, seed=23)
    workload, _ = make_workload(150, seed=23, arrival_rate=60.0, duration_mean=1.5,
                                with_affinity=True, with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, workload)
    W, C, RB = 4, 4, 8
    want = anchor(ec, ep, W=W, C=C, RB=RB)
    got = port_replay(ec, ep, wave_width=W, chunk_waves=C, retry_buffer=RB)
    assert_same(got, want, "greedy_replay")
    assert got.placed > anchor(ec, ep, W=W, C=C).placed


def test_single_replay_engine_retry_matches_greedy():
    """The port against greedy_replay and JaxReplayEngine's host boundary
    pass: assignments, placed, retry_dropped and the carried planes."""
    ec, ep = _contended()
    want = anchor(ec, ep, W=4, C=4, RB=8)
    jax_res = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=4,
                              retry_buffer=8).replay()
    got = port_replay(ec, ep, wave_width=4, chunk_waves=4, retry_buffer=8)
    assert_same(got, want, "greedy_replay")
    assert_same(got, jax_res, "JaxReplayEngine")
    np.testing.assert_array_equal(got.state.used, want.state.used)
    np.testing.assert_array_equal(got.state.match_count, want.state.match_count)


def test_host_and_device_retry_paths_agree():
    """The port's single replay, the JAX host retry pass and the JAX
    what-if's device retry pass place alike."""
    from kubernetes_simulator_tpu.sim.whatif import Scenario, WhatIfEngine

    ec, ep = _contended()
    dev = WhatIfEngine(ec, ep, [Scenario()], J_Config(), wave_width=4, chunk_waves=4,
                       retry_buffer=8).run()
    host = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=4,
                           retry_buffer=8).replay()
    got = port_replay(ec, ep, wave_width=4, chunk_waves=4, retry_buffer=8)
    assert got.placed == host.placed == int(dev.placed[0])
    assert got.retry_dropped == int(dev.retry_dropped[0])


# -- further cases ---------------------------------------------------------------


@pytest.mark.parametrize("seed,W,C,RB", [(1, 8, 2, 8), (2, 4, 3, 4), (3, 2, 5, 16),
                                        (4, 8, 1, 8), (5, 4, 2, 12)])
def test_random_contended_traces_equal_greedy(seed, W, C, RB):
    """Contended full-plugin traces with gangs, short durations and small
    buffers that overflow, over several wave widths, chunk sizes and
    buffer sizes (one not a multiple of the wave width)."""
    cluster = make_cluster(4, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(160, seed=seed, arrival_rate=50.0, duration_mean=2.0,
                                with_affinity=True, with_spread=True, with_tolerations=True,
                                gang_fraction=0.1, gang_size=2)
    ec, ep = encode(cluster, workload)
    want = anchor(ec, ep, W=W, C=C, RB=RB)
    got = port_replay(ec, ep, wave_width=W, chunk_waves=C, retry_buffer=RB,
                      granularity_guard=False)
    assert_same(got, want, "greedy_replay")


def test_buffer_rounds_up_to_the_wave_width():
    """The reference rounds the buffer up to a multiple of the wave width
    in the single replay too (sim/boundary.py BoundaryOps): RB 5 at W 4
    holds 8, and the port drops what greedy_replay and JaxReplayEngine
    drop."""
    ec, ep = _contended(pods=200)
    want = anchor(ec, ep, W=4, C=4, RB=5)
    jax_res = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=4,
                              retry_buffer=5).replay()
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", wave_width=4,
                            chunk_waves=4, retry_buffer=5)
    assert eng.retry_buffer == 8
    got = eng.replay()
    assert got.retry_dropped > 0
    assert_same(got, want, "greedy_replay")
    assert_same(got, jax_res, "JaxReplayEngine")


def test_no_durations_retry_runs_on_the_chunk_grid():
    """With no finite duration nothing releases, yet the reference's host
    pass still runs at every chunk boundary: a pod whose required affinity
    names a pod that has not arrived yet is placed on retry once that pod
    is bound. The port matches JaxReplayEngine and greedy_replay on the
    same grid, on that trace and on a synthetic one."""
    from kubernetes_simulator_tpu.models.core import (
        LabelSelector,
        PodAffinitySpec,
        PodAffinityTerm,
    )

    host = "kubernetes.io/hostname"
    term = PodAffinityTerm(LabelSelector.make({"app": "y"}), host)
    pods = [Pod("x", labels={"app": "x"}, requests={"cpu": 1}, arrival_time=0.0,
                pod_affinity=PodAffinitySpec(required=(term,))),
            Pod("y", labels={"app": "y"}, requests={"cpu": 1}, arrival_time=1.0),
            Pod("f1", requests={}, arrival_time=2.0), Pod("f2", requests={}, arrival_time=3.0)]
    ec, ep = encode(Cluster(nodes=[Node("n0", {"cpu": 4}), Node("n1", {"cpu": 4})]), pods)
    kw = dict(wave_width=1, chunk_waves=1)
    got = port_replay(ec, ep, retry_buffer=1, **kw)
    assert got.assignments[0] == got.assignments[1] >= 0
    assert port_replay(ec, ep, **kw).assignments[0] == PAD
    assert_same(got, JaxReplayEngine(ec, ep, J_Config(), retry_buffer=1, **kw).replay(),
                "JaxReplayEngine")
    assert_same(got, anchor(ec, ep, W=1, C=1, RB=1), "greedy_replay")
    cluster = make_cluster(6, seed=3)
    workload, _ = make_workload(240, seed=3, arrival_rate=40.0, with_spread=True,
                                with_affinity=True)
    ec, ep = encode(cluster, workload)
    assert not np.isfinite(ep.duration).any()
    jax_res = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=3,
                              retry_buffer=16).replay()
    want = anchor(ec, ep, W=4, C=3, RB=16)
    got = port_replay(ec, ep, wave_width=4, chunk_waves=3, retry_buffer=16)
    assert_same(got, jax_res, "JaxReplayEngine")
    assert_same(got, want, "greedy_replay")


def test_granularity_guard_grows_the_buffer_like_the_reference():
    """Durations far below the chunk span: the guard shrinks the chunks and
    grows the buffer to one chunk's failures, in both packages."""
    cluster = make_cluster(3, seed=5)
    workload, _ = make_workload(300, seed=5, arrival_rate=60.0, duration_mean=0.2,
                                with_spread=True)
    ec, ep = encode(cluster, workload)
    with pytest.warns(UserWarning, match="auto-shrinking"):
        jax_res = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=64,
                                  retry_buffer=4).replay()
    pec, pep = port_case(ec, ep)
    with pytest.warns(UserWarning, match="auto-shrinking"):
        eng = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", wave_width=4,
                                chunk_waves=64, retry_buffer=4)
    assert eng.plan.C < 64 and eng.retry_buffer > 4
    got = eng.replay()
    assert_same(got, jax_res, "JaxReplayEngine")


def test_summary_latency_equals_jax_engine():
    """At ``telemetry="summary"`` a pod placed on retry waits from its
    arrival to the start of its boundary; every other placement has
    latency 0. The histogram equals JaxReplayEngine's."""
    ec, ep = _contended()
    jax_res = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=4, retry_buffer=8,
                              telemetry="summary").replay()
    got = port_replay(ec, ep, wave_width=4, chunk_waves=4, retry_buffer=8,
                      telemetry="summary")
    lat, want = got.telemetry.latency, jax_res.telemetry.latency
    assert lat == want
    assert lat["count"] == got.placed and lat["max"] > 0


@pytest.mark.parametrize(
    "kw,exc,match",
    [(dict(retry_buffer=8, preemption=True), ValueError, "tier preemption"),
     (dict(retry_buffer=8, completions=False), ValueError, "completions=False"),
     (dict(retry_buffer=-1), ValueError, "retry_buffer"),
     (dict(retry_buffer=0, preemption="kube"), ValueError, "retry_buffer > 0")],
)
def test_engine_refuses_what_the_reference_refuses(kw, exc, match):
    ec, ep = _contended()
    pec, pep = port_case(ec, ep)
    with pytest.raises(exc, match=match):
        TorchReplayEngine(pec, pep, device="cpu", **kw).replay()
    if exc is ValueError and kw["retry_buffer"] > 0:
        with pytest.raises(ValueError, match=match):
            JaxReplayEngine(ec, ep, J_Config(), **kw).replay()


def test_cli_run_with_a_retry_buffer(tmp_path):
    """``run`` with ``whatIf.retryBuffer``: the replay row's placed and
    retry_dropped equal greedy_replay's on the same config."""
    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu.utils.config import build_encoded_case
    from kubernetes_simulator_tpu_torch import cli

    d = {
        "cluster": {"synthetic": {"nodes": 4, "seed": 4, "taintFraction": 0.2}},
        "workload": {"synthetic": {"pods": 400, "seed": 4, "tolerations": True,
                                   "spread": True, "durationMean": 3.0, "arrivalRate": 100.0}},
        "chunkWaves": 4,
        "whatIf": {"retryBuffer": 8},
        "output": str(tmp_path / "out.jsonl"),
    }
    cfg = tmp_path / "r.yaml"
    cfg.write_text(yaml.safe_dump(d))
    assert cli.main(["run", str(cfg), "--device", "cpu"]) == 0
    row = json.loads((tmp_path / "out.jsonl").read_text().splitlines()[-1])
    jcfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(jcfg)
    want = greedy_replay(ec, ep, jcfg.framework, completions_chunk_waves=4, retry_buffer=8)
    assert row["placed"] == want.placed and row["retry_dropped"] == want.retry_dropped > 0


@pytest.mark.parametrize(
    "extra,match",
    [({"whatIf": {"retryBuffer": -1}}, "must be >= 0"),
     ({"whatIf": {"retryBuffer": 8}, "devicePreemption": True}, "tier devicePreemption"),
     ({"whatIf": {"retryBuffer": 8, "completions": False}}, "completions: false")],
)
def test_config_refuses_what_validate_refuses(extra, match):
    """The JAX package's ``validate`` refusals of a retry buffer
    (kubernetes_simulator_tpu/cli.py:705-730) raise ValueError at parse."""
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    with pytest.raises(ValueError, match=match):
        SimConfig.from_dict({"cluster": {"synthetic": {"nodes": 4}}, **extra})


def test_config7_parses_like_the_reference():
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    path = "examples/config7_retry_completions.yaml"
    got, want = SimConfig.load(path), J_SimConfig.load(path)
    assert got.whatif.retry_buffer == want.whatif.retry_buffer == 256
    assert (got.whatif.scenarios, got.chunk_waves, got.whatif.completions) == (
        want.whatif.scenarios, want.chunk_waves, want.whatif.completions)


def test_wrappers_take_the_twins_on_cpu_under_the_buffer():
    """A retry replay on CPU tensors runs every wrapper's twin (the retry
    pass placed pods, K4 recorded them) and counts no launch."""
    from kubernetes_simulator_tpu_torch.ops import kernels as K

    ec, ep = _contended()
    pec, pep = port_case(ec, ep)
    K.reset_launch_counts()
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", wave_width=4,
                            chunk_waves=4, retry_buffer=8)
    eng.replay()
    assert int((eng.last_tables.retry.rnode >= 0).sum()) > 0
    assert K.launch_counts() == dict.fromkeys(
        ("filter_score", "normalize_select", "apply_placements", "retry_boundary",
         "first_reject", "first_reject_fold", "chunk_replay", "shard_select", "shard_apply",
         "shard_chunk_replay", "evict_node", "apply_placements_bind", "apply_placements_rollback",
         "apply_placements_release", "shard_apply_bind", "shard_apply_rollback",
         "shard_apply_release"), 0)
