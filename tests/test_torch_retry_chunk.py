"""K6's retry mode — the retry chunk program's boundary sequence inside the
chunk launch (``chunk_replay(retry=(b, t_b, pending))``; the reference's
sim/whatif.py:1413 ``per_scenario_retry``, :1433-1494) — on the CPU, through
its plain twin.

- The twin ``ref.chunk_replay(retry=...)`` equals the per-slot route's
  boundary sequence, ``run_retry_boundary`` (K3's pending release, K1 → K2
  → K3 a buffer slot, K4), followed by ``ref.chunk_replay`` over the waves:
  every state and scratch plane, every retry record, the choice buffer and,
  at series, the reject counters and the boundary samples, after every
  chunk. Parametrised over seeds, wave widths, chunk sizes, buffer sizes,
  the joint release order and not, buffers that overflow and boundaries
  whose buffers are empty.
- The what-if on the chunk route equals the JAX ``WhatIfEngine(retry_buffer
  =...)`` (placed and drops exact, ``utilization_cpu`` within the ``used``
  tolerance of tests/test_jax_parity.py::assert_parity, atol 1e-3) and,
  scenario by scenario, ``greedy_replay``.
- The single replay on the chunk route equals ``greedy_replay(retry_buffer
  =...)`` (assignments, placed and drops exact; ``used`` atol 1e-3 and the
  count planes atol 1e-5, assert_parity's), which the port follows where
  ``JaxReplayEngine(retry_buffer=...)`` differs (ROADMAP §C).
- Series and timeline on the retry path (K6 charging the retry pass, K5
  folding the chunks) equal ``JaxReplayEngine``'s reasons, attempts, events
  and latency exactly and its gauges within atol 1e-3.

Inputs come from seeds through the JAX package's generators, carried into
the port as numpy arrays (tests/torch_port_case.py). Every run here is
checked to have taken the chunk route's retry mode: ``run_retry_boundary``
(the per-slot route's sequence) is replaced by a function that fails."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim import torch_runtime as TR
from kubernetes_simulator_tpu_torch.sim import whatif as T

from torch_port_case import port_case

USED_ATOL = 1e-3  # assert_parity's tolerance on ``used`` (f32 sums)
PLANE_ATOL = 1e-5  # and on the count planes
EXACT_KEYS = ("t", "retry_depth", "pend_depth")


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture
def chunk_route_only(monkeypatch):
    """Fail any use of the per-slot route's boundary sequence: the run under
    test must take K6's retry mode."""
    def refuse(*a, **kw):
        raise AssertionError("run_retry_boundary ran on the chunk route")
    monkeypatch.setattr(TR, "run_retry_boundary", refuse)


def _trace(seed, nodes=3, pods=240, rate=60.0, duration=1.5):
    """A contended seeded trace with the full default plugin set, gangs and
    completions."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(pods, seed=seed, arrival_rate=rate, duration_mean=duration,
                                with_affinity=True, with_spread=True, with_tolerations=True,
                                gang_fraction=0.1, gang_size=3)
    return encode(cluster, workload)


def _port_scenarios(scen):
    return [T.Scenario([T.Perturbation(**dataclasses.asdict(pt)) for pt in sc.perturbations])
            for sc in scen]


def _all_planes(tb):
    out = {}
    for part in ("state", "scratch", "retry", "reject"):
        nt = getattr(tb, part)
        if nt is not None:
            out.update({f"{part}.{f}": x for f, x in zip(nt._fields, nt) if torch.is_tensor(x)})
    return out


# -- the twin of K6's retry mode against the per-slot boundary sequence -------------

#: (seed, W, C, RB, S, joint, series, what the case must show)
TWIN_CASES = [
    (11, 8, 2, 16, 1, True, False, "overflow"),
    (12, 4, 3, 8, 3, False, False, "overflow"),
    (18, 4, 5, 16, 2, False, True, "overflow"),
    (14, 8, 1, 64, 1, True, True, "empty"),
    (15, 4, 2, 12, 3, False, True, "empty"),
    (16, 8, 2, 24, 1, False, False, "empty"),
]


@pytest.mark.parametrize("seed,W,C,RB,S,joint,series,shows", TWIN_CASES)
def test_twin_equals_run_retry_boundary_then_chunk_replay(seed, W, C, RB, S, joint, series,
                                                          shows):
    """Chunk by chunk from the initial state, two copies of the tables take
    the same releases at each boundary (the single replay's joint release
    with ``joint``, else the static bucket), then (a) ``run_retry_boundary``
    with the twins and ``ref.chunk_replay`` over the chunk's waves, (b)
    ``ref.chunk_replay(retry=(b, t_b, not joint))`` — with ``series`` the
    retry pass charged (K5's twin in (a), ``reject=`` in (b)), the chunk
    folded and the samples taken as run_waves takes them. Every plane,
    record, choice, counter and sample equal after each chunk."""
    ec, ep = _trace(seed)
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=W, chunk_waves=C, retry_buffer=RB, granularity_guard=False,
              device="cpu")
    if S == 1:
        eng = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), **kw)
    else:
        scen = J.uniform_scenarios(ec, S, seed=seed, p_node_down=0.5, p_capacity=0.5)
        eng = T.WhatIfEngine(pec, pep, _port_scenarios(scen), FrameworkConfig(), **kw)
    plan = eng.plan
    assert len(plan.buckets) >= 4
    tbs = [eng._tables(attribute=series) for _ in range(2)]
    chs = [TR.new_choices(plan, eng.S, "cpu") for _ in range(2)]
    sers = [TR.new_series(plan, tb, True) if series else None for tb in tbs]
    desc = plan.device_desc("cpu")
    RBe = tbs[0].retry.rbuf.shape[1]
    pos_rb = torch.arange(RBe, dtype=torch.int32)
    fns = (ref.filter_score, ref.normalize_select, ref.apply_placements, ref.retry_boundary)
    CW = plan.C * plan.idx.shape[1]
    held = empty = 0
    for c in range(len(plan.buckets)):
        lo, hi = c * plan.C, (c + 1) * plan.C
        bucket = (tuple(torch.as_tensor(x) for x in plan.buckets[c])
                  if plan.buckets[c] is not None else None)
        for tb, ch, ser in zip(tbs, chs, sers):
            if series and c > 0:  # chunk c-1's fold against the chunk's start planes
                cols = slice((c - 1) * CW, c * CW)
                ref.first_reject(tb._replace(state=ser.snap), desc.idx[cols], ch[:, cols])
            if joint and c > 0:
                TR.joint_release(c, tb, ref.apply_placements, tb.retry, ch, bucket)
            elif bucket is not None:
                ref.apply_placements(tb, *bucket, ch, -1.0)
        if c == 0:
            for tb, ch, ser in zip(tbs, chs, sers):
                if series:
                    if np.isfinite(plan.tb[0]):
                        ser.used[0].copy_(tb.state.used)
                        ser.rcount[0].copy_(tb.retry.rcount)
                        ser.pend[0].copy_(tb.retry.pend_id)
                    for dst, src in zip(ser.snap, tb.state):
                        dst.copy_(src)
                ref.chunk_replay(tb, desc.idx, desc.gang, ch, lo, hi, append=True)
        else:
            n = int(tbs[0].retry.rcount.max())
            held += n > 0
            empty += n == 0
            t_b = float(np.float32(plan.tb[c]))
            (ta, tb_), (ca, cb), (sa, sb) = tbs, chs, sers
            TR.run_retry_boundary(plan, c, ta, fns, ta.retry, pos_rb,
                                  ref.first_reject if series else None, joint)
            samples = None
            if series:
                fin = np.isfinite(plan.tb[c])
                if fin:
                    sa.used[c].copy_(ta.state.used)
                    sa.rcount[c].copy_(ta.retry.rcount)
                    sa.pend[c].copy_(ta.retry.pend_id)
                for dst, src in zip(sa.snap, ta.state):
                    dst.copy_(src)
                samples = ref.RetrySamples(
                    *((sb.used[c], sb.rcount[c], sb.pend[c]) if fin else (None,) * 3), sb.snap)
            ref.chunk_replay(ta, desc.idx, desc.gang, ca, lo, hi, append=True)
            ref.chunk_replay(tb_, desc.idx, desc.gang, cb, lo, hi, append=True,
                             reject=tb_.reject if series else None, retry=(c, t_b, not joint),
                             samples=samples)
        assert torch.equal(chs[0], chs[1]), c
        a, b = _all_planes(tbs[0]), _all_planes(tbs[1])
        for name in a:
            assert torch.equal(a[name], b[name]), (c, name)
        if series:
            for f in ("used", "rcount", "pend"):
                assert torch.equal(getattr(sers[0], f), getattr(sers[1], f)), (c, f)
            for x, y in zip(sers[0].snap, sers[1].snap):
                assert torch.equal(x, y), c
    rt = tbs[1].retry
    assert held > 0 and int((rt.rnode >= 0).sum()) > 0
    if shows == "overflow":
        assert int(rt.rdrop.sum()) > 0
    else:
        assert empty > 0
    if series:
        assert int(tbs[1].reject.attempts.sum()) > 0


def test_twin_refusals():
    """What K6's retry mode refuses on any device: no retry tables, tier
    preemption with the buffer (as the reference), a boundary at 0, no
    failure append, samples without a boundary, counters on retry tables
    without a boundary (the chunk fold charges the waves)."""
    from kubernetes_simulator_tpu_torch.ops import kernels as K

    ec, ep = _trace(11)
    pec, pep = port_case(ec, ep)
    eng = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), wave_width=8, chunk_waves=2,
                               retry_buffer=16, device="cpu")
    plain = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), wave_width=8, chunk_waves=2,
                                 device="cpu")
    desc = eng.plan.device_desc("cpu")
    for e, kw, match in (
            (plain, dict(retry=(1, 0.0, True), append=False), "needs retry tables"),
            (eng, dict(retry=(0, 0.0, True), append=True), "boundary b > 0"),
            (eng, dict(retry=(1, 0.0, True), append=False), "boundary b > 0"),
            (eng, dict(append=True, samples=ref.RetrySamples(None, None, None, None)),
             "retry boundary"),
            (eng, dict(append=True, reject="counters"), "chunk fold")):
        tb = e._tables()
        if kw.get("reject") == "counters":
            tb = e._tables(attribute=True)
            kw["reject"] = tb.reject
        ch = TR.new_choices(e.plan, 1, "cpu")
        with pytest.raises(ValueError, match=match):
            K.chunk_replay(K.Bound(tb), desc.idx, desc.gang, ch, 2, 4, **kw)
    tb = eng._tables()
    pre = ref.new_preempt(np.zeros(pep.num_pods, np.int32), pep.group_id,
                          np.zeros(tb.state.used.shape[0], np.int32), np.zeros(1, np.int32), 0,
                          np.zeros((1,) + tuple(tb.state.used.shape[1:]), np.float32),
                          np.zeros((1, tb.state.used.shape[1]), np.float32), 1, "cpu")
    with pytest.raises(ValueError, match="tier preemption"):
        K.chunk_replay(K.Bound(tb._replace(preempt=pre)), desc.idx, desc.gang,
                       TR.new_choices(eng.plan, 1, "cpu"), 2, 4,
                       append=True, retry=(1, 0.0, True))


# -- the chunk route's retry mode against the JAX package --------------------------


@pytest.mark.parametrize("seed,W,C,RB", [(11, 8, 2, 16), (18, 4, 5, 32)])
def test_whatif_chunk_route_equals_jax_whatif(seed, W, C, RB, chunk_route_only):
    """The port's what-if on the chunk route (K6's retry mode's twin at every
    boundary past 0) against the JAX ``WhatIfEngine(retry_buffer=...)``:
    placed and drops exact, ``utilization_cpu`` within atol 1e-3; each
    scenario's assignments, placed and drops equal ``greedy_replay`` on its
    perturbed cluster."""
    ec, ep = _trace(seed, nodes=4, pods=200)
    scen = J.uniform_scenarios(ec, 3, seed=seed, p_node_down=0.5, p_capacity=0.5,
                               p_taint=0.5)
    kw = dict(wave_width=W, chunk_waves=C, retry_buffer=RB)
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, _port_scenarios(scen), FrameworkConfig(), device="cpu",
                         **kw)
    res = eng.run()
    assert res.route == "chunk"
    _, _, assignments, placed, _ = eng._run()
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(), **kw).run()
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_array_equal(res.retry_dropped, jres.retry_dropped)
    np.testing.assert_allclose(res.utilization_cpu, jres.utilization_cpu, rtol=0,
                               atol=USED_ATOL)
    np.testing.assert_array_equal(placed, res.placed)
    clusters = J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec)
    for s, ecs in enumerate(clusters):
        g = greedy_replay(ecs, ep, J_Config(), wave_width=W, completions_chunk_waves=C,
                          retry_buffer=eng.retry_buffer)
        np.testing.assert_array_equal(assignments[s], g.assignments, err_msg=str(s))
        assert (int(res.placed[s]), int(res.retry_dropped[s])) == (g.placed, g.retry_dropped)
    assert int((eng.last_tables.retry.rnode >= 0).sum()) > 0


@pytest.mark.parametrize("seed,W,C,RB", [(11, 8, 2, 16), (12, 4, 3, 8), (14, 4, 5, 16),
                                        (15, 8, 1, 8)])
def test_replay_chunk_route_equals_greedy(seed, W, C, RB, chunk_route_only):
    """The single replay on the chunk route (the joint release order, K6's
    retry mode skipping the pending release K3 took) against
    ``greedy_replay(retry_buffer=...)``: assignments, placed and drops exact,
    ``used`` atol 1e-3 and the count planes atol 1e-5."""
    ec, ep = _trace(seed, pods=200)
    want = greedy_replay(ec, ep, J_Config(), wave_width=W, completions_chunk_waves=C,
                         retry_buffer=RB)
    pec, pep = port_case(ec, ep)
    got = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), wave_width=W, chunk_waves=C,
                               retry_buffer=RB, granularity_guard=False,
                               device="cpu").replay()
    assert got.route == "chunk"
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert (got.placed, got.retry_dropped) == (want.placed, want.retry_dropped)
    np.testing.assert_allclose(got.state.used, want.state.used, rtol=0, atol=USED_ATOL)
    for f in ("match_count", "anti_active", "pref_wsum"):
        np.testing.assert_allclose(getattr(got.state, f), getattr(want.state, f), rtol=0,
                                   atol=PLANE_ATOL, err_msg=f)


@pytest.mark.parametrize("seed,C,RB,granularity", [(11, 2, 16, "series"),
                                                  (12, 3, 8, "timeline")])
def test_series_on_the_retry_path_equals_jax_engine(seed, C, RB, granularity,
                                                    chunk_route_only):
    """Telemetry series/timeline on the retry path's chunk route (K6's retry
    mode charging each failed retry-pass slot and copying the boundary's
    samples, K5 folding each chunk) against ``JaxReplayEngine``: assignments,
    reasons, attempts, latency and events exact, the series' times and
    depths exact and its gauges within atol 1e-3."""
    ec, ep = _trace(seed)
    kw = dict(wave_width=8, chunk_waves=C, retry_buffer=RB, telemetry=granularity)
    j = JaxReplayEngine(ec, ep, J_Config(), **kw).replay()
    pec, pep = port_case(ec, ep)
    t = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", **kw).replay()
    assert t.route == "chunk"
    np.testing.assert_array_equal(t.assignments, j.assignments)
    assert (t.placed, t.retry_dropped) == (j.placed, j.retry_dropped)
    a, b = j.telemetry, t.telemetry
    assert (b.reasons, b.rejection_attempts) == (a.reasons, a.rejection_attempts)
    assert sum(b.rejection_attempts.values()) > sum(b.reasons.values()) > 0
    assert (b.latency, b.events) == (a.latency, a.events)
    assert list(b.series) == list(a.series)
    for k, v in a.series.items():
        if k in EXACT_KEYS:
            assert b.series[k] == v, k
        else:
            np.testing.assert_allclose(b.series[k], v, rtol=0, atol=USED_ATOL, err_msg=k)
    assert max(b.series["retry_depth"]) > 0 and max(b.series["pend_depth"]) > 0
