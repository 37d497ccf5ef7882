"""Paged pod waves of the port's single replay (``sim/pager.py``) on the CPU:
paged against resident pod tables, replicated (the chunk route, K6's twin
reading each page) and node-sharded (the shard route), as the JAX
package's tests/test_node_sharding.py::test_paged_parity; a page's rows and
ids; the gang guard of ``pack_waves(page_pods=...)``; and the CLI ``run`` of
a Borg config with ``nodeShards`` and ``pagedWaves`` against the JAX CLI.

Tolerance: none — assignments, placed, unschedulable and ``used`` exact."""

import json

import numpy as np
import pytest
import torch
import yaml

from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.pager import PodPager
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case


def _case(n_nodes=24, n_pods=220, seed=7, **kw):
    """tests/test_node_sharding.py:_case (24 nodes x 220 pods, taints,
    affinity, spread, tolerations, gangs of 4, durationMean 40)."""
    cluster = make_cluster(n_nodes, seed=seed, taint_fraction=0.2)
    args = dict(with_affinity=True, with_spread=True, with_tolerations=True,
                gang_fraction=0.1, gang_size=4, duration_mean=40.0)
    args.update(kw)
    pods, _ = make_workload(n_pods, seed=seed, **args)
    return port_case(*j_encode(cluster, pods))


@pytest.fixture(scope="module")
def resident():
    ec, ep = _case()
    return ec, ep, TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4,
                                     device="cpu").replay()


@pytest.mark.parametrize("shards", (1, 4))
def test_paged_equals_resident(resident, shards):
    """The _case trace, chunkWaves 4: paged on and off, replicated and over 4
    node shards, place alike; the paged run keeps no whole-trace pod tables
    and prefetches every page but the first."""
    ec, ep, want = resident
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4, device="cpu",
                            node_shards=shards, paged=True)
    res = eng.replay()
    assert res.route == ("shard" if shards > 1 else "chunk")
    assert eng._pods is None
    assert eng.last_pager.prefetches == len(eng.plan.buckets) - 1
    assert eng.last_pager.stalls >= 1
    np.testing.assert_array_equal(res.assignments, want.assignments)
    assert (res.placed, res.unschedulable) == (want.placed, want.unschedulable)
    np.testing.assert_array_equal(res.state.used, want.state.used)


def test_paged_plain_slot_route_equals_resident(resident):
    """The twins on the per-slot route (``plain=True``) read the pages too."""
    ec, ep, want = resident
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4, device="cpu",
                            paged=True, plain=True)
    res = eng.replay()
    assert res.route == "slot"
    np.testing.assert_array_equal(res.assignments, want.assignments)


def test_page_rows_and_ids():
    """Page c holds the pod rows of chunk c's slots in slot order, then its
    boundary's released pods; the plan's page index names each slot's row,
    and the page's release ids name the bucket's rows."""
    ec, ep = _case()
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4, device="cpu", paged=True)
    plan = eng.plan
    pager = PodPager(ep, plan.idx, plan.C, plan.buckets, "cpu")
    local = plan.page_idx()
    full = ref.pods_to(ep, "cpu")
    CW = plan.C * plan.idx.shape[1]
    try:
        checked = 0
        for c in range(len(plan.buckets)):
            page = pager.get(c)
            if c + 1 < len(plan.buckets):
                pager.prefetch(c + 1)
            rows = plan.idx[c * plan.C:(c + 1) * plan.C].reshape(-1)
            loc = local[c * plan.C:(c + 1) * plan.C].reshape(-1)
            assert np.array_equal(loc >= 0, rows >= 0)
            for f in ref.DevPods._fields:
                got, want = getattr(page.pods, f), getattr(full, f)
                v = rows >= 0
                assert torch.equal(got[torch.as_tensor(loc[v]).long()],
                                   want[torch.as_tensor(rows[v]).long()]), (c, f)
            bk = plan.buckets[c]
            if bk is None:
                assert page.rel_ids is None
            else:
                assert page.rel_ids.tolist() == list(range(CW, CW + len(bk[0])))
                assert torch.equal(page.pods.requests[page.rel_ids.long()],
                                   full.requests[torch.as_tensor(bk[0]).long()])
                checked += 1
            pager.done(page)
        assert checked > 0 and pager.rows >= CW
    finally:
        pager.close()


def test_page_smaller_than_largest_gang_raises():
    """tests/test_node_sharding.py::test_pack_waves_rejects_page_smaller_than_gang
    for the port: a page must hold the largest gang; the engine pages
    chunkWaves x waveWidth slots."""
    from kubernetes_simulator_tpu_torch.sim.waves import pack_waves

    ec, ep = _case(n_nodes=8, n_pods=64, gang_fraction=0.5, gang_size=8,
                   with_affinity=False, with_spread=False, with_tolerations=False)
    with pytest.raises(ValueError, match="largest gang"):
        pack_waves(ep, 8, page_pods=4)
    assert pack_waves(ep, 8, page_pods=8).idx.shape[1] == 8
    with pytest.raises(ValueError, match="largest gang"):
        TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=0, device="cpu",
                          paged=True)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=1,
                            device="cpu", paged=True)
    assert eng.plan.C * eng.wave_width >= 8


def test_cli_run_sharded_paged_borg(tmp_path, capsys, caplog):
    """A small Borg config with nodeShards: 4 and pagedWaves: true (the
    shape of examples/config13_borgscale.yaml) through the port's CLI on the
    CPU: one replay row placing what the JAX CLI places, on the shard
    route."""
    from kubernetes_simulator_tpu import cli as J_cli
    from kubernetes_simulator_tpu_torch import cli

    cfgp = tmp_path / "b.yaml"
    cfgp.write_text(yaml.safe_dump({
        "strategy": "jax", "nodeShards": 4, "pagedWaves": True, "chunkWaves": 16,
        "workload": {"borg": {"nodes": 12, "tasks": 1500, "seed": 0, "gangFraction": 0.08,
                              "maxGang": 8}},
    }))

    def row(main, extra):
        capsys.readouterr()
        assert main(["run", str(cfgp)] + extra) == 0
        lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
        return json.loads(lines[-1])

    with caplog.at_level("INFO"):
        got = row(cli.main, ["--device", "cpu"])
    assert "route shard" in caplog.text
    want = row(J_cli.main, [])
    assert got["kind"] == "replay-torch"
    for k in ("placed", "unschedulable", "attempts", "seed"):
        assert got[k] == want[k], k
