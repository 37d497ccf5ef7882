"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the test, never at collection)
where torch has no CUDA device. On the card, run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: none — the kernels keep the twins' operation order, and are
compiled without FMA contraction and with IEEE division."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.models.encode import PAD, encode
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec, TorchReplayEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, nodes=64, pods=600, **kw):
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(pods, seed=seed, with_affinity=True, with_spread=True,
                                with_tolerations=True, **kw)
    return encode(cluster, workload)


@pytest.mark.parametrize("seed", range(3))
def test_kernels_equal_twins(card, seed):
    ec, ep = _case(seed, gang_fraction=0.1, gang_size=3)
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    cl, pods = ref.cluster_to(ec, card), ref.pods_to(ep, card)
    G, D = cl.gdom.shape[0], max(ec.max_domains, 1)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=card)
    st_k = ref.DevState(z(ec.num_nodes, ec.num_resources), z(G, D), z(G, D), z(G, D))
    st_t = ref.DevState(*(t.clone() for t in st_k))
    tb_k = ref.Tables(cl, pods, st_k, ref.new_scratch(ec.num_nodes, card), consts)
    tb_t = ref.Tables(cl, pods, st_t, ref.new_scratch(ec.num_nodes, card), consts)
    b = K.Bound(tb_k)
    ids = torch.arange(ep.num_pods, dtype=torch.int32, device=card)
    ch_k = torch.full((ep.num_pods,), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    for p in range(ep.num_pods):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        for f in ref.Scratch._fields:
            assert torch.equal(getattr(tb_k.scratch, f), getattr(tb_t.scratch, f)), (p, f)
        K.normalize_select(b, p, ch_k[p : p + 1])
        ref.normalize_select(tb_t, p, ch_t[p : p + 1])
        assert int(ch_k[p]) == int(ch_t[p]), p
        K.apply_placements(b, ids[p : p + 1], ch_k[p : p + 1], 1.0)
        ref.apply_placements(tb_t, ids[p : p + 1], ch_t[p : p + 1], 1.0)
    rel = torch.nonzero(ch_k >= 0).flatten()[::3].to(torch.int32)
    K.apply_placements(b, rel, ch_k[rel.long()].contiguous(), -1.0)
    ref.apply_placements(tb_t, rel, ch_t[rel.long()].contiguous(), -1.0)
    torch.cuda.synchronize()
    for f in ref.DevState._fields:
        assert torch.equal(getattr(st_k, f), getattr(st_t, f)), f


def test_replay_kernel_path_equals_plain_path(card):
    ec, ep = _case(7, nodes=40, pods=800, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    kw = dict(wave_width=4, chunk_waves=8)
    K.reset_launch_counts()
    kern = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw).replay()
    assert all(n > 0 for n in K.launch_counts().values())
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, plain=True, **kw).replay()
    cpu = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()
    np.testing.assert_array_equal(kern.assignments, plain.assignments)
    np.testing.assert_array_equal(kern.assignments, cpu.assignments)
    np.testing.assert_array_equal(kern.state.used, cpu.state.used)
