"""K6's attributed mode on the CPU: the plain twin ``ops.reference.chunk_replay``
with ``reject=`` (the counters K5 takes) held against

- the per-slot twin chain over the same waves — K1 (``filter_score``) →
  K2 (``normalize_select``) → K5 (``first_reject``, gated on the slot's
  choice before the wave's rollback) → K3 bind a slot, and K3's rollback
  after a gang wave — in reasons, attempts, episode marks, the choice
  buffer and every state plane, exactly; over a trace whose gang waves
  hold failed members, rolled-back members and padded slots, at S = 1
  (the single replay) and S = 3 (a what-if batch);
- the JAX package's instrumented chunk program,
  ``kubernetes_simulator_tpu/sim/jax_runtime.py:443`` ``make_chunk_fn_rej``,
  chunk by chunk from the same initial state: its carried ``[K]`` counts
  equal the port's attempts (and reasons: every plain-path failure is
  terminal) and its choices the port's, exactly;

and the wrapper's refusals (tier preemption, counters of another shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.ops import tpu as J_T
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine, make_chunk_fn_rej
from kubernetes_simulator_tpu.sim.synthetic import make_cluster as j_make_cluster
from kubernetes_simulator_tpu.sim.synthetic import make_workload as j_make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine, new_choices
from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

from torch_port_case import port_case

W = 8


def _contended(seed=5, nodes=4, pods=200):
    """A contended trace with the full default plugin set: taints,
    affinity, spread, tolerations, gangs of 3 (a tenth of the pods); no
    durations, so nothing releases inside a chunk."""
    cluster = j_make_cluster(nodes, seed=seed, taint_fraction=0.25)
    workload, _ = j_make_workload(pods, seed=seed, arrival_rate=80.0, with_affinity=True,
                                  with_spread=True, with_tolerations=True, gang_fraction=0.1,
                                  gang_size=3)
    return j_encode(cluster, workload)


def _engine(S, chunk_waves=4):
    jec, jep = _contended()
    ec, ep = port_case(jec, jep)
    if S == 1:
        return TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=W,
                                 chunk_waves=chunk_waves, device="cpu", telemetry="series")
    scen = uniform_scenarios(ec, S, seed=2, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    return WhatIfEngine(ec, ep, scen, FrameworkConfig(), wave_width=W, chunk_waves=chunk_waves,
                        device="cpu")


def _fresh(eng):
    tb = eng._tables(attribute=True)
    return tb, new_choices(eng.plan, eng.S, eng.pods.bound_node, "cpu")


def _slot_chain(tb, idx, gang, choices, first, end):
    """The per-slot twin chain of K6's attributed mode over waves [first, end);
    returns (failed slots charged by K5 with a non-PAD gate after the
    rollback, rolled-back members, padded slots in gang waves)."""
    pos = torch.arange(choices.shape[1], dtype=torch.int32)
    rows = idx.tolist()
    seen = dict(rolled_back=0, failed_gang=0, padded_gang=0)
    for w in range(first, end):
        base = w * W
        for s in range(base, base + W):
            p = rows[s]
            if p < 0:
                seen["padded_gang"] += int(bool(gang[w]))
                continue
            ref.filter_score(tb, p)
            ref.normalize_select(tb, p, choices, s, w)
            ref.first_reject(tb, idx[s : s + 1], choices[:, s : s + 1])
            seen["failed_gang"] += int(bool(gang[w])) * int((choices[:, s] < 0).sum())
            ref.apply_placements(tb, idx[s : s + 1], pos[s : s + 1], choices, 1.0)
        if gang[w]:
            before = choices[:, base : base + W].clone()
            ref.apply_placements(tb, idx[base : base + W], pos[base : base + W], choices, -1.0,
                                 rollback=True)
            seen["rolled_back"] += int(((before >= 0) & (choices[:, base : base + W] < 0)).sum())
    return seen


def _same(tb_a, ch_a, tb_b, ch_b):
    assert torch.equal(ch_a, ch_b)
    for part in ("state", "scratch", "reject"):
        for name, x, y in zip(getattr(tb_a, part)._fields, getattr(tb_a, part),
                              getattr(tb_b, part)):
            assert torch.equal(x, y), f"{part}.{name}"


@pytest.mark.parametrize("S", [1, 3])
def test_attributed_twin_equals_the_per_slot_chain(S):
    eng = _engine(S)
    plan = eng.plan
    desc = plan.device_desc("cpu")
    end = plan.idx.shape[0]
    tb_a, ch_a = _fresh(eng)
    tb_b, ch_b = _fresh(eng)
    for c0 in range(0, end, plan.C):  # a launch a chunk, as run_waves enqueues them
        ref.chunk_replay(tb_a, desc.idx, desc.gang, ch_a, c0, min(end, c0 + plan.C),
                         reject=tb_a.reject)
    seen = _slot_chain(tb_b, desc.idx, desc.gang, ch_b, 0, end)
    _same(tb_a, ch_a, tb_b, ch_b)
    rj = tb_a.reject
    # The trace exercises what the gate decides: failures charged, gang
    # members rolled back (not charged), padded slots in gang waves.
    assert int(rj.attempts.sum()) > 0 and bool((rj.attempts == rj.reasons).all())
    assert seen["rolled_back"] > 0 and seen["failed_gang"] > 0 and seen["padded_gang"] > 0
    charged = int(rj.attributed.sum())
    assert int(rj.reasons.sum()) == charged * eng.ec.num_nodes


def test_wrapper_on_cpu_tensors_runs_the_attributed_twin():
    """K.chunk_replay(reject=) on CPU tables is the twin (no launch
    counted), attributed or not."""
    eng = _engine(1)
    plan = eng.plan
    desc = plan.device_desc("cpu")
    tb_a, ch_a = _fresh(eng)
    tb_b, ch_b = _fresh(eng)
    K.reset_launch_counts()
    K.chunk_replay(K.Bound(tb_a), desc.idx, desc.gang, ch_a, 0, plan.C, reject=tb_a.reject)
    ref.chunk_replay(tb_b, desc.idx, desc.gang, ch_b, 0, plan.C, reject=tb_b.reject)
    _same(tb_a, ch_a, tb_b, ch_b)
    assert K.chunk_replay.launches == K.chunk_replay.attributed == 0


def test_attributed_twin_equals_make_chunk_fn_rej():
    """Chunk by chunk from the initial state, the twin with ``reject`` and
    the reference's instrumented chunk program give the same choices and
    the same [K] counts."""
    jec, jep = _contended()
    C = 4
    j = JaxReplayEngine(jec, jep, J_Config(), wave_width=W, chunk_waves=C, telemetry="series")
    fn = make_chunk_fn_rej(W, j.spec)
    j_state = j._init_dev_state(force_v2=True)
    eng = _engine(1, chunk_waves=C)
    plan = eng.plan
    # the plan pads the wave list to whole chunks, as the reference's replay does
    n = j.waves.idx.shape[0]
    np.testing.assert_array_equal(plan.idx[:n], j.waves.idx)
    assert (plan.idx[n:] == -1).all()
    desc = plan.device_desc("cpu")
    tb, ch = _fresh(eng)
    rej = jnp.zeros(tb.reject.reasons.shape[1], jnp.int32)
    end = plan.idx.shape[0]
    for c0 in range(0, end, C):
        hi = min(end, c0 + C)
        j_state, rej, j_ch = fn(j.dc, j_state, rej, J_T.gather_slots(j.pods, plan.idx[c0:hi]))
        ref.chunk_replay(tb, desc.idx, desc.gang, ch, c0, hi, reject=tb.reject)
        np.testing.assert_array_equal(ch[0, c0 * W : hi * W].numpy(),
                                      np.asarray(j_ch).reshape(-1))
        np.testing.assert_array_equal(tb.reject.attempts[0].numpy(), np.asarray(rej))
    assert int(np.asarray(rej).sum()) > 0
    np.testing.assert_array_equal(tb.reject.reasons[0].numpy(), np.asarray(rej))


def test_wrapper_refusals():
    eng = _engine(1)
    desc = eng.plan.device_desc("cpu")
    tb, ch = _fresh(eng)
    bad = tb.reject._replace(attributed=tb.reject.attributed[:, :1].contiguous())
    with pytest.raises(ValueError, match="reject.attributed"):
        K.chunk_replay(K.Bound(tb), desc.idx, desc.gang, ch, 0, 1, reject=bad)
    pre = TorchReplayEngine(eng.ec, eng.pods, FrameworkConfig(), wave_width=W, chunk_waves=4,
                            device="cpu", preemption=True)
    tbp = pre._tables()
    rj = ref.new_reject(tb.reject.reasons.shape[1], eng.pods.num_pods, 1, "cpu")
    with pytest.raises(ValueError, match="without tier preemption"):
        K.chunk_replay(K.Bound(tbp), desc.idx, desc.gang, ch, 0, 1, boundary=0, reject=rj)
