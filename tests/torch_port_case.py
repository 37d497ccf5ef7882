"""Shared helpers of the tests/test_torch_*.py suites: carry an encoded
case and a host state from the JAX package into the PyTorch port through
its public carry-across functions (numpy arrays only), and build the
port's own S-stacked kernel tables. Nothing here imports JAX."""

import dataclasses

import numpy as np

from kubernetes_simulator_tpu_torch.convert import encoded_from_numpy, state_from_numpy


def field_dicts(ec, ep):
    """numpy field dicts of a JAX-package EncodedCluster / EncodedPods,
    the cluster's with the whole interning vocabulary."""
    ecf = {f.name: getattr(ec, f.name) for f in dataclasses.fields(ec) if f.name != "vocab"}
    ecf["resources"] = dict(ec.vocab._r)
    for name in ("keys", "kvs", "namespaces", "topo_keys"):
        ecf[name] = list(getattr(ec.vocab, name))
    epf = {f.name: getattr(ep, f.name) for f in dataclasses.fields(ep)}
    return ecf, epf


def assert_same(a, b, where):
    """Two encoded dataclasses (EncodedCluster / EncodedPods of either
    package) field for field: arrays with their dtypes, the vocabulary's
    tables, the count-group keys by repr, everything else by ==."""
    assert type(a).__name__ == type(b).__name__, where
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f"{where}.{f.name} dtype"
            np.testing.assert_array_equal(va, vb, err_msg=f"{where}.{f.name}")
        elif f.name == "vocab":
            for lst in ("resources", "keys", "kvs", "namespaces", "topo_keys"):
                assert getattr(va, lst) == getattr(vb, lst), f"{where}.vocab.{lst}"
        elif f.name == "group_keys":
            assert [repr(g) for g in va] == [repr(g) for g in vb], f"{where}.group_keys"
        else:
            assert va == vb, f"{where}.{f.name}"


def port_case(ec, ep):
    """The port's (EncodedCluster, EncodedPods) for a JAX-package case."""
    return encoded_from_numpy(*field_dicts(ec, ep))


def port_state(st, device="cpu"):
    """A JAX-package SchedState on ``device`` as the port's CarriedState."""
    return state_from_numpy(
        st.used, st.match_count, st.anti_active, st.pref_wsum, st.bound, device
    )


def assert_state_close(a, b, used_atol, mc_atol):
    """Planes of two host states within the stated tolerances."""
    np.testing.assert_allclose(a.used, b.used, atol=used_atol)
    np.testing.assert_allclose(a.match_count, b.match_count, atol=mc_atol)


def scenario_tables(seed=6):
    """Three scenarios whose allocatable and taints differ (capacity cut,
    node loss, hard and soft injected taints), as one S=3 Tables and as
    three S=1 Tables holding each scenario's cluster rows unstacked."""
    from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
    from kubernetes_simulator_tpu_torch.models.encode import encode as t_encode
    from kubernetes_simulator_tpu_torch.models.state import init_state as t_init
    from kubernetes_simulator_tpu_torch.ops import reference as ref
    from kubernetes_simulator_tpu_torch.sim.synthetic import (
        make_cluster as t_cluster,
        make_workload as t_workload,
    )
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec
    from kubernetes_simulator_tpu_torch.sim.whatif import Perturbation, Scenario, ScenarioSet

    ec, ep = t_encode(
        t_cluster(20, seed=seed, taint_fraction=0.2),
        t_workload(90, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True,
                   gang_fraction=0.2, gang_size=3)[0],
    )
    scen = [
        Scenario([Perturbation("scale_capacity", nodes=np.arange(8), resource="cpu",
                               factor=0.5)]),
        Scenario([Perturbation("node_down", nodes=np.arange(3)),
                  Perturbation("add_taint", nodes=np.arange(3, 9), key="k", value="v",
                               effect="NoSchedule")]),
        Scenario([Perturbation("add_taint", nodes=np.arange(10), key="soft", value="x",
                               effect="PreferNoSchedule")]),
    ]
    ss = ScenarioSet(ec, scen)
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    st = t_init(ec, ep)
    base = ref.cluster_to(ec, "cpu")
    pods = ref.pods_to(ep, "cpu")
    planes = (st.used, st.match_count, st.anti_active, st.pref_wsum)
    batched = ref.Tables(
        ref.cluster_to(ec, "cpu", 3)._replace(allocatable=ss.alloc, taint_key=ss.taint_key, taint_kv=ss.taint_kv,
                      taint_effect=ss.taint_effect),
        pods, ref.stacked_state(*planes, 3, "cpu"), ref.new_scratch(3, ec.num_nodes, "cpu"),
        consts)
    singles = [
        ref.Tables(
            base._replace(allocatable=ss.alloc[s].clone(), taint_key=ss.taint_key[s].clone(),
                          taint_kv=ss.taint_kv[s].clone(),
                          taint_effect=ss.taint_effect[s].clone()),
            pods, ref.stacked_state(*planes, 1, "cpu"), ref.new_scratch(1, ec.num_nodes, "cpu"),
            consts)
        for s in range(3)
    ]
    return ep, batched, singles
