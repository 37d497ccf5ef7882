"""The port's host builders against the JAX package's: the copies of
make_cluster / make_workload / encode / pack_waves give identical arrays
on the seeds and shapes of tests/test_jax_parity.py, and the carry-across
functions round-trip."""


import numpy as np
import pytest

from kubernetes_simulator_tpu.models import encode as J_encode
from kubernetes_simulator_tpu.sim import synthetic as J_syn
from kubernetes_simulator_tpu.sim.waves import pack_waves as J_pack
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.convert import (
    encoded_from_numpy,
    state_from_numpy,
    to_numpy,
)
from kubernetes_simulator_tpu_torch.models import encode as T_encode
from kubernetes_simulator_tpu_torch.plugins.builtin import (
    SYSTEM_DEFAULT_SPREAD,
    inject_default_spread,
)
from kubernetes_simulator_tpu_torch.sim import synthetic as T_syn
from kubernetes_simulator_tpu_torch.sim.waves import pack_waves as T_pack

from torch_port_case import assert_same as _assert_same, field_dicts, port_case

# (cluster kwargs, workload kwargs, wave width) — the shapes of
# tests/test_jax_parity.py plus the completions trace of
# tests/test_completions_device.py.
CASES = {
    "fit_only": (dict(num_nodes=40, seed=0), dict(num_pods=300, seed=0), 8),
    **{
        f"full_seed{s}": (
            dict(num_nodes=25, seed=s, taint_fraction=0.2),
            dict(num_pods=120, seed=s, with_affinity=True, with_spread=True,
                 with_tolerations=True),
            8,
        )
        for s in range(3)
    },
    "gangs": (dict(num_nodes=15, seed=5), dict(num_pods=80, seed=5, gang_fraction=0.2,
                                               gang_size=3), 8),
    "extended": (
        dict(num_nodes=20, seed=3, extended_resources={"google.com/tpu": (8, 0.3)}),
        dict(num_pods=100, seed=3, extended_resource=("google.com/tpu", 8, 0.3),
             gang_fraction=0.1, gang_size=4),
        8,
    ),
    "completions": (
        dict(num_nodes=12, seed=3, taint_fraction=0.2),
        dict(num_pods=80, seed=3, arrival_rate=10.0, duration_mean=2.0, with_affinity=True,
             with_spread=True, with_tolerations=True),
        4,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_builders_match_reference(case):
    ckw, wkw, W = CASES[case]
    j_cluster = J_syn.make_cluster(**ckw)
    t_cluster = T_syn.make_cluster(**ckw)
    j_pods, j_meta = J_syn.make_workload(**wkw)
    t_pods, t_meta = T_syn.make_workload(**wkw)
    assert j_meta == t_meta
    j_ec, j_ep = J_encode.encode(j_cluster, j_pods)
    t_ec, t_ep = T_encode.encode(t_cluster, t_pods)
    _assert_same(j_ec, t_ec, "ec")
    _assert_same(j_ep, t_ep, "ep")
    np.testing.assert_array_equal(J_pack(j_ep, W).idx, T_pack(t_ep, W).idx)


def test_config2_shape_builders_match_reference():
    """The config2 generators (taints, affinity, spread, tolerations) at a
    reduced size, with the System default-spread injection."""
    j_cluster, j_pods, _ = J_syn.config2(num_nodes=60, num_pods=400, seed=1)
    t_cluster, t_pods, _ = T_syn.config2(num_nodes=60, num_pods=400, seed=1)
    cfg = FrameworkConfig(plugins=[{"name": "PodTopologySpread",
                                    "args": {"defaultingType": "System"}}])
    from kubernetes_simulator_tpu.plugins.builtin import inject_default_spread as J_inject

    J_inject(j_pods, cfg)
    inject_default_spread(t_pods, cfg)
    assert SYSTEM_DEFAULT_SPREAD[0]["topologyKey"] == "kubernetes.io/hostname"
    j_ec, j_ep = J_encode.encode(j_cluster, j_pods)
    t_ec, t_ep = T_encode.encode(t_cluster, t_pods)
    _assert_same(j_ec, t_ec, "ec")
    _assert_same(j_ep, t_ep, "ep")


@pytest.mark.parametrize("case", ["full_seed0", "extended"])
def test_encoded_from_numpy_roundtrip(case):
    ckw, wkw, _ = CASES[case]
    ec, ep = J_encode.encode(J_syn.make_cluster(**ckw), J_syn.make_workload(**wkw)[0])
    pec, pep = port_case(ec, ep)
    ecf, epf = field_dicts(ec, ep)
    for name, v in ecf.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(pec, name), v, err_msg=name)
    for name, v in epf.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(pep, name), v, err_msg=name)
    assert pec.vocab.resources == ec.vocab.resources
    assert pec.num_groups == ec.num_groups
    assert pec.num_resources == ec.num_resources
    del ecf["group_keys"]  # without them the group count comes from group_topo
    assert encoded_from_numpy(ecf, epf)[0].num_groups == ec.num_groups


def test_state_roundtrip():
    rng = np.random.default_rng(0)
    arrs = dict(
        used=rng.random((7, 3)).astype(np.float32),
        match_count=rng.integers(0, 5, (4, 6)).astype(np.float32),
        anti_active=rng.integers(0, 2, (4, 6)).astype(np.float32),
        pref_wsum=rng.integers(-9, 9, (4, 6)).astype(np.float32),
        bound=rng.integers(-1, 7, 11).astype(np.int32),
    )
    back = to_numpy(state_from_numpy(device="cpu", **arrs))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_encoded_from_numpy_names_missing_fields():
    ec, ep = J_encode.encode(*J_syn.config1(num_nodes=4, num_pods=5)[:2])
    ecf, epf = field_dicts(ec, ep)
    del ecf["allocatable"], epf["requests"]
    with pytest.raises(KeyError, match="allocatable.*requests"):
        encoded_from_numpy(ecf, epf)


@pytest.mark.parametrize("case", ["full_seed0", "extended"])
def test_carried_vocab_equals_reference_and_interns_alike(case):
    """The carried vocabulary holds every interning table of the JAX
    package's, so interning a new key or key/value pair afterwards (the
    what-if add_taint) gives the same id in both packages."""
    ckw, wkw, _ = CASES[case]
    ec, ep = J_encode.encode(J_syn.make_cluster(**ckw), J_syn.make_workload(**wkw)[0])
    pec, _ = port_case(ec, ep)
    for lst in ("resources", "keys", "kvs", "namespaces", "topo_keys"):
        assert getattr(pec.vocab, lst) == getattr(ec.vocab, lst), lst
    assert ec.vocab.keys and ec.vocab.kvs
    old_key, old_kv = ec.vocab.keys[-1], ec.vocab.kvs[-1]
    for fn, args in (
        ("key", ("whatif/injected",)), ("kv", ("whatif/injected", "true")),
        ("key", (old_key,)), ("kv", old_kv), ("kv", (old_key, "a-new-value")),
        ("ns", ("a-new-namespace",)), ("topo", ("example.com/rack",)),
        ("resource", ("example.com/gpu",)),
    ):
        want = getattr(ec.vocab, fn)(*args)
        assert getattr(pec.vocab, fn)(*args) == want, (fn, args)
    assert pec.vocab.key("whatif/injected") == len(ec.vocab.keys) - 1


def test_encoded_from_numpy_requires_the_vocabulary():
    ec, ep = J_encode.encode(*J_syn.config1(num_nodes=4, num_pods=5)[:2])
    ecf, epf = field_dicts(ec, ep)
    del ecf["kvs"], ecf["topo_keys"]
    with pytest.raises(KeyError, match="kvs.*topo_keys"):
        encoded_from_numpy(ecf, epf)
