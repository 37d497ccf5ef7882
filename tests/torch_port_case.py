"""Shared helpers of the tests/test_torch_*.py suites: carry an encoded
case and a host state from the JAX package into the PyTorch port through
its public carry-across functions (numpy arrays only)."""

import dataclasses

import numpy as np

from kubernetes_simulator_tpu_torch.convert import encoded_from_numpy, state_from_numpy


def field_dicts(ec, ep):
    """numpy field dicts of a JAX-package EncodedCluster / EncodedPods."""
    ecf = {f.name: getattr(ec, f.name) for f in dataclasses.fields(ec) if f.name != "vocab"}
    ecf["resources"] = dict(ec.vocab._r)
    epf = {f.name: getattr(ep, f.name) for f in dataclasses.fields(ep)}
    return ecf, epf


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
