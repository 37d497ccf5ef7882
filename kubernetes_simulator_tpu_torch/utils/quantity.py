"""Kubernetes resource-quantity parsing.

Counterpart: ``kubernetes_simulator_tpu/utils/quantity.py`` (a copy; the
port imports nothing of the JAX package).

Semantics follow the upstream ``resource.Quantity`` grammar
(apimachinery/pkg/api/resource): decimal SI suffixes (k, M, G, T, P, E),
binary suffixes (Ki, Mi, Gi, Ti, Pi, Ei), and the milli suffix ``m``.

Provenance: [K8S] upstream semantics.
"""

from __future__ import annotations

_BINARY = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL = {
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(value) -> float:
    """Parse a k8s quantity (``"100m"``, ``"2"``, ``"4Gi"``, 0.5) to a float.

    CPU quantities come back in cores (``"100m"`` -> 0.1); memory/storage in
    bytes (``"1Ki"`` -> 1024.0). Plain ints/floats pass through unchanged.
    """
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, str):
        raise TypeError(f"cannot parse quantity of type {type(value)!r}")
    s = value.strip()
    if not s:
        raise ValueError("empty quantity")
    for suf, mult in _BINARY.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suf, mult in _DECIMAL.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def format_quantity(value: float, binary: bool = False) -> str:
    """Best-effort inverse of :func:`parse_quantity` for logs and dumps."""
    if binary:
        for suf in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            mult = _BINARY[suf]
            if value >= mult and value % mult == 0:
                return f"{int(value // mult)}{suf}"
    if value == int(value):
        return str(int(value))
    milli = value * 1000
    if milli == int(milli):
        return f"{int(milli)}m"
    return repr(value)
