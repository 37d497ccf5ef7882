"""Plugin-set constants and the PodTopologySpread defaulting hook.

Counterpart: ``kubernetes_simulator_tpu/plugins/builtin.py`` — only what
config loading and :class:`..sim.torch_runtime.StepSpec` need: the
default plugin order and Score weights ([K8S] default profile), the
"System" default spreading constraints, and the pre-encode injector.
The per-plugin Filter/Score arithmetic itself lives in
:mod:`..ops.reference` (plain PyTorch) and ``csrc/`` (the kernels).
"""

from __future__ import annotations

#: Plugin names in Filter/Score order — the order of the JAX package's
#: ``PLUGIN_FACTORIES`` and of its device score fold.
PLUGIN_NAMES = (
    "NodeResourcesFit",
    "TaintToleration",
    "NodeAffinity",
    "InterPodAffinity",
    "PodTopologySpread",
)

#: Plugin name → default Score weight ([K8S] default profile weights).
DEFAULT_WEIGHTS = {
    "NodeResourcesFit": 1.0,
    "TaintToleration": 3.0,
    "NodeAffinity": 2.0,
    "InterPodAffinity": 2.0,
    "PodTopologySpread": 2.0,
}

#: kube-scheduler "System" default spreading (KubeSchedulerConfiguration
#: PodTopologySpreadArgs when defaultingType=System).
SYSTEM_DEFAULT_SPREAD = [
    {"maxSkew": 3, "topologyKey": "kubernetes.io/hostname",
     "whenUnsatisfiable": "ScheduleAnyway"},
    {"maxSkew": 5, "topologyKey": "topology.kubernetes.io/zone",
     "whenUnsatisfiable": "ScheduleAnyway"},
]


def resolved_default_constraints(config):
    """The PodTopologySpread defaulting constraint list from config, or
    None when not configured — the single source for both the predicate
    and the injector."""
    constraints = None
    for e in (config.plugins if config and config.plugins is not None else []):
        if e.get("name") != "PodTopologySpread":
            continue
        args = e.get("args", {})
        if args.get("defaultingType") == "System":
            constraints = SYSTEM_DEFAULT_SPREAD
        elif args.get("defaultConstraints"):
            constraints = args["defaultConstraints"]
    return constraints


def inject_default_spread(pods, config) -> None:
    """Apply PodTopologySpread cluster-default constraints: pods WITHOUT
    explicit constraints get the plugin-args defaults, selecting on the
    pod's own labels (the simulator's stand-in for upstream's
    controller-selector lookup — pods of one controller share labels).

    Config vocabulary mirrors KubeSchedulerConfiguration:
        plugins:
        - name: PodTopologySpread
          args: {defaultingType: System}             # built-in pair
        # or explicit: args: {defaultConstraints: [{maxSkew: ..., ...}]}
    No-op unless the plugin entry asks for defaulting (upstream's List
    defaulting with an empty list)."""
    from ..models.core import LabelSelector, TopologySpreadConstraint

    constraints = resolved_default_constraints(config)
    if not constraints:
        return
    for p in pods:
        if p.topology_spread or not p.labels:
            continue
        for c in constraints:
            p.topology_spread.append(
                TopologySpreadConstraint(
                    max_skew=int(c["maxSkew"]),
                    topology_key=c["topologyKey"],
                    when_unsatisfiable=c.get("whenUnsatisfiable", "ScheduleAnyway"),
                    label_selector=LabelSelector.make(dict(p.labels)),
                )
            )
