"""Per-scenario scheduler policies: the column layout of a policy row.

Counterpart: ``kubernetes_simulator_tpu/ops/tpu.py:40-89``
(``POLICY_WEIGHT_COLS``, ``IDX_FIT_LEAST``, ``POLICY_COLS`` and the
static/traced accessor rule of ``policy_weight_fns``).

A what-if batch built with ``policies`` (an f32 ``[S, len(POLICY_COLS)]``
tensor on the device, one row per scenario) reads its Score weights and
its NodeResourcesFit strategy from the scenario's row instead of the
static config: K1 (csrc/filter_score.cu) picks the fit strategy of each
scenario from column ``IDX_FIT_LEAST`` (> 0.5 → LeastAllocated, else
MostAllocated; ignored when the static strategy is
RequestedToCapacityRatio), and K2 (csrc/normalize_select.cu) weights the
five normalized rows with columns 0–4. Between runs only the values
change (``WhatIfEngine.set_policies``), so one engine serves a whole
population of policies.

The accessor rule (``StepSpec.consts(traced=...)``): in static mode a
plugin whose config weight is 0 is gated out of the weighted total; in
traced mode every plugin the step enables stays in, and a zero weight adds
an exact ``0.0 · normalized`` term. The normalize extrema never depend on the
weights, so a row equal to the config's own weights reproduces the static
totals bit for bit.
"""

#: The five Score weight columns, in the plugin order of the weighted total.
POLICY_WEIGHT_COLS = (
    "NodeResourcesFit",
    "TaintToleration",
    "NodeAffinity",
    "InterPodAffinity",
    "PodTopologySpread",
)
#: The NodeResourcesFit strategy selector column.
IDX_FIT_LEAST = len(POLICY_WEIGHT_COLS)
POLICY_COLS = POLICY_WEIGHT_COLS + ("fit_least",)
#: NodeResourcesFit strategies the selector chooses between.
TRACED_FIT_STRATEGIES = ("LeastAllocated", "MostAllocated")
