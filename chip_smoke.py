"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a host with one CUDA card. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ``kubernetes_simulator_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build seconds;
3. single-scenario kernel checks (S=1) at the config2 shape (5,000
   nodes, 50,000 pods, the full default plugin set) over a few hundred
   random slots of a mid-replay state: masks, score rows, choices and the
   state after every apply must equal the plain-PyTorch twin's exactly,
   and so must a 4,000-pair release and a gang rollback;
4. the same checks at S=4 and N=5,000, with scenarios whose allocatable
   and taints differ (node loss, capacity changes, hard and soft injected
   taints), scenario by scenario;
5. replays a reduced case (300 nodes, 2,000 pods, completions and gangs)
   on four routes — the chunk route (K6, one launch a chunk), the per-slot
   kernels (K1 -> K2 -> K3 a slot), the plain path on the card and the
   plain path on the CPU: assignments must be identical (so do steps 6, 9,
   12 and 16; step 20's series runs take the chunk route — the plain path
   attributing inside K6 — and are held against the per-slot route, and
   step 12's timeline replay against its per-slot route and the same
   replay at summary on K6);
6. runs a reduced what-if (8 scenarios × 60 nodes × 3,000 pods,
   durationMean 60, gangs: a contended trace where gangs roll back and
   completions move placements) the same three ways: assignments [S, P]
   must be identical;
7. replays the config2 shape (durationMean 50, gangFraction 0.02) on the
   kernel path with every launch counter zeroed just before, checks the
   result and each kernel's launches, and profiles a second replay; K6
   held against its twin over the first K6_TWIN_WAVES waves at S=1;
8. the main path: the headline what-if — 128 scenarios
   (``uniform_scenarios(seed=0)``) × 2,000 nodes × 20,000 pods, the full
   default plugin set, durationMean 50, gangs (0.02 × 4), chunkWaves 512
   — with the counters zeroed just before a warm-up run and read just
   after it, then three timed runs (median wall, aggregate placements/s),
   scenario 0 held against a single-scenario replay of the same trace,
   one profiled run for the device's busy share; then each kernel held
   against its twin at the headline shapes (S=128, N=2,000) and timed
   beside its twin, a PyTorch yardstick and its least possible time on
   the card. The batch runs on the chunk route (K6 one launch a chunk, K1
   and K2 none); its per-slot route places alike (assignments' sha256),
   and K6 is held against its twin over the first K6_TWIN_WAVES waves and
   against the per-slot kernels over the first chunk (choices and every
   plane), and its launch over K6_TIMED_WAVES waves timed;
8c. config4 (``examples/config4_borg_1m.yaml``: 10,000 nodes x 1,000,000
   Borg-shaped tasks, chunkWaves 2048) through the CLI ``run`` on the card,
   counters zeroed just before and read just after: placed, unschedulable,
   set-up seconds by part, replay wall, placements/s, launches, B6's bound;
   K6 held against its twin over the first K6_TWIN_WAVES waves (S=1) and
   its first two chunks against the per-slot kernels;
8d. config4's generator cut to BORG_CUT (12 nodes x 5,000 tasks) on both
   routes against greedy_replay's pins (BORG_PINS);
8e. node-plane shards (row B13) and paged pod waves: the reduced sharded
   replay (SHARD_REDUCED: 100 nodes over 3 shards, two pad rows, 600 pods)
   on every route — the shard route (K9 ``shard_chunk_replay``, one launch a
   chunk, and K8 at each release), the per-slot shard route on the kernels
   (K1 over the padded node axis -> K7 -> K8 a slot), K9's twin and the
   per-slot twins on the card and on the CPU, the replicated K6 route —
   paged and not: assignments, placed and ``used`` identical, each route's
   launches checked; SHARD_CUT (BORG_CUT over 4 shards, paged) on K9 against
   SHARD_PINS; config13 (``examples/config13_borgscale.yaml`` as shipped:
   10,000 nodes x 100,000 Borg tasks, nodeShards 8, pagedWaves, chunkWaves
   512) through the CLI ``run``, counters zeroed just before and read just
   after (one K9 a chunk, K8 its releases, nothing else), its assignments
   equal to the per-slot shard route's and a second K9 run's in the same
   call and to the same trace replicated on K6; the walls of both routes,
   placements/s, set-up split, launches, the pager's stalls on both routes;
   K9's time a slot over the first chunk (CUDA events); the per-slot route's
   first chunk profiled (K1's, K7's and K8's device time a launch) beside
   their bounds; K1 on the sharded tables, K7 and K8 held against their
   twins launch by launch in mid-replay windows of config13's trace at 8
   shards and at 3 (two pad rows), every node but one in a hundred filled to
   its allocatable (binds, undone gang rollbacks, a release), and timed
   beside their twins, their bounds and, for K7's choice, ``torch.argmax``
   over the masked total row; K9 held in the same windows against its twin
   and the per-slot kernels (every plane, the shard buffers, the choices)
   and timed there beside its twin and its bound (K9's registers and shared
   bytes are printed after the build);
9. tier preemption, reduced: a tier-preemption replay (config6 cut to 20
   nodes x 1,040 pods) and a preemption x completions what-if (8
   scenarios x 8 nodes x 400 pods) on the kernel path, the plain path on
   the card and the plain path on the CPU: assignments and victims
   identical;
10. config6 (``examples/config6_preempt_defaults.yaml``, 500 nodes x
   26,000 pods, tiers {0, 100, 1000}) as a tier-preemption replay, with
   the counters zeroed just before and read just after: placed, victims
   and the assignments' sha256 equal greedy_replay's pinned constants
   (PREEMPT_PINS); median of 3 timed runs and a profiled run; then each
   kernel held against its twin launch by launch in a window of the
   replay where evictions fire (candidate rows, choices, eviction records,
   victim marks and counters, state and tier planes), a release bucket,
   and each kernel's preemption work timed there;
11. the tier-preemption what-if: 128 ``uniform_scenarios(seed=0)`` over
   config6 with durationMean 200 and gangs (0.02 x 4), chunkWaves 512,
   completions on — scenario 0 equal to the pinned constants and to a
   single-scenario replay, median of 3, busy share, the same kernel
   checks at S=128 (with a gang rollback) and timings; for both tier
   paths B6's bound, from each scenario's victims wave by wave;
12. the retry buffer, reduced: CONFIG7 (``examples/config7_retry_completions.yaml``)
   cut to 40 nodes x 2,000 pods, chunkWaves 32, retryBuffer 64 (buffers
   fill and overflow), as a single replay and an 8-scenario what-if, on
   the kernel path, the plain path on the card and on the CPU: placed,
   drops, assignments and every retry record identical;
13. the main retry path: CONFIG7's what-if as shipped (64
   ``uniform_scenarios(seed=0)`` x 500 nodes x 20,000 pods, retryBuffer
   256, chunkWaves 256) with the counters zeroed just before its warm-up
   and read just after — every scenario places 20,000 with no drop,
   scenario 0 equals greedy_replay's pins (RETRY_PINS), the batch without
   the buffer places fewer (scenario 0 pinned too); median of 3, busy
   share, B6's bound;
14. ``run``'s engine on CONFIG7 (S = 1) against the same pins: wall and
   placements/s;
15. the contended retry what-if: CONFIG7 cut to 150 nodes, 64 scenarios —
   scenario 0 against its pins with and without the buffer, the batch
   placing differently without it; then at the boundary where the most
   scenarios hold buffered pods every launch of the boundary sequence
   (static and pending releases, each pass slot's K1 → K2 → K3, K4) and
   the following main-path binds (failure appends and overflows) held
   against the twins plane by plane, and each retry mode timed beside
   its twin and its least time;
16. label perturbations (``set_label``), reduced: 8 scenarios x 60 nodes x
   2,000 pods (durationMean 60, gangs) — a move to an existing zone with a
   capacity cut, a new zone, emptying a singleton zone, a node gaining the
   key, a taint-only scenario, a tier flip, and a new zone beside uniform
   perturbations — on the kernel path, the plain path on the card and the
   plain path on the CPU: assignments identical;
17. the relabel what-if at the headline's full width (the slice's main
   run): 128 ``relabel_scenarios`` (``uniform_scenarios(seed=0)`` plus one
   relabel of 1..32 nodes each, cycling a zone move, a new zone and a tier
   flip; 128 label rows) over the headline trace, inside the DynTables
   envelope with completions on — counters zeroed just before a warm-up
   and read just after, median of 3, busy share, scenario 0 equal to the
   headline's, one scenario of each kind equal to a single replay of its
   cluster relabelled explicitly and re-encoded; K1, K2 and K3 held
   against their twins launch by launch in a window of the batch's own
   replay (a release bucket, binds and a gang rollback), and again at a
   synthetic mid-replay state, where each is timed beside its twin and its
   least time;
18. the label cut (LABEL_CUT: the base and one scenario of each kind over
   500 nodes x 5,000 pods): each relabelled scenario's placed count and
   assignments' sha256 equal greedy_replay's pins (LABEL_PINS);
19. outside the envelope: 16 scenarios over the headline trace, each
   moving a whole zone (250 nodes) into the next, completions off —
   engine "v2", completions off, scenario 1 equal to its from-scratch
   replay, and the wall;
20. series telemetry, reduced: CONFIG6's trace cut to 20 nodes x 1,040
   pods with devicePreemption off at ``series`` on the kernel path (K6's
   attributed mode, no K5), the plain path on the card and on the CPU
   (reasons, attempts, series and latency identical; the per-slot route's
   assignments too; step 12's replay runs at ``timeline`` and holds its
   telemetry and events the same way), and ``run`` through the port's CLI
   with ``timelineOut`` on CONFIG7's 40-node cut on the card and on the
   CPU: rows and Chrome traces identical;
21. series telemetry at full width (the slice's main path), counters zeroed
   just before each run and read just after: (a) CONFIG6's trace with
   devicePreemption off at ``series`` (the plain path on the chunk route:
   one attributed K6 a chunk, no K1, K2, K3 bind or K5 launch) against
   REJECT_PINS, with sum(reasons) = 500 x unschedulable and attempts =
   reasons, and equal to its per-slot route (K5 after every slot's K2) in
   assignments and reject counters; (b) CONFIG7 as shipped through the CLI
   ``run`` with ``telemetry: series`` and ``timelineOut`` (the retry path on
   the chunk route: K5 in the retry pass and as the chunk fold between K6
   launches), its row, events and the Chrome trace's sha256 against
   REJECT_PINS, its placements against RETRY_PINS; (c) the 150-node cut at
   ``timeline`` against REJECT_PINS and RETRY_PINS; (d) CONFIG13 through the
   CLI at ``series`` (node shards: K9 with the pager, attribution off and
   the reference's note logged, no K5) placing as its summary run, and
   SHARD_CUT at ``series`` against SHARD_PINS; the walls of (a) at summary,
   series on K6 and series per slot in turns, of (b) beside ``summary``,
   and busy shares; CONFIG6 as shipped (tier preemption) at ``series``
   logging the reference's note and placing as PREEMPT_PINS; K6's
   attributed mode held against its twin and the per-slot kernels in a
   window of (a) where pods fail (its plan's C = 1 and 4 ranks forced) and
   timed there in turns with the summary build; K5 held against its twin
   launch by launch in the same window on the per-slot route, at a fold
   and a retry pass of (c) at S = 1 and of CONFIG7's 40-node cut at S = 4,
   and timed per launch on the plain path and as a fold;
22. (P1) per-scenario policy rows at full width (their main path):
   ``PolicyTuner`` over the headline trace (CEM, 32 candidates x 4 train
   scenarios = 128 rows a sweep, 2 held-out scenarios, 2 rounds, no
   oracle), counters zeroed just before and read just after; one engine
   set-up across both rounds; K1, K2 and K3 held against their twins launch
   by launch in a window of a sweep with distinct rows, MostAllocated rows
   among them; a sweep whose rows all equal the default vector equal to
   the same 128 scenarios without policies (assignments' sha256); the
   held-out sweep's default half equal to a static what-if of the held-out
   split; the policy sweep against the static batch in turns (median of
   3), its launches and busy share; K1 and K2 with policy rows held and
   timed at a synthetic mid-replay state;
23. (P2) four policy rows (the default, MostAllocated, a zero weight,
   non-integer weights) x four scenarios over the headline's generators cut
   to 500 nodes x 5,000 pods: each row's placed pods and assignments'
   sha256 equal greedy_replay's pins (POLICY_PINS);
24. (P3) ``python -m kubernetes_simulator_tpu_torch tune`` on CONFIG11 as
   shipped, through the CLI's entry point on the card: the trajectory
   file's sha256 equal to the JAX package's (TUNE_PINS), the oracle's
   envelope <= 1e-6, one engine set-up; the walls of the search, the
   held-out sweep and the oracle.

The selects — K2, K6, K7 and K9 — launch as thread-block clusters
(ops/kernels.py ``cluster_plan``): every step that launches one prints its
plan (cluster size C, block width, grid). K2 at S=1 (step 3) and S=128
(step 8), K2's argmin (steps 10-11) and K7 at 8 and 3 shards (step 8e) are
timed in turns with their PyTorch calls (kernel, library, library,
kernel), and one line gives K6's device time a slot at the headline,
config2 and config4 with the C of each, beside PR 10's (EARLIER).

After the headline, K6 runs at 300 scenarios (BEYOND: more clusters than
the card holds at once) over an 8-wave window, held against its twin and
the per-slot kernels; config4's K6 plan is checked for ranks of more than
1,024 nodes and a short last rank. K3's release (each tile of pairs sorted
by node in shared memory, then each node summed in pair order) is held
against its twin and ``_add_in_pair_order`` on BORG_CUT's 12 nodes x 5,000
tasks (RELEASE_CASES: plain, tier planes, label rows, the pending release,
and all 5,000 tasks, a short last tile) and at config4's largest bucket, and
timed, with each of its two kernels' share from the same profile, beside
one deterministic ``index_add_`` of the same requests (the release row's
``library_ms``: a yardstick that keeps no pair order).

Every phase prints its route. Prints the kernel table as one JSON line
(K6 ``chunk_replay`` among the kernels; each row's ``launches`` from its
path's main run, where K1 and K2 run inside K6 and launch 0 times, and
``slot_route_launches`` from the same batch on the per-slot route), then,
as its last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code not
0, no result line). Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig  # noqa: E402
from kubernetes_simulator_tpu_torch.models.encode import PAD, encode  # noqa: E402
from kubernetes_simulator_tpu_torch.models.state import init_state  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import kernels as K  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import reference as ref  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (  # noqa: E402
    StepSpec,
    TorchReplayEngine,
    assignments_from_choices,
    joint_release,
    new_choices,
    retry_slots,
    run_waves,
)
from kubernetes_simulator_tpu_torch.sim.tuner import PolicyTuner  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.whatif import (  # noqa: E402
    Perturbation,
    Scenario,
    ScenarioSet,
    WhatIfEngine,
    uniform_scenarios,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
SEED = 0
HEADLINE = dict(scenarios=128, nodes=2000, pods=20_000, chunk_waves=512)
#: Pods of the reduced replay and relabel what-if held on three paths
#: (3,000 before the series steps were added; the plain path on the card
#: costs ≈6 ms a pod slot).
REDUCED_PODS = 2000

#: Tier preemption (devicePreemption: true): priority tiers contending for
#: an over-committed cluster (500 nodes, 26,000 pods, tiers {0, 100, 1000}).
CONFIG6 = "examples/config6_preempt_defaults.yaml"
#: The what-if shape: CONFIG6 with durations and gangs, 128 scenarios.
PREEMPT_WHATIF = dict(scenarios=128, chunk_waves=512, duration_mean=200.0, gang_fraction=0.02,
                      gang_size=4)
#: greedy_replay(preemption=True) of the JAX package on CONFIG6 and on the
#: what-if shape (completions_chunk_waves=512): placed pods, victims and the
#: sha256 of the int32 assignments. tests/test_torch_preempt_pins.py
#: recomputes them on the CPU.
PREEMPT_PINS = {
    "config6": dict(placed=17928, victims=5920,
                    sha256="6ed8cc1ab5f14847fb9bc64a95d12f34995b8785444cd07ad7b16bd63b0af348"),
    "whatif": dict(placed=25765, victims=180,
                   sha256="f78d570f85ec5002d72885c6e4a4f9b5bba49b4359b84e6921f1578d368f1fb6"),
}

#: The unschedulable-retry buffer: CONFIG7 (a what-if of 64 scenarios x
#: 500 nodes x 20,000 pods, durationMean 40, retryBuffer 256, chunkWaves
#: 256) as shipped, and its cluster cut to RETRY_CUT_NODES so that the
#: buffer fills and overflows.
CONFIG7 = "examples/config7_retry_completions.yaml"
RETRY_CUT_NODES = 150
#: greedy_replay(retry_buffer=256, completions_chunk_waves=256) of the JAX
#: package on CONFIG7 (scenario 0 of its what-if) and on its 150-node cut,
#: with and without the buffer: placed pods, drops and the sha256 of the
#: int32 assignments. tests/test_torch_retry_pins.py recomputes them.
RETRY_PINS = {
    "config7": dict(placed=20000, retry_dropped=0,
                    sha256="1f423f2ffe2680a96a3fe5a8c9a7287305a02bfec527e6c477d0de8d8c6f2100"),
    "config7_no_retry": dict(placed=19995, retry_dropped=0,
                             sha256="e07628c9ed2e9576601b5d5f3d8f1f6d222dbae7c90937511d1b8c825d6b564b"),
    "cut150": dict(placed=18228, retry_dropped=1608,
                   sha256="4a45ace5c00e5876f62113048b545d1211621392ce81ca98629486373f3f3664"),
    "cut150_no_retry": dict(placed=18508, retry_dropped=0,
                            sha256="ae0ce5f0b76ab61d5fc8bea303e0fc6da99685a2a71dbdd65738204995ac66bc"),
}
#: The retry tables compared between paths and launch by launch.
RETRY_PLANES = ("rbuf", "rcount", "rdrop", "rchoice", "pend_id", "pend_node", "pend_relb",
                "rnode", "rbind_b")

#: Label perturbations (set_label): the relabel what-if over the headline
#: trace, each scenario past 0 adding one relabel of 1..32 nodes to its
#: uniform_scenarios perturbations (relabel_scenarios), and its cut to
#: LABEL_CUT (four scenarios: the base and one of each kind).
ZONE = "topology.kubernetes.io/zone"
LABEL_KINDS = ("zone_move", "new_zone", "tier_hot")  # by scenario index mod 3
LABEL_CUT = dict(nodes=500, pods=5000, scenarios=4, chunk_waves=64)
#: greedy_replay(completions_chunk_waves=64) of the JAX package on each
#: relabelled scenario of the cut, perturbed explicitly and re-encoded:
#: placed pods and the sha256 of the int32 assignments.
#: tests/test_torch_label_pins.py recomputes them.
LABEL_PINS = {
    "zone_move": dict(placed=5000,
                      sha256="cca193fc0e528b8837250e1395f8f0c052bb163a1f0ede2928d96f3680f551f4"),
    "new_zone": dict(placed=5000,
                     sha256="e06ea9414bcd2dad1973e73c9022a2faa9a11d293d935cffc3b166ec8db6e3d0"),
    "tier_hot": dict(placed=5000,
                     sha256="a79b6b8535701a50c8379ee886c7680f9fc6a1662f0c7cb7addebf66392b5e86"),
}
#: Series telemetry: JaxReplayEngine of the JAX package at "series" on
#: CONFIG6's trace with devicePreemption off (the plain path) and at
#: "timeline" on CONFIG7 as shipped (what its ``run`` with timelineOut
#: collects; the retry path) and on its 150-node cut: reasons, rejection
#: attempts, the sha256 of the series and of the events (series_digest),
#: and of CONFIG7's Chrome trace. tests/test_torch_telemetry_pins.py
#: recomputes them.
REJECT_PINS = {
    "config6": dict(
        reasons={"NodeResourcesFit": 4336494, "TaintToleration": 6},
        attempts={"NodeResourcesFit": 4336494, "TaintToleration": 6},
        series_sha256="c8cfe5588fd62c1a70a6ee2306d9d67e30484c1da161954f7f5be9b6e3eba2e3",
        events_sha256="4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945"),
    # Barely contended: nothing is attributed; the series and the 20,000
    # bind events are what is held.
    "config7": dict(
        reasons={}, attempts={},
        series_sha256="5441f22a027f60a57256d9e1908fb0be6064a838de1888063b326624b2e2eced",
        events_sha256="5db02611b38a016989994bec2c9e449e6cadf575d1351b2560cf23341265118d",
        trace_sha256="a41735ff2f68e1836e63046c3b7f7cbdd2fd38dc34237a0c48965a50d20245f5"),
    # Every buffer overflows, yet nothing is attributed: each failed slot
    # had a feasible node at its chunk's start, and every retried pod
    # bound at its first retry.
    "cut150": dict(
        reasons={}, attempts={},
        series_sha256="29c455faffeee6e77be4fd80a9ef494be129ef922ffac32d654add7d380eec2d",
        events_sha256="ba78c540117c3aaf31037d69f40d07911a22972a00b71bcae917b35edda0d508"),
}
#: Per-scenario policy rows (row B1w). P1: the policy tuner's sweep over
#: the headline trace — CEM, 32 candidates x 4 train scenarios = 128 rows
#: a sweep, 2 held-out scenarios, 2 rounds, no oracle.
TUNE_SWEEP = dict(algo="cem", population=32, train_scenarios=4, heldout_scenarios=2,
                  rounds=2, seed=0)
#: P2: four policy rows x the first four ``uniform_scenarios`` of the
#: headline's generators cut to 500 nodes x 5,000 pods (chunkWaves 64),
#: row-major: scenario r·4 + s runs row r on scenario s.
POLICY_CUT = dict(nodes=500, pods=5000, scenarios=4, chunk_waves=64)
POLICY_ROWS = {
    "default": (1.0, 3.0, 2.0, 2.0, 2.0, 1.0),
    "most_allocated": (0.8, 3.0, 2.5, 1.25, 2.0, 0.0),
    "zero_weight": (1.0, 3.0, 2.0, 2.0, 0.0, 1.0),
    "non_integer": (2.5, 0.75, 9.9, 0.3, 0.05, 1.0),
}
#: greedy_replay(completions_chunk_waves=64) of each row's four scenarios,
#: with the row as an ordinary config (exact f32 weights, the selector's
#: strategy): placed per scenario and the sha256 of the int32 [4, P]
#: assignments. tests/test_torch_policy_pins.py recomputes them with the
#: port's greedy_replay and the JAX package's.
POLICY_PINS = {
    "default": dict(placed=[5000, 5000, 5000, 5000],
                    sha256="750614a6f8c9edb47abd0560518cae734bc80e0f18468a439a9cd0d4d3771e15"),
    "most_allocated": dict(placed=[5000, 5000, 5000, 5000],
                           sha256="d19ea0c06f7f0ad89562bbc94a598a3da8135c46f23c3b261718f0b1e3a0deb8"),
    "zero_weight": dict(placed=[5000, 5000, 5000, 5000],
                        sha256="f9755524e42df713151243ea55bc2aa87a78d5157444728586a92762f3b254e9"),
    "non_integer": dict(placed=[5000, 5000, 5000, 5000],
                        sha256="f2c6462bdabffdcd670880545e00a6231e50273463fec94f62a54ae8d41d403a"),
}
#: P3: config11 as shipped through the CLI ``tune``; the sha256 of its
#: trajectory file and its rows, from the JAX package's ``tune`` on the
#: CPU (tests/test_torch_tuner.py::test_config11_as_shipped_pin).
CONFIG11 = "examples/config11_tune.yaml"
TUNE_PINS = {
    "config11": dict(rows=103,
                     sha256="ef6da9eecb8c393ce738863c6d2febb7519853172a4c167cbc2b6a67f1ea478c"),
}
#: The kernels' policy-row work, each with the kernel it runs in and the
#: reference lines it replaces.
POLICY_SOURCES = {
    "filter_score_policy_rows": ("filter_score", "kubernetes_simulator_tpu/ops/tpu3.py:1316"),
    "normalize_select_policy_rows": ("normalize_select",
                                     "kubernetes_simulator_tpu/ops/tpu.py:62"),
}

#: The outside-the-envelope batch: scenario s moves all nodes of zone
#: s mod 8 into zone s+1 mod 8 (250 nodes: K > 32, the reference's v2).
OUTSIDE_SCENARIOS = 16

SOURCES = {
    "filter_score": ("kubernetes_simulator_tpu_torch/csrc/filter_score.cu",
                     "kubernetes_simulator_tpu/ops/tpu3.py:944"),
    "normalize_select": ("kubernetes_simulator_tpu_torch/csrc/normalize_select.cu",
                         "kubernetes_simulator_tpu/ops/tpu.py:739"),
    "apply_placements": ("kubernetes_simulator_tpu_torch/csrc/apply_placements.cu",
                         "kubernetes_simulator_tpu/sim/jax_runtime.py:1414"),
    "retry_boundary": ("kubernetes_simulator_tpu_torch/csrc/retry_boundary.cu",
                       "kubernetes_simulator_tpu/sim/whatif.py:1456"),
    "first_reject": ("kubernetes_simulator_tpu_torch/csrc/first_reject.cu",
                     "kubernetes_simulator_tpu/ops/tpu.py:816"),
    "chunk_replay": ("kubernetes_simulator_tpu_torch/csrc/chunk_replay.cu",
                     "kubernetes_simulator_tpu/sim/jax_runtime.py:742"),
    "shard_select": ("kubernetes_simulator_tpu_torch/csrc/shard_select.cu",
                     "kubernetes_simulator_tpu/ops/tpu.py:1316"),
    "shard_apply": ("kubernetes_simulator_tpu_torch/csrc/shard_apply.cu",
                    "kubernetes_simulator_tpu/ops/tpu.py:1406"),
    "shard_chunk_replay": ("kubernetes_simulator_tpu_torch/csrc/shard_chunk_replay.cu",
                           "kubernetes_simulator_tpu/sim/jax_runtime.py:548"),
}
#: The node-shard work (row B13), each with the kernel it runs in and the
#: reference lines it replaces: K1 on the sharded tables (the mask and rows
#: over the padded node axis, pad rows masked; eval_pod_fused(shard_ctx)),
#: K7 (with each shard's packed extrema), and K8's bind, gang rollback and
#: release.
SHARD_SOURCES = {
    "filter_score_shards": ("filter_score", "kubernetes_simulator_tpu/ops/tpu.py:1059"),
    "shard_select": ("shard_select", "kubernetes_simulator_tpu/ops/tpu.py:1316"),
    "shard_apply": ("shard_apply", "kubernetes_simulator_tpu/ops/tpu.py:1406"),
    "shard_apply_rollback": ("shard_apply", "kubernetes_simulator_tpu/ops/tpu.py:1435"),
    "shard_apply_release": ("shard_apply", "kubernetes_simulator_tpu/sim/jax_runtime.py:1224"),
}
#: config13 (examples/config13_borgscale.yaml: 10,000 nodes x 100,000 Borg
#: tasks, nodeShards 8, pagedWaves, chunkWaves 512) through the CLI ``run``.
CONFIG13 = "examples/config13_borgscale.yaml"
#: The reduced sharded replay (four routes, paged and not): 100 nodes over 3
#: shards (two pad rows), 600 pods, gangs, completions.
SHARD_REDUCED = dict(nodes=100, pods=600, node_shards=3, chunk_waves=8)
#: Waves of a mid-replay window the shard kernels are held against their
#: twins over, launch by launch, after every node but one in a hundred is
#: filled to its allocatable (so gangs fail and roll back).
SHARD_HOLD_WAVES = 6
#: The series attribution's kernels, each with its kernel and the reference
#: lines it replaces: K5's per-slot attribution (first_reject_counts; the
#: retry pass and the per-slot route), K5's chunk fold on the retry path
#: (sim/boundary.py fold_chunk), and K6's attributed mode, the plain path's
#: instrumented chunk program (make_chunk_fn_rej).
SERIES_SOURCES = {
    "first_reject": ("first_reject", "kubernetes_simulator_tpu/ops/tpu.py:816"),
    "first_reject_fold": ("first_reject", "kubernetes_simulator_tpu/sim/boundary.py:373"),
    "chunk_replay_attributed": ("chunk_replay",
                                "kubernetes_simulator_tpu/sim/jax_runtime.py:443"),
}
#: The kernels' retry-buffer work, each with the kernel it runs in and the
#: reference lines it replaces.
RETRY_SOURCES = {
    "apply_placements_pending_release": ("apply_placements",
                                         "kubernetes_simulator_tpu/sim/whatif.py:1437"),
    "filter_score_per_scenario_pod": ("filter_score",
                                      "kubernetes_simulator_tpu/sim/whatif.py:1444"),
    "normalize_select_per_scenario_pod": ("normalize_select",
                                          "kubernetes_simulator_tpu/sim/whatif.py:1444"),
    "apply_placements_retry_bind": ("apply_placements",
                                    "kubernetes_simulator_tpu/sim/whatif.py:1444"),
    "apply_placements_failure_append": ("apply_placements",
                                        "kubernetes_simulator_tpu/sim/whatif.py:1502"),
}
#: The kernels' label-row work (each block's scenario row), each with the
#: kernel it runs in and the reference lines it replaces.
LABEL_SOURCES = {
    "filter_score_label_rows": ("filter_score", "kubernetes_simulator_tpu/ops/tpu3.py:944"),
    "apply_placements_label_rows": ("apply_placements",
                                    "kubernetes_simulator_tpu/sim/whatif.py:1760"),
}
#: The kernels the per-slot route launches (the retry buffer adds
#: retry_boundary; telemetry series first_reject): the plain twins' route,
#: and any path whose route is chosen explicitly.
SOURCES_PLAIN = ("filter_score", "normalize_select", "apply_placements")
#: Earlier times printed beside this run's (PERF.md; NVIDIA H100 80GB HBM3,
#: 700 W): K6 a slot in PR 10's chip run 6 (config4 run 7, CUDA events), the
#: cooperative K6 with two grid barriers a slot; K3's release (ms) in PR 8,
#: one block a scenario walking the pairs in order; config13's CLI wall on
#: the per-slot shard route (K1 -> K7 -> K8 a slot), before K9.
EARLIER = dict(k6_us_per_slot=dict(headline=30.15, config2=21.24, config4=19.38),
               release_ms=dict(headline=2.12, tier=4.33), config13_wall_s=6.407)
#: config4 (examples/config4_borg_1m.yaml, 10,000 nodes x 1,000,000 tasks)
#: through the CLI ``run``; the first chunks held against the per-slot route.
CONFIG4 = "examples/config4_borg_1m.yaml"
CONFIG4_HOLD_CHUNKS = 2
#: config4's generator cut so that greedy_replay recomputes it on a CPU in
#: seconds (tests/test_torch_borg_pins.py), contended (190 pods unschedulable:
#: every node choice matters), chunkWaves 32 (21 chunks, releases at 19).
BORG_CUT = dict(nodes=12, tasks=5000, chunk_waves=32)
BORG_PINS = {"placed": 4810, "unschedulable": 190,
             "sha256": "d320d2a1c17a1e88b28055be12e7fc18164d3176f9c481de920f917567a4705b"}
#: The same cut node-sharded and paged (row B13): 4 shards of 3 nodes, pages of
#: 32 x 8 slots. The placements are the replicated ones, so SHARD_PINS are
#: JaxReplayEngine(node_shards=4, paged=True)'s and greedy_replay's
#: (tests/test_torch_shards.py recomputes them).
SHARD_CUT = dict(nodes=12, tasks=5000, chunk_waves=32, node_shards=4)
SHARD_PINS = {"placed": 4810, "unschedulable": 190,
              "sha256": "d320d2a1c17a1e88b28055be12e7fc18164d3176f9c481de920f917567a4705b"}
#: Waves of the headline's first chunk that K6 is held against its twin over
#: (the twin costs ~6 ms a slot at S = 128; the whole chunk, 512 waves, ~25 s),
#: and of the window its launch is timed in.
K6_TWIN_WAVES = 64
K6_TIMED_WAVES = 8
#: The kernels' tier-preemption work, each with the kernel it runs in and
#: the reference function it replaces.
PREEMPT_SOURCES = {
    "filter_score_tier": ("filter_score", "kubernetes_simulator_tpu/ops/tpu3.py:1510"),
    "normalize_select_argmin": ("normalize_select", "kubernetes_simulator_tpu/ops/tpu.py:788"),
    "apply_placements_evict": ("apply_placements", "kubernetes_simulator_tpu/ops/tpu3.py:1629"),
    "apply_placements_tier_release": ("apply_placements",
                                      "kubernetes_simulator_tpu/sim/whatif.py:2145"),
}


def case(nodes, pods, seed=SEED, duration_mean=50.0, gang_fraction=0.02):
    """config2's generators (taints, affinity, spread, tolerations) with
    completions and gangs (of 4) on."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.1)
    workload, _ = make_workload(
        pods, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True,
        duration_mean=duration_mean, gang_fraction=gang_fraction, gang_size=4,
    )
    return encode(cluster, workload)


#: Wall of each step of the script since the previous ``mark`` (seconds),
#: into ``chip_smoke.json``'s ``step_s``.
STEP_S = {}
_last_mark = [time.perf_counter()]


def mark(step):
    now = time.perf_counter()
    STEP_S[step] = now - _last_mark[0]
    _last_mark[0] = now


def time_cuda(fn, iters, warm=3):
    """Mean ms of ``fn(i)`` over ``iters`` calls, by CUDA events after
    ``warm`` warm-up calls."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def in_turns(kernel, library, iters, match):
    """(kernel ms, library ms, the four turns) — the device time per call of
    ``kernel`` (its profiler records containing ``match``) and of ``library``
    (every record), taken in turns: kernel, library, library, kernel, each
    the mean of its two turns (CUDA events where the profiler records no
    device time)."""
    def one(fn, m):
        return device_ms(fn, iters, m) or time_cuda(fn, iters)

    turns = [one(kernel, match), one(library, None), one(library, None), one(kernel, match)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def plan_of(wrapper):
    """The cluster plan of ``wrapper``'s last launch (K2, K6, K7) as a dict:
    cluster size C, block width, grid, nodes a rank (K7: a shard)."""
    p = wrapper.plan
    return dict(C=p.C, threads=p.threads, grid=p.grid, span=p.span)


def device_ms(fn, iters, match=None, by_kernel=None):
    """Mean device time (ms) per ``fn(i)`` call over ``iters`` calls, from
    the CUPTI kernel records of torch.profiler: the kernels whose name
    contains ``match`` (or one of a tuple of names; every kernel when None).
    None when the profiler recorded no device time. ``by_kernel`` (a dict)
    receives each matched record's ms a call, by name, from the same
    profile."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = 0.0
    names = (match,) if isinstance(match, str) else match
    for evt in prof.key_averages():
        if names is None or any(m in evt.key for m in names):
            us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0)
            total_us += us
            if by_kernel is not None and us:
                by_kernel[evt.key] = us / iters / 1e3
    return total_us / iters / 1e3 if total_us > 0 else None


#: The device records of one K3 release: its two kernels, sort and sums
#: (csrc/apply_placements.cu ksim_release).
RELEASE_MATCH = ("ksim_release",)


def restored(tb, fn):
    """``fn(i)`` from the same state at every call: each carried plane of
    ``tb`` (:func:`_planes`) copied back from a snapshot first (copies that
    :data:`RELEASE_MATCH` and the kernels' names do not match). The copies
    leave L2 cold for the call, so a kernel that can be timed in place (a
    bind) is."""
    snap = {name: x.clone() for name, x in _planes(tb).items()}

    def call(i):
        for name, x in _planes(tb).items():
            x.copy_(snap[name])
        fn(i)
    return call


def index_add_ms(tb, pod_ids, nodes, iters=20, due=None):
    """The yardstick of a release: one ``index_add_`` of the live pairs'
    requests into a zeroed [S·N, R] plane under
    ``torch.use_deterministic_algorithms(True)`` (device ms, every kernel
    of the call; by CUDA events where torch.profiler recorded no device
    time). It keeps no pair order within a row, so it is a yardstick, not a
    path."""
    S, N, R = tb.state.used.shape
    pid = pod_ids if pod_ids.dim() == 2 else pod_ids.expand(S, -1)
    live = (pid >= 0) & (nodes >= 0)
    if due is not None:
        live &= due[0] <= due[1]
    s_i, k_i = torch.nonzero(live, as_tuple=True)
    rows = s_i * N + nodes[s_i, k_i].long()
    req = tb.pods.requests[pid[s_i, k_i].long()]
    plane = torch.zeros(S * N, R, dtype=torch.float32, device=req.device)
    torch.use_deterministic_algorithms(True)
    try:
        call = lambda i: plane.index_add_(0, rows, req)
        # CUDA events where the profiler keeps no device record of the call
        return device_ms(call, iters, None) or time_cuda(call, iters)
    finally:
        torch.use_deterministic_algorithms(False)


def launch_ms(launch, restore, iters, spin_cycles=1_000_000):
    """Mean ms of ``launch()`` over ``iters`` calls, each between two CUDA
    events with ``restore()`` before it, outside them (torch.profiler keeps
    no record of some long launches: PERF.md §7). A spin of ``spin_cycles``
    clock cycles on the card (≈0.5 ms) precedes each first event, so the
    host has enqueued the launch before the card reaches that event: the
    pair brackets the kernel, not the wrapper's host time."""
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(iters + 1)]
    for i, (a, b) in enumerate(evs):
        restore()
        torch.cuda._sleep(spin_cycles)
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs[1:]) / iters  # the first warms up


def chunk_events_s(eng, dev, series=False):
    """Device seconds of ``eng``'s single replay on the chunk route from its
    initial state (``series``: with the attribution and samples), chunk by
    chunk: CUDA events around the work ``run_waves`` enqueues for each chunk
    (its boundary's work, then one K6), summed. Each chunk's K6 outlasts the
    host's enqueue of the next by far, so the events bracket device time;
    torch.profiler keeps no record of some long launches (PERF.md §7)."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_series

    plan = eng.plan
    tb = eng._tables(attribute=series)
    ser = new_series(plan, tb, series) if series else None
    ch = new_choices(plan, eng.S, eng.pods.bound_node, dev)
    n, evs = plan.idx.shape[0], []
    for lo in range(0, n, plan.C):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run_waves(plan, tb, ch, lo, min(n, lo + plan.C), plain=False, ser=ser, route="chunk",
                  joint=True)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / 1e3


def profiled_busy_s(fn, by_kernel=None):
    """(result of fn(), seconds of device time torch.profiler recorded);
    ``by_kernel`` (a dict) receives the seconds by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    busy_us = 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        busy_us += us
        if by_kernel is not None and us:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
    return out, busy_us / 1e6


def k6_device_s(by_kernel):
    """K6's device seconds in a profiled run's kernel times."""
    return sum(t for k, t in by_kernel.items() if "chunk_replay" in k)


def check_chunk_launches(where, launches, plan, retry=False):
    """The chunk route's launches in a run (counters zeroed just before it):
    one K6 a chunk, K3 at each release, K1 and K2 none outside the retry
    pass (retry: K1, K2 and K4 in it)."""
    want_k6 = len(plan.buckets)
    if launches["chunk_replay"] != want_k6:
        raise AssertionError(f"{where}: {launches['chunk_replay']} K6 launches for "
                             f"{want_k6} chunks")
    if retry:
        if any(launches[k] <= 0 for k in SOURCES_PLAIN + ("retry_boundary",)):
            raise AssertionError(f"{where}: a kernel of the retry pass was not launched: "
                                 f"{launches}")
    elif launches["filter_score"] or launches["normalize_select"]:
        raise AssertionError(f"{where}: K1/K2 launched on the chunk route: {launches}")
    if any(bk is not None for bk in plan.buckets) and launches["apply_placements_release"] <= 0:
        raise AssertionError(f"{where}: no K3 release was launched")


def slot_route(where, eng, want, series=False, joint=False):
    """``eng``'s run on the per-slot route (K1 → K2 → K3 a slot; with
    ``series`` K5 after each slot's K2 on the plain path; ``joint``: the
    single replay's release order), counters zeroed just before and read
    just after: it must place ``want`` [S, P] (the chunk route's
    assignments). Returns (its launches, its wall)."""
    K.reset_launch_counts()
    _, wall, a, _, _ = eng._run(series=series, route="slot", joint=joint)
    launches = K.launch_counts()
    if launches["chunk_replay"] or any(launches[k] <= 0 for k in SOURCES_PLAIN):
        raise AssertionError(f"{where}: the per-slot route launched {launches}")
    bad = np.argwhere(a != want)
    if bad.size:
        raise AssertionError(f"{where}: the chunk route != the per-slot route at (scenario, "
                             f"pod) {bad[:5].tolist()}")
    return launches, wall


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: The launch count each K3 row of the kernels line reads: K3 counts its
#: launches by mode (ops/kernels.py apply_placements.modes).
K3_ROW_MODE = {
    "apply_placements": "apply_placements_bind",
    "apply_placements_release": "apply_placements_release",
    "apply_placements_evict": "apply_placements_bind",
    "apply_placements_tier_release": "apply_placements_release",
    "apply_placements_pending_release": "apply_placements_release",
    "apply_placements_retry_bind": "apply_placements_bind",
    "apply_placements_failure_append": "apply_placements_bind",
    "apply_placements_label_rows": "apply_placements_bind",
}


def _ids(a):
    return {int(g) for g in np.ravel(a) if g >= 0}


class Work:
    """Bytes and operations each kernel's function needs on given inputs,
    for its least time on the card: each input read once and each output
    written once. A table shared by the S scenarios (the pod rows, a
    shared allocatable or taints) counts once, a stacked one S times; a
    label row (expression matches, domains) once for each distinct row the
    scenarios read, and each scenario's row index once. A plane row counts
    only for the groups and planes the pod reads it in, and only over the
    domains of the group's key in the scenario's row; a domain-map (gdom)
    cell counts once however many scenarios look it up; a score row
    counts only where its on_* flag puts it into the total. Where the work
    depends on the run's data (K3's nodes), the nodes given are counted:
    a PAD node costs only the read of its choice."""

    def __init__(self, ep, tb):
        self.ep, self.k = ep, tb.consts
        self.S, self.N, self.R = tb.state.used.shape
        c = tb.cluster
        self.alloc_copies = c.allocatable.shape[0] if c.allocatable.dim() == 3 else 1
        self.taint_copies = c.taint_key.shape[0] if c.taint_key.dim() == 3 else 1
        self.TT = c.taint_key.shape[-1]
        self.gdom = c.gdom.cpu().numpy().astype(np.int64)  # [L, G, N]
        self.gnd = c.gnd.cpu().numpy().astype(np.int64)  # [L, G]
        self.lrow = c.lrow.cpu().numpy().astype(np.int64)  # [S]
        self.G, self.D = tb.state.match_count.shape[1:]
        k = self.k
        self.rows_on = int(k.on_fit) + int(k.on_taint) + int(k.on_na) + int(k.on_ip) + int(k.on_sp)
        #: policy rows: K1 reads a scenario's selector, K2 its five weights
        self.policy = tb.wrow is not None
        pre = tb.preempt
        self.pod_tier = pre.tier_host.astype(np.int64) if pre is not None else None
        self.Tt = pre.used_tier.shape[1] if pre is not None else 0
        self.RB = tb.retry.rbuf.shape[1] if tb.retry is not None else 0

    def k1_preempt(self, p):
        """(bytes, ops) K1 adds under tier preemption for pod p: the tier
        cells below its tier read, the candidate row written (0 for a pod
        that may not preempt)."""
        if self.pod_tier is None or self.ep.group_id[p] >= 0 or self.pod_tier[p] == 0:
            return 0, 0
        S, N, R, tp = self.S, self.N, self.R, int(self.pod_tier[p])
        return S * N * (tp * (R + 1) * 4 + 4), S * N * (tp * (2 * R + 3) + R * 3 + 3)

    def k2_fire(self, fired):
        """(bytes, ops) K2 adds in the ``fired`` scenarios: the candidate
        row read, the eviction record and stamp written."""
        return fired * (self.N * 4 + 12), fired * self.N * 2

    def k3_evict(self, cols, matches, victims, ev_tiers):
        """(bytes, ops) of K3's eviction step: the ``cols`` choice-buffer
        columns it reads in each evicting scenario (one per entry of
        ``ev_tiers``), the pod, tier, gang id and release boundary of the
        ``matches`` columns that hold the evicting node, a PAD per victim,
        and per eviction the node's used row and its tier cells below the
        preempting tier, read and written."""
        R = self.R
        nbytes = (len(ev_tiers) * cols * 4 + matches * 16 + victims * 4
                  + sum(R * 8 + int(t) * (R + 1) * 8 for t in ev_tiers))
        return nbytes, len(ev_tiers) * cols + matches * 4 + sum(int(t) * (R + 1)
                                                                for t in ev_tiers)

    def _k1_sets(self, p):
        """(the groups whose match_count, anti_active and pref_wsum rows K1
        reads, the expression columns it reads) for pod p."""
        ep, k = self.ep, self.k
        mc, aa, pw = set(), set(), set()
        if k.interpod:
            mc = _ids(ep.aff_req[p]) | _ids(ep.anti_req[p]) | _ids(ep.pref_aff[p])
            aa = set(np.nonzero(ep.pod_matches_group[p])[0].tolist())
            pw = aa if k.has_symmetric_pref else set()
        if k.spread:
            mc |= _ids(ep.spread_g[p])
        exprs = set()
        if k.node_affinity:
            exprs = _ids(ep.na_pref[p]) | (_ids(ep.na_req[p]) if ep.na_has_req[p] else set())
        return mc, aa, pw, exprs

    def _k1_reads(self, p):
        """(expression columns, looked-up groups, the groups whose plane
        rows it reads, with repeats) K1 reads for pod p."""
        mc, aa, pw, exprs = self._k1_sets(p)
        return exprs, mc | aa | pw, [g for gs in (mc, aa, pw) for g in gs]

    def _term_rows(self, pods):
        """[len(pods), *] the term rows K1's work depends on, one per pod:
        pods with equal rows cost K1 alike (a million Borg tasks share ~100
        template rows)."""
        ep = self.ep
        return np.concatenate([
            ep.aff_req[pods], ep.anti_req[pods], ep.pref_aff[pods], ep.spread_g[pods],
            ep.na_pref[pods].reshape(pods.size, -1), ep.na_req[pods].reshape(pods.size, -1),
            ep.na_has_req[pods].reshape(pods.size, -1).astype(np.int64),
            ep.pod_matches_group[pods].astype(np.int64),
        ], axis=1).astype(np.int64)

    def k1(self, p):
        """(bytes, ops) of K1 for pod p over all S scenarios."""
        return self.k1_scen(np.full(self.S, p))

    def k1_scen(self, pods):
        """(bytes, ops) of K1 with pod ``pods[s]`` in scenario s (the retry
        pass; PAD: the scenario only writes its zero rows). Tables shared by
        the scenarios count once, the pod rows once per distinct pod."""
        ep, k, N, R = self.ep, self.k, self.N, self.R
        pods = np.asarray(pods, np.int64)
        live = pods[pods >= 0]
        act, pad = live.size, pods.size - live.size
        TO = ep.tol_key.shape[1]
        exprs, looked_up = set(), set()
        cells = 0
        for p in np.unique(live).tolist():
            e, g, gl = self._k1_reads(p)
            exprs |= e
            looked_up |= g
            rows = self.lrow[pods == p]
            cells += int(self.gnd[rows][:, gl].sum())
        n_rows = np.unique(self.lrow[pods >= 0]).size
        per = lambda copies: copies if copies == 1 else act  # shared once, else per scenario
        nbytes = (
            act * N * R * 4 + (N * R * 4 if self.alloc_copies == 1 else act * N * R * 4)
            + np.unique(live).size * (R * 4 + (TO * 12 if k.taints else 0))  # pod rows
            + (per(self.taint_copies) * 3 * N * self.TT * 4 if k.taints and act else 0)
            + n_rows * N * len(exprs)  # expression-match columns the pods' terms name
            + n_rows * len(looked_up) * N * 4  # gdom rows, shared by a label row's scenarios
            + pods.size * 4  # each scenario's label row index
            + cells * 4  # plane cells, per scenario
            + act * N * (1 + self.rows_on * 4 + int(k.on_sp))  # feasible, rows, ignored
            + pad * N * (2 + ref.NUM_ROWS * 4)  # an empty slot's zero rows
            + (act * 4 if self.policy else 0)  # each scenario's fit selector
        )
        nops = act * N * (R * 8 + (self.TT * (4 + TO * 6) if k.taints else 0)
                          + len(exprs) + len(looked_up) * 4 + 16)
        return nbytes, nops

    def k5(self, pods, failed):
        """(bytes, ops) of K5 over one launch's slots: ``pods`` [S, M] the
        slots' pods (PAD: a padded slot) and ``failed`` [S, M] the slots
        whose gate is PAD (their Filter chain runs: K1's mask reads, no
        score row written; a charge writes its [K] counts twice and the
        episode mark); every slot reads its pod and gate."""
        pods = np.asarray(pods, np.int64).reshape(self.S, -1)
        failed = np.asarray(failed, bool).reshape(pods.shape)
        K_ = sum(map(bool, (self.k.fit, self.k.taints, self.k.node_affinity, self.k.interpod,
                            self.k.spread)))
        nbytes, nops = pods.size * 8, 0
        for m in range(pods.shape[1]):
            col = np.where(failed[:, m] & (pods[:, m] >= 0), pods[:, m], PAD)
            act = int((col >= 0).sum())
            if not act:
                continue
            nb, no = self.k1_scen(col)
            nbytes += (nb - act * self.N * (1 + self.rows_on * 4 + int(self.k.on_sp))
                       - (col.size - act) * self.N * (2 + ref.NUM_ROWS * 4)
                       + act * (K_ * 8 + 1))
            nops += no
        return nbytes, nops

    def k2(self):
        """(bytes, ops) of K2 for one slot over all S scenarios."""
        return self.k2_scen(self.S)

    def k2_scen(self, act):
        """(bytes, ops) of K2 where ``act`` of the S scenarios hold a pod;
        the others write their PAD choice only."""
        N = self.N
        return (act * (N * (1 + self.rows_on * 4 + int(self.k.on_sp)) + 4 + 20 * self.policy)
                + (self.S - act) * 8,
                act * N * (2 + self.rows_on * 8))

    def k3_append(self):
        """(bytes, ops) a main-path bind adds under the retry buffer: each
        scenario's count read and its buffer slot or drop counter written."""
        return self.S * 12, self.S

    def k4(self, rbuf, rchoice, pend_id, pend_relb, n_tbt):
        """(bytes, ops) of K4 on a boundary's buffers [S, RB]: every buffer
        slot, choice and pending entry read, the lists and counts written,
        and per retried bind its duration, its log2(B) steps of the
        boundary times and its two records."""
        S, RB = rbuf.shape
        placed = int(((rbuf >= 0) & (rchoice >= 0)).sum())
        steps = max(int(np.ceil(np.log2(max(n_tbt, 2)))), 1)
        nbytes = S * RB * 20 + S * (RB * 16 + 4) + placed * (4 + steps * 4 + 8)
        return nbytes, S * RB * 8 + placed * (steps + 4)

    def k3(self, pods, nodes, rollback=False):
        """(bytes, ops) of K3 applying pods[k] (or, per scenario, pods[s, k])
        at nodes[s, k] in each of the S scenarios. A rollback reads the
        wave's choices and gang ids and undoes only the pairs of a gang left
        partial: pass those pairs' nodes (PAD for the rest)."""
        ep, N, R, G, D = self.ep, self.N, self.R, self.G, self.D
        pods = np.asarray(pods, np.int64)
        K = pods.shape[-1]
        nodes = np.asarray(nodes, np.int64).reshape(-1, K)
        S = nodes.shape[0]
        pods2 = np.broadcast_to(pods, (S, K))
        uniq = np.unique(pods[pods >= 0])
        AA, PA = ep.anti_req.shape[1], ep.pref_aff.shape[1]
        nbytes = (pods.size * 4 + K * 4 + S * K * 4  # pod ids, slots; each scenario's choice
                  + S * 4  # each scenario's label row index
                  + uniq.size * (R * 4 + G + AA * 4 + PA * 8)  # the pods' shared rows
                  + (pods.size * 4 if rollback else 0))  # gang ids
        s_i, k_i = np.nonzero((nodes >= 0) & (pods2 >= 0))
        if s_i.size == 0:
            return nbytes, 0
        n, p = nodes[s_i, k_i], pods2[s_i, k_i]
        nbytes += np.unique(s_i * N + n).size * R * 8  # used rows, read and written
        if self.pod_tier is not None:  # tier cells of the non-gang pairs, distinct once
            ng = ep.group_id[p] < 0
            tcell = (s_i[ng] * self.Tt + self.pod_tier[p[ng]]) * N + n[ng]
            nbytes += np.unique(tcell).size * (R + 1) * 8
        # Each pair's (plane, group) terms: match_count (0) for each group its
        # pod matches, anti_active (1) for its anti terms, pref_wsum (2) for
        # its preferred terms.
        GM = ep.pod_matches_group.shape[1]
        plane = np.concatenate([np.zeros(GM), np.ones(AA), np.full(PA, 2)]).astype(np.int64)
        gcol = np.concatenate([np.broadcast_to(np.arange(GM), (p.size, GM)), ep.anti_req[p],
                               ep.pref_aff[p]], axis=1).astype(np.int64)
        tmask = np.concatenate([ep.pod_matches_group[p] != 0, ep.anti_req[p] >= 0,
                                ep.pref_aff[p] >= 0], axis=1)
        j, t = np.nonzero(tmask)
        if not j.size:
            return nbytes, s_i.size * R
        pl, g = plane[t], gcol[j, t]
        nn, ss = n[j], s_i[j]
        lr = self.lrow[ss] if self.lrow.size == S else np.zeros_like(ss)
        nbytes += np.unique((lr * G + g) * N + nn).size * 4  # gdom cells, shared by a row
        dom = self.gdom[lr, g, nn]
        live = dom >= 0
        cell = ((ss[live] * 3 + pl[live]) * G + g[live]) * D + dom[live]
        nbytes += np.unique(cell).size * 8  # plane cells, read and written
        return nbytes, s_i.size * R + int(live.sum())

    def k6(self, waves, gang, assignments, first=0, evictions=None, tail=0, append=False):
        """(bytes, ops) of one K6 launch over the wave rows ``waves`` [n, W]
        (waves ``first`` on, ``gang`` [n] their gang flags) with the run's
        ``assignments`` [S, P] for the binds: the chunk as one function.
        Bytes: each input it needs read once and each output written once —
        the descriptor, the used plane, the cluster tables, expression
        columns, domain-map rows and plane cells the window's pods read,
        each distinct pod's rows and each scenario's label row index (and
        policy row); the choices, and the used rows and plane cells (and
        tier cells) the binds change. K1's mask and Score rows, which K2
        reads back, are K6's own scratch and are not counted, nor is a
        slot's re-read of what an earlier slot of the launch read. Ops:
        every slot's K1, K2 and K3 work as :meth:`k1_scen`, :meth:`k2_scen`
        and :meth:`k3` count it (pods with equal term rows counted once and
        weighted). Under tier preemption ``evictions`` [n, S] (the victims
        each wave took in each scenario; ``tail`` the pre-bound columns)
        adds K1's candidate work, K2's argmin where it fired, and K3's
        eviction step with the choice buffer read once; under the retry
        buffer ``append`` adds each scenario's buffer and counters."""
        ep, k, S, N, R, G, D = self.ep, self.k, self.S, self.N, self.R, self.G, self.D
        waves = np.asarray(waves, np.int64)
        pods = waves[waves >= 0]
        nbytes, nops = waves.size * 4 + len(waves), 0  # the descriptor: slots, gang flags
        if not pods.size:
            return nbytes, 0
        TO, TT = ep.tol_key.shape[1], self.TT
        AA, PA, GM = ep.anti_req.shape[1], ep.pref_aff.shape[1], ep.pod_matches_group.shape[1]
        _, first_i, count = np.unique(self._term_rows(pods), axis=0, return_index=True,
                                      return_counts=True)
        exprs, looked, cells = set(), set(), set()
        per_node = R * 8 + (TT * (4 + TO * 6) if k.taints else 0) + 16
        for i, c in zip(first_i.tolist(), count.tolist()):
            mc, aa, pw, e = self._k1_sets(int(pods[i]))
            exprs |= e
            looked |= mc | aa | pw
            cells |= {(0, g) for g in mc} | {(1, g) for g in aa} | {(2, g) for g in pw}
            nops += c * S * N * (per_node + len(e) + len(mc | aa | pw) * 4)  # K1
        nops += pods.size * S * N * (2 + self.rows_on * 8)  # K2
        lrow = self.lrow if self.lrow.size == S else np.zeros(S, np.int64)
        n_rows = np.unique(lrow).size
        gnd = self.gnd[lrow]  # [S, G]
        uniq = np.unique(pods)
        nbytes += (
            S * N * R * 4  # the used plane
            + self.alloc_copies * N * R * 4
            + (self.taint_copies * 3 * N * TT * 4 if k.taints else 0)
            + uniq.size * (R * 4 + (TO * 12 if k.taints else 0) + GM + AA * 4 + PA * 8 + 4)
            + n_rows * N * len(exprs)  # expression-match columns
            + n_rows * len(looked) * N * 4  # domain-map rows
            + sum(int(gnd[:, g].sum()) for _, g in cells) * 4  # plane cells read
            + S * 4 + (S * 20 if self.policy else 0)  # label row index, policy row
            + S * pods.size * 4  # the choices written
        )
        # K3's binds: the used rows and plane cells they change (read above).
        nodes = np.asarray(assignments, np.int64)[:, pods]  # [S, K]
        s_i, k_i = np.nonzero(nodes >= 0)
        n, p = nodes[s_i, k_i], pods[k_i]
        nbytes += np.unique(s_i * N + n).size * R * 4
        nops += s_i.size * R
        if self.pod_tier is not None:
            tiers = self.pod_tier[pods][self.ep.group_id[pods] < 0]
            nbytes += S * N * int(tiers.max(initial=0)) * (R + 1) * 4  # tier cells K1 reads
            ng = ep.group_id[p] < 0
            tcell = (s_i[ng] * self.Tt + self.pod_tier[p[ng]]) * N + n[ng]
            nbytes += np.unique(tcell).size * (R + 1) * 4
            nops += sum(self.k1_preempt(int(q))[1] for q in pods)
        plane = np.concatenate([np.zeros(GM), np.ones(AA), np.full(PA, 2)]).astype(np.int64)
        gcol = np.concatenate([np.broadcast_to(np.arange(GM), (p.size, GM)), ep.anti_req[p],
                               ep.pref_aff[p]], axis=1).astype(np.int64)
        tmask = np.concatenate([ep.pod_matches_group[p] != 0, ep.anti_req[p] >= 0,
                                ep.pref_aff[p] >= 0], axis=1)
        j, t = np.nonzero(tmask)
        if j.size:
            pl, g, nn, ss = plane[t], gcol[j, t], n[j], s_i[j]
            lr = lrow[ss]
            unread = ~np.isin(g, sorted(looked))  # domain-map cells K1 did not read
            nbytes += np.unique(((lr * G + g) * N + nn)[unread]).size * 4
            dom = self.gdom[lr, g, nn]
            live = dom >= 0
            cell = ((ss[live] * 3 + pl[live]) * G + g[live]) * D + dom[live]
            nbytes += np.unique(cell).size * 4
            nops += int(live.sum())
        if evictions is not None:
            ev = np.asarray(evictions)
            W = waves.shape[1]
            nops += sum(self.k2_fire(int(f))[1] for f in (ev > 0).sum(axis=1) if f)
            if ev.any():
                nbytes += S * ((first + len(waves)) * W + tail) * 4  # choice buffer
            for w, v in enumerate(ev):
                if v.any():
                    cols = (first + w) * W + tail
                    nb, no = self.k3_evict(cols, int(v.sum()), int(v.sum()),
                                           [1] * int((v > 0).sum()))
                    nbytes += nb - int((v > 0).sum()) * cols * 4
                    nops += no
        if append:
            nbytes += S * (self.RB * 4 + 16)  # buffer, count and drop counter
            nops += S * pods.size
        return nbytes, nops

    def chunk_loop_ms(self, plan, assignments, launches, evictions=None, retry_walk=None):
        """B6's bound for a run on the chunk route (``launches``, the run's
        counts, must be the route's): each chunk's K6 launch (:meth:`k6`)
        and the host's launches between chunks — each release's K3 and,
        under the retry buffer ``retry_walk`` (per boundary b > 0: the
        buffer and pending list before the boundary, the pass's choices),
        the pending release, each pass slot's K1 → K2 → K3 and K4. The
        binds count the nodes the run's assignments [S, P] give them (a pod
        placed on retry counts as PAD there), which leaves out the binds of
        pods later rolled back or evicted: this term is a floor.
        ``evictions`` ([waves, S]) goes to :meth:`k6`."""
        S, C = self.S, plan.C
        k6 = 0.0
        for c in range(len(plan.buckets)):
            w = slice(c * C, (c + 1) * C)
            k6 += bound(*self.k6(plan.idx[w], plan.gang_wave[w], assignments, c * C,
                                 None if evictions is None else evictions[w],
                                 plan.prebound.size, retry_walk is not None))[0]
        releases = sum(bound(*self.k3(bk[0], assignments[:, bk[0]]))[0]
                       for bk in plan.buckets if bk is not None)
        want = dict(filter_score=0, normalize_select=0,
                    apply_placements=sum(bk is not None for bk in plan.buckets),
                    retry_boundary=0, chunk_replay=len(plan.buckets))
        out = dict(k6=k6, k3_release=releases)
        if retry_walk is not None:
            RB = retry_walk[0]["rbuf"].shape[1] if retry_walk else 0
            k1r = k2r = k3r = pend = k4 = 0.0
            for b, step in enumerate(retry_walk, start=1):
                rbuf, rch = step["rbuf"], step["rchoice"]
                due = (step["pend_id"] >= 0) & (step["pend_relb"] <= b)
                nb, no = self.k3(step["pend_id"], np.where(due, step["pend_node"], PAD))
                pend += bound(nb + S * RB * 4, no)[0]
                n = retry_slots(plan, b, RB)
                for k in range(n):
                    k1r += bound(*self.k1_scen(rbuf[:, k]))[0]
                    k2r += bound(*self.k2_scen(int((rbuf[:, k] >= 0).sum())))[0]
                    k3r += bound(*self.k3(rbuf[:, k : k + 1],
                                          np.where(rbuf[:, k : k + 1] >= 0, rch[:, k : k + 1],
                                                   PAD)))[0]
                k4 += bound(*self.k4(rbuf, rch, step["pend_id"], step["pend_relb"],
                                     plan.tbt.size))[0]
                for name in ("filter_score", "normalize_select"):
                    want[name] += n
                want["apply_placements"] += 1 + n
                want["retry_boundary"] += 1
            out.update(k3_pending_release=pend, k1_retry=k1r, k2_retry=k2r, k3_retry_bind=k3r,
                       k4=k4)
        if any(launches.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"launch counts {launches} do not match the chunk plan {want}")
        out["total"] = sum(out.values())
        out["slots"] = int((plan.idx >= 0).sum())
        return out


def _planes(tb):
    """Every carried plane of a Tables (state, scratch, tier and retry
    tables) by name."""
    out = {}
    for part in ("state", "scratch", "preempt", "retry"):
        nt = getattr(tb, part)
        if nt is not None:
            out.update({f"{part}.{f}": x for f, x in zip(nt._fields, nt) if torch.is_tensor(x)})
    return out


def same_planes(where, tb_a, ch_a, tb_b, ch_b):
    torch.cuda.synchronize()
    bad = torch.nonzero(ch_a != ch_b)
    if bad.numel():
        raise AssertionError(f"{where}: choices differ at (scenario, column) "
                             f"{bad[:5].tolist()}")
    pb = _planes(tb_b)
    for name, x in _planes(tb_a).items():
        if not torch.equal(x, pb[name]):
            raise AssertionError(f"{where}: {name} differs")


def hold_twin(where, plan, mk, waves):
    """K6 against its twin (``ref.chunk_replay``) from the initial state
    ``mk()`` makes ((tables, choices)), over waves [0, ``waves``) of the
    first chunk: the choice buffer and every plane equal after. Returns
    (K6's tables and choices, the twin's, the record)."""
    (tb_k, ch_k), (tb_t, ch_t) = mk(), mk()
    t0 = time.perf_counter()
    run_waves(plan, tb_k, ch_k, 0, waves, plain=False, route="chunk")
    torch.cuda.synchronize()
    k6_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_waves(plan, tb_t, ch_t, 0, waves, plain=True, route="chunk")
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    same_planes(f"{where}: K6 vs its twin over waves [0, {waves})", tb_k, ch_k, tb_t, ch_t)
    rec = dict(twin_window_waves=waves, twin_window_slots=int((plan.idx[:waves] >= 0).sum()),
               k6_window_s=k6_s, twin_window_s=twin_s)
    print(f"{where}: K6 == its twin over waves [0, {waves}) ({rec['twin_window_slots']} slots, "
          f"S={ch_k.shape[0]}; {k6_s:.3f}s vs {twin_s:.1f}s), choices and every plane",
          flush=True)
    return (tb_k, ch_k), (tb_t, ch_t), rec


def hold_chunk_replay(where, eng, dev, results, assignments=None):
    """K6 against its twin and the per-slot route, from ``eng``'s initial
    state: the first K6_TWIN_WAVES waves of the first chunk on K6 and on
    its twin (:func:`hold_twin`), then the rest of the chunk on K6
    against the per-slot kernels over the whole chunk — the choice buffer
    and every plane equal after each. Then K6's launch over the next
    K6_TIMED_WAVES waves timed (device time by torch.profiler, the state
    restored before each launch) beside its twin's wall and the window's
    least time (:meth:`Work.k6`, with ``assignments`` [S, P] of the full
    run for the binds). Returns the kernel-table row's numbers."""
    plan, S = eng.plan, eng.S
    desc = plan.device_desc(dev)
    mk = lambda: (eng._tables(), new_choices(plan, S, eng.pods.bound_node, dev))
    w1, C = min(K6_TWIN_WAVES, plan.C), plan.C
    (tb_k, ch_k), (tb_t, ch_t), twin_rec = hold_twin(where, plan, mk, w1)
    tb_s, ch_s = mk()
    # K6's launch over the next waves, timed from a snapshot of the state.
    w2 = min(w1 + K6_TIMED_WAVES, C)
    snap = {name: x.clone() for name, x in _planes(tb_k).items()}
    ch_snap = ch_k.clone()
    b = K.Bound(tb_k)
    boundary = 0 if tb_k.preempt is not None else None
    append = tb_k.retry is not None

    def restore(tb, ch):
        for name, x in _planes(tb).items():
            x.copy_(snap[name])
        ch.copy_(ch_snap)

    def k6(_):
        restore(tb_k, ch_k)
        K.chunk_replay(b, desc.idx, desc.gang, ch_k, w1, w2, boundary, append)

    ms = device_ms(k6, 20, match="chunk_replay")
    if ms is None:
        ms = time_cuda(k6, 20)
    k6_plan = plan_of(K.chunk_replay)

    def twin(_):
        restore(tb_t, ch_t)
        ref.chunk_replay(tb_t, desc.idx, desc.gang, ch_t, w1, w2, boundary, append)

    plain_ms = time_cuda(twin, 1, warm=1)
    same_planes(f"{where}: K6 vs its twin over waves [{w1}, {w2})", tb_k, ch_k, tb_t, ch_t)
    window = plan.idx[w1:w2]
    pods = window[window >= 0]
    a = assignments if assignments is not None else np.full((S, eng.pods.num_pods), PAD)
    if tb_k.preempt is not None:
        raise AssertionError(f"{where}: the window's bound takes no evictions")
    bound_ms, bound_by = bound(*Work(eng.pods, tb_k).k6(window, plan.gang_wave[w1:w2], a, w1,
                                                         append=append))
    # The rest of the first chunk on K6 against the per-slot kernels.
    restore(tb_k, ch_k)
    run_waves(plan, tb_k, ch_k, w1, C, plain=False, route="chunk")
    run_waves(plan, tb_s, ch_s, 0, C, plain=False, route="slot")
    same_planes(f"{where}: K6 vs the per-slot kernels over the first chunk ({C} waves)",
                tb_k, ch_k, tb_s, ch_s)
    out = dict(ms=ms, per_slot_ms=ms / max(pods.size, 1), plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, slots=int(pods.size), waves=w2 - w1,
               max_abs_err=0.0, cluster=k6_plan, **twin_rec)
    results.setdefault("k6", {})[where] = out
    print(f"{where}: K6 == the per-slot kernels over the first chunk ({C} waves), choices and "
          f"every plane; K6 over {w2 - w1} waves ({pods.size} slots, cluster "
          f"{json.dumps(k6_plan)}): "
          f"{ms * 1e3:.1f} us a launch, {ms * 1e3 / max(pods.size, 1):.2f} us a slot (bound "
          f"{bound_ms * 1e3:.3f} us by {bound_by}; twin {plain_ms:.1f} ms)", flush=True)
    return out


#: K6 beyond what the card holds at once: the headline's trace under 300
#: ``uniform_scenarios(seed=0)`` (300 clusters of one 1,024-thread block on
#: 132 SMs), over an 8-wave window (chunkWaves 8).
BEYOND = dict(scenarios=300, waves=8)


def hold_beyond_card(ec, ep, dev, results):
    """K6 at more scenarios than the card holds at once (its clusters run in
    waves, which no cooperative launch could): the first BEYOND waves on
    K6 held against its twin (:func:`hold_twin`) and the per-slot kernels
    from the same initial state (choices and every plane), then K6's launch
    over the window timed by CUDA events."""
    S = BEYOND["scenarios"]
    eng = WhatIfEngine(ec, ep, uniform_scenarios(ec, S, seed=0), FrameworkConfig(),
                       chunk_waves=BEYOND["waves"], collect_assignments=True)
    plan = eng.plan
    mk = lambda: (eng._tables(), new_choices(plan, S, eng.pods.bound_node, dev))
    (tb_k, ch_k), _, twin_rec = hold_twin(f"S={S}", plan, mk, plan.C)
    k6_plan = plan_of(K.chunk_replay)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if k6_plan["grid"] != S * k6_plan["C"] or k6_plan["grid"] <= sms:
        raise AssertionError(f"S={S}: K6's plan {k6_plan} fits the card's {sms} SMs at once")
    tb_s, ch_s = mk()
    run_waves(plan, tb_s, ch_s, 0, plan.C, plain=False, route="slot")
    same_planes(f"S={S}: K6 vs the per-slot kernels over {plan.C} waves", tb_k, ch_k, tb_s,
                ch_s)
    tb_e, ch_e = mk()
    b = K.Bound(tb_e)
    desc = plan.device_desc(dev)
    K.chunk_replay(b, desc.idx, desc.gang, ch_e, 0, plan.C)  # warm
    tb_e, ch_e = mk()
    b = K.Bound(tb_e)
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    K.chunk_replay(b, desc.idx, desc.gang, ch_e, 0, plan.C)
    ev[1].record()
    torch.cuda.synchronize()
    slots = int((plan.idx[: plan.C] >= 0).sum())
    us = ev[0].elapsed_time(ev[1]) * 1e3 / slots
    results["k6_beyond_card"] = dict(scenarios=S, sms=sms, waves=plan.C, slots=slots,
                                     us_per_slot=us, cluster=k6_plan, **twin_rec)
    print(f"S={S} ({S * k6_plan['C']} blocks on {sms} SMs): K6 == its twin and the per-slot "
          f"kernels over {plan.C} waves ({slots} slots), choices and every plane; {us:.2f} us a "
          f"slot (CUDA events)", flush=True)


def mid_replay_tables(ec, ep, cl, consts, S, rng, dev, state=None, wrow=None):
    """Twin and kernel tables of S scenarios in a mid-replay state: a third
    of the trace bound at random nodes, chosen per scenario, from the
    engine's initial ``state`` (a copy; None: the trace's own), with the
    policy rows ``wrow`` (None: static). Returns (twin tables, kernel
    tables with a copy of the state, pre-bound pods, their nodes [S, n])."""
    if state is None:
        st = init_state(ec, ep)
        state = ref.stacked_state(st.used, st.match_count, st.anti_active, st.pref_wsum, S,
                                  dev)
    else:
        state = ref.DevState(*(t.clone() for t in state))
    pods = ref.pods_to(ep, dev)
    tb_t = ref.Tables(cl, pods, state, ref.new_scratch(S, ec.num_nodes, dev), consts, wrow=wrow)
    pre = rng.choice(ep.num_pods, size=ep.num_pods // 3, replace=False).astype(np.int32)
    pre_nodes = rng.integers(0, ec.num_nodes, size=(S, pre.size)).astype(np.int32)
    pre_t = torch.as_tensor(pre, device=dev)
    ref.apply_placements(tb_t, pre_t, torch.arange(pre.size, dtype=torch.int32, device=dev),
                         torch.as_tensor(pre_nodes, device=dev), 1.0)
    tb_k = tb_t._replace(state=ref.DevState(*(t.clone() for t in tb_t.state)),
                         scratch=ref.new_scratch(S, ec.num_nodes, dev))
    return tb_t, tb_k, pre, pre_nodes


def hold_kernels(where, ep, tb_t, tb_k, pre, pre_nodes, n_slots, rng, dev):
    """Each kernel against its twin on the same inputs, slot after slot:
    masks, score rows and choices of every scenario, and the state after
    every bind, a bucketed release (each scenario's own nodes, some PAD)
    and a gang rollback (a member unplaced in odd scenarios only). Raises
    on the first difference; returns what the timings reuse."""
    S = tb_t.state.used.shape[0]
    b = K.Bound(tb_k)

    def same_state(at):
        for name in ref.DevState._fields:
            x, y = getattr(tb_k.state, name), getattr(tb_t.state, name)
            if not torch.equal(x, y):
                err = float((x - y).abs().max())
                raise AssertionError(f"{where}, {at}: state {name} differs (max |d| {err})")

    slots = rng.choice(np.setdiff1d(np.arange(ep.num_pods), pre), size=n_slots,
                       replace=False).astype(np.int32)
    pid = torch.as_tensor(slots, device=dev)
    pos = torch.arange(n_slots, dtype=torch.int32, device=dev)
    ch_k = torch.full((S, n_slots), PAD, dtype=torch.int32, device=dev)
    ch_t = ch_k.clone()
    k1_err = 0.0
    for i, p in enumerate(slots.tolist()):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        xk, xt = tb_k.scratch, tb_t.scratch
        if not torch.equal(xk.feasible, xt.feasible) or not torch.equal(xk.ignored, xt.ignored):
            raise AssertionError(f"{where}: filter_score masks differ at pod {p}")
        k1_err = max(k1_err, float((xk.scores - xt.scores).abs().max()))
        K.normalize_select(b, p, ch_k, i)
        ref.normalize_select(tb_t, p, ch_t, i)
        if not torch.equal(ch_k[:, i], ch_t[:, i]):
            raise AssertionError(f"{where}: normalize_select choices differ at pod {p}: "
                                 f"{ch_k[:, i].tolist()[:8]} != {ch_t[:, i].tolist()[:8]}")
        K.apply_placements(b, pid[i : i + 1], pos[i : i + 1], ch_k, 1.0)
        ref.apply_placements(tb_t, pid[i : i + 1], pos[i : i + 1], ch_t, 1.0)
        same_state(f"bind of pod {p}")
    if k1_err != 0.0:
        raise AssertionError(f"{where}: filter_score score rows differ by {k1_err}")
    placed = int((ch_k >= 0).sum())
    if not 0 < placed:
        raise AssertionError(f"{where}: no slot placed; the check state is degenerate")
    # A release bucket, in pod order, reading each scenario's own node.
    n_rel = min(4000, pre.size)
    rel = np.sort(rng.choice(pre.size, size=n_rel, replace=False))
    rel = rel[np.argsort(pre[rel])]
    rel_nodes = pre_nodes[:, rel].copy()
    rel_nodes[rng.random(rel_nodes.shape) < 0.1] = PAD
    rel_p = torch.as_tensor(pre[rel], device=dev)
    rel_pos = torch.arange(n_rel, dtype=torch.int32, device=dev)
    rel_ch = torch.as_tensor(rel_nodes, device=dev)
    K.apply_placements(b, rel_p, rel_pos, rel_ch, -1.0)
    ref.apply_placements(tb_t, rel_p, rel_pos, rel_ch, -1.0)
    torch.cuda.synchronize()
    same_state("release")
    # Gang rollback over one wave: a gang whose last member is unplaced in
    # the odd scenarios (in the only one at S=1), a complete gang, a
    # non-gang pod and a padded slot.
    gid = ep.group_id
    gangs = np.unique(gid[gid >= 0])[:2]
    g0 = np.nonzero(gid == gangs[0])[0]
    wave = np.concatenate([g0, np.nonzero(gid == gangs[1])[0], np.nonzero(gid < 0)[0][:1],
                           [PAD]]).astype(np.int32)
    wnodes = rng.integers(0, tb_t.state.used.shape[1], size=(S, wave.size)).astype(np.int32)
    unplaced = (np.arange(S) % 2 == 1) if S > 1 else np.ones(1, bool)
    wnodes[unplaced, g0.size - 1] = PAD
    wnodes[:, -1] = PAD
    w_p = torch.as_tensor(wave, device=dev)
    w_pos = torch.arange(wave.size, dtype=torch.int32, device=dev)
    wn_k = torch.tensor(wnodes, device=dev)
    wn_t = wn_k.clone()
    K.apply_placements(b, w_p, w_pos, wn_k, -1.0, rollback=True)
    ref.apply_placements(tb_t, w_p, w_pos, wn_t, -1.0, rollback=True)
    torch.cuda.synchronize()
    same_state("rollback")
    rolled = (wn_k < 0).sum(dim=1).cpu().numpy() - (wnodes < 0).sum(axis=1)
    if (not torch.equal(wn_k, wn_t) or not (rolled[unplaced] == g0.size - 1).all()
            or (rolled[~unplaced] != 0).any()):
        raise AssertionError(f"{where}: rollback choices differ or rolled back the wrong gangs")
    print(f"{where}: {n_slots} slots x {S} scenarios ({placed} placements), a {n_rel}-pair "
          f"release and a gang rollback; kernels equal their twins exactly", flush=True)
    return dict(b=b, slots=slots, pid=pid, ch_k=ch_k, ch_t=ch_t, k1_err=k1_err, placed=placed,
                rel=(rel_p, rel_pos, rel_ch, pre[rel]))


# ---------------------------------------------------------------------------
# K3's release (pairs grouped by node, each node summed in pair order)
# ---------------------------------------------------------------------------

#: The release cases on BORG_CUT (12 nodes x 5,000 Borg-shaped tasks, their
#: requests not binary fractions): RELEASE_S scenarios each bind
#: RELEASE_PAIRS tasks at random nodes of their own (a tenth PAD), then
#: release them — some 300 pairs a node.
RELEASE_CASES = ("borg", "tier", "labels", "pending")
RELEASE_S = 4
RELEASE_PAIRS = 4000
#: The same cut's release of every task: tiles of K3's release sort
#: (kernels.release_tile: 1,024 pairs at 4 scenarios) with a short last one.
RELEASE_ALL = 5000
#: The pending case's boundary: pairs whose relb <= RELEASE_DUE release.
RELEASE_DUE = 2


def release_case(kind, ec, ep, dev, S=RELEASE_S, pods=None, n_pairs=RELEASE_PAIRS, seed=SEED):
    """Kernel and twin tables of S scenarios and one release on the cluster
    ``ec`` and trace ``ep``: the released pods (``pods``, in pod order;
    None: ``n_pairs`` drawn at random) are first bound, through the twin,
    at random nodes of each scenario's own (a tenth PAD) on the trace's
    initial state. ``kind``: ``borg`` plain; ``tier`` with three tier
    planes (random tiers); ``labels`` each scenario its own label row
    (scenario s > 0 reads a permutation of the domain table's node axis);
    ``pending`` the retry buffer's pending lists (each scenario its own
    pods, relb in [0, 4], due at RELEASE_DUE). Returns the kernel's and
    the twin's (tables, pod ids, pos, nodes, due or None)."""
    rng = np.random.default_rng(seed)
    N, R, P = ec.num_nodes, ec.num_resources, ep.num_pods
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    st = init_state(ec, ep)
    state = ref.stacked_state(st.used, st.match_count, st.anti_active, st.pref_wsum, S, dev)
    cl = ref.cluster_to(ec, dev, S)
    if kind == "labels":
        perm = [torch.arange(N, device=dev)] + [
            torch.as_tensor(rng.permutation(N), device=dev) for _ in range(S - 1)]
        rows = lambda t: t.expand(S, *t.shape[1:]).contiguous()
        cl = cl._replace(gdom=torch.stack([cl.gdom[0][:, q] for q in perm]).contiguous(),
                         expr_match=rows(cl.expr_match), gnd=rows(cl.gnd), sp_w=rows(cl.sp_w),
                         lrow=torch.arange(S, dtype=torch.int32, device=dev))
    tb = ref.Tables(cl, ref.pods_to(ep, dev), state, ref.new_scratch(S, N, dev), consts)
    if pods is None:
        pods = np.sort(rng.choice(P, size=n_pairs, replace=False))
    pods = np.asarray(pods, np.int32)
    nodes = rng.integers(0, N, size=(S, pods.size)).astype(np.int32)
    nodes[rng.random(nodes.shape) < 0.1] = PAD
    pos = torch.arange(pods.size, dtype=torch.int32, device=dev)
    due = None
    if kind == "tier":
        tiers = rng.integers(0, 3, size=P).astype(np.int32)
        tb = tb._replace(preempt=ref.new_preempt(
            tiers, ep.group_id, pods, np.zeros(pods.size, np.int32), pods.size,
            np.zeros((3, N, R), np.float32), np.zeros((3, N), np.float32), S, dev))
    if kind == "pending":
        rt = ref.new_retry(pods.size, ep.duration, np.arange(4, dtype=np.float32), S, dev)
        ids = np.stack([np.sort(rng.choice(P, size=pods.size, replace=False))
                        for _ in range(S)]).astype(np.int32)
        ids[rng.random(ids.shape) < 0.05] = PAD
        rt.pend_id.copy_(torch.as_tensor(ids))
        rt.pend_node.copy_(torch.as_tensor(nodes))
        rt.pend_relb.copy_(torch.as_tensor(rng.integers(0, 5, size=ids.shape).astype(np.int32)))
        tb = tb._replace(retry=rt)
    ref.apply_placements(tb, *release_pairs(tb, pods, pos, nodes)[:3], 1.0)  # what it takes back
    tb_k = clone_tables(tb)
    return ((tb_k, *release_pairs(tb_k, pods, pos, nodes)),
            (tb, *release_pairs(tb, pods, pos, nodes)))


def release_pairs(tb, pods, pos, nodes):
    """(pod ids, pos, nodes, due or None) of a case's release on ``tb``: the
    pending lists of its retry tables, else ``pods`` at ``nodes``."""
    rt = tb.retry
    if rt is not None:
        return rt.pend_id, pos, rt.pend_node, (rt.pend_relb, RELEASE_DUE)
    dev = tb.state.used.device
    return torch.as_tensor(pods, device=dev), pos, torch.as_tensor(nodes, device=dev), None


def hold_release(where, ep, case, timed=True):
    """K3's release against its twin (``ref.apply_placements``, which sums
    each node's requests by ``_add_in_pair_order``) and against
    ``_add_in_pair_order`` itself, on one case (:func:`release_case`):
    every plane bit for bit, and exactly one K3 launch. ``timed``: its
    device time (20 releases from a restored state, :data:`RELEASE_MATCH`)
    beside the twin's wall, one deterministic ``index_add_`` of the same
    requests and the least time (:meth:`Work.k3`). Returns the record."""
    (tb_k, pid_k, pos, ch_k, due_k), (tb_t, pid_t, _, ch_t, due_t) = case
    b = K.Bound(tb_k)
    S, N, R = tb_t.state.used.shape
    used0 = tb_t.state.used.clone()
    n0 = K.apply_placements.launches
    K.apply_placements(b, pid_k, pos, ch_k, -1.0, due=due_k)
    if K.apply_placements.launches != n0 + 1:
        raise AssertionError(f"{where}: the release did not launch K3 once")
    ref.apply_placements(tb_t, pid_t, pos, ch_t, -1.0, due=due_t)
    same_planes(f"{where}: K3's release vs its twin", tb_k, ch_k, tb_t, ch_t)
    pid = pid_t if pid_t.dim() == 2 else pid_t.expand(S, -1)
    live = (pid >= 0) & (ch_t >= 0)
    if due_t is not None:
        live &= due_t[0] <= due_t[1]
    s_i, k_i = torch.nonzero(live, as_tuple=True)
    rows = s_i * N + ch_t[s_i, k_i].long()
    req = tb_t.pods.requests[pid[s_i, k_i].long()]
    delta = torch.zeros(S * N, R, dtype=torch.float32, device=req.device)
    ref._add_in_pair_order(delta, rows, req)
    if not torch.equal(tb_k.state.used, used0 - delta.view(S, N, R)):
        raise AssertionError(f"{where}: K3's release != used less _add_in_pair_order's sums")
    dyadic = bool((req * 1024 == torch.round(req * 1024)).all())
    rec = dict(scenarios=S, pairs=int(pid.shape[1]), live_pairs=int(live.sum()),
               max_pairs_a_node=int(torch.bincount(rows).max()) if rows.numel() else 0,
               dyadic_requests=dyadic, tier=tb_t.preempt is not None,
               label_rows=int(tb_t.cluster.gdom.shape[0]), pending=due_t is not None,
               max_abs_err=0.0)
    if timed:
        due_nodes = ch_t if due_t is None else torch.where(
            due_t[0] <= due_t[1], ch_t, torch.full_like(ch_t, PAD))
        nb, no = Work(ep, tb_t).k3(pid_t.cpu().numpy(), due_nodes.cpu().numpy())
        split = {}
        rec.update(
            ms=device_ms(restored(tb_k, lambda i: K.apply_placements(b, pid_k, pos, ch_k, -1.0,
                                                                     due=due_k)),
                         20, RELEASE_MATCH, split),
            ms_by_kernel=split,
            plain_ms=time_cuda(restored(tb_t, lambda i: ref.apply_placements(
                tb_t, pid_t, pos, ch_t, -1.0, due=due_t)), 3, warm=1),
            library_ms=index_add_ms(tb_t, pid_t, ch_t, due=due_t), bytes=float(nb),
            ops=float(no))
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["ops"])
    print(f"{where}: K3's release ({rec['live_pairs']} live of {rec['pairs']} pairs x {S} "
          f"scenarios, up to {rec['max_pairs_a_node']} on a node) == its twin and "
          f"_add_in_pair_order, every plane bit for bit"
          + (f"; {rec['ms'] * 1e3:.1f} us (by kernel, us: {_us(rec['ms_by_kernel'])}; twin "
             f"{rec['plain_ms']:.2f} ms, deterministic index_add_ {rec['library_ms'] * 1e3:.1f} "
             f"us, bound {rec['bound_ms'] * 1e3:.3f} us)" if timed else ""), flush=True)
    return rec


def _us(by_kernel):
    """A profile's ms a call by kernel as a JSON object of µs, names cut to
    the kernel's."""
    return json.dumps({k.split("(")[0].split("<")[0].replace("void ", ""): round(v * 1e3, 2)
                       for k, v in by_kernel.items()})


def check_releases(results, dev):
    """K3's release on BORG_CUT, each of RELEASE_CASES (plain, tier planes,
    label rows, pending) and the plain one of every task held and timed
    (:func:`hold_release`)."""
    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    bc = BORG_CUT
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=bc["nodes"], tasks=bc["tasks"], seed=SEED))
    out = {}
    cases = [(k, RELEASE_PAIRS) for k in RELEASE_CASES] + [("borg", RELEASE_ALL)]
    for kind, pairs in cases:
        name = kind if pairs == RELEASE_PAIRS else f"{kind}_all"
        out[name] = hold_release(f"Borg cut release ({name})", ep,
                                 release_case(kind, ec, ep, dev, n_pairs=pairs))
        if out[name]["dyadic_requests"] or out[name]["max_pairs_a_node"] < 100:
            raise AssertionError(f"Borg cut release ({name}): the case lost its point "
                                 f"({out[name]})")
    results["release_borg_cut"] = out


def time_kernels(ep, tb_t, held, dev, iters=200, plain_iters=20):
    """Device time per launch (torch.profiler) and host launch interval
    (CUDA events) of each kernel at the held shapes, beside its twin's
    time, a PyTorch yardstick and the least time the card could take."""
    b, slots, pid = held["b"], held["slots"], held["pid"]
    ch_k, ch_t = held["ch_k"], held["ch_t"]
    S = tb_t.state.used.shape[0]
    n = len(slots)
    sl = slots.tolist()
    t_k1 = time_cuda(lambda i: K.filter_score(b, sl[i % n]), iters)
    t_k1_plain = time_cuda(lambda i: ref.filter_score(tb_t, sl[i % n]), plain_iters)
    t_k2 = time_cuda(lambda i: K.normalize_select(b, sl[i % n], ch_k, 0), iters)
    t_k2_plain = time_cuda(lambda i: ref.normalize_select(tb_t, sl[i % n], ch_t, 0), plain_iters)
    ref.filter_score(tb_t, sl[0])
    total = ref.weighted_total(tb_t, sl[0])
    masked = torch.where(tb_t.scratch.feasible, total, torch.full_like(total, float("-inf")))
    t_argmax = time_cuda(lambda i: torch.argmax(masked, dim=-1), iters)
    one_p = pid[:1]
    one_pos = torch.zeros(1, dtype=torch.int32, device=dev)
    one_ch = ch_k[:, :1].clone().clamp_(min=0).contiguous()
    one_ch_t = one_ch.clone()
    # Releases from a restored state (each launch interval includes the
    # restore's copies; the device times match the kernels alone), taken
    # first; then the bind in place, the same pod on the same node again and
    # again (warm L2, as the chunk route's binds run).
    rel_p, rel_pos, rel_ch, rel_pods = held["rel"]
    rel_k = restored(b.tables, lambda i: K.apply_placements(b, rel_p, rel_pos, rel_ch, -1.0))
    t_rel = time_cuda(rel_k, 10)
    t_rel_plain = time_cuda(
        restored(tb_t, lambda i: ref.apply_placements(tb_t, rel_p, rel_pos, rel_ch, -1.0)), 10)
    d_k1 = device_ms(lambda i: K.filter_score(b, sl[i % n]), iters, "ksim_filter_score")
    d_k2, d_argmax, k2_turns = in_turns(lambda i: K.normalize_select(b, sl[i % n], ch_k, 0),
                                        lambda i: torch.argmax(masked, dim=-1), iters,
                                        "ksim_normalize_select")
    k2_plan = plan_of(K.normalize_select)
    rel_split = {}
    d_rel = device_ms(rel_k, 20, RELEASE_MATCH, rel_split)
    bind_k = lambda i: K.apply_placements(b, one_p, one_pos, one_ch, 1.0)
    t_k3 = time_cuda(bind_k, iters)
    t_k3_plain = time_cuda(lambda i: ref.apply_placements(tb_t, one_p, one_pos, one_ch_t, 1.0),
                           plain_iters)
    d_k3 = device_ms(bind_k, iters, "ksim_apply")
    lib_rel = index_add_ms(tb_t, rel_p, rel_ch)
    pick = lambda d, t: d if d is not None else t
    work = Work(ep, tb_t)
    k1b, k1o = np.mean([work.k1(p) for p in sl], axis=0)
    k2b, k2o = work.k2()
    k3b, k3o = work.k3(one_p.cpu().numpy(), one_ch.cpu().numpy())
    rb, ro = work.k3(rel_pods, rel_ch.cpu().numpy())
    out = {
        "filter_score": dict(max_abs_err=held["k1_err"], ms=pick(d_k1, t_k1), device_ms=d_k1,
                             launch_interval_ms=t_k1, plain_ms=t_k1_plain, bytes=float(k1b),
                             ops=float(k1o), library_ms=None),
        "normalize_select": dict(max_abs_err=0.0, ms=d_k2, device_ms=d_k2,
                                 launch_interval_ms=t_k2, plain_ms=t_k2_plain,
                                 bytes=float(k2b), ops=float(k2o), library_ms=d_argmax,
                                 library_launch_interval_ms=t_argmax, turns_ms=k2_turns,
                                 cluster=k2_plan),
        "apply_placements": dict(max_abs_err=0.0, ms=pick(d_k3, t_k3), device_ms=d_k3,
                                 launch_interval_ms=t_k3, plain_ms=t_k3_plain,
                                 bytes=float(k3b), ops=float(k3o), library_ms=None),
    }
    for m in out.values():
        m["bound_ms"], m["bound_by"] = bound(m["bytes"], m["ops"])
    k2 = out["normalize_select"]
    print(f"K2 at S={S}, N={tb_t.state.used.shape[1]} (cluster {json.dumps(k2_plan)}): "
          f"{d_k2 * 1e3:.2f} us vs torch.argmax {d_argmax * 1e3:.2f} us in turns "
          f"{[round(t * 1e3, 2) for t in k2_turns]} (bound {k2['bound_ms'] * 1e3:.3f} us)",
          flush=True)
    release = dict(pairs=len(rel_pods), scenarios=S, ms=pick(d_rel, t_rel), device_ms=d_rel,
                   ms_by_kernel=rel_split, launch_interval_ms=t_rel, plain_ms=t_rel_plain,
                   library_ms=lib_rel, bytes=float(rb), ops=float(ro), max_abs_err=0.0)
    release["bound_ms"], release["bound_by"] = bound(float(rb), float(ro))
    return out, release


def check_kernels_s1(ec, ep, results, dev):
    """Step 3: S=1 kernels vs twins at the config2 shape."""
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    rng = np.random.default_rng(SEED)
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, ref.cluster_to(ec, dev), consts, 1,
                                                   rng, dev)
    held = hold_kernels("S=1 kernel checks (N=5000)", ep, tb_t, tb_k, pre, pre_nodes, 300, rng,
                        dev)
    results["kernels_s1_n5000"], results["apply_release_s1_n5000"] = time_kernels(
        ep, tb_t, held, dev)


def check_kernels_s4(ec, ep, results, dev):
    """Step 4: S=4 kernels vs twins at N=5000, scenarios whose allocatable
    and taints differ."""
    scen = uniform_scenarios(ec, 4, seed=SEED + 1, p_node_down=1.0, p_capacity=1.0, p_taint=1.0)
    scen[1].perturbations.append(Perturbation(
        "add_taint", nodes=np.arange(0, ec.num_nodes, 6), key="whatif/soft", value="x",
        effect="PreferNoSchedule"))
    ss = ScenarioSet(ec, scen, device=dev)
    for a, c in ((ss.alloc[1], ss.alloc[2]), (ss.taint_key[1], ss.taint_key[2])):
        if torch.equal(a, c):
            raise AssertionError("the S=4 check's scenarios do not differ")
    consts = dataclasses.replace(StepSpec.from_config(ec, FrameworkConfig(), ep),
                                 taint_score=True).consts()
    cl = ref.cluster_to(ec, dev, 4)._replace(
        allocatable=ss.alloc, taint_key=ss.taint_key, taint_kv=ss.taint_kv,
        taint_effect=ss.taint_effect)
    rng = np.random.default_rng(SEED + 4)
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, cl, consts, 4, rng, dev)
    held = hold_kernels("S=4 kernel checks (N=5000)", ep, tb_t, tb_k, pre, pre_nodes, 150, rng,
                        dev)
    results["check_s4"] = dict(slots=150, placements=held["placed"],
                               release_pairs=len(held["rel"][3]))


def check_reduced_replay(results, dev="cuda"):
    """Step 5: kernel path == plain path on the card == plain path on the
    CPU, on a trace where completions change the placements."""
    nodes, pods = 300, REDUCED_PODS
    ec, ep = case(nodes, pods, duration_mean=20.0, gang_fraction=0.05)
    kw = dict(wave_width=8, chunk_waves=64)
    t0 = time.perf_counter()
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, **kw)
    kern = eng.replay()
    t1 = time.perf_counter()
    if kern.route != "chunk":
        raise AssertionError(f"reduced replay ran on route {kern.route}")
    _, slot_s = slot_route("reduced replay", eng, kern.assignments[None])
    t1s = time.perf_counter()
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, plain=True,
                              **kw).replay()
    t2 = time.perf_counter()
    cpu = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", plain), ("plain on the cpu", cpu)):
        diff = np.nonzero(kern.assignments != other.assignments)[0]
        if diff.size:
            raise AssertionError(f"reduced replay: kernel path != {name} at pods {diff[:5]}")
        for plane in ("used", "match_count", "anti_active", "pref_wsum"):
            if not np.array_equal(getattr(kern.state, plane), getattr(other.state, plane)):
                raise AssertionError(f"reduced replay: {plane} differs from {name}")
    off = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, completions=False,
                            **kw).replay()
    moved = int((off.assignments != kern.assignments).sum())
    if kern.placed <= 0 or moved == 0:
        raise AssertionError("reduced replay placed nothing or completions changed nothing")
    results["reduced"] = dict(nodes=nodes, pods=pods, placed=kern.placed,
                              unschedulable=kern.unschedulable, moved_by_completions=moved,
                              kernel_s=t1 - t0, slot_route_s=slot_s, plain_card_s=t2 - t1s,
                              plain_cpu_s=t3 - t2)
    print(f"reduced replay ({nodes} nodes, {pods} pods): placed {kern.placed}, identical on the "
          f"chunk route (K6), the per-slot kernels, the plain path on the card and on the CPU "
          f"({t1 - t0:.2f}s / {slot_s:.2f}s / {t2 - t1s:.2f}s / {t3 - t2:.2f}s); completions "
          f"move {moved} assignments", flush=True)


def check_reduced_whatif(results, dev="cuda"):
    """Step 6: the what-if batch on the kernel path == the plain path on the
    card == the plain path on the CPU."""
    nodes, pods = 60, 3000
    ec, ep = case(nodes, pods, duration_mean=60.0, gang_fraction=0.05)
    scen = uniform_scenarios(ec, 8, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    kw = dict(wave_width=8, chunk_waves=64, collect_assignments=True)
    mk = lambda **o: WhatIfEngine(ec, ep, scen, FrameworkConfig(), **{**kw, **o})
    t0 = time.perf_counter()
    eng = mk(device=dev)
    kern = eng.run()
    t1 = time.perf_counter()
    if kern.route != "chunk":
        raise AssertionError(f"reduced what-if ran on route {kern.route}")
    _, slot_s = slot_route("reduced what-if", eng, kern.assignments)
    t1s = time.perf_counter()
    plain = mk(device=dev, plain=True).run()
    t2 = time.perf_counter()
    cpu = mk(device="cpu").run()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", plain), ("plain on the cpu", cpu)):
        bad = np.argwhere(kern.assignments != other.assignments)
        if bad.size:
            raise AssertionError(f"reduced what-if: kernel path != {name} at (scenario, pod) "
                                 f"{bad[:5].tolist()}")
    if not np.array_equal(kern.utilization_cpu, plain.utilization_cpu):
        raise AssertionError("reduced what-if: utilization differs from the plain path")
    off = mk(device=dev, completions=False).run()
    moved = int((off.assignments != kern.assignments).sum())
    distinct = len({a.tobytes() for a in kern.assignments})
    gang_unplaced = int((kern.assignments[:, ep.group_id >= 0] < 0).sum())
    if moved == 0 or distinct < 2 or gang_unplaced == 0 or kern.total_placed <= 0:
        raise AssertionError("reduced what-if is vacuous (no scenario, completion or gang "
                             "rollback effect)")
    results["reduced_whatif"] = dict(
        scenarios=len(scen), nodes=nodes, pods=pods, placed=kern.placed.tolist(),
        moved_by_completions=moved, distinct_scenarios=distinct,
        gang_pods_unplaced=gang_unplaced,
        kernel_s=t1 - t0, slot_route_s=slot_s, plain_card_s=t2 - t1s, plain_cpu_s=t3 - t2)
    print(f"reduced what-if (8 scenarios x {nodes} nodes x {pods} pods): placed "
          f"{kern.placed.tolist()}, assignments identical on the chunk route (K6), the per-slot "
          f"kernels, the plain path on the card and on the CPU ({t1 - t0:.2f}s / "
          f"{slot_s:.2f}s / {t2 - t1s:.2f}s / {t3 - t2:.2f}s); "
          f"completions move {moved} assignments, {gang_unplaced} gang pods rolled back or "
          f"unplaced", flush=True)


def check_result(ec, ep, res):
    P = ep.num_pods
    if res.assignments.shape != (P,) or res.state.used.shape != ec.allocatable.shape:
        raise AssertionError("result shapes are wrong")
    for plane in ("used", "match_count", "anti_active", "pref_wsum"):
        if not np.all(np.isfinite(getattr(res.state, plane))):
            raise AssertionError(f"{plane} holds non-finite values")
    if res.placed + res.unschedulable != res.attempts or res.placed <= 0:
        raise AssertionError("placed/unschedulable do not add up")
    a = res.assignments
    if not np.all((a >= PAD) & (a < ec.num_nodes)):
        raise AssertionError("assignments out of range")
    if not np.all(res.state.used <= ec.allocatable + 1e-3):
        raise AssertionError("a node is committed past its allocatable")
    if res.state.match_count.min() < 0 or res.state.anti_active.min() < 0:
        raise AssertionError("a count plane went negative")
    gid = ep.group_id
    for g in np.unique(gid[gid >= 0]):
        placed = a[gid == g] >= 0
        if placed.any() and not placed.all():
            raise AssertionError(f"gang {g} placed partially")


def check_whatif_result(ep, res, S):
    to_schedule = int((ep.bound_node < 0).sum())
    if res.placed.shape != (S,) or res.utilization_cpu.shape != (S,):
        raise AssertionError("what-if result shapes are wrong")
    if not np.all(res.placed + res.unschedulable == to_schedule) or (res.placed <= 0).any():
        raise AssertionError("what-if placed/unschedulable do not add up")
    u = res.utilization_cpu
    if not np.all(np.isfinite(u)) or (u < 0).any() or (u > 1 + 1e-5).any():
        raise AssertionError(f"utilization out of range: {u.min()}..{u.max()}")
    if int(res.placed.sum()) != res.total_placed:
        raise AssertionError("total_placed is not the sum over scenarios")


# ---------------------------------------------------------------------------
# Tier preemption (devicePreemption: true)
# ---------------------------------------------------------------------------


#: Encoded cases already built, keyed by case and arguments: a later step
#: that asks for the same case gets a deep copy instead of a new encode.
_CASES = {}


def _case_copy(key, build):
    if key not in _CASES:
        _CASES[key] = build()
    return copy.deepcopy(_CASES[key])


def config6_case(whatif=False, nodes=None, pods=None):
    """(SimConfig, EncodedCluster, EncodedPods) of CONFIG6 as the port's
    config parses it: 500 nodes, 26,000 pods, priority tiers {0, 100,
    1000}, the full default plugin set. ``whatif`` adds the what-if shape's
    durations and gangs (PREEMPT_WHATIF); ``nodes`` / ``pods`` cut it."""
    return _case_copy(("config6", whatif, nodes, pods),
                      lambda: _config6_case(whatif, nodes, pods))


def _config6_case(whatif, nodes, pods):
    import yaml

    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, build_encoded_case

    with open(os.path.join(ROOT, CONFIG6)) as f:
        d = yaml.safe_load(f)
    syn = d["workload"]["synthetic"]
    if whatif:
        syn.update(durationMean=PREEMPT_WHATIF["duration_mean"],
                   gangFraction=PREEMPT_WHATIF["gang_fraction"],
                   gangSize=PREEMPT_WHATIF["gang_size"])
    if nodes:
        d["cluster"]["synthetic"]["nodes"] = nodes
    if pods:
        syn["pods"] = pods
    cfg = SimConfig.from_dict(d)
    return (cfg,) + tuple(build_encoded_case(cfg))


def assignments_sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.int32).tobytes()).hexdigest()


def check_pins(where, pin, placed, victims, assignments):
    got = dict(placed=int(placed), victims=int(victims), sha256=assignments_sha256(assignments))
    if got != pin:
        raise AssertionError(f"{where}: {got} != greedy_replay's pinned {pin}")


def hold_preempt(where, eng, n_check, dev, results):
    """Each kernel against its twin under tier preemption, launch after
    launch, in a mid-replay window where evictions fire: a kernel-path run
    of ``eng`` (reading each scenario's victims after every wave, which
    also gives B6's bound its evictions) finds the 16-wave block with the
    most victims; a second run stops at that block, the state is
    copied into twin tables on the card, and from there K1 → K2 → K3 (and
    each boundary release and gang rollback) run on both for ``n_check``
    slots. After every launch the masks, score rows, candidate rows,
    choices, eviction records and stamps, victim marks (the whole choice
    buffer), victim counters, state planes and tier planes must be equal.
    Then a release bucket of the placed pods (tier planes included) and,
    where the trace has gangs, a gang rollback. Returns what the timings
    reuse."""
    plan, S, bound_node = eng.plan, eng.S, eng.pods.bound_node
    nw = plan.idx.shape[0]
    tb = eng._tables()
    ch = new_choices(plan, S, bound_node, dev)
    vic = np.zeros((nw + 1, S), np.int64)
    for w in range(nw):
        run_waves(plan, tb, ch, w, w + 1, plain=False)
        vic[w + 1] = tb.preempt.victims.cpu().numpy()
    wave_victims = np.diff(vic, axis=0)  # [waves, S] victims each wave took
    gain = np.add.reduceat(wave_victims.sum(axis=1), np.arange(0, nw, 16))
    if gain.max() <= 0:
        raise AssertionError(f"{where}: no eviction fired in the run")
    w_start = int(np.argmax(gain)) * 16
    tb_k = eng._tables()
    ch_k = new_choices(plan, S, bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, w_start, plain=False)
    torch.cuda.synchronize()
    clone = lambda nt: type(nt)(*(x.clone() if torch.is_tensor(x) else x for x in nt))
    tb_t = tb_k._replace(state=clone(tb_k.state), scratch=clone(tb_k.scratch),
                         preempt=clone(tb_k.preempt))
    ch_t = ch_k.clone()
    b = K.Bound(tb_k)
    pk, pt = tb_k.preempt, tb_t.preempt

    def same(at, parts=("state", "preempt", "choices")):
        if "scratch" in parts:
            for name in ("feasible", "ignored", "scores"):
                if not torch.equal(getattr(tb_k.scratch, name), getattr(tb_t.scratch, name)):
                    raise AssertionError(f"{where}, {at}: scratch {name} differs")
        if "state" in parts:
            for name in ref.DevState._fields:
                x, y = getattr(tb_k.state, name), getattr(tb_t.state, name)
                if not torch.equal(x, y):
                    raise AssertionError(f"{where}, {at}: state {name} differs "
                                         f"(max |d| {float((x - y).abs().max())})")
        if "preempt" in parts:
            for name in ("used_tier", "npods_tier", "cand", "last_wave", "ev_node", "ev_tier",
                         "victims"):
                if not torch.equal(getattr(pk, name), getattr(pt, name)):
                    raise AssertionError(f"{where}, {at}: preempt.{name} differs")
        if "choices" in parts and not torch.equal(ch_k, ch_t):
            bad = torch.nonzero(ch_k != ch_t)[:5].tolist()
            raise AssertionError(f"{where}, {at}: choice buffers differ at {bad}")

    same("the window's start")
    idx_dev = torch.as_tensor(plan.idx.reshape(-1), device=dev)
    pos_dev = torch.arange(plan.L, dtype=torch.int32, device=dev)
    W, C = plan.idx.shape[1], plan.C
    slots, evictions, fire_slot, v0 = 0, 0, None, int(pk.victims.sum())
    releases = rollbacks = cand_rows = 0
    w = w_start
    while slots < n_check and w < nw:
        bnd = w // C
        if w % C == 0 and plan.buckets[bnd] is not None:
            bp, bpos = (torch.as_tensor(x, device=dev) for x in plan.buckets[bnd])
            K.apply_placements(b, bp, bpos, ch_k, -1.0)
            ref.apply_placements(tb_t, bp, bpos, ch_t, -1.0)
            same(f"release at boundary {bnd}")
            releases += 1
        for k, p in enumerate(plan.idx[w].tolist()):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(b, p)
            ref.filter_score(tb_t, p)
            same(f"K1 of pod {p}", ("scratch", "preempt"))
            cand_rows += int(pk.eligible[p])
            K.normalize_select(b, p, ch_k, s, w)
            ref.normalize_select(tb_t, p, ch_t, s, w)
            same(f"K2 of pod {p}", ("preempt", "choices"))
            fired = int((pk.ev_node >= 0).sum())
            if fired:
                evictions += fired
                if fire_slot is None or fired > fire_slot["fired"]:
                    # The slot the timings replay: its tables before K3.
                    fire_slot = dict(p=p, s=s, boundary=bnd, fired=fired, ch=ch_k.clone(),
                                     tables=tb_k._replace(state=clone(tb_k.state),
                                                          scratch=clone(tb_k.scratch),
                                                          preempt=clone(pk)))
            K.apply_placements(b, idx_dev[s : s + 1], pos_dev[s : s + 1], ch_k, 1.0,
                               boundary=bnd)
            ref.apply_placements(tb_t, idx_dev[s : s + 1], pos_dev[s : s + 1], ch_t, 1.0,
                                 boundary=bnd)
            same(f"K3 bind of pod {p}")
            slots += 1
        if plan.gang_wave[w]:
            K.apply_placements(b, idx_dev[w * W : (w + 1) * W], pos_dev[w * W : (w + 1) * W],
                               ch_k, -1.0, rollback=True)
            ref.apply_placements(tb_t, idx_dev[w * W : (w + 1) * W],
                                 pos_dev[w * W : (w + 1) * W], ch_t, -1.0, rollback=True)
            same(f"rollback of wave {w}")
            rollbacks += 1
        w += 1
    victims = int(pk.victims.sum()) - v0
    if evictions == 0 or victims == 0:
        raise AssertionError(f"{where}: the window fired no eviction")
    # A release bucket of placed pods in pod order (their tier cells drop).
    end = w * W
    cols = np.arange(end)
    host_ch = ch_k.cpu().numpy()
    col_pod = plan.col_pod
    cols = cols[(col_pod[cols] >= 0) & (host_ch[:, cols] >= 0).any(axis=0)]
    cols = cols[np.argsort(col_pod[cols], kind="stable")][:4000]
    rel_p = torch.as_tensor(col_pod[cols], device=dev)
    rel_pos = torch.as_tensor(cols.astype(np.int32), device=dev)
    K.apply_placements(b, rel_p, rel_pos, ch_k, -1.0)
    ref.apply_placements(tb_t, rel_p, rel_pos, ch_t, -1.0)
    same(f"a {cols.size}-pod release")
    # A gang rollback: a gang's last member unplaced in the odd scenarios.
    gid = eng.pods.group_id
    rolled = None
    if (gid >= 0).any():
        g0 = np.nonzero(gid == gid[gid >= 0][0])[0]
        wcols = np.nonzero(np.isin(col_pod[: plan.idx.size],
                                   np.append(g0, np.nonzero(gid < 0)[0][:1])))[0]
        wave = col_pod[wcols]
        odd = torch.as_tensor(np.nonzero((np.arange(S) % 2 == 1) | (S == 1))[0], device=dev)
        last = int(wcols[wave == g0[-1]][0])
        before = (host_ch[:, wcols] >= 0).sum()
        for c in (ch_k, ch_t):
            c[odd, last] = PAD
        wp = torch.as_tensor(wave, device=dev)
        wpos = torch.as_tensor(wcols.astype(np.int32), device=dev)
        K.apply_placements(b, wp, wpos, ch_k, -1.0, rollback=True)
        ref.apply_placements(tb_t, wp, wpos, ch_t, -1.0, rollback=True)
        same("a gang rollback")
        rolled = int(before - (ch_k[:, wcols] >= 0).sum().item())
    out = dict(window_waves=[w_start, w], slots=slots, eviction_events=evictions,
               victims=victims, cand_rows=cand_rows, releases_in_window=releases,
               rollbacks_in_window=rollbacks, release_pods=int(cols.size),
               rollback_pads=rolled)
    results[where] = out
    print(f"{where}: waves {w_start}..{w}, {slots} slots x {S} scenarios, {evictions} eviction "
          f"events, {victims} victims, {cand_rows} candidate rows, {releases} boundary releases, "
          f"{rollbacks} gang-wave rollbacks, a {cols.size}-pod release"
          f"{'' if rolled is None else ' and a gang rollback'}; kernels equal their twins "
          f"exactly", flush=True)
    return dict(b=b, tb_k=tb_k, tb_t=tb_t, ch_k=ch_k, ch_t=ch_t, fire=fire_slot,
                rel=(rel_p, rel_pos, col_pod[cols]), wave_victims=wave_victims)


def time_preempt(eng, held, dev, iters=200, plain_iters=20):
    """Device time per launch (torch.profiler) of each kernel's preemption
    work, beside its twin, a PyTorch yardstick and its least time, at the
    window slot where the most scenarios preempted (its tables before K3):
    K1 for that pod (with its candidate row), K2 where the masked argmin
    fires (a new wave stamp every call), K3's bind with the eviction step
    (the victims leave on the first call), and K3's release of the held
    bucket with the tier planes. Runs on copies of the held tables."""
    f = held["fire"]
    p, s, bnd = f["p"], f["s"], f["boundary"]
    clone = lambda nt: type(nt)(*(x.clone() if torch.is_tensor(x) else x for x in nt))
    snap = f["tables"]
    tk = snap._replace(state=clone(snap.state), scratch=clone(snap.scratch),
                       preempt=clone(snap.preempt))
    tt = snap._replace(state=clone(snap.state), scratch=clone(snap.scratch),
                       preempt=clone(snap.preempt))
    b = K.Bound(tk)
    ch_k, ch_t = f["ch"].clone(), f["ch"].clone()
    pk = tk.preempt
    S = tk.state.used.shape[0]
    work = Work(eng.pods, tk)
    dms = lambda fn, it, match=None: device_ms(fn, it, match) or time_cuda(fn, it)
    t_k1 = dms(lambda i: K.filter_score(b, p), iters, "ksim_filter_score")
    t_k1_plain = time_cuda(lambda i: ref.filter_score(tt, p), plain_iters)
    k1b, k1o = work.k1(p)
    k1pb, k1po = work.k1_preempt(p)
    K.normalize_select(b, p, ch_k, s, 10_000_000)
    fire_n = int((pk.ev_node >= 0).sum())
    if fire_n != f["fired"]:
        raise AssertionError(f"K2 fired in {fire_n} scenarios on replay, {f['fired']} in the run")
    waves = itertools.count(10_000_001)  # a new wave every call: the argmin fires each time
    masked = torch.where(pk.cand < float("inf"), pk.cand, torch.full_like(pk.cand, float("inf")))
    t_k2, t_argmin, k2_turns = in_turns(
        lambda i: K.normalize_select(b, p, ch_k, s, next(waves)),
        lambda i: torch.argmin(masked, dim=1), iters, "ksim_normalize_select")
    k2_plan = plan_of(K.normalize_select)
    t_k2_plain = time_cuda(lambda i: ref.normalize_select(tt, p, ch_t, s, 10_000_001 + i),
                           plain_iters)
    print(f"K2's argmin at S={S}, N={tk.state.used.shape[1]} (cluster {json.dumps(k2_plan)}): "
          f"{t_k2 * 1e3:.2f} us vs torch.argmin {t_argmin * 1e3:.2f} us in turns "
          f"{[round(t * 1e3, 2) for t in k2_turns]}", flush=True)
    k2b, k2o = work.k2()
    k2fb, k2fo = work.k2_fire(fire_n)
    # The record of one more K2 call is the one every K3 call below reads.
    K.normalize_select(b, p, ch_k, s, 20_000_000)
    ref.normalize_select(tt, p, ch_t, s, 20_000_000)
    ev_t = pk.ev_tier[pk.ev_node >= 0].tolist()
    cols = s + (ch_k.shape[1] - pk.n_slots)
    scanned = torch.cat([ch_k[:, :s], ch_k[:, pk.n_slots:]], dim=1)
    matches = int(((scanned == pk.ev_node[:, None]) & (pk.ev_node[:, None] >= 0)).sum())
    one_p = torch.as_tensor([p], dtype=torch.int32, device=dev)
    one_pos = torch.as_tensor([s], dtype=torch.int32, device=dev)
    vic0 = int(pk.victims.sum())
    K.apply_placements(b, one_p, one_pos, ch_k, 1.0, boundary=bnd)
    vic = int(pk.victims.sum()) - vic0
    k3b, k3o = work.k3([p], ch_k[:, s].cpu().numpy())
    k3eb, k3eo = work.k3_evict(cols, matches, vic, ev_t)
    t_k3 = dms(lambda i: K.apply_placements(b, one_p, one_pos, ch_k, 1.0, boundary=bnd),
                     iters, "ksim_apply")
    t_k3_plain = time_cuda(lambda i: ref.apply_placements(tt, one_p, one_pos, ch_t, 1.0,
                                                          boundary=bnd), plain_iters)
    rel_p, rel_pos, rel_pods = held["rel"]
    rel_ch = held["ch_k"].clone()
    rb, ro = work.k3(rel_pods, rel_ch[:, rel_pos.long()].cpu().numpy())
    t_rel = dms(restored(b.tables, lambda i: K.apply_placements(b, rel_p, rel_pos, rel_ch, -1.0)),
                20, RELEASE_MATCH)
    t_rel_plain = time_cuda(
        restored(tt, lambda i: ref.apply_placements(tt, rel_p, rel_pos, rel_ch, -1.0)), 10)
    out = {
        "filter_score_tier": dict(ms=t_k1, plain_ms=t_k1_plain, bytes=float(k1b + k1pb),
                                  ops=float(k1o + k1po), library_ms=None),
        "normalize_select_argmin": dict(ms=t_k2, plain_ms=t_k2_plain, bytes=float(k2b + k2fb),
                                        ops=float(k2o + k2fo), library_ms=t_argmin,
                                        scenarios_firing=fire_n, turns_ms=k2_turns,
                                        cluster=k2_plan),
        "apply_placements_evict": dict(ms=t_k3, plain_ms=t_k3_plain, bytes=float(k3b + k3eb),
                                       ops=float(k3o + k3eo), library_ms=None,
                                       scenarios_evicting=len(ev_t), victims=vic,
                                       columns_scanned=cols, columns_matching=matches),
        "apply_placements_tier_release": dict(ms=t_rel, plain_ms=t_rel_plain, bytes=float(rb),
                                              ops=float(ro), library_ms=None,
                                              pairs=int(rel_p.numel())),
    }
    for m in out.values():
        m["bound_ms"], m["bound_by"] = bound(m["bytes"], m["ops"])
        m["scenarios"] = S
    return out


def check_reduced_preempt(results, dev="cuda"):
    """A reduced tier-preemption replay (CONFIG6 cut to 20 nodes x 1,040
    pods) and a reduced preemption x completions what-if (8 scenarios x 8
    nodes x 400 pods, durationMean 20: evictions fire and completions move
    placements), each on the kernel path, the plain path on the card and
    the plain path on the CPU: assignments and preemptions identical."""
    cfg, ec, ep = config6_case(nodes=20, pods=1040)
    kw = dict(wave_width=8, chunk_waves=cfg.chunk_waves, preemption=True)
    t0 = time.perf_counter()
    eng = TorchReplayEngine(ec, ep, cfg.framework, device=dev, **kw)
    kern = eng.replay()
    t1 = time.perf_counter()
    if kern.route != "chunk":
        raise AssertionError(f"reduced preemption replay ran on route {kern.route}")
    slot_route("reduced preemption replay", eng, kern.assignments[None])
    if int(eng.last_tables.preempt.victims[0]) != kern.preemptions:
        raise AssertionError("reduced preemption replay: the per-slot route's victims differ")
    t1s = time.perf_counter()
    plain = TorchReplayEngine(ec, ep, cfg.framework, device=dev, plain=True, **kw).replay()
    t2 = time.perf_counter()
    cpu = TorchReplayEngine(ec, ep, cfg.framework, device="cpu", **kw).replay()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", plain), ("plain on the cpu", cpu)):
        diff = np.nonzero(kern.assignments != other.assignments)[0]
        if diff.size or kern.preemptions != other.preemptions:
            raise AssertionError(f"reduced preemption replay: kernel path != {name} at pods "
                                 f"{diff[:5]} ({kern.preemptions} vs {other.preemptions} victims)")
    if kern.preemptions <= 0:
        raise AssertionError("reduced preemption replay fired no eviction")
    results["reduced_preempt_replay"] = dict(
        nodes=20, pods=1040, placed=kern.placed, victims=kern.preemptions,
        kernel_s=t1 - t0, plain_card_s=t2 - t1s, plain_cpu_s=t3 - t2)
    cluster = make_cluster(8, seed=2, taint_fraction=0.2)
    workload, _ = make_workload(400, seed=2, with_spread=True, with_tolerations=True,
                                duration_mean=20.0, arrival_rate=12.0)
    ec2, ep2 = encode(cluster, workload)
    scen = uniform_scenarios(ec2, 8, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    wkw = dict(wave_width=8, chunk_waves=4, collect_assignments=True, preemption=True)
    mk = lambda **o: WhatIfEngine(ec2, ep2, scen, FrameworkConfig(), **{**wkw, **o})
    t0 = time.perf_counter()
    weng = mk(device=dev)
    wk = weng.run()
    t1 = time.perf_counter()
    if wk.route != "chunk":
        raise AssertionError(f"reduced preemption what-if ran on route {wk.route}")
    slot_route("reduced preemption what-if", weng, wk.assignments)
    if not np.array_equal(weng.last_tables.preempt.victims.cpu().numpy(), wk.preemptions):
        raise AssertionError("reduced preemption what-if: the per-slot route's victims differ")
    t1s = time.perf_counter()
    wp = mk(device=dev, plain=True).run()
    t2 = time.perf_counter()
    wc = mk(device="cpu").run()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", wp), ("plain on the cpu", wc)):
        bad = np.argwhere(wk.assignments != other.assignments)
        if bad.size or not np.array_equal(wk.preemptions, other.preemptions):
            raise AssertionError(f"reduced preemption what-if: kernel path != {name} at "
                                 f"(scenario, pod) {bad[:5].tolist()}")
    off = mk(device=dev, completions=False).run()
    moved = int((off.assignments != wk.assignments).sum())
    if (wk.preemptions <= 0).all() or moved == 0:
        raise AssertionError("reduced preemption what-if is vacuous")
    results["reduced_preempt_whatif"] = dict(
        scenarios=8, nodes=8, pods=400, placed=wk.placed.tolist(),
        victims=wk.preemptions.tolist(), moved_by_completions=moved,
        kernel_s=t1 - t0, plain_card_s=t2 - t1s, plain_cpu_s=t3 - t2)
    print(f"reduced tier preemption: replay (20 nodes x 1040 pods) placed {kern.placed}, "
          f"{kern.preemptions} victims; what-if (8 x 8 nodes x 400 pods) victims "
          f"{wk.preemptions.tolist()}, completions move {moved}; identical on the chunk route "
          f"(K6), the per-slot kernels, the plain path on the card and on the CPU", flush=True)


def run_preempt_paths(results, dev):
    """The tier-preemption paths at full width: CONFIG6 as a single replay
    and the what-if shape (128 ``uniform_scenarios(seed=0)``), each with
    the launch counters zeroed just before its warm-up run and read just
    after, the result held against greedy_replay's pinned constants, then
    a median of 3 timed runs and one profiled run; then each kernel held
    against its twin in an eviction window of each shape and timed there.
    Returns (kernel timings, the what-if's launches, its per-slot route's
    launches)."""
    cfg, ec, ep = config6_case()
    eng = TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                            chunk_waves=cfg.chunk_waves, preemption=True)
    K.reset_launch_counts()
    warm = eng.replay()
    launches = K.launch_counts()
    check_chunk_launches("config6 replay", launches, eng.plan)
    check_result(ec, ep, warm)
    check_pins("config6 replay", PREEMPT_PINS["config6"], warm.placed, warm.preemptions,
               warm.assignments)
    runs = [eng.replay() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.assignments, warm.assignments):
            raise AssertionError("the config6 replay placed differently from run to run")
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    res_p, busy_s = profiled_busy_s(eng.replay)
    results["config6"] = dict(
        route=warm.route, nodes=ec.num_nodes, pods=ep.num_pods, chunk_waves=eng.plan.C,
        launches=launches,
        placed=warm.placed, victims=warm.preemptions, walls_s=walls, wall_s=wall,
        placements_per_s=warm.placed / wall, profiled_wall_s=res_p.wall_clock_s,
        device_busy_s=busy_s, device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None)
    print(f"config6 tier-preemption replay ({ec.num_nodes} nodes x {ep.num_pods} pods, route "
          f"{warm.route}): median "
          f"wall {wall:.3f}s of {[round(x, 3) for x in walls]}, {warm.placed / wall:.1f} "
          f"placements/s, placed {warm.placed}, {warm.preemptions} victims (== greedy_replay's "
          f"pins); launches {json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, "
          f"device busy {busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%})", flush=True)
    mark("10 config6 replays")
    held1 = hold_preempt("S=1 preemption kernel checks (config6)", eng, 300, dev, results)
    mark("10 config6 hold")
    results["chunk_loop_bound_ms_config6"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, warm.assignments[None], launches, evictions=held1["wave_victims"])
    print(f"config6 chunk-loop bound (B6): "
          f"{json.dumps(results['chunk_loop_bound_ms_config6'])} ms", flush=True)
    mark("10 config6 B6 bound")
    results["kernels_preempt_s1"] = time_preempt(eng, held1, dev)
    del eng, warm, runs, res_p, held1

    pw = PREEMPT_WHATIF
    cfg, ec, ep = config6_case(whatif=True)
    scen = uniform_scenarios(ec, pw["scenarios"], seed=0)
    t0 = time.perf_counter()
    eng = WhatIfEngine(ec, ep, scen, cfg.framework, wave_width=cfg.wave_width,
                       chunk_waves=pw["chunk_waves"], collect_assignments=True, preemption=True)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    warm = eng.run()
    launches = K.launch_counts()
    check_chunk_launches("tier what-if", launches, eng.plan)
    check_whatif_result(ep, warm, pw["scenarios"])
    check_pins("what-if scenario 0", PREEMPT_PINS["whatif"], warm.placed[0],
               warm.preemptions[0], warm.assignments[0])
    single = TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                               chunk_waves=pw["chunk_waves"], preemption=True).replay()
    if (not np.array_equal(single.assignments, warm.assignments[0])
            or single.preemptions != int(warm.preemptions[0])):
        raise AssertionError("what-if scenario 0 differs from the single-scenario replay")
    runs = [eng.run() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.assignments, warm.assignments):
            raise AssertionError("the preemption what-if placed differently from run to run")
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    res_p, busy_s = profiled_busy_s(eng.run)
    # The per-slot route of the batch: the same placements and victims.
    slot_launches, slot_wall = slot_route("tier what-if", eng, warm.assignments)
    if not np.array_equal(eng.last_tables.preempt.victims.cpu().numpy(), warm.preemptions):
        raise AssertionError("tier what-if: the per-slot route's victims differ")
    results["preempt_whatif"] = dict(
        **pw, nodes=ec.num_nodes, pods=ep.num_pods, setup_s=setup_s,
        chunk_waves_run=eng.plan.C, completions_on=warm.completions_on, route=warm.route,
        launches=launches,
        launches_detail=dict(release=sum(bk is not None for bk in eng.plan.buckets),
                             rollback=int(eng.plan.gang_wave.sum())),
        slot_route=dict(launches=slot_launches, wall_s=slot_wall),
        walls_s=walls, wall_s=wall, placements_per_s=warm.total_placed / wall,
        total_placed=warm.total_placed, victims_total=int(warm.preemptions.sum()),
        victims_min=int(warm.preemptions.min()), victims_max=int(warm.preemptions.max()),
        scenario0_placed=int(warm.placed[0]), scenario0_victims=int(warm.preemptions[0]),
        single_replay_wall_s=single.wall_clock_s, profiled_wall_s=res_p.wall_clock_s,
        device_busy_s=busy_s, device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None)
    print(f"tier-preemption what-if (route {warm.route}, {pw['scenarios']} scenarios x "
          f"{ec.num_nodes} nodes x "
          f"{ep.num_pods} pods, durationMean {pw['duration_mean']}, gangs, chunkWaves "
          f"{pw['chunk_waves']}): median wall {wall:.3f}s of {[round(x, 3) for x in walls]}, "
          f"{warm.total_placed / wall:.1f} aggregate placements/s, victims "
          f"{int(warm.preemptions.min())}..{int(warm.preemptions.max())} per scenario; "
          f"scenario 0 == greedy_replay's pins == the single replay ({single.wall_clock_s:.3f}s); "
          f"launches {json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, device "
          f"busy {busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%})", flush=True)
    mark("11 tier what-if runs")
    held = hold_preempt(f"S={pw['scenarios']} preemption kernel checks (what-if shape)", eng,
                        300, dev, results)
    mark("11 tier what-if hold")
    results["chunk_loop_bound_ms_preempt_whatif"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, warm.assignments, launches, evictions=held["wave_victims"])
    print(f"tier-preemption what-if chunk-loop bound (B6): "
          f"{json.dumps(results['chunk_loop_bound_ms_preempt_whatif'])} ms", flush=True)
    mark("11 tier what-if B6 bound")
    kernels = time_preempt(eng, held, dev)
    results["kernels_preempt"] = kernels
    print(f"preemption kernels at S={pw['scenarios']}, N={ec.num_nodes}: "
          + "; ".join(f"{k} {m['ms'] * 1e3:.2f} us (bound {m['bound_ms'] * 1e3:.4f} us, twin "
                      f"{m['plain_ms']:.3f} ms)" for k, m in kernels.items()), flush=True)
    return kernels, launches, slot_launches


# ---------------------------------------------------------------------------
# The unschedulable-retry buffer (whatIf.retryBuffer)
# ---------------------------------------------------------------------------


def config7_dict(nodes=None, pods=None):
    """CONFIG7's YAML as a dict; ``nodes`` / ``pods`` cut it."""
    import yaml

    with open(os.path.join(ROOT, CONFIG7)) as f:
        d = yaml.safe_load(f)
    if nodes:
        d["cluster"]["synthetic"]["nodes"] = nodes
    if pods:
        d["workload"]["synthetic"]["pods"] = pods
    return d


def config7_case(nodes=None, pods=None):
    """(SimConfig, EncodedCluster, EncodedPods) of CONFIG7 as the port's
    config parses it (500 nodes, 20,000 pods, durationMean 40, affinity,
    spread, tolerations, retryBuffer 256, chunkWaves 256); ``nodes`` /
    ``pods`` cut it."""
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, build_encoded_case

    def build():
        cfg = SimConfig.from_dict(config7_dict(nodes, pods))
        return (cfg,) + tuple(build_encoded_case(cfg))

    return _case_copy(("config7", nodes, pods), build)


def check_retry_pins(where, pin, placed, dropped, assignments):
    got = dict(placed=int(placed), retry_dropped=int(dropped),
               sha256=assignments_sha256(assignments))
    if got != pin:
        raise AssertionError(f"{where}: {got} != greedy_replay's pinned {pin}")


def retry_records(tb):
    """The retry tables of a run's tables as host arrays."""
    return {f: getattr(tb.retry, f).cpu().numpy() for f in RETRY_PLANES}


def same_records(where, a, b):
    for f in RETRY_PLANES:
        if not np.array_equal(a[f], b[f]):
            raise AssertionError(f"{where}: retry.{f} differs")


def check_reduced_retry(results, dev="cuda"):
    """Reduced retry cases on the kernel path, the plain path on the card
    and the plain path on the CPU: CONFIG7's workload and plugins cut to
    40 nodes x 2,000 pods (chunkWaves 32, retryBuffer 64: the buffer fills
    and overflows), as a single replay and as an 8-scenario what-if.
    Placed, retry_dropped, the (internal) assignments and every retry
    record must be identical, and retry must change the outcome."""
    nodes, pods = 40, 2000
    cfg, ec, ep = config7_case(nodes=nodes, pods=pods)
    kw = dict(wave_width=cfg.wave_width, chunk_waves=32, retry_buffer=64)
    runs, walls, engs = [], [], []
    for o in (dict(device=dev), dict(device=dev, plain=True), dict(device="cpu")):
        t0 = time.perf_counter()
        eng = TorchReplayEngine(ec, ep, cfg.framework, telemetry="timeline", **kw, **o)
        r = eng.replay()
        walls.append(time.perf_counter() - t0)
        runs.append((r, retry_records(eng.last_tables)))
        engs.append(eng)
    (kern, rec), others = runs[0], runs[1:]
    for name, (other, orec) in zip(("plain on the card", "plain on the cpu"), others):
        diff = np.nonzero(kern.assignments != other.assignments)[0]
        if diff.size or (kern.placed, kern.retry_dropped) != (other.placed, other.retry_dropped):
            raise AssertionError(f"reduced retry replay: kernel path != {name} at pods "
                                 f"{diff[:5]}")
        same_records(f"reduced retry replay vs {name}", rec, orec)
        if (series_digest(kern.telemetry) != series_digest(other.telemetry)
                or kern.telemetry.latency != other.telemetry.latency):
            raise AssertionError(f"reduced retry replay: telemetry != {name}")
    if sum(kern.telemetry.rejection_attempts.values()) <= sum(kern.telemetry.reasons.values()):
        raise AssertionError("reduced retry replay: no retry-pass attempt was attributed")
    # timeline runs on the chunk route (K6, K5's folds and retry pass between
    # launches); the same replay on the per-slot route and at summary on K6
    slot_route("reduced retry replay (timeline)", engs[0], kern.assignments[None], series=True,
               joint=True)
    same_records("reduced retry replay, per-slot route", rec,
                 retry_records(engs[0].last_tables))
    chunk_eng = TorchReplayEngine(ec, ep, cfg.framework, device=dev, **kw)
    chunk = chunk_eng.replay()
    if chunk.route != "chunk" or runs[0][0].route != "chunk":
        raise AssertionError(f"reduced retry replay routes {chunk.route}, {runs[0][0].route}")
    if (not np.array_equal(chunk.assignments, kern.assignments)
            or (chunk.placed, chunk.retry_dropped) != (kern.placed, kern.retry_dropped)):
        raise AssertionError("reduced retry replay: summary != timeline")
    same_records("reduced retry replay, summary", rec, retry_records(chunk_eng.last_tables))
    off_replay = TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                                   chunk_waves=32, device=dev).replay().placed
    if kern.retry_dropped <= 0 or (rec["rnode"] >= 0).sum() == 0 or off_replay == kern.placed:
        raise AssertionError("reduced retry replay is vacuous (no drop, no retried bind or no "
                             "change against no retry)")
    results["reduced_retry_replay"] = dict(
        nodes=nodes, pods=pods, placed=kern.placed, retry_dropped=kern.retry_dropped,
        reasons=kern.telemetry.reasons, attempts=kern.telemetry.rejection_attempts,
        events=len(kern.telemetry.events),
        retried_binds=int((rec["rnode"] >= 0).sum()), placed_without_retry=off_replay,
        kernel_s=walls[0], plain_card_s=walls[1], plain_cpu_s=walls[2])
    scen = uniform_scenarios(ec, 8, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    runs, walls = [], []
    for o in (dict(device=dev), dict(device=dev, plain=True), dict(device="cpu")):
        t0 = time.perf_counter()
        eng = WhatIfEngine(ec, ep, scen, cfg.framework, **kw, **o)
        tb, _, assignments, placed, _ = eng._run()
        walls.append(time.perf_counter() - t0)
        runs.append((assignments, placed, retry_records(tb)))
    (ka, kp, krec), others = runs[0], runs[1:]
    slot_eng = WhatIfEngine(ec, ep, scen, cfg.framework, device=dev, **kw)
    slot_route("reduced retry what-if", slot_eng, ka)
    same_records("reduced retry what-if, per-slot route", krec,
                 retry_records(slot_eng.last_tables))
    for name, (oa, op, orec) in zip(("plain on the card", "plain on the cpu"), others):
        bad = np.argwhere(ka != oa)
        if bad.size or not np.array_equal(kp, op):
            raise AssertionError(f"reduced retry what-if: kernel path != {name} at (scenario, "
                                 f"pod) {bad[:5].tolist()}")
        same_records(f"reduced retry what-if vs {name}", krec, orec)
    off = WhatIfEngine(ec, ep, scen, cfg.framework, wave_width=cfg.wave_width, chunk_waves=32,
                       device=dev).run()
    if (krec["rdrop"] > 0).sum() < 4 or np.array_equal(off.placed, kp):
        raise AssertionError("reduced retry what-if is vacuous")
    results["reduced_retry_whatif"] = dict(
        scenarios=8, nodes=nodes, pods=pods, placed=kp.tolist(),
        retry_dropped=krec["rdrop"].tolist(),
        placed_without_retry=off.placed.tolist(), kernel_s=walls[0], plain_card_s=walls[1],
        plain_cpu_s=walls[2])
    print(f"reduced retry: replay ({nodes} nodes x {pods} pods, retryBuffer 64) placed "
          f"{kern.placed} (without retry {off_replay}), {kern.retry_dropped} dropped; what-if "
          f"(8 x {nodes} x {pods}) placed {kp.tolist()}, dropped "
          f"{krec['rdrop'].tolist()}; identical on the chunk route (K6), the per-slot kernels, "
          f"the plain path on the card and on the CPU, every retry record and (replay, "
          f"timeline, per-slot route) the reasons "
          f"{json.dumps(kern.telemetry.reasons)}, attempts "
          f"{json.dumps(kern.telemetry.rejection_attempts)}, series and events included",
          flush=True)


def clone_tables(tb):
    c = lambda nt: None if nt is None else type(nt)(
        *(x.clone() if torch.is_tensor(x) else x for x in nt))
    return tb._replace(state=c(tb.state), scratch=c(tb.scratch), retry=c(tb.retry),
                       reject=c(tb.reject), preempt=c(tb.preempt))


def clone_series(ser):
    c = lambda x: x.clone() if torch.is_tensor(x) else x
    return dataclasses.replace(
        ser, snap=None if ser.snap is None else ref.DevState(*(x.clone() for x in ser.snap)),
        used=c(ser.used), rcount=c(ser.rcount), pend=c(ser.pend))


def lockstep(where, plan, tb_k, tb_t, ch_k, ch_t, first, end, dev, snap=None,
             after_bind=None, ser=None, joint=False):
    """Waves [first, end) of ``plan`` (as run_waves enqueues them, with the
    retry sequence at each boundary past 0 when the tables have a retry
    buffer) on the kernels over ``tb_k`` and on the twins over ``tb_t``,
    launch by launch: after every launch the scratch rows, the choice
    buffer, the state and every retry table must be equal. ``snap(name, at)`` is called before chosen launches
    (the kernel tables as they stand) and ``after_bind()`` after each
    main-path bind. With ``ser`` = (kernel Series, twin Series) of a series
    run (telemetry series), K5 runs where run_waves launches it — after
    each slot's K2 on the plain path; in each retry-pass slot and as the
    chunk fold at each boundary (and at the run's end) on the retry path,
    the chunk-start planes copied at each boundary — and the reject
    counters are compared after each K5 as well. ``joint`` (the single
    replay's order, as run_waves) releases a boundary's pending list and
    static bucket in one launch. Returns the count of each
    kind of launch (``appends``, ``overflows`` and ``k5_charged`` count
    scenarios)."""
    b_k = K.Bound(tb_k)
    rk, rt = tb_k.retry, tb_t.retry
    RB = rk.rbuf.shape[1] if rk is not None else 0
    W, C = plan.idx.shape[1], plan.C
    idx_dev = torch.as_tensor(plan.idx.reshape(-1), device=dev)
    pos_dev = torch.arange(plan.L, dtype=torch.int32, device=dev)
    pos_rb = torch.arange(RB, dtype=torch.int32, device=dev)
    n = dict(static_release=0, pending_release=0, joint_release=0, retry_slots=0, k4=0,
             binds=0, appends=0, overflows=0, rollbacks=0, k5_slot=0, k5_retry=0, k5_fold=0,
             k5_charged=0)
    joint = joint and rk is not None
    ser_k, ser_t = ser if ser is not None else (None, None)
    attribute = ser_k is not None and ser_k.attribute
    fold = attribute and ser_k.fold
    if fold:
        snap_k = K.Bound(tb_k._replace(state=ser_k.snap))
        snap_t = tb_t._replace(state=ser_t.snap)

    def k5(hk, ht, pods_k, pods_t, gate_k, gate_t, key, at):
        before = tb_k.reject.attempts.clone()
        (K.first_reject_fold if key == "k5_fold" else K.first_reject)(hk, pods_k, gate_k)
        ref.first_reject(ht, pods_t, gate_t)
        same(at)
        n[key] += 1
        n["k5_charged"] += int((tb_k.reject.attempts != before).any(dim=1).sum())

    def k5_fold(c, at):
        cols = slice(c * C * W, (c + 1) * C * W)
        k5(snap_k, snap_t, idx_dev[cols], idx_dev[cols], ch_k[:, cols], ch_t[:, cols], "k5_fold",
           at)

    def same(at):
        for part in ("state", "scratch", "retry", "reject"):
            x, y = getattr(tb_k, part), getattr(tb_t, part)
            for name in (x._fields if x is not None else ()):
                if not torch.equal(getattr(x, name), getattr(y, name)):
                    raise AssertionError(f"{where}, {at}: {part}.{name} differs")
        if not torch.equal(ch_k, ch_t):
            raise AssertionError(f"{where}, {at}: choice buffers differ at "
                                 f"{torch.nonzero(ch_k != ch_t)[:5].tolist()}")

    for w in range(first, end):
        b = w // C
        if fold and w % C == 0 and b > 0:
            k5_fold(b - 1, f"K5 fold of chunk {b - 1}")
        bucket = (tuple(torch.as_tensor(x, device=dev) for x in plan.buckets[b])
                  if w % C == 0 and plan.buckets[b] is not None else None)
        if w % C == 0 and b > 0 and joint:
            # the single replay's one release of the pending list and the bucket
            if snap:
                snap("pending_release", b)
            joint_release(b, b_k, K.apply_placements, rk, ch_k, bucket)
            joint_release(b, tb_t, ref.apply_placements, rt, ch_t, bucket)
            same(f"joint pending and static release at boundary {b}")
            n["joint_release"] += 1
        elif bucket is not None:
            K.apply_placements(b_k, *bucket, ch_k, -1.0)
            ref.apply_placements(tb_t, *bucket, ch_t, -1.0)
            same(f"static release at boundary {b}")
            n["static_release"] += 1
        if w % C == 0 and b > 0 and rk is not None and not joint:
            if snap:
                snap("pending_release", b)
            K.apply_placements(b_k, rk.pend_id, pos_rb, rk.pend_node, -1.0, due=(rk.pend_relb, b))
            ref.apply_placements(tb_t, rt.pend_id, pos_rb, rt.pend_node, -1.0,
                                 due=(rt.pend_relb, b))
            same(f"pending release at boundary {b}")
            n["pending_release"] += 1
        if w % C == 0 and b > 0 and rk is not None:
            for k in range(retry_slots(plan, b, RB)):
                if snap and k == 0:
                    snap("retry_slot", b)
                K.filter_score(b_k, PAD, rk.rbuf[:, k])
                ref.filter_score(tb_t, PAD, rt.rbuf[:, k])
                same(f"retry K1, boundary {b} slot {k}")
                K.normalize_select(b_k, PAD, rk.rchoice, k, -1, rk.rbuf[:, k])
                ref.normalize_select(tb_t, PAD, rt.rchoice, k, -1, rt.rbuf[:, k])
                same(f"retry K2, boundary {b} slot {k}")
                if attribute:
                    k5(b_k, tb_t, rk.rbuf[:, k : k + 1], rt.rbuf[:, k : k + 1],
                       rk.rchoice[:, k : k + 1], rt.rchoice[:, k : k + 1], "k5_retry",
                       f"retry K5, boundary {b} slot {k}")
                K.apply_placements(b_k, rk.rbuf[:, k : k + 1], pos_rb[k : k + 1], rk.rchoice, 1.0)
                ref.apply_placements(tb_t, rt.rbuf[:, k : k + 1], pos_rb[k : k + 1], rt.rchoice,
                                     1.0)
                same(f"retry K3, boundary {b} slot {k}")
                n["retry_slots"] += 1
            if snap:
                snap("k4", b)
            t_b = float(np.float32(plan.tb[b]))
            K.retry_boundary(b_k, b, t_b)
            ref.retry_boundary(tb_t, b, t_b)
            same(f"K4 at boundary {b}")
            n["k4"] += 1
        if fold and w % C == 0:
            for sr, tb in ((ser_k, tb_k), (ser_t, tb_t)):
                for dst, src in zip(sr.snap, tb.state):
                    dst.copy_(src)
        for k, p in enumerate(plan.idx[w].tolist()):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(b_k, p)
            ref.filter_score(tb_t, p)
            K.normalize_select(b_k, p, ch_k, s, w)
            ref.normalize_select(tb_t, p, ch_t, s, w)
            same(f"K1 and K2 of pod {p} (wave {w})")
            if attribute and not fold:
                k5(b_k, tb_t, idx_dev[s : s + 1], idx_dev[s : s + 1], ch_k[:, s : s + 1],
                   ch_t[:, s : s + 1], "k5_slot", f"K5 of pod {p} (wave {w})")
            if snap:
                snap("bind", (w, k))
            append = rk is not None
            before = (rk.rcount.clone(), rk.rdrop.clone()) if append else None
            K.apply_placements(b_k, idx_dev[s : s + 1], pos_dev[s : s + 1], ch_k, 1.0,
                               append=append)
            ref.apply_placements(tb_t, idx_dev[s : s + 1], pos_dev[s : s + 1], ch_t, 1.0,
                                 append=append)
            same(f"bind of pod {p} (wave {w})")
            if after_bind:
                after_bind()
            n["binds"] += 1
            if append:
                n["appends"] += int((rk.rcount > before[0]).sum())
                n["overflows"] += int((rk.rdrop > before[1]).sum())
        if plan.gang_wave[w]:
            K.apply_placements(b_k, idx_dev[w * W : (w + 1) * W], pos_dev[w * W : (w + 1) * W],
                               ch_k, -1.0, rollback=True)
            ref.apply_placements(tb_t, idx_dev[w * W : (w + 1) * W], pos_dev[w * W : (w + 1) * W],
                                 ch_t, -1.0, rollback=True)
            same(f"rollback of wave {w}")
            n["rollbacks"] += 1
    if fold and end == plan.idx.shape[0] and end > first:
        k5_fold((end - 1) // C, "K5 fold of the last chunk")
    return n


def retry_walk(eng, dev):
    """A kernel-path run of ``eng`` chunk by chunk, reading the retry
    tables after each chunk: per boundary b > 0 the buffer and pending list
    it starts from and its pass's choices (B6's bound and the choice of the
    densest boundary take them)."""
    plan = eng.plan
    tb = eng._tables()
    ch = new_choices(plan, eng.S, eng.pods.bound_node, dev)
    snaps = []
    for c in range(len(plan.buckets)):
        run_waves(plan, tb, ch, c * plan.C, (c + 1) * plan.C, plain=False)
        snaps.append({f: getattr(tb.retry, f).cpu().numpy()
                      for f in ("rbuf", "pend_id", "pend_node", "pend_relb", "rchoice")})
    return [dict(rbuf=snaps[b - 1]["rbuf"], pend_id=snaps[b - 1]["pend_id"],
                 pend_node=snaps[b - 1]["pend_node"], pend_relb=snaps[b - 1]["pend_relb"],
                 rchoice=snaps[b]["rchoice"]) for b in range(1, len(snaps))]


def hold_retry(where, eng, walk, dev, results, waves_after=8):
    """Each kernel against its twin under the retry buffer, launch after
    launch, at the boundary where the most scenarios hold buffered pods
    (from ``walk``): a kernel-path run stops there, the tables are copied
    into twin tables on the card, and from there the static release, the
    pending release, every pass slot's K1 → K2 → K3, K4 and the waves
    after it — at least ``waves_after``, and on until a main-path bind has
    appended a failure and one has overflowed a full buffer — run on both,
    every plane compared after every launch. Returns snapshots of the
    kernel tables before each timed mode."""
    plan, S = eng.plan, eng.S
    held = [int((step["rbuf"][:, 0] >= 0).sum()) for step in walk]
    pods_held = [int((step["rbuf"] >= 0).sum()) for step in walk]
    b = 1 + max(range(len(walk)), key=lambda i: (held[i], pods_held[i]))
    tb_k = eng._tables()
    ch_k = new_choices(plan, S, eng.pods.bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, b * plan.C, plain=False)
    torch.cuda.synchronize()
    tb_t, ch_t = clone_tables(tb_k), ch_k.clone()
    snaps, last = {}, {}

    def snap(name, at):
        if name == "bind":
            last["bind"] = (clone_tables(tb_k), ch_k.clone(), at)
            last["counts"] = (tb_k.retry.rcount.clone(), tb_k.retry.rdrop.clone())
        elif name not in snaps:
            snaps[name] = (clone_tables(tb_k), ch_k.clone(), at)

    def snap_after_bind():
        rc, rd = last["counts"]
        if "append" not in snaps and bool((tb_k.retry.rcount > rc).any()):
            snaps["append"] = last["bind"]
        if "overflow" not in snaps and bool((tb_k.retry.rdrop > rd).any()):
            snaps["overflow"] = last["bind"]

    n = dict(static_release=0, pending_release=0, retry_slots=0, k4=0, binds=0, appends=0,
             overflows=0, rollbacks=0)
    end = b * plan.C
    while end < plan.idx.shape[0] and (end < b * plan.C + waves_after or n["appends"] == 0
                                       or n["overflows"] == 0):
        for k, v in lockstep(where, plan, tb_k, tb_t, ch_k, ch_t, end, end + 1, dev, snap,
                             snap_after_bind).items():
            n[k] = n.get(k, 0) + v
        end += 1
    if n["appends"] == 0 or n["overflows"] == 0 or n["retry_slots"] == 0:
        raise AssertionError(f"{where}: the window saw no append, overflow or retry slot: {n}")
    out = dict(boundary=b, scenarios_holding=held[b - 1], pods_held=pods_held[b - 1],
               waves=[b * plan.C, end], **n)
    results[where] = out
    print(f"{where}: boundary {b} ({held[b - 1]} of {S} scenarios holding {pods_held[b - 1]} "
          f"buffered pods), "
          f"{json.dumps(n)}; every launch equals its twin exactly", flush=True)
    return snaps, b


def time_retry(eng, snaps, bnd, dev, iters=200, plain_iters=10):
    """Device time per launch (torch.profiler) of each retry-buffer mode,
    beside its twin's wall (CUDA events) and its least time, on copies of
    the tables snapshot before it in the held window."""
    plan = eng.plan
    pos_rb = None
    out = {}
    dms = lambda fn, match: device_ms(fn, iters, match) or time_cuda(fn, iters)

    def pair(name):
        tb, ch, at = snaps[name]
        tk, tt = clone_tables(tb), clone_tables(tb)
        return K.Bound(tk), tk, tt, ch.clone(), ch.clone(), at

    b, tk, tt, _, _, _ = pair("pending_release")
    work = Work(eng.pods, tk)
    RB = tk.retry.rbuf.shape[1]
    pos_rb = torch.arange(RB, dtype=torch.int32, device=dev)
    rk, rt = tk.retry, tt.retry
    due = (rk.pend_id >= 0) & (rk.pend_relb <= bnd)
    nb, no = work.k3(rk.pend_id.cpu().numpy(),
                     torch.where(due, rk.pend_node, torch.full_like(rk.pend_node, PAD))
                     .cpu().numpy())
    out["apply_placements_pending_release"] = dict(
        ms=dms(restored(tk, lambda i: K.apply_placements(b, rk.pend_id, pos_rb, rk.pend_node,
                                                         -1.0, due=(rk.pend_relb, bnd))),
               RELEASE_MATCH),
        plain_ms=time_cuda(restored(tt, lambda i: ref.apply_placements(
            tt, rt.pend_id, pos_rb, rt.pend_node, -1.0, due=(rt.pend_relb, bnd))), plain_iters),
        bytes=float(nb + work.S * RB * 4), ops=float(no), due_entries=int(due.sum()))
    b, tk, tt, _, _, _ = pair("retry_slot")
    rk, rt = tk.retry, tt.retry
    pods0 = rk.rbuf[:, 0].cpu().numpy()
    act = int((pods0 >= 0).sum())
    out["filter_score_per_scenario_pod"] = dict(
        ms=dms(lambda i: K.filter_score(b, PAD, rk.rbuf[:, 0]), "ksim_filter_score"),
        plain_ms=time_cuda(lambda i: ref.filter_score(tt, PAD, rt.rbuf[:, 0]), plain_iters),
        **dict(zip(("bytes", "ops"), map(float, work.k1_scen(pods0)))), scenarios_with_pod=act)
    out["normalize_select_per_scenario_pod"] = dict(
        ms=dms(lambda i: K.normalize_select(b, PAD, rk.rchoice, 0, -1, rk.rbuf[:, 0]),
               "ksim_normalize_select"),
        plain_ms=time_cuda(lambda i: ref.normalize_select(tt, PAD, rt.rchoice, 0, -1,
                                                          rt.rbuf[:, 0]), plain_iters),
        **dict(zip(("bytes", "ops"), map(float, work.k2_scen(act)))), scenarios_with_pod=act)
    K.normalize_select(b, PAD, rk.rchoice, 0, -1, rk.rbuf[:, 0])
    ref.normalize_select(tt, PAD, rt.rchoice, 0, -1, rt.rbuf[:, 0])
    rch0 = rk.rchoice[:, :1].cpu().numpy()
    nb, no = work.k3(pods0[:, None], np.where(pods0[:, None] >= 0, rch0, PAD))
    out["apply_placements_retry_bind"] = dict(
        ms=dms(lambda i: K.apply_placements(b, rk.rbuf[:, 0:1], pos_rb[0:1], rk.rchoice, 1.0),
               "ksim_apply"),  # in place: the same binds again and again
        plain_ms=time_cuda(lambda i: ref.apply_placements(tt, rt.rbuf[:, 0:1], pos_rb[0:1],
                                                          rt.rchoice, 1.0), plain_iters),
        bytes=float(nb), ops=float(no), placed=int((rch0 >= 0).sum()))
    b, tk, tt, _, _, _ = pair("k4")
    rk, rt = tk.retry, tt.retry
    t_b = float(np.float32(plan.tb[bnd]))
    h = lambda t: t.cpu().numpy()
    nb, no = work.k4(h(rk.rbuf), h(rk.rchoice), h(rk.pend_id), h(rk.pend_relb), plan.tbt.size)
    out["retry_boundary"] = dict(
        ms=dms(lambda i: K.retry_boundary(b, bnd, t_b), "ksim_retry_boundary"),
        plain_ms=time_cuda(lambda i: ref.retry_boundary(tt, bnd, t_b), plain_iters),
        bytes=float(nb), ops=float(no),
        retried_binds=int(((h(rk.rbuf) >= 0) & (h(rk.rchoice) >= 0)).sum()))
    b, tk, tt, ch_k, ch_t, (w, k) = pair("append")
    s = w * plan.idx.shape[1] + k
    p = int(plan.idx[w, k])
    one_p = torch.as_tensor([p], dtype=torch.int32, device=dev)
    one_s = torch.as_tensor([s], dtype=torch.int32, device=dev)
    nb, no = work.k3([p], ch_k[:, s].cpu().numpy())
    ab, ao = work.k3_append()
    out["apply_placements_failure_append"] = dict(
        ms=dms(lambda i: K.apply_placements(b, one_p, one_s, ch_k, 1.0, append=True),
               "ksim_apply"),
        plain_ms=time_cuda(lambda i: ref.apply_placements(tt, one_p, one_s, ch_t, 1.0,
                                                          append=True), plain_iters),
        bytes=float(nb + ab), ops=float(no + ao), failing=int((ch_k[:, s] < 0).sum()))
    for m in out.values():
        m["bound_ms"], m["bound_by"] = bound(m["bytes"], m["ops"])
        m["library_ms"] = None
        m["scenarios"] = eng.S
    return out


def run_retry_paths(results, dev):
    """The retry buffer at full width. CONFIG7's what-if as shipped (64
    ``uniform_scenarios(seed=0)`` x 500 nodes x 20,000 pods) with the
    counters zeroed just before its warm-up run and read just after: every
    scenario places every pod with no drop, scenario 0 equals
    greedy_replay's pins, the batch without the buffer places fewer; a
    median of 3 timed runs and one profiled run; B6's bound. Then ``run``'s
    engine on CONFIG7 (S = 1) against the same pins, and the contended
    what-if (CONFIG7 cut to 150 nodes): its pins, the batch without the
    buffer differing, and each kernel held against its twin and timed at
    the boundary where the most scenarios hold buffered pods."""
    cfg, ec, ep = config7_case()
    rb = cfg.whatif.retry_buffer
    kw = dict(wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves, device=dev)
    scen = uniform_scenarios(ec, cfg.whatif.scenarios, seed=cfg.whatif.seed)
    S = len(scen)
    t0 = time.perf_counter()
    eng = WhatIfEngine(ec, ep, scen, cfg.framework, retry_buffer=rb, **kw)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    warm = eng.run()
    launches = K.launch_counts()
    check_chunk_launches("config7 what-if", launches, eng.plan, retry=True)
    check_whatif_result(ep, warm, S)
    if (warm.placed != ep.num_pods).any() or warm.retry_dropped.any():
        raise AssertionError(f"config7 what-if: placed {warm.placed.min()}..{warm.placed.max()}, "
                             f"dropped {warm.retry_dropped.max()}")
    tb, _, assignments, placed, _ = eng._run()
    check_retry_pins("config7 what-if scenario 0", RETRY_PINS["config7"], placed[0],
                     warm.retry_dropped[0], assignments[0])
    runs = [eng.run() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.placed, warm.placed):
            raise AssertionError("the config7 what-if placed differently from run to run")
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    res_p, busy_s = profiled_busy_s(eng.run)
    off_eng = WhatIfEngine(ec, ep, scen, cfg.framework, collect_assignments=True, **kw)
    off = off_eng.run()
    check_retry_pins("config7 what-if without retry, scenario 0", RETRY_PINS["config7_no_retry"],
                     off.placed[0], 0, off.assignments[0])
    if off.total_placed >= warm.total_placed:
        raise AssertionError("config7 what-if: the buffer did not place more")
    rnode = tb.retry.rnode.cpu().numpy()
    walk = retry_walk(eng, dev)
    mark("13 config7 what-if runs, walk")
    results["chunk_loop_bound_ms_config7_whatif"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, np.where(rnode >= 0, PAD, assignments), launches, retry_walk=walk)
    slots = [retry_slots(eng.plan, b, eng.retry_buffer) for b in range(1, len(eng.plan.buckets))]
    results["config7_whatif"] = dict(
        scenarios=S, nodes=ec.num_nodes, pods=ep.num_pods, retry_buffer=eng.retry_buffer,
        chunk_waves_run=eng.plan.C, setup_s=setup_s, route=warm.route, launches=launches,
        launches_detail=dict(pass_slots_per_boundary=slots,
                             retry_launches=3 * sum(slots) + 2 * len(slots)),
        walls_s=walls, wall_s=wall, placements_per_s=warm.total_placed / wall,
        total_placed=warm.total_placed, total_placed_without_retry=off.total_placed,
        retried_binds=int((rnode >= 0).sum()), profiled_wall_s=res_p.wall_clock_s,
        device_busy_s=busy_s, device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None)
    print(f"config7 retry what-if (route {warm.route} + the host's retry pass, {S} scenarios "
          f"x {ec.num_nodes} nodes x {ep.num_pods} pods, "
          f"retryBuffer {eng.retry_buffer}, chunkWaves {eng.plan.C}): median wall {wall:.3f}s of "
          f"{[round(x, 3) for x in walls]}, {warm.total_placed / wall:.1f} aggregate placements/s, "
          f"every scenario placed {ep.num_pods} with 0 dropped ({int((rnode >= 0).sum())} on "
          f"retry; {off.total_placed} without the buffer); scenario 0 == greedy_replay's pins; "
          f"launches {json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, device "
          f"busy {busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%}); B6 bound "
          f"{json.dumps(results['chunk_loop_bound_ms_config7_whatif'])} ms", flush=True)
    del eng, off_eng, tb, res_p

    mark("13 config7 B6 bound")
    single = TorchReplayEngine(ec, ep, cfg.framework, retry_buffer=rb, **kw)
    single.replay()
    res1 = single.replay()
    check_retry_pins("config7 run", RETRY_PINS["config7"], res1.placed, res1.retry_dropped,
                     res1.assignments)
    results["config7_run"] = dict(wall_s=res1.wall_clock_s,
                                  placements_per_s=res1.placements_per_sec, placed=res1.placed)
    print(f"config7 run (S=1, retryBuffer {rb}, route {res1.route}): wall "
          f"{res1.wall_clock_s:.3f}s, "
          f"{res1.placements_per_sec:.1f} placements/s, placed {res1.placed} == greedy_replay's "
          f"pins", flush=True)
    del single

    cfg, ec, ep = config7_case(nodes=RETRY_CUT_NODES)
    scen = uniform_scenarios(ec, cfg.whatif.scenarios, seed=cfg.whatif.seed)
    eng = WhatIfEngine(ec, ep, scen, cfg.framework, retry_buffer=rb, **kw)
    K.reset_launch_counts()
    warm = eng.run()
    launches3 = K.launch_counts()
    tb, _, assignments, placed, _ = eng._run()
    check_retry_pins(f"{RETRY_CUT_NODES}-node what-if scenario 0", RETRY_PINS["cut150"],
                     placed[0], warm.retry_dropped[0], assignments[0])
    off = WhatIfEngine(ec, ep, scen, cfg.framework, collect_assignments=True, **kw).run()
    check_retry_pins(f"{RETRY_CUT_NODES}-node what-if without retry, scenario 0",
                     RETRY_PINS["cut150_no_retry"], off.placed[0], 0, off.assignments[0])
    if np.array_equal(off.placed, warm.placed):
        raise AssertionError("the contended what-if places alike with and without the buffer")
    walk = retry_walk(eng, dev)
    overflowing = int((warm.retry_dropped > 0).sum())
    results["cut150_whatif"] = dict(
        scenarios=S, nodes=ec.num_nodes, pods=ep.num_pods, launches=launches3,
        wall_s=warm.wall_clock_s, total_placed=warm.total_placed,
        total_placed_without_retry=off.total_placed, placed=warm.placed.tolist(),
        retry_dropped=warm.retry_dropped.tolist(), scenarios_overflowing=overflowing,
        pending_entries_max=int(max((st["pend_id"] >= 0).sum(axis=1).max() for st in walk)))
    print(f"contended retry what-if ({S} x {ec.num_nodes} nodes x {ep.num_pods} pods, route "
          f"{warm.route}): placed "
          f"{int(warm.placed.min())}..{int(warm.placed.max())} (without the buffer "
          f"{int(off.placed.min())}..{int(off.placed.max())}), {overflowing} scenarios "
          f"overflowing; scenario 0 == greedy_replay's pins; wall {warm.wall_clock_s:.3f}s; "
          f"launches {json.dumps(launches3)}", flush=True)
    mark("14 cut150 what-if runs, walk")
    snaps, bnd = hold_retry(f"S={S} retry kernel checks ({RETRY_CUT_NODES} nodes)", eng, walk,
                            dev, results)
    mark("15 cut150 hold")
    kernels = time_retry(eng, snaps, bnd, dev)
    results["kernels_retry"] = kernels
    print(f"retry kernels at S={S}, N={ec.num_nodes}: "
          + "; ".join(f"{k} {m['ms'] * 1e3:.2f} us (bound {m['bound_ms'] * 1e3:.4f} us, twin "
                      f"{m['plain_ms']:.3f} ms)" for k, m in kernels.items()), flush=True)
    return kernels, launches

# ---------------------------------------------------------------------------
# Series and timeline telemetry (telemetry: series | timeline)
# ---------------------------------------------------------------------------


def series_digest(tel):
    """What REJECT_PINS holds of a telemetry: reasons, rejection attempts
    and the sha256 of the series and of the events (as JSON)."""
    h = lambda x: hashlib.sha256(json.dumps(x).encode()).hexdigest()
    return dict(reasons=dict(sorted(tel.reasons.items())),
                attempts=dict(sorted(tel.rejection_attempts.items())),
                series_sha256=h(tel.series), events_sha256=h([list(e) for e in tel.events]))


def file_sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check_series_pins(where, pin, tel, extra=None):
    got = {**series_digest(tel), **(extra or {})}
    if got != pin:
        raise AssertionError(f"{where}: {got} != JaxReplayEngine's pinned {pin}")


class LogLines(logging.Handler):
    """The messages of the port's logger while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("k8sim.torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("k8sim.torch").removeHandler(self)
        return False


def check_reduced_series(results, dev="cuda"):
    """Series telemetry on the kernel path, the plain path on the card and
    the plain path on the CPU: CONFIG6's trace cut to 20 nodes x 1,040
    pods with devicePreemption off (the plain path: in-scan attribution):
    assignments, reasons, attempts, series and latency identical (the
    retry path's are held in check_reduced_retry); then ``run`` through the
    port's CLI with ``timelineOut`` on CONFIG7's cut to 40 nodes x 2,000
    pods (chunkWaves 32, retryBuffer 64) on the card and on the CPU: the
    rows' telemetry and the Chrome traces identical, and the trace
    parses."""
    from kubernetes_simulator_tpu_torch import cli

    out = {}
    for name, (cfg, ec, ep), kw in (
        ("config6_cut", config6_case(nodes=20, pods=1040), dict(telemetry="series")),
    ):
        kw["chunk_waves"] = cfg.chunk_waves
        runs, walls = [], []
        for o in (dict(device=dev), dict(device=dev, plain=True), dict(device="cpu")):
            K.reset_launch_counts()
            t0 = time.perf_counter()
            e = TorchReplayEngine(ec, ep, cfg.framework, wave_width=8, **kw, **o)
            r = e.replay()
            walls.append(time.perf_counter() - t0)
            runs.append((r, K.launch_counts()))
            if len(runs) == 1:
                eng_k = e  # the kernel path's engine
        (kern, launches), others = runs[0], runs[1:]
        if kern.route != "chunk" or launches["first_reject"] or not launches["chunk_replay"]:
            raise AssertionError(f"reduced series {name}: route {kern.route}, launches "
                                 f"{launches}: the plain path attributes inside K6")
        for other_name, (other, _) in zip(("plain on the card", "plain on the cpu"), others):
            if (not np.array_equal(kern.assignments, other.assignments)
                    or series_digest(kern.telemetry) != series_digest(other.telemetry)
                    or kern.telemetry.latency != other.telemetry.latency):
                raise AssertionError(f"reduced series {name}: kernel path != {other_name}")
        tel = kern.telemetry
        if sum(tel.rejection_attempts.values()) == 0:
            raise AssertionError(f"reduced series {name} is vacuous: nothing attributed")
        slot_launches, _ = slot_route(f"reduced series {name}", eng_k, kern.assignments[None],
                                      series=True, joint=True)
        if slot_launches["first_reject"] <= 0:
            raise AssertionError(f"reduced series {name}: the per-slot route launched no K5")
        out[name] = dict(nodes=ec.num_nodes, pods=ep.num_pods, placed=kern.placed,
                         reasons=tel.reasons, attempts=tel.rejection_attempts,
                         samples=len(tel.series["t"]), events=len(tel.events),
                         launches=launches, kernel_s=walls[0], plain_card_s=walls[1],
                         plain_cpu_s=walls[2])
    import yaml

    d = config7_dict(nodes=40, pods=2000)
    d["chunkWaves"], d["whatIf"]["retryBuffer"] = 32, 64
    outdir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    docs, rows = {}, {}
    for device in (dev.type, "cpu"):
        d["telemetry"] = {"granularity": "series",
                          "timelineOut": os.path.join(outdir, f"reduced_timeline_{device}.json")}
        d["output"] = os.path.join(outdir, f"reduced_run_{device}.jsonl")
        path = os.path.join(outdir, f"reduced_series_{device}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        if cli.main(["run", path, "--device", device]) != 0:
            raise AssertionError(f"reduced series: the CLI run on {device} failed")
        with open(d["telemetry"]["timelineOut"]) as f:
            docs[device] = json.load(f)
        with open(d["output"]) as f:
            rows[device] = json.loads(f.read().splitlines()[-1])["telemetry"]
        os.remove(d["telemetry"]["timelineOut"])
    strip = lambda t: {k: v for k, v in t.items() if k != "phases"}
    if docs[dev.type] != docs["cpu"] or strip(rows[dev.type]) != strip(rows["cpu"]):
        raise AssertionError("reduced series: the CLI's trace or row differs between the card "
                             "and the CPU")
    if rows["cpu"]["granularity"] != "timeline" or not docs["cpu"]["traceEvents"]:
        raise AssertionError("reduced series: timelineOut did not give a timeline")
    out["cli"] = dict(trace_events=len(docs["cpu"]["traceEvents"]), row=strip(rows["cpu"]))
    results["reduced_series"] = out
    print("reduced series: " + "; ".join(
        f"{k} ({v['nodes']} x {v['pods']}) reasons {json.dumps(v['reasons'])}, attempts "
        f"{json.dumps(v['attempts'])}, {v['samples']} samples, {v['events']} events"
        for k, v in out.items() if k != "cli")
        + f"; identical on the kernel path, the plain path on the card and on the CPU; the CLI's "
          f"trace ({out['cli']['trace_events']} events) identical on the card and the CPU",
          flush=True)


def hold_first_reject(where, eng, first, end, dev, results, must_charge=True, joint=False):
    """K1–K5 against their twins launch by launch over waves [first, end)
    of a series run of ``eng`` (a kernel-path run with the series carriers
    up to ``first``, then the tables, series buffers and choice buffer
    copied for the twins), reject counters compared after every K5
    (``joint``: the single replay's release order, as run_waves)."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_series

    plan = eng.plan
    tb_k = eng._tables(attribute=True)
    ser_k = new_series(plan, tb_k, True)
    ch_k = new_choices(plan, eng.S, eng.pods.bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, first, plain=False, ser=ser_k, joint=joint)
    torch.cuda.synchronize()
    tb_t, ch_t, ser_t = clone_tables(tb_k), ch_k.clone(), clone_series(ser_k)
    n = lockstep(where, plan, tb_k, tb_t, ch_k, ch_t, first, end, dev, ser=(ser_k, ser_t),
                 joint=joint)
    k5 = n["k5_slot"] + n["k5_retry"] + n["k5_fold"]
    if not k5 or (must_charge and not n["k5_charged"]):
        raise AssertionError(f"{where}: the window launched or charged nothing: {n}")
    results.setdefault("first_reject_holds", {})[where] = dict(waves=[first, end], **n)
    print(f"{where}: waves {first}..{end}: {json.dumps({k: v for k, v in n.items() if v})}; "
          f"every launch equals its twin exactly, reject counters included", flush=True)
    return n


def time_first_reject(tb, pods, gate, iters=200, plain_iters=10, wrapper=None):
    """K5 on ``tb`` with the slots ``pods`` / ``gate`` through ``wrapper``
    (K.first_reject by default): its device time per launch
    (torch.profiler; the launch interval by CUDA events where the profiler
    recorded no kernel) and its twin's wall (CUDA events, on a copy). The
    counters move; the result is not read."""
    b = K.Bound(tb)
    wrapper = wrapper or K.first_reject
    run = lambda i: wrapper(b, pods, gate)
    d_ms = device_ms(run, iters, match="first_reject")
    interval = time_cuda(run, iters)
    tb_t = clone_tables(tb)
    plain_ms = time_cuda(lambda i: ref.first_reject(tb_t, pods, gate), plain_iters,
                         warm=min(3, plain_iters))
    return dict(ms=d_ms if d_ms is not None else interval, device_ms=d_ms,
                launch_interval_ms=interval, plain_ms=plain_ms)


def force_k6_ranks(b, C):
    """K6's geometry on Bound ``b`` (S = 1) with C ranks a cluster, whatever
    the card's SM count would choose (ops/kernels.py cluster_plan): spans of
    a multiple of 32 nodes, the last rank short. Returns the C it took."""
    N = b.tables.state.used.shape[1]
    span = -(-(-(-N // C)) // 32) * 32
    C = -(-N // span)
    b._plans["chunk_replay"] = K.ClusterPlan(S=1, N=N, NP=1, C=C, threads=K.SELECT_THREADS,
                                             span=span, grid=C)
    return C


def series_chunk_launches(where, res, launches, attributed, plan):
    """A series run on the plain path (counters zeroed just before it): the
    chunk route, one attributed K6 a chunk (``attributed``, the run's
    K.chunk_replay.attributed), K3 at each release and nowhere else, none
    of K1, K2, K4 or K5."""
    check_chunk_launches(where, launches, plan)
    bad = {k: launches[k] for k in ("first_reject", "first_reject_fold", "retry_boundary",
                                    "apply_placements_bind", "apply_placements_rollback")
           if launches[k]}
    if res.route != "chunk" or bad or attributed != len(plan.buckets):
        raise AssertionError(f"{where}: route {res.route}, {attributed} attributed K6 launches "
                             f"for {len(plan.buckets)} chunks, launches {launches}")


def series_retry_launches(where, res, launches, attributed, plan):
    """A series run on the retry path: the chunk route (one K6 a chunk, none
    attributed), the retry pass's K1, K2, K3, K4 and K5, K5's chunk folds."""
    check_chunk_launches(where, launches, plan, retry=True)
    if (res.route != "chunk" or attributed or launches["first_reject"] <= 0
            or launches["first_reject_fold"] <= 0):
        raise AssertionError(f"{where}: route {res.route}, {attributed} attributed K6 "
                             f"launches, launches {launches}")


def hold_k6_attributed(where, eng, first, end, dev, assignments, C=None):
    """K6's attributed mode against its twin and the per-slot kernels over
    waves [first, end) of one chunk (past its start: no boundary work in the
    window) of ``eng``'s series run on the plain path (S = 1): the state
    after waves [0, first) on the chunk route, copied three ways; then the
    window as one attributed K6 launch (its plan's ranks, or ``C`` forced),
    on the twin ``ref.chunk_replay(reject=)`` and on the per-slot kernels
    (K1 -> K2 -> K5 -> K3 a slot, K3's rollback after a gang wave):
    choices, every plane and the reject counters equal after. Then the
    launch timed (:func:`launch_ms`, the state restored before each of 20
    launches) in turns with the summary build over the same window
    (attributed, summary, summary, attributed), beside the twin's
    wall and the window's least time, ``Work.k6`` plus ``Work.k5`` over its
    failed slots (``assignments`` [S, P] of the full run for the binds)."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_series

    plan = eng.plan
    if first % plan.C == 0 or first // plan.C != (end - 1) // plan.C or end <= first:
        raise AssertionError(f"{where}: waves [{first}, {end}) are not inside one chunk, "
                             "past its start")
    desc = plan.device_desc(dev)
    tb_k = eng._tables(attribute=True)
    ser_k = new_series(plan, tb_k, True)
    ch_k = new_choices(plan, eng.S, eng.pods.bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, first, plain=False, ser=ser_k, route="chunk")
    torch.cuda.synchronize()
    tb_t, ch_t = clone_tables(tb_k), ch_k.clone()
    tb_s, ch_s, ser_s = clone_tables(tb_k), ch_k.clone(), clone_series(ser_k)
    snap = {name: x.clone() for name, x in _planes(tb_k).items()}
    rj_snap = [x.clone() for x in tb_k.reject]
    ch_snap = ch_k.clone()
    b = K.Bound(tb_k)
    if C is not None:
        force_k6_ranks(b, C)
    K.chunk_replay(b, desc.idx, desc.gang, ch_k, first, end, reject=tb_k.reject)
    t0 = time.perf_counter()
    ref.chunk_replay(tb_t, desc.idx, desc.gang, ch_t, first, end, reject=tb_t.reject)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    K.reset_launch_counts()
    run_waves(plan, tb_s, ch_s, first, end, plain=False, ser=ser_s, route="slot")
    k5 = K.launch_counts()["first_reject"]
    k6_plan = plan_of(K.chunk_replay)
    for other, tb_o, ch_o in (("its twin", tb_t, ch_t), ("the per-slot kernels", tb_s, ch_s)):
        same_planes(f"{where}: attributed K6 vs {other}", tb_k, ch_k, tb_o, ch_o)
        for f, x, y in zip(tb_k.reject._fields, tb_k.reject, tb_o.reject):
            if not torch.equal(x, y):
                raise AssertionError(f"{where}: attributed K6 vs {other}: reject.{f} differs")
    newly = (tb_k.reject.attributed[0] != rj_snap[2][0]).cpu().numpy()
    failed = np.nonzero(newly)[0]
    if not failed.size or not k5:
        raise AssertionError(f"{where}: the window charged nothing ({k5} K5 launches)")

    def restore():
        for name, x in _planes(tb_k).items():
            x.copy_(snap[name])
        for x, y in zip(tb_k.reject, rj_snap):
            x.copy_(y)
        ch_k.copy_(ch_snap)

    def launch(reject):
        return lambda: launch_ms(
            lambda: K.chunk_replay(b, desc.idx, desc.gang, ch_k, first, end, reject=reject),
            restore, 20)

    attr, summ = launch(tb_k.reject), launch(None)
    turns = [attr(), summ(), summ(), attr()]
    ms, summary_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    window = plan.idx[first:end]
    slots = int((window >= 0).sum())
    w = Work(eng.pods, tb_k)
    nb6, no6 = w.k6(window, plan.gang_wave[first:end], assignments, first)
    nb5, no5 = w.k5(failed[None], np.ones((1, failed.size), bool))
    bound_ms, bound_by = bound(nb6 + nb5, no6 + no5)
    out = dict(waves=[first, end], slots=slots, failed=int(failed.size), k5_launches=k5,
               cluster=k6_plan, ms=ms, summary_ms=summary_ms, turns_ms=turns,
               us_per_slot=ms * 1e3 / slots, summary_us_per_slot=summary_ms * 1e3 / slots,
               extra_us_per_failed_slot=(ms - summary_ms) * 1e3 / failed.size,
               plain_ms=twin_s * 1e3, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)
    print(f"{where}: attributed K6 == its twin == the per-slot kernels (K1 -> K2 -> K5 -> K3) "
          f"over waves {first}..{end} ({slots} slots, {failed.size} charged; cluster "
          f"{json.dumps(k6_plan)}), choices, every plane and the reject counters; a launch "
          f"{ms * 1e3:.1f} us ({out['us_per_slot']:.2f} us a slot) vs the summary build "
          f"{summary_ms * 1e3:.1f} us ({out['summary_us_per_slot']:.2f}), turns "
          f"{[round(t * 1e3, 1) for t in turns]} us; "
          f"+{out['extra_us_per_failed_slot']:.2f} us a charged slot; bound "
          f"{bound_ms * 1e3:.3f} us by {bound_by}; twin {twin_s * 1e3:.1f} ms", flush=True)
    return out


def run_series_paths(results, dev):
    """Series telemetry at full width (the slice's main path), each run
    with the counters zeroed just before and read just after:
    (a) CONFIG6's trace with devicePreemption off at ``series`` (500 nodes
    x 26,000 pods, contended, the plain path: one attributed K6 a chunk,
    no K1, K2, K3 bind or K5 launch), against REJECT_PINS, sum(reasons) =
    nodes x unschedulable and attempts = reasons, equal to the per-slot
    route (K5 after every slot's K2) in assignments and reject counters;
    (b) CONFIG7 as shipped through the port's CLI ``run`` with ``telemetry:
    series`` and ``timelineOut`` (the retry path on the chunk route: K5's
    folds and retry pass between K6 launches), the row, the events and the
    Chrome trace against REJECT_PINS and the placements against
    RETRY_PINS; (c) the 150-node cut at ``timeline`` against REJECT_PINS
    and RETRY_PINS; (d) config13 through the CLI at ``series`` (node shards:
    K9 with the pager, no attribution, the reference's note) placing as its
    summary run, and SHARD_CUT at ``series`` against SHARD_PINS. The walls
    of (a) at ``summary``, ``series`` on the chunk route and ``series`` on
    the per-slot route in turns, of (b) at ``timeline`` against
    ``summary``, and busy shares. CONFIG6 as shipped (tier preemption) at
    ``series`` logs the reference's note and places as PREEMPT_PINS. K6's
    attributed mode held against its twin and the per-slot kernels in a
    window of (a) where pods fail, with its plan's ranks (C = 1) and with 4
    ranks forced, and timed there a slot beside the summary build; K5 held
    against its twin launch by launch in the same window on the per-slot
    route, at a chunk fold and the retry pass of (c) at S = 1 and of
    CONFIG7's 40-node cut at S = 4, and timed per launch on the plain path
    and as a fold."""
    from kubernetes_simulator_tpu_torch import cli
    import yaml

    out = {}
    # (a)
    cfg, ec, ep = config6_case()
    kw = dict(wave_width=8, chunk_waves=cfg.chunk_waves, device=dev)
    eng_sum = TorchReplayEngine(ec, ep, cfg.framework, telemetry="summary", **kw)
    eng = TorchReplayEngine(ec, ep, cfg.framework, telemetry="series", **kw)
    eng_sum.replay()
    K.reset_launch_counts()
    res = eng.replay()
    launches = K.launch_counts()
    attributed = K.chunk_replay.attributed
    series_chunk_launches("config6 series", res, launches, attributed, eng.plan)
    tel = res.telemetry
    check_series_pins("config6 series", REJECT_PINS["config6"], tel)
    if (sum(tel.reasons.values()) != ec.num_nodes * res.unschedulable
            or tel.rejection_attempts != tel.reasons):
        raise AssertionError(f"config6 series: reasons {tel.reasons} do not charge {ec.num_nodes}"
                             f" nodes for each of {res.unschedulable} unschedulable pods")
    rj = [x.clone() for x in eng.last_tables.reject]
    slot_launches_a, _ = slot_route("config6 series, per-slot route", eng, res.assignments[None],
                                    series=True, joint=True)
    for f, x, y in zip(eng.last_tables.reject._fields, rj, eng.last_tables.reject):
        if not torch.equal(x, y):
            raise AssertionError(f"config6 series: reject.{f} differs on the per-slot route")
    if slot_launches_a["first_reject"] != int((eng.plan.idx >= 0).sum()):
        raise AssertionError(f"config6 series, per-slot route: launches {slot_launches_a}")
    modes = {"summary": lambda: eng_sum._run(joint=True),
             "series_chunk": lambda: eng._run(series=True, joint=True),
             "series_slot": lambda: eng._run(series=True, route="slot", joint=True)}
    walls = {k: [] for k in modes}
    for k in ("summary", "series_chunk", "series_slot", "series_slot", "series_chunk",
              "summary"):
        walls[k].append(modes[k]()[1])
    by_series, by_summary = {}, {}
    res_p, busy_s = profiled_busy_s(eng.replay, by_series)
    res_sp, busy_sum = profiled_busy_s(eng_sum.replay, by_summary)
    (_, slot_wall_p, _, _, _), busy_slot = profiled_busy_s(modes["series_slot"])
    ev_series, ev_summary = chunk_events_s(eng, dev, True), chunk_events_s(eng_sum, dev)
    wall_series = float(np.median(walls["series_chunk"]))
    wall_summary = float(np.median(walls["summary"]))
    out["config6"] = dict(nodes=ec.num_nodes, pods=ep.num_pods, placed=res.placed,
                          unschedulable=res.unschedulable, reasons=tel.reasons,
                          samples=len(tel.series["t"]), launches=launches,
                          k6_attributed=attributed, slot_route_launches=slot_launches_a,
                          walls_s=walls, route=res.route, chunks=len(eng.plan.buckets),
                          profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
                          device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None,
                          device_s_by_kernel=by_series, summary_profiled_wall_s=res_sp.wall_clock_s,
                          chunk_events_device_s=ev_series, chunk_events_busy_share=ev_series
                          / wall_series, summary_chunk_events_device_s=ev_summary,
                          summary_chunk_events_busy_share=ev_summary / wall_summary,
                          summary_device_busy_s=busy_sum, summary_device_s_by_kernel=by_summary,
                          slot_profiled_wall_s=slot_wall_p, slot_device_busy_s=busy_slot,
                          slot_device_busy_share=busy_slot / slot_wall_p if busy_slot else None)
    print(f"(a) config6 series ({ec.num_nodes} x {ep.num_pods}, devicePreemption off, route "
          f"{res.route}): placed "
          f"{res.placed}, reasons {json.dumps(tel.reasons)} == {ec.num_nodes} x "
          f"{res.unschedulable}, attempts == reasons, == REJECT_PINS, == the per-slot route "
          f"(assignments, reject counters); launches {json.dumps(launches)}, {attributed} "
          f"attributed K6 for {len(eng.plan.buckets)} chunks; walls in turns: summary "
          f"{[round(w, 3) for w in walls['summary']]} s, series on K6 "
          f"{[round(w, 3) for w in walls['series_chunk']]} s, series per slot "
          f"{[round(w, 3) for w in walls['series_slot']]} s; profiled busy: K6 "
          f"{busy_s / res_p.wall_clock_s:.1%} of {res_p.wall_clock_s:.3f} s (K6 "
          f"{k6_device_s(by_series):.4f} s), summary {busy_sum / res_sp.wall_clock_s:.1%} of "
          f"{res_sp.wall_clock_s:.3f} s (K6 {k6_device_s(by_summary):.4f} s), per slot "
          f"{busy_slot / slot_wall_p:.1%} of {slot_wall_p:.3f} s; device time by CUDA events "
          f"chunk by chunk: series {ev_series:.4f} s ({ev_series / wall_series:.1%} of the "
          f"median wall), summary {ev_summary:.4f} s ({ev_summary / wall_summary:.1%})",
          flush=True)
    mark("21 (a) config6 series runs")
    # K6's attributed mode in a window of (a) where pods fail (inside one
    # chunk, past its start), at its plan's ranks and at 4 ranks; then K5
    # launch by launch in the same window on the per-slot route, and timed.
    unplaced = np.nonzero(res.assignments < 0)[0]
    flat = eng.plan.idx.reshape(-1)
    Cw, Wd = eng.plan.C, eng.plan.idx.shape[1]
    pos = {int(q): i for i, q in enumerate(flat.tolist()) if q >= 0}
    w0 = next(pos[int(q)] // Wd for q in unplaced if (pos[int(q)] // Wd) % Cw)
    lo = max(w0 // Cw * Cw + 1, min(w0, (w0 // Cw + 1) * Cw - 8))
    hi = min(lo + 8, (w0 // Cw + 1) * Cw)
    k6a = {f"C={c or 'plan'}": hold_k6_attributed(f"K6 attributed (config6, C {c or 'plan'})",
                                                  eng, lo, hi, dev, res.assignments[None], C=c)
           for c in (None, 4)}
    results["k6_attributed"] = k6a
    hold_first_reject("K5 at S=1 (config6, plain path)", eng, lo, hi, dev, results)
    p = int(unplaced[-1])
    pods = torch.tensor([p], dtype=torch.int32, device=dev)
    gate = torch.full((1, 1), PAD, dtype=torch.int32, device=dev)
    tb_end = eng.last_tables
    nb, no = Work(ep, tb_end).k5([[p]], [[True]])
    bms, bby = bound(nb, no)
    m = k6a["C=plan"]
    kernels = {"first_reject": dict(**time_first_reject(tb_end, pods, gate), bound_ms=bms,
                                    bound_by=bby, library_ms=None, max_abs_err=0.0),
               "chunk_replay_attributed": dict(
                   ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"], library_ms=None, max_abs_err=0.0,
                   launches=attributed, cluster=m["cluster"], window_slots=m["slots"],
                   us_per_slot=m["us_per_slot"], summary_ms=m["summary_ms"])}
    del eng, eng_sum, res_p
    mark("21 (a) K6 attributed and K5 holds, time")
    # Config6 as shipped: tier preemption keeps its placements, with the note.
    eng_t = TorchReplayEngine(ec, ep, cfg.framework, telemetry="series", preemption=True, **kw)
    with LogLines() as lines:
        rt = eng_t.replay()
    if not any("not available with in-scan tier preemption" in m for m in lines.lines):
        raise AssertionError("config6 (tier) at series: the reference's note was not logged")
    check_pins("config6 (tier) at series", PREEMPT_PINS["config6"], rt.placed, rt.preemptions,
               rt.assignments)
    if rt.telemetry.reasons != {}:
        raise AssertionError("config6 (tier) at series attributed rejections")
    print("config6 (tier preemption) at series: the reference's note logged, reasons empty, "
          "placements == PREEMPT_PINS", flush=True)
    del eng_t, rt

    mark("21 config6 tier at series")
    # (b) config7 through the CLI.
    cfg7, ec7, ep7 = config7_case()
    outdir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    d = config7_dict()
    trace = os.path.join(outdir, "config7_timeline.json")
    d["telemetry"] = {"granularity": "series", "timelineOut": trace}
    d["output"] = os.path.join(outdir, "config7_run.jsonl")
    path = os.path.join(outdir, "config7_series.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main(["run", path, "--device", dev.type]) != 0:
        raise AssertionError("config7 run through the CLI failed")
    cli_s = time.perf_counter() - t0
    launches7 = K.launch_counts()
    attributed7 = K.chunk_replay.attributed
    with open(d["output"]) as f:
        row = json.loads(f.read().splitlines()[-1])
    with open(trace) as f:
        doc = json.load(f)
    trace_sha = file_sha256(trace)
    os.remove(trace)
    rb = cfg7.whatif.retry_buffer
    kw7 = dict(wave_width=8, chunk_waves=cfg7.chunk_waves, retry_buffer=rb, device=dev)
    e7 = {g: TorchReplayEngine(ec7, ep7, cfg7.framework, telemetry=g, **kw7)
          for g in ("summary", "timeline")}
    r7 = e7["timeline"].replay()
    series_retry_launches("config7's CLI run at series", r7, launches7, attributed7,
                          e7["timeline"].plan)
    check_series_pins("config7 run (CLI)", REJECT_PINS["config7"], r7.telemetry,
                      dict(trace_sha256=trace_sha))
    check_retry_pins("config7 run (CLI) at series", RETRY_PINS["config7"], r7.placed,
                     r7.retry_dropped, r7.assignments)
    if (row["telemetry"]["granularity"] != "timeline" or row["placed"] != r7.placed
            or row["telemetry"]["timeline_events"] != len(r7.telemetry.events)
            or len(doc["traceEvents"]) == 0):
        raise AssertionError(f"config7 run (CLI): row {row['telemetry']} or trace disagree")
    walls7 = {"summary": [], "timeline": []}
    for g in ("summary", "timeline", "timeline", "summary"):
        walls7[g].append(e7[g].replay().wall_clock_s)
    res_p, busy7 = profiled_busy_s(e7["timeline"].replay)
    out["config7"] = dict(nodes=ec7.num_nodes, pods=ep7.num_pods, placed=r7.placed,
                          reasons=r7.telemetry.reasons, events=len(r7.telemetry.events),
                          trace_events=len(doc["traceEvents"]), cli_s=cli_s, launches=launches7,
                          walls_s=walls7, profiled_wall_s=res_p.wall_clock_s,
                          device_busy_s=busy7,
                          device_busy_share=busy7 / res_p.wall_clock_s if busy7 else None)
    print(f"(b) config7 run through the CLI (series + timelineOut, retryBuffer {rb}, route "
          f"{r7.route}): placed "
          f"{r7.placed}, {len(r7.telemetry.events)} events, trace of {len(doc['traceEvents'])} "
          f"events parses, == REJECT_PINS (trace sha256 included) and RETRY_PINS; CLI "
          f"{cli_s:.2f} s; launches "
          f"{json.dumps(launches7)}; walls timeline {[round(w, 3) for w in walls7['timeline']]} s"
          f" vs summary {[round(w, 3) for w in walls7['summary']]} s; profiled busy "
          f"{busy7 / res_p.wall_clock_s:.1%}", flush=True)
    del e7, r7, res_p

    mark("21 (b) config7 CLI, runs")
    # (c) the 150-node cut.
    cfgc, ecc, epc = config7_case(nodes=RETRY_CUT_NODES)
    ec_ = TorchReplayEngine(ecc, epc, cfgc.framework, telemetry="timeline",
                            wave_width=8, chunk_waves=cfgc.chunk_waves, retry_buffer=rb,
                            device=dev)
    K.reset_launch_counts()
    rc = ec_.replay()
    launchesc = K.launch_counts()
    series_retry_launches(f"the {RETRY_CUT_NODES}-node cut at timeline", rc, launchesc,
                          K.chunk_replay.attributed, ec_.plan)
    check_series_pins(f"{RETRY_CUT_NODES}-node cut at timeline", REJECT_PINS["cut150"],
                      rc.telemetry)
    check_retry_pins(f"{RETRY_CUT_NODES}-node cut at timeline", RETRY_PINS["cut150"], rc.placed,
                     rc.retry_dropped, rc.assignments)
    out["cut150"] = dict(placed=rc.placed, retry_dropped=rc.retry_dropped,
                         reasons=rc.telemetry.reasons, launches=launchesc,
                         wall_s=rc.wall_clock_s)
    print(f"(c) {RETRY_CUT_NODES}-node cut at timeline (route {rc.route}): placed "
          f"{rc.placed}, dropped "
          f"{rc.retry_dropped}, reasons {json.dumps(rc.telemetry.reasons)}, attempts "
          f"{json.dumps(rc.telemetry.rejection_attempts)}, == REJECT_PINS and RETRY_PINS; "
          f"launches {json.dumps(launchesc)}; wall {rc.wall_clock_s:.3f} s", flush=True)
    mark("21 (c) cut150 run")
    # K5 at a fold and in a retry pass of (c), S = 1 (the fold charges
    # nothing there: every failed slot had room at its chunk's start).
    C = ec_.plan.C
    b = max(len(ec_.plan.buckets) // 2, 1)
    hold_first_reject(f"K5 at S=1 ({RETRY_CUT_NODES}-node cut, fold and retry pass)", ec_,
                      b * C - 2, b * C + 2, dev, results,
                      must_charge=bool(REJECT_PINS["cut150"]["attempts"]), joint=True)
    plan = ec_.plan
    CW = C * plan.idx.shape[1]
    cols = slice((b - 1) * CW, b * CW)
    ch_dev = torch.as_tensor(ec_.last_choices, device=dev)
    idx_dev = torch.as_tensor(plan.idx.reshape(-1), device=dev)
    tb_c = ec_.last_tables
    slots = plan.idx.reshape(-1)[cols]
    nb, no = Work(epc, tb_c).k5(slots[None], (ec_.last_choices[:, cols] < 0))
    bms, bby = bound(nb, no)
    kernels["first_reject_fold"] = dict(
        **time_first_reject(tb_c, idx_dev[cols], ch_dev[:, cols], iters=50, plain_iters=1,
                            wrapper=K.first_reject_fold),
        bound_ms=bms, bound_by=bby, library_ms=None, max_abs_err=0.0,
        launches=launchesc["first_reject_fold"])
    mark("21 (c) K5 hold, fold time")
    # S = 4: CONFIG7's 40-node cut as a 4-scenario batch (chunkWaves 32,
    # retryBuffer 64), fold and retry pass both charging.
    cfg4, ec4, ep4 = config7_case(nodes=40, pods=2000)
    scen = uniform_scenarios(ec4, 4, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    w4 = WhatIfEngine(ec4, ep4, scen, cfg4.framework, wave_width=8, chunk_waves=32,
                      retry_buffer=64, device=dev)
    # Failures gather late in the trace: the window is the last boundary
    # whose fold charges, walking back from the run's end.
    nb = len(w4.plan.buckets)
    for b4 in range(nb - 1, max(nb - 4, 0), -1):
        n4 = hold_first_reject(f"K5 at S=4 (config7 cut to 40 nodes, boundary {b4})", w4,
                               b4 * 32 - 2, b4 * 32 + 2, dev, results, must_charge=False)
        if n4["k5_charged"]:
            break
    else:
        raise AssertionError("K5 at S=4: no window near the end of the run charged anything")
    # K5's row: the retry path's per-slot launches in (b), the main run
    kernels["first_reject"]["launches"] = launches7["first_reject"]
    mark("21 S=4 K5 holds")
    out["config13"] = run_series_shards(results, dev)
    results["series"] = out
    results["kernels_series"] = kernels
    print("series kernels: " + "; ".join(
        f"{k} {m['ms'] * 1e3:.2f} us (bound {m['bound_ms'] * 1e3:.4f} us, {m['bound_by']}; twin "
        f"{m['plain_ms']:.3f} ms), {m['launches']} launches" for k, m in kernels.items()),
          flush=True)
    return kernels


def run_series_shards(results, dev):
    """(d) Telemetry series under node shards, as the reference runs it
    (sim/jax_runtime.py:2137-2144: attribution off, the note logged): CONFIG13
    through the CLI ``run`` with ``telemetry: series``, counters zeroed just
    before and read just after — the shard route (one K9 a chunk, K8 at each
    release, the pager), no K5 and no K6, the note logged, no reasons, the
    assignments equal to the summary run of step e (their sha256); then
    SHARD_CUT (4 shards, paged) at ``series`` against SHARD_PINS."""
    import contextlib
    import io

    import yaml

    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.framework import registry
    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    outdir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(ROOT, CONFIG13)) as f:
        d = yaml.safe_load(f)
    d["telemetry"] = {"granularity": "series"}
    path = os.path.join(outdir, "config13_series.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    factory = registry.get_strategy("torch")
    made = []
    registry._STRATEGIES["torch"] = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
    buf = io.StringIO()
    K.reset_launch_counts()
    try:
        with LogLines() as lines, contextlib.redirect_stdout(buf):
            rc = cli.main(["run", path, "--device", dev.type])
    finally:
        registry._STRATEGIES["torch"] = factory
    launches = K.launch_counts()
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"config13 at series: the CLI returned {rc}")
    eng = made[0]
    row = json.loads([x for x in buf.getvalue().splitlines() if x.startswith("{")][-1])
    shard_route_launches("config13 at series", launches, eng.plan)
    if (launches["first_reject"] or launches["first_reject_fold"] or eng.last_route != "shard"
            or eng.last_pager is None):
        raise AssertionError(f"config13 at series: route {eng.last_route}, pager "
                             f"{eng.last_pager}, launches {launches}")
    if not any("rejection attribution is disabled under node sharding" in m
               for m in lines.lines):
        raise AssertionError("config13 at series: the reference's note was not logged")
    a, placed, _ = assignments_from_choices(eng.plan, eng.last_choices, eng.pods.bound_node)
    sha = assignments_sha256(a[0])
    tel = row["telemetry"]
    if (tel["granularity"] != "series" or tel.get("reasons")
            or sha != results["config13"]["assignments_sha256"]
            or row["placed"] != results["config13"]["placed"]):
        raise AssertionError(f"config13 at series: row {row}, sha256 {sha} (summary: "
                             f"{results['config13']['assignments_sha256']})")
    sc = SHARD_CUT
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=sc["nodes"], tasks=sc["tasks"], seed=SEED))
    cut = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=sc["chunk_waves"],
                            node_shards=sc["node_shards"], paged=True, device=dev,
                            telemetry="series").replay()
    got = dict(placed=cut.placed, unschedulable=cut.unschedulable,
               sha256=assignments_sha256(cut.assignments))
    if got != SHARD_PINS or cut.route != "shard" or cut.telemetry.reasons:
        raise AssertionError(f"shard cut at series: {got} (route {cut.route}) != SHARD_PINS")
    out = dict(route=eng.last_route, placed=row["placed"], wall_s=row["wall_clock_s"],
               summary_wall_s=results["config13"]["wall_s"], launches=launches,
               pager_stalls=eng.last_pager.stalls, assignments_sha256=sha,
               shard_cut=dict(**got, wall_s=cut.wall_clock_s))
    print(f"(d) config13 at series through the CLI (route {eng.last_route}: one K9 a chunk, K8 "
          f"at {launches['shard_apply_release']} releases, pager {eng.last_pager.stalls} "
          f"stalls; no K5): the reference's note logged, no reasons, placed {row['placed']}, "
          f"assignments == the summary run's; wall {row['wall_clock_s']:.3f} s (summary "
          f"{results['config13']['wall_s']:.3f} s); the shard cut at series == SHARD_PINS",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Label perturbations (set_label)
# ---------------------------------------------------------------------------


def relabel_scenarios(ec, S, seed=SEED):
    """Scenario 0 the base; scenario s of 1..S-1 ``uniform_scenarios(seed)``'s
    perturbations plus one ``set_label`` of k = rng.integers(1, 33) nodes
    (numpy ``default_rng(seed)``), of the kind ``LABEL_KINDS[s % 3]``: the
    zone set to an existing zone, the zone set to a new one ``zone-x{s}``,
    or ``tier`` set to ``hot`` (which pods prefer through node affinity)."""
    scen = uniform_scenarios(ec, S, seed=seed)
    rng = np.random.default_rng(seed)
    for s in range(1, S):
        k = int(rng.integers(1, 33))
        nodes = rng.choice(ec.num_nodes, size=k, replace=False)
        kind = LABEL_KINDS[s % 3]
        if kind == "zone_move":
            key, value = ZONE, f"zone-{int(rng.integers(8))}"
        elif kind == "new_zone":
            key, value = ZONE, f"zone-x{s}"
        else:
            key, value = "tier", "hot"
        scen[s].perturbations.append(Perturbation("set_label", nodes=nodes, key=key, value=value))
    return scen


def explicit_cluster(cluster, sc, taint=None):
    """A copy of the object-model ``cluster`` with scenario ``sc``'s
    perturbations applied to its nodes (the from-scratch check).
    ``taint``: the Taint class of the cluster's object model (None: the
    port's)."""
    if taint is None:
        from kubernetes_simulator_tpu_torch.models.core import Taint as taint

    c2 = copy.deepcopy(cluster)
    for pt in sc.perturbations:
        for n in np.atleast_1d(np.arange(len(c2.nodes))[pt.nodes]).tolist():
            node = c2.nodes[n]
            if pt.op == "set_label":
                node.labels[pt.key] = pt.value
            elif pt.op == "scale_capacity":
                node.allocatable = {k: (v * pt.factor if k == pt.resource else v)
                                    for k, v in node.allocatable.items()}
            elif pt.op == "node_down":
                node.allocatable = {k: 0.0 for k in node.allocatable}
            elif pt.op == "add_taint":
                node.taints.append(taint(pt.key, pt.value, pt.effect))
    return c2


def case_objects(nodes, pods, seed=SEED, duration_mean=50.0, gang_fraction=0.02):
    """The object-model cluster and workload :func:`case` encodes."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.1)
    workload, _ = make_workload(
        pods, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True,
        duration_mean=duration_mean, gang_fraction=gang_fraction, gang_size=4,
    )
    return cluster, workload


def first_of_each_kind(S):
    """{kind: the first scenario of ``relabel_scenarios`` of that kind}."""
    return {LABEL_KINDS[s % 3]: s for s in range(min(S, 4) - 1, 0, -1)}


def check_reduced_relabel(results, dev="cuda"):
    """The relabel batch reduced: 8 scenarios x 60 nodes x 2,000 pods
    (durationMean 60, gangs) — a move to an existing zone with a capacity
    cut, a new zone, emptying a singleton zone, a node gaining the key, a
    taint-only scenario, a tier flip and a new zone beside uniform
    perturbations — on the kernel path, the plain path on the card and the
    plain path on the CPU: assignments [S, P] identical."""
    nodes, pods = 60, REDUCED_PODS
    cluster, workload = case_objects(nodes, pods, duration_mean=60.0, gang_fraction=0.05)
    cluster.nodes[7].labels[ZONE] = "zonly"
    del cluster.nodes[11].labels[ZONE]
    ec, ep = encode(cluster, workload)
    P = lambda nodes, key=ZONE, value=None, **kw: Perturbation(
        "set_label", nodes=np.asarray(nodes), key=key, value=value, **kw)
    scen = [Scenario() for _ in range(8)]
    scen[1].perturbations = [P([0, 4], value="zone-1"),
                             Perturbation("scale_capacity", nodes=np.array([2]),
                                          resource="cpu", factor=0.5)]
    scen[2].perturbations = [P([1, 9, 17], value="zz-fresh")]
    scen[3].perturbations = [P([7], value="zone-0")]
    scen[4].perturbations = [P([11], value="zone-2")]
    scen[5].perturbations = [Perturbation("add_taint", nodes=np.array([5, 6]), key="wi",
                                          value="x", effect="NoSchedule")]
    scen[6].perturbations = [P(np.arange(1, 30, 2), key="tier", value="hot")]
    scen[7].perturbations = (uniform_scenarios(ec, 2, seed=3, p_node_down=1.0,
                                               p_taint=1.0)[1].perturbations
                             + [P(np.arange(20, 40), value="zone-new")])
    kw = dict(wave_width=8, chunk_waves=64)
    runs, walls = [], []
    for o in (dict(device=dev), dict(device=dev, plain=True), dict(device="cpu")):
        t0 = time.perf_counter()
        eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), **kw, **o)
        if eng.engine != "v3" or not eng.completions_on:
            raise AssertionError(f"reduced relabel: engine {eng.engine}, completions "
                                 f"{eng.completions_on}")
        runs.append(eng._run()[2])
        walls.append(time.perf_counter() - t0)
        if o == dict(device=dev):
            if eng.last_route != "chunk":
                raise AssertionError(f"reduced relabel ran on route {eng.last_route}")
            slot_route("reduced relabel what-if", eng, runs[0])
    for name, other in (("plain on the card", runs[1]), ("plain on the cpu", runs[2])):
        bad = np.argwhere(runs[0] != other)
        if bad.size:
            raise AssertionError(f"reduced relabel: kernel path != {name} at (scenario, pod) "
                                 f"{bad[:5].tolist()}")
    moved = [s for s in range(1, 8) if (runs[0][s] != runs[0][0]).any()]
    if len(moved) < 6:
        raise AssertionError(f"reduced relabel is vacuous: scenarios {moved} differ from 0")
    results["reduced_relabel"] = dict(scenarios=8, nodes=nodes, pods=pods,
                                      placed=(runs[0] >= 0).sum(axis=1).tolist(),
                                      scenarios_moved=moved, kernel_s=walls[0],
                                      plain_card_s=walls[1], plain_cpu_s=walls[2])
    print(f"reduced relabel what-if (8 x {nodes} nodes x {pods} pods): assignments identical on "
          f"the chunk route (K6), the per-slot kernels, the plain path on the card and on the CPU "
          f"({walls[0]:.2f}s / {walls[1]:.2f}s / {walls[2]:.2f}s); scenarios {moved} differ "
          f"from the base", flush=True)


def check_label_cut(results, dev):
    """The relabel batch on LABEL_CUT (the base and one scenario of each
    kind): each relabelled scenario's placed count and assignments' sha256
    equal greedy_replay's pins (LABEL_PINS)."""
    lc = LABEL_CUT
    ec, ep = case(lc["nodes"], lc["pods"])
    scen = relabel_scenarios(ec, lc["scenarios"])
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=lc["chunk_waves"],
                       device=dev)
    if eng.engine != "v3" or not eng.completions_on or eng.chunk_waves != lc["chunk_waves"]:
        raise AssertionError(f"label cut: engine {eng.engine}, completions "
                             f"{eng.completions_on}, chunk waves {eng.chunk_waves}")
    _, wall, assignments, placed, _ = eng._run()
    for kind, s in first_of_each_kind(lc["scenarios"]).items():
        got = dict(placed=int(placed[s]), sha256=assignments_sha256(assignments[s]))
        if got != LABEL_PINS[kind]:
            raise AssertionError(f"label cut scenario {s} ({kind}): {got} != greedy_replay's "
                                 f"pinned {LABEL_PINS[kind]}")
    results["label_cut"] = dict(nodes=lc["nodes"], pods=lc["pods"], placed=placed.tolist(),
                                wall_s=wall)
    print(f"label cut ({lc['nodes']} nodes x {lc['pods']} pods, route {eng.last_route}): "
          f"scenarios "
          f"{sorted(first_of_each_kind(lc['scenarios']).values())} == greedy_replay's pins, "
          f"placed {placed.tolist()}, wall {wall:.3f}s", flush=True)


def hold_window(where, eng, dev, results, key, min_waves=16):
    """K1, K2 and K3 against their twins launch by launch in a mid-replay
    window of ``eng``'s batch (its label rows, its policy rows): a
    kernel-path run up to the first boundary past 0 with a release bucket,
    the tables copied into twin tables on the card, then that release, and
    every K1, K2 and bind after it — at least ``min_waves`` waves, and on
    past a wave with a gang rollback — on both, every plane compared after
    every launch. The counts go to ``results[key]``."""
    plan = eng.plan
    b = next(b for b in range(1, len(plan.buckets)) if plan.buckets[b] is not None)
    first = b * plan.C
    gang = np.nonzero(plan.gang_wave[first:])[0]
    end = first + max(min_waves, int(gang[0]) + 1 if gang.size else min_waves)
    tb_k = eng._tables()
    ch_k = new_choices(plan, eng.S, eng.pods.bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, first, plain=False)
    torch.cuda.synchronize()
    tb_t, ch_t = clone_tables(tb_k), ch_k.clone()
    n = lockstep(where, plan, tb_k, tb_t, ch_k, ch_t, first, end, dev)
    if not (n["static_release"] and n["rollbacks"] and n["binds"]):
        raise AssertionError(f"{where}: the window ran {n}")
    results[key] = dict(boundary=b, waves=[first, end], **n)
    print(f"{where}: boundary {b}'s release and waves {first}..{end} ({n['binds']} binds, "
          f"{n['rollbacks']} rollbacks) x {eng.S} scenarios: K1, K2 and K3 equal their twins "
          f"launch by launch", flush=True)


def run_label_paths(results, headline_s0, dev):
    """The relabel what-if at the headline's full width (the slice's main
    run): 128 ``relabel_scenarios`` over the headline trace, inside the
    DynTables envelope (completions on). Counters zeroed just before a
    warm-up and read just after; three timed runs and a profiled one;
    scenario 0 equal to the headline's; one relabelled scenario of each
    kind equal to a single-scenario replay on the card of its cluster,
    relabelled explicitly and re-encoded; K1 and K3 held against their
    twins at a synthetic mid-replay state (and timed) and in a window of
    the batch's own replay. Then the label cut against its pins and the
    batch outside the envelope. Returns (kernel timings, the batch's
    launches, its per-slot route's launches)."""
    hs = HEADLINE
    S = hs["scenarios"]
    t0 = time.perf_counter()
    cluster, workload = case_objects(hs["nodes"], hs["pods"])
    ec, ep = encode(cluster, workload)
    scen = relabel_scenarios(ec, S)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=hs["chunk_waves"])
    setup_s = time.perf_counter() - t0
    cl = eng._tables().cluster
    if eng.engine != "v3" or not eng.completions_on or cl.gdom.shape[0] != S:
        raise AssertionError(f"relabel what-if: engine {eng.engine}, completions "
                             f"{eng.completions_on}, {cl.gdom.shape[0]} label rows")
    K.reset_launch_counts()
    _, warm_wall, assignments, placed, _ = eng._run()
    launches = K.launch_counts()
    check_chunk_launches("relabel what-if", launches, eng.plan)
    runs = [eng.run() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.placed, placed):
            raise AssertionError("the relabel what-if placed differently from run to run")
    check_whatif_result(ep, runs[0], S)
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    res_p, busy_s = profiled_busy_s(eng.run)
    if not np.array_equal(assignments[0], headline_s0):
        raise AssertionError("relabel what-if scenario 0 != the headline's scenario 0")
    route = eng.last_route
    # The per-slot route: the same placements.
    slot_launches, slot_wall = slot_route("relabel what-if", eng, assignments)
    singles = {}
    for kind, s in first_of_each_kind(S).items():
        ec_s, ep_s = encode(explicit_cluster(cluster, scen[s]), workload)
        one = TorchReplayEngine(ec_s, ep_s, FrameworkConfig(), chunk_waves=eng.chunk_waves)
        res1 = one.replay()
        bad = np.nonzero(res1.assignments != assignments[s])[0]
        if bad.size:
            raise AssertionError(f"relabel what-if scenario {s} ({kind}) != its from-scratch "
                                 f"replay at pods {bad[:5].tolist()}")
        singles[kind] = dict(scenario=s, placed=res1.placed, wall_s=res1.wall_clock_s)
    moved = int(sum((assignments[s] != assignments[0]).any() for s in range(1, S)))
    results["relabel_whatif"] = dict(
        **hs, setup_s=setup_s, label_rows=int(cl.gdom.shape[0]),
        domains=int(eng._tables().state.match_count.shape[2]), chunk_waves_run=eng.plan.C,
        completions_on=eng.completions_on, route=route, launches=launches,
        slot_route=dict(launches=slot_launches, wall_s=slot_wall), warmup_wall_s=warm_wall,
        walls_s=walls, wall_s=wall, placements_per_s=float(placed.sum()) / wall,
        total_placed=int(placed.sum()), placed_min=int(placed.min()),
        placed_max=int(placed.max()), scenarios_moved=moved, singles=singles,
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None)
    print(f"relabel what-if (route {route}, {S} scenarios x {hs['nodes']} nodes x "
          f"{hs['pods']} pods, "
          f"{cl.gdom.shape[0]} label rows, completions on): median wall {wall:.3f}s of "
          f"{[round(w, 3) for w in walls]}, {float(placed.sum()) / wall:.1f} aggregate "
          f"placements/s, placed {int(placed.min())}..{int(placed.max())}; {moved} scenarios "
          f"differ from 0; scenario 0 == the headline's; scenarios "
          f"{[v['scenario'] for v in singles.values()]} == their from-scratch replays; launches "
          f"{json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%})", flush=True)
    mark("17 relabel what-if runs")
    results["chunk_loop_bound_ms_relabel"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, assignments, launches)
    hold_chunk_replay(f"S={S} relabel what-if", eng, dev, results, assignments)
    hold_window(f"S={S} relabel window (N={hs['nodes']})", eng, dev, results, "label_window")
    rng = np.random.default_rng(SEED + 256)
    tb0 = eng._tables()
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, tb0.cluster, tb0.consts, S, rng,
                                                   dev, state=tb0.state)
    mark("17 relabel B6 bound, window")
    held = hold_kernels(f"S={S} label-row kernel checks (N={hs['nodes']})", ep, tb_t, tb_k,
                        pre, pre_nodes, 40, rng, dev)
    mark("18 label-row hold")
    kernels, release = time_kernels(ep, tb_t, held, dev)
    results["kernels_label"], results["apply_release_label"] = kernels, release
    del eng, res_p, tb0, tb_t, tb_k, held

    check_label_cut(results, dev)

    # Outside the envelope: whole zones move (K = 250 > 32), completions off.
    t0 = time.perf_counter()
    out_scen = []
    for s in range(OUTSIDE_SCENARIOS):
        zone = np.array([n.labels[ZONE] == f"zone-{s % 8}" for n in cluster.nodes])
        out_scen.append(Scenario([Perturbation("set_label", nodes=np.nonzero(zone)[0], key=ZONE,
                                               value=f"zone-{(s + 1) % 8}")]))
    out = WhatIfEngine(ec, ep, out_scen, FrameworkConfig(), chunk_waves=hs["chunk_waves"],
                       completions=False, collect_assignments=True)
    setup_out = time.perf_counter() - t0
    if out.engine != "v2" or out.completions_on or out.sset.relabelled != hs["nodes"] // 8:
        raise AssertionError(f"outside the envelope: engine {out.engine}, completions "
                             f"{out.completions_on}, K {out.sset.relabelled}")
    out.run()
    res_out = out.run()
    ec_1, ep_1 = encode(explicit_cluster(cluster, out_scen[1]), workload)
    one = TorchReplayEngine(ec_1, ep_1, FrameworkConfig(), chunk_waves=out.chunk_waves,
                            completions=False).replay()
    if not np.array_equal(one.assignments, res_out.assignments[1]):
        raise AssertionError("outside the envelope: scenario 1 != its from-scratch replay")
    results["relabel_outside"] = dict(
        scenarios=OUTSIDE_SCENARIOS, engine=res_out.engine,
        completions_on=res_out.completions_on, relabelled_per_scenario=out.sset.relabelled,
        setup_s=setup_out, wall_s=res_out.wall_clock_s,
        placements_per_s=res_out.placements_per_sec,
        placed_min=int(res_out.placed.min()), placed_max=int(res_out.placed.max()))
    print(f"relabel what-if outside the envelope (route {res_out.route}, {OUTSIDE_SCENARIOS} "
          f"scenarios, "
          f"{out.sset.relabelled} nodes relabelled each): engine {res_out.engine}, completions "
          f"{res_out.completions_on}, wall {res_out.wall_clock_s:.3f}s, placed "
          f"{int(res_out.placed.min())}..{int(res_out.placed.max())}; scenario 1 == its "
          f"from-scratch replay", flush=True)
    return kernels, launches, slot_launches


def policy_cut_batch(ec):
    """(scenarios, policy rows [16, 6]) of P2 over ``ec``: each row of
    POLICY_ROWS on the first ``POLICY_CUT['scenarios']`` uniform_scenarios,
    row-major (the tuner's candidate-major layout)."""
    n = POLICY_CUT["scenarios"]
    rows = np.asarray(list(POLICY_ROWS.values()), np.float32)
    return uniform_scenarios(ec, n, seed=SEED) * len(rows), np.repeat(rows, n, axis=0)


def run_policy_paths(results, ec, ep, dev):
    """P1, the main path of policy rows: the policy tuner's sweep at the
    headline's full width (``PolicyTuner`` over the headline trace, 32
    candidates x 4 train scenarios = 128 rows a sweep, 2 rounds), counters
    zeroed just before and read just after; the engine set up once across
    both rounds; K1, K2 and K3 against their twins launch by launch in a
    window of a sweep with distinct rows (the last round's candidates,
    every other one MostAllocated); a
    sweep whose rows all equal the default vector equal to the same 128
    scenarios without policies (sha256 of the assignments); the held-out
    sweep's default half equal to a static what-if of the held-out split;
    the policy sweep timed against the static batch in turns (median of
    3), its launches and busy share; K1 and K2 with policy rows held and
    timed at a synthetic mid-replay state. Returns (kernel timings, the
    tuner's launches, the sweep's per-slot route's launches)."""
    hs, ts = HEADLINE, TUNE_SWEEP
    kw = dict(chunk_waves=hs["chunk_waves"], device=dev)
    t0 = time.perf_counter()
    tuner = PolicyTuner(ec, ep, FrameworkConfig(), cpu_oracle=False, **ts, **kw)
    K.reset_launch_counts()
    res = tuner.run()
    launches = K.launch_counts()
    tune_s = time.perf_counter() - t0
    if (launches["chunk_replay"] <= 0 or launches["apply_placements"] <= 0
            or launches["filter_score"] or launches["normalize_select"]):
        raise AssertionError(f"the policy sweep's chunk-route launches: {launches}")
    eng = tuner._train_engine
    S, S_h = eng.S, ts["heldout_scenarios"]
    if S != ts["population"] * ts["train_scenarios"] or eng.setups != 1 or res.compile_count != 1:
        raise AssertionError(f"policy sweep: {S} rows, {eng.setups} set-ups")
    if len(res.trajectory) != ts["rounds"] * (ts["population"] + 1) + 1:
        raise AssertionError(f"policy sweep: {len(res.trajectory)} trajectory rows")
    # The window's and the timed sweeps' rows: the last round's candidates,
    # every other one switched to MostAllocated.
    cand = eng._wrow.cpu().numpy()[:: ts["train_scenarios"]].copy()
    cand[:, 5] = np.arange(len(cand)) % 2 == 0
    sweep_rows = np.repeat(cand, ts["train_scenarios"], axis=0)
    if len({r.tobytes() for r in cand}) < len(cand) // 2:
        raise AssertionError("policy sweep: the last round's candidates are not distinct")
    eng.set_policies(sweep_rows)
    print(f"P1 policy tuner (route chunk, {ts['population']} candidates x "
          f"{ts['train_scenarios']} train "
          f"scenarios = {S} rows over the headline trace, {ts['rounds']} rounds): best "
          f"{json.dumps(res.best_policy)}, train {res.train_objective:.6f}, held-out "
          f"{res.heldout_objective:.6f} vs default {res.default_heldout_objective:.6f}; "
          f"{eng.setups} set-up; walls {json.dumps({k: round(v, 3) for k, v in res.phase_s.items()})}"
          f" s; launches {json.dumps(launches)}", flush=True)
    mark("P1 tuner")
    hold_window(f"S={S} policy-row window (N={hs['nodes']})", eng, dev, results, "policy_window")
    mark("P1 window")
    # (a) every row the default vector == the same scenarios without policies.
    eng.set_policies(np.repeat(tuner.space.defaults[None], S, axis=0))
    _, _, a_pol, _, _ = eng._run()
    static = WhatIfEngine(ec, ep, tuner.train_split * ts["population"], FrameworkConfig(),
                          **kw)
    _, _, a_static, _, _ = static._run()
    sha_pol, sha_static = assignments_sha256(a_pol), assignments_sha256(a_static)
    if sha_pol != sha_static:
        raise AssertionError(f"default policy rows {sha_pol} != policies=None {sha_static}")
    # (d) the held-out sweep's default half == a static what-if of the held-out split.
    hpol = np.concatenate([np.repeat(res.best_vector[None], S_h, axis=0),
                           np.repeat(tuner.space.defaults[None], S_h, axis=0)])
    held = WhatIfEngine(ec, ep, tuner.heldout_split * 2, FrameworkConfig(), policies=hpol,
                        collect_assignments=True, **kw).run()
    hstatic = WhatIfEngine(ec, ep, tuner.heldout_split, FrameworkConfig(),
                           collect_assignments=True, **kw).run()
    h_default = float(tuner._objective(hstatic).mean())
    if (not np.array_equal(held.assignments[S_h:], hstatic.assignments)
            or h_default != res.default_heldout_objective):
        raise AssertionError("the held-out sweep's default half != the static held-out what-if")
    mark("P1 default rows, held-out")
    # The sweep against the static batch, in turns; launches and busy share.
    eng.set_policies(sweep_rows)
    walls = {"static": [], "policy": []}
    for name, e in (("static", static), ("policy", eng), ("policy", eng), ("static", static),
                    ("static", static), ("policy", eng)):
        if name == "policy" and not walls["policy"]:
            K.reset_launch_counts()  # the first policy sweep: its launches
            sweep = e.run()
            sweep_launches = K.launch_counts()
        else:
            sweep = e.run()
        walls[name].append(sweep.wall_clock_s)
    res_p, busy_s = profiled_busy_s(eng.run)
    wall = float(np.median(walls["policy"]))
    # The per-slot route of the sweep: the same placements.
    _, _, a_sweep, _, _ = eng._run()
    slot_launches, slot_wall = slot_route("policy sweep", eng, a_sweep)
    results["policy_sweep"] = dict(
        **ts, rows=S, nodes=ec.num_nodes, pods=ep.num_pods, tune_s=tune_s,
        phase_s=res.phase_s, launches=launches, setups=eng.setups,
        best_policy=res.best_policy, train_objective=res.train_objective,
        heldout_objective=res.heldout_objective,
        default_heldout_objective=res.default_heldout_objective,
        default_rows_sha256=sha_pol, walls_s=walls, wall_s=wall,
        static_wall_s=float(np.median(walls["static"])),
        placements_per_s=float(sweep.placed.sum()) / wall, sweep_launches=sweep_launches,
        route=sweep.route, slot_route=dict(launches=slot_launches, wall_s=slot_wall),
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None)
    print(f"P1 policy sweep ({S} rows, route {sweep.route}): default rows == policies=None "
          f"(sha256 {sha_pol[:16]}); "
          f"held-out default half == the static held-out what-if; walls policy "
          f"{[round(w, 3) for w in walls['policy']]} s vs static "
          f"{[round(w, 3) for w in walls['static']]} s, {float(sweep.placed.sum()) / wall:.1f} "
          f"aggregate placements/s; launches {json.dumps(sweep_launches)}; profiled busy "
          f"{busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%})", flush=True)
    mark("P1 timed sweeps")
    rng = np.random.default_rng(SEED + 512)
    tb0 = eng._tables()
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, tb0.cluster, tb0.consts, S, rng,
                                                   dev, state=tb0.state, wrow=eng._wrow)
    held_k = hold_kernels(f"S={S} policy-row kernel checks (N={hs['nodes']})", ep, tb_t, tb_k,
                          pre, pre_nodes, 40, rng, dev)
    kernels, _ = time_kernels(ep, tb_t, held_k, dev)
    results["kernels_policy"] = kernels
    # K1 and K2 with and without the policy rows on the same tables, in
    # turns (device time per launch, µs): what reading the rows costs.
    b_static = K.Bound(tb_k._replace(wrow=None, consts=eng.spec.consts()))
    sl, ch = held_k["slots"].tolist(), held_k["ch_k"]
    ab = {"policy": {"K1": [], "K2": []}, "static": {"K1": [], "K2": []}}
    us = lambda d: None if d is None else 1e3 * d  # no profiler record: None
    for name, bb in (("policy", held_k["b"]), ("static", b_static), ("static", b_static),
                     ("policy", held_k["b"])):
        ab[name]["K1"].append(us(device_ms(lambda i: K.filter_score(bb, sl[i % len(sl)]), 200,
                                           "ksim_filter_score")))
        ab[name]["K2"].append(us(device_ms(
            lambda i: K.normalize_select(bb, sl[i % len(sl)], ch, 0), 200,
            "ksim_normalize_select")))
    results["policy_ab_us"] = ab
    print(f"K1, K2 with policy rows vs static on the same tables, in turns (us): "
          f"{json.dumps(ab)}", flush=True)
    del tuner, eng, static, res_p, tb0, tb_t, tb_k, held_k, b_static
    mark("P1 kernel hold, times")
    return kernels, launches, slot_launches


def check_policy_cut(results, dev):
    """P2: POLICY_ROWS x four scenarios over POLICY_CUT as one 16-row
    what-if on the card: each row's placed pods and assignments' sha256
    equal greedy_replay's pins (POLICY_PINS)."""
    pc = POLICY_CUT
    ec, ep = case(pc["nodes"], pc["pods"])
    scen, pol = policy_cut_batch(ec)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=pc["chunk_waves"],
                       policies=pol, collect_assignments=True, device=dev)
    if eng.chunk_waves != pc["chunk_waves"] or not eng.completions_on:
        raise AssertionError(f"policy cut: chunkWaves {eng.chunk_waves}, completions "
                             f"{eng.completions_on}")
    res = eng.run()
    n = pc["scenarios"]
    out = {}
    for r, name in enumerate(POLICY_ROWS):
        a = res.assignments[r * n : (r + 1) * n]
        got = dict(placed=[int(x) for x in res.placed[r * n : (r + 1) * n]],
                   sha256=assignments_sha256(a))
        if got != POLICY_PINS[name]:
            raise AssertionError(f"policy cut row {name}: {got} != POLICY_PINS {POLICY_PINS[name]}")
        out[name] = got
    if len({v["sha256"] for v in out.values()}) != len(out):
        raise AssertionError("policy cut: two rows placed alike")
    results["policy_cut"] = dict(**pc, rows=out, wall_s=res.wall_clock_s)
    print(f"P2 policy cut ({len(POLICY_ROWS)} rows x {n} scenarios over {pc['nodes']} x "
          f"{pc['pods']}, route {res.route}): every row == POLICY_PINS, wall "
          f"{res.wall_clock_s:.3f}s", flush=True)


def run_tune_cli(results, dev):
    """P3: ``python -m kubernetes_simulator_tpu_torch tune`` on CONFIG11 as
    shipped, on the card, through the CLI's entry point (in this process,
    so the launch counts show), writing its trajectory into a scratch
    directory: the file's sha256 against TUNE_PINS, the oracle's envelope
    <= 1e-6, one engine set-up; the walls of the search, the held-out sweep
    and the oracle."""
    from kubernetes_simulator_tpu_torch import cli

    outdir = os.path.join(ROOT, "chiprun_out", "tune_config11")
    os.makedirs(outdir, exist_ok=True)
    traj = os.path.join(outdir, "tune_trajectory.jsonl")
    if os.path.exists(traj):
        os.remove(traj)  # the writer appends
    cwd = os.getcwd()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    os.chdir(outdir)
    try:
        with LogLines() as lines:
            rc = cli.main(["tune", os.path.join(ROOT, CONFIG11), "--device", dev.type])
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    if rc != 0:
        raise AssertionError(f"config11 tune: the CLI returned {rc}")
    with open(traj, "rb") as f:
        data = f.read()
    rows = data.decode().splitlines()
    sha = hashlib.sha256(data).hexdigest()
    pin = TUNE_PINS["config11"]
    if sha != pin["sha256"] or len(rows) != pin["rows"]:
        raise AssertionError(f"config11 tune: trajectory {len(rows)} rows, sha256 {sha} != "
                             f"TUNE_PINS {pin}")
    final = json.loads(rows[-1])
    setups = [int(m.group(1)) for m in (re.search(r"evaluations, (\d+) set-up", x)
                                        for x in lines.lines) if m]
    phase = [m.groups() for m in (re.search(
        r"walls set-up ([\d.]+)s, search ([\d.]+)s, held-out ([\d.]+)s, oracle ([\d.]+)s", x)
        for x in lines.lines) if m]
    if final["cpu_envelope"] is None or final["cpu_envelope"] > 1e-6 or setups != [1]:
        raise AssertionError(f"config11 tune: envelope {final['cpu_envelope']}, set-ups {setups}")
    if (launches["chunk_replay"] <= 0 or launches["filter_score"]
            or launches["normalize_select"]):
        raise AssertionError(f"config11 tune's chunk-route launches: {launches}")
    setup_s, search_s, heldout_s, oracle_s = (float(x) for x in phase[0])
    results["tune_config11"] = dict(
        wall_s=wall, setup_s=setup_s, search_s=search_s, heldout_s=heldout_s, oracle_s=oracle_s,
        launches=launches, rows=len(rows), sha256=sha, best_policy=final["best_policy"],
        heldout_objective=final["heldout_objective"], cpu_objective=final["cpu_objective"],
        cpu_envelope=final["cpu_envelope"])
    print(f"P3 config11 tune through the CLI on the card (route chunk): trajectory == "
          f"TUNE_PINS ({len(rows)} "
          f"rows, sha256 {sha[:16]}), cpu_envelope {final['cpu_envelope']}, 1 set-up; walls "
          f"set-up {setup_s:.3f}s, search {search_s:.3f}s, held-out {heldout_s:.3f}s, oracle "
          f"{oracle_s:.3f}s (command "
          f"{wall:.1f}s); launches {json.dumps(launches)}", flush=True)


# ---------------------------------------------------------------------------
# Borg-shaped traces: config4 (10,000 nodes x 1,000,000 tasks) on K6
# ---------------------------------------------------------------------------


def run_config4(results, dev):
    """(c) config4 as shipped through the CLI ``run`` on the card (in this
    process, the engine the CLI builds kept for the holds), counters zeroed
    just before and read just after: one K6 a chunk, K3 at each release;
    placed, unschedulable, the set-up seconds by part, the replay wall and
    placements/s from the CLI's row and log; the result's planes finite,
    within the allocatable, gangs whole; B6's bound; then, from the initial
    state, K6 held against its twin over the first K6_TWIN_WAVES waves and
    the first CONFIG4_HOLD_CHUNKS chunks on K6 against the per-slot
    kernels, the choices and every plane equal after each."""
    import contextlib
    import io

    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.framework import registry

    factory = registry.get_strategy("torch")
    made = []
    registry._STRATEGIES["torch"] = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
    out = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with LogLines() as lines, contextlib.redirect_stdout(out):
            rc = cli.main(["run", os.path.join(ROOT, CONFIG4), "--device", dev.type])
    finally:
        registry._STRATEGIES["torch"] = factory
    command_s = time.perf_counter() - t0
    launches = K.launch_counts()
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"config4 run: the CLI returned {rc}")
    k6_plan = plan_of(K.chunk_replay)
    eng = made[0]
    row = json.loads([x for x in out.getvalue().splitlines() if x.startswith("{")][-1])
    ec, ep, plan = eng.ec, eng.pods, eng.plan
    if (ec.num_nodes, ep.num_pods) != (10_000, 1_000_000) or eng.last_route != "chunk":
        raise AssertionError(f"config4 run: {ec.num_nodes} nodes, {ep.num_pods} tasks, route "
                             f"{eng.last_route}")
    check_chunk_launches("config4 run", launches, plan)
    if row["placed"] + row["unschedulable"] != ep.num_pods or row["placed"] <= 0:
        raise AssertionError(f"config4 run: placed {row['placed']}, unschedulable "
                             f"{row['unschedulable']}")
    a, placed, _ = assignments_from_choices(plan, eng.last_choices, ep.bound_node)
    if int(placed[0]) != row["placed"]:
        raise AssertionError("config4 run: the row's placed != the choice buffer's")
    st = eng.last_tables.state
    used = st.used[0].cpu().numpy()
    if not all(torch.isfinite(x).all() for x in st) or (used > ec.allocatable + 1e-3).any():
        raise AssertionError("config4 run: non-finite planes or a node past its allocatable")
    if min(float(x.min()) for x in (st.match_count, st.anti_active)) < 0:
        raise AssertionError("config4 run: a count plane went negative")
    gid = ep.group_id
    g_placed = np.bincount(gid[gid >= 0], weights=(a[0][gid >= 0] >= 0).astype(float))
    g_size = np.bincount(gid[gid >= 0])
    if ((g_placed > 0) & (g_placed < g_size)).any():
        raise AssertionError("config4 run: a gang placed partially")
    setup = [m.groups() for m in (re.search(r"set-up: trace ([\d.]+)s, engine ([\d.]+)s", x)
                                  for x in lines.lines) if m]
    mark("c config4 CLI run")
    bound_ms = Work(ep, eng._tables()).chunk_loop_ms(plan, a, launches)
    mark("c config4 B6 bound")
    mk = lambda: (eng._tables(), new_choices(plan, 1, ep.bound_node, dev))
    _, _, twin_rec = hold_twin("config4", plan, mk, min(K6_TWIN_WAVES, plan.C))
    mark("c config4 twin hold")
    # The first chunks on K6 and on the per-slot kernels, from the initial state.
    (tb_k, ch_k), (tb_s, ch_s) = ((eng._tables(), new_choices(plan, 1, ep.bound_node, dev))
                                  for _ in range(2))
    walls = {"chunk": 0.0, "slot": 0.0}
    for c in range(min(CONFIG4_HOLD_CHUNKS, len(plan.buckets))):
        for route, tb, ch in (("chunk", tb_k, ch_k), ("slot", tb_s, ch_s)):
            t1 = time.perf_counter()
            run_waves(plan, tb, ch, c * plan.C, (c + 1) * plan.C, plain=False, route=route)
            torch.cuda.synchronize()
            walls[route] += time.perf_counter() - t1
        same_planes(f"config4 chunk {c}: K6 vs the per-slot kernels", tb_k, ch_k, tb_s, ch_s)
    hold_slots = int((plan.idx[: CONFIG4_HOLD_CHUNKS * plan.C] >= 0).sum())
    # K6 alone over the first chunk (no release before it), from the initial
    # state, timed by CUDA events around its one launch
    if plan.buckets[0] is not None:
        raise AssertionError("config4: a release before the first chunk")
    tb_e, ch_e = eng._tables(), new_choices(plan, 1, ep.bound_node, dev)
    desc = plan.device_desc(dev)
    b_e = K.Bound(tb_e)
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    K.chunk_replay(b_e, desc.idx, desc.gang, ch_e, 0, plan.C)
    ev[1].record()
    torch.cuda.synchronize()
    k6_us = ev[0].elapsed_time(ev[1]) * 1e3 / int((plan.idx[: plan.C] >= 0).sum())
    # K6's ranks here own more than 1,024 nodes (phase 1 tiles the block) and
    # the last one fewer than the rest (N is no multiple of span).
    if not (k6_plan["span"] > K.SELECT_THREADS and ec.num_nodes % k6_plan["span"]):
        raise AssertionError(f"config4: K6's plan {k6_plan} lost its long, uneven ranks")
    mark("c config4 K6 holds")
    # K3's release at config4's full size: its largest bucket, at random nodes.
    sizes = [0 if bk is None else len(bk[0]) for bk in plan.buckets]
    big = int(np.argmax(sizes))
    rel = hold_release(f"config4 release (bucket {big}, {sizes[big]} tasks)", ep,
                       release_case("borg", ec, ep, dev, S=1, pods=plan.buckets[big][0]))
    results["config4"] = dict(
        nodes=ec.num_nodes, tasks=ep.num_pods, chunk_waves=plan.C, chunks=len(plan.buckets),
        waves=int(plan.idx.shape[0]), gang_waves=int(plan.gang_wave.sum()),
        releases=sum(bk is not None for bk in plan.buckets), route=eng.last_route,
        placed=row["placed"], unschedulable=row["unschedulable"], wall_s=row["wall_clock_s"],
        placements_per_s=row["placements_per_sec"], command_s=command_s,
        setup_trace_s=float(setup[0][0]), setup_engine_s=float(setup[0][1]),
        setup_s=eng.setup_s, launches=launches, chunk_loop_bound_ms=bound_ms,
        k6_twin=twin_rec, held_chunks=CONFIG4_HOLD_CHUNKS,
        held_slots=hold_slots, held_walls_s=walls, utilization=row["utilization"],
        k6_us_per_slot=k6_us, k6_cluster=k6_plan, release=rel)
    print(f"config4 through the CLI run on the card ({ec.num_nodes} nodes x {ep.num_pods} tasks, "
          f"chunkWaves {plan.C}, {len(plan.buckets)} chunks, route {eng.last_route}): placed "
          f"{row['placed']}, unschedulable {row['unschedulable']}; set-up trace "
          f"{float(setup[0][0]):.2f}s, engine {float(setup[0][1]):.2f}s "
          f"({json.dumps({k: round(v, 3) for k, v in eng.setup_s.items()})}); replay wall "
          f"{row['wall_clock_s']:.3f}s, {row['placements_per_sec']:.1f} placements/s; command "
          f"{command_s:.1f}s; launches {json.dumps(launches)}; B6 bound "
          f"{bound_ms['total']:.3f} ms; the first {CONFIG4_HOLD_CHUNKS} chunks ({hold_slots} "
          f"slots) on K6 == the per-slot kernels, choices and every plane ({walls['chunk']:.2f}s "
          f"vs {walls['slot']:.2f}s); K6 over the first chunk {k6_us:.2f} us a slot (CUDA "
          f"events; cluster "
          f"{json.dumps(k6_plan)})", flush=True)
    del eng, made, tb_k, tb_s, tb_e


def check_borg_pins(results, dev):
    """(d) config4's generator on BORG_CUT on the card, on both routes:
    placed, unschedulable and the assignments' sha256 equal BORG_PINS
    (greedy_replay's, recomputed by tests/test_torch_borg_pins.py)."""
    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    bc = BORG_CUT
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=bc["nodes"], tasks=bc["tasks"], seed=SEED))
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=bc["chunk_waves"])
    res = eng.replay()
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=assignments_sha256(res.assignments))
    if got != BORG_PINS or res.route != "chunk" or eng.plan.C != bc["chunk_waves"]:
        raise AssertionError(f"Borg cut: {got} (route {res.route}) != BORG_PINS {BORG_PINS}")
    slot_route("Borg cut", eng, res.assignments[None])
    results["borg_cut"] = dict(**bc, **got, wall_s=res.wall_clock_s)
    print(f"Borg cut ({bc['nodes']} nodes x {bc['tasks']} tasks, chunkWaves "
          f"{bc['chunk_waves']}): placed {res.placed}, unschedulable {res.unschedulable}, "
          f"sha256 {got['sha256'][:16]} == BORG_PINS on the chunk route and the per-slot route",
          flush=True)


def _clone_shard_tables(tb):
    """A deep copy of a sharded Tables' state, scratch and shard buffers."""
    c = lambda nt: type(nt)(*(x.clone() if torch.is_tensor(x) else x for x in nt))
    return tb._replace(state=c(tb.state), scratch=c(tb.scratch), shards=c(tb.shards))


def shard_window(eng, dev, seed):
    """The start of a mid-replay window of ``eng`` (node-sharded): K9 replays
    up to the first boundary past chunk 1 that releases pods, then every node
    is filled to its allocatable but one in a hundred (at least 16), left 0-3
    mean requests of room (so gangs fail and roll back). Returns (the
    boundary, the tables, the choices), the boundary's release still to do."""
    plan = eng.plan
    b = next(i for i in range(2, len(plan.buckets)) if plan.buckets[i] is not None)
    tb_k = eng._tables()
    ch_k = new_choices(plan, 1, eng.pods.bound_node, dev)
    run_waves(plan, tb_k, ch_k, 0, b * plan.C, plain=False, route="shard")
    rng = np.random.default_rng(seed)
    lay = eng.layout
    alloc = tb_k.cluster.allocatable
    room = np.zeros((lay.n_pad, 1))
    open_nodes = rng.choice(lay.n_real, size=max(16, lay.n_real // 100), replace=False)
    room[open_nodes] = rng.uniform(0.0, 3.0, size=(open_nodes.size, 1))
    room = room * eng.pods.requests.mean(axis=0)
    tb_k.state.used.copy_(torch.maximum(
        tb_k.state.used, alloc[None] - torch.as_tensor(room.astype(np.float32), device=dev)))
    return b, tb_k, ch_k


def hold_shards(where, eng, dev, seed):
    """K1 on the sharded tables, K7 and K8 against their twins, launch by launch,
    in a mid-replay window of ``eng`` (:func:`shard_window`): from the
    window's boundary's K8 release, every slot's K1 (scratch rows), K7 (each
    shard's packed extrema, the choice and the column's domain ids) and K8
    bind (every plane), and each gang wave's K8 rollback, over
    SHARD_HOLD_WAVES waves (more until a rollback undid a pair), must equal
    the twins' bit for bit. Returns the record, the kernel tables and choices
    at the window's end, a live slot (for timing) and the window's release
    pairs."""
    plan = eng.plan
    C, W = plan.C, plan.idx.shape[1]
    lay = eng.layout
    b, tb_k, ch_k = shard_window(eng, dev, seed)
    tb_t = _clone_shard_tables(tb_k)
    ch_t = ch_k.clone()
    bk = K.Bound(tb_k)
    idx = torch.as_tensor(plan.idx.reshape(-1), device=dev)
    pos = torch.arange(plan.L, dtype=torch.int32, device=dev)
    n = dict(releases=0, binds=0, rollbacks=0, undone=0, unplaced=0)
    rolled = None

    def same(at, scratch=False):
        torch.cuda.synchronize()
        parts = [(tb_k.state, tb_t.state)] + ([(tb_k.scratch, tb_t.scratch)] if scratch else [])
        for x, y in parts:
            for f, a in zip(x._fields, x):
                if not torch.equal(a, getattr(y, f)):
                    raise AssertionError(f"{where}, {at}: {f} differs")
        for f in ("ext", "cdom"):
            if not torch.equal(getattr(tb_k.shards, f), getattr(tb_t.shards, f)):
                raise AssertionError(f"{where}, {at}: shards.{f} differs")
        if not torch.equal(ch_k, ch_t):
            raise AssertionError(f"{where}, {at}: choices differ")

    rel_ids, rel_pos = (torch.as_tensor(a, device=dev) for a in plan.buckets[b])
    K.shard_apply(bk, rel_ids, rel_pos, ch_k, -1.0)
    ref.shard_apply(tb_t, rel_ids, rel_pos, ch_t, -1.0)
    same(f"K8 release of boundary {b} ({rel_ids.numel()} pods)")
    n["releases"] += 1
    live = None
    w = b * C
    while w < b * C + SHARD_HOLD_WAVES or (n["undone"] == 0 and w < (b + 1) * C):
        for k, p in enumerate(plan.idx[w].tolist()):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(bk, p)
            ref.filter_score(tb_t, p)
            same(f"K1 of pod {p}", scratch=True)
            K.shard_select(bk, p, ch_k, s)
            ref.shard_select(tb_t, p, ch_t, s)
            same(f"K7 of pod {p}")
            live = live or (p, s)
            n["unplaced"] += int(ch_k[0, s]) < 0
            K.shard_apply(bk, idx[s : s + 1], pos[s : s + 1], ch_k, 1.0)
            ref.shard_apply(tb_t, idx[s : s + 1], pos[s : s + 1], ch_t, 1.0)
            same(f"K8 bind of pod {p}")
            n["binds"] += 1
        if plan.gang_wave[w]:
            sl = slice(w * W, (w + 1) * W)
            before = ch_k[:, sl].clone()
            K.shard_apply(bk, idx[sl], pos[sl], ch_k, -1.0, rollback=True)
            ref.shard_apply(tb_t, idx[sl], pos[sl], ch_t, -1.0, rollback=True)
            same(f"K8 rollback of wave {w}")
            n["rollbacks"] += 1
            undone = int((before >= 0).sum()) - int((ch_k[:, sl] >= 0).sum())
            if undone:
                n["undone"] += undone
                rolled = (sl, before, idx[sl].clone())
        w += 1
    if not (n["binds"] and n["rollbacks"] and n["undone"] and n["releases"]):
        raise AssertionError(f"{where}: the window lacked a bind, an undone rollback or a "
                             f"release: {n}")
    rec = dict(P=lay.P, n_local=lay.n_local, n_pad=lay.n_pad, n_real=lay.n_real,
               boundary=b, waves=w - b * C, max_abs_err=0.0, **n)
    print(f"{where}: K1, K7 and K8 == their twins launch by launch at P={lay.P} "
          f"(n_local {lay.n_local}, {lay.n_pad - lay.n_real} pad rows) over waves "
          f"[{b * C}, {w}) from boundary {b}'s release: {json.dumps(n)}", flush=True)
    return rec, tb_k, ch_k, tb_t, ch_t, live, (rel_ids, rel_pos), rolled


def time_shards(work, tb_k, ch_k, tb_t, ch_t, live, rel, rolled, dev, iters=200,
                plain_iters=10):
    """Each shard kernel's device time per launch (torch.profiler) at the
    window's end state, beside its twin's wall per call (CUDA events), its
    least time from ``work`` and, for K7's choice, ``torch.argmax`` over the
    masked total row (the library call for the select part)."""
    bk = K.Bound(tb_k)
    p, s = live
    sh = tb_k.shards
    sgn = lambda i: 1.0 if i % 2 == 0 else -1.0
    idx1 = torch.tensor([p], dtype=torch.int32, device=dev)
    pos1 = torch.tensor([s], dtype=torch.int32, device=dev)
    ids, cols = rel
    out = {}
    K.filter_score(bk, p)
    ref.filter_score(tb_t, p)
    nb, no = work.k1(p)
    d1 = device_ms(lambda i: K.filter_score(bk, p), iters, "ksim_filter_score_kernel")
    t1 = time_cuda(lambda i: ref.filter_score(tb_t, p), plain_iters)
    out["filter_score_shards"] = dict(ms=d1, plain_ms=t1, library_ms=None,
                                      **dict(zip(("bound_ms", "bound_by"), bound(nb, no))))
    # K7: the shards' extrema and the two-stage choice (choices[s] rewritten
    # alike each call); the exchange buffers written and read once
    nb, no = work.k2_scen(work.S)
    nb += (2 * sh.ext.numel() + 2 * sh.best_v.numel() + 2 * sh.best_i.numel() + 2 * work.G) * 4
    K.shard_select(bk, p, ch_k, s)
    ref.shard_select(tb_t, p, ch_t, s)
    ext = ref.exchange_pmax(tb_t.shards.ext[:, i] for i in range(sh.P))
    total = ref.weighted_total(tb_t, p, ext)
    masked = torch.where(tb_t.scratch.feasible, total, torch.full_like(total, float("-inf")))
    d7, lib, k7_turns = in_turns(lambda i: K.shard_select(bk, p, ch_k, s),
                                 lambda i: torch.argmax(masked, dim=-1), iters, "shard_select")
    k7_plan = plan_of(K.shard_select)
    t7 = time_cuda(lambda i: ref.shard_select(tb_t, p, ch_t, s), plain_iters)
    out["shard_select"] = dict(ms=d7, plain_ms=t7, library_ms=lib, turns_ms=k7_turns,
                               cluster=k7_plan,
                               **dict(zip(("bound_ms", "bound_by"), bound(nb, no))))
    print(f"K7 at P={sh.P} (cluster {json.dumps(k7_plan)}): {d7 * 1e3:.2f} us vs torch.argmax "
          f"{lib * 1e3:.2f} us in turns {[round(t * 1e3, 2) for t in k7_turns]} (bound "
          f"{out['shard_select']['bound_ms'] * 1e3:.3f} us)", flush=True)
    # K8: a bind and its undo in turns (the slot's node), a release and its
    # re-add in turns (the window's boundary bucket)
    node = ch_k[:, s].cpu().numpy()
    nb, no = work.k3(np.array([p]), node[:, None])
    d8 = device_ms(lambda i: K.shard_apply(bk, idx1, pos1, ch_k, sgn(i)), iters, "shard_apply")
    t8 = time_cuda(lambda i: ref.shard_apply(tb_t, idx1, pos1, ch_t, sgn(i)), plain_iters)
    out["shard_apply"] = dict(ms=d8, plain_ms=t8, library_ms=None,
                              **dict(zip(("bound_ms", "bound_by"), bound(nb, no))))
    rel_nodes = ch_k[:, cols.long()].cpu().numpy()
    nb, no = work.k3(ids.cpu().numpy(), rel_nodes)
    dr = device_ms(lambda i: K.shard_apply(bk, ids, cols, ch_k, -sgn(i)), 20, "shard_apply")
    tr = time_cuda(lambda i: ref.shard_apply(tb_t, ids, cols, ch_t, -sgn(i)), 4)
    out["shard_apply_release"] = dict(ms=dr, plain_ms=tr, library_ms=None, pairs=int(ids.numel()),
                                      **dict(zip(("bound_ms", "bound_by"), bound(nb, no))))
    # K8's rollback of the window's last wave that undid pairs, its choices
    # restored before each call (a copy the profiler's match leaves out)
    sl, before, ids_w = rolled
    pos_w = torch.arange(sl.start, sl.stop, dtype=torch.int32, device=dev)
    after = ch_k[:, sl].cpu().numpy()
    undo = np.where(after < 0, before.cpu().numpy(), PAD)  # the pairs the rollback undid
    nb, no = work.k3(ids_w.cpu().numpy(), undo, rollback=True)

    def rb_k(i):
        ch_k[:, sl].copy_(before)
        K.shard_apply(bk, ids_w, pos_w, ch_k, -1.0, rollback=True)

    def rb_t(i):
        ch_t[:, sl].copy_(before)
        ref.shard_apply(tb_t, ids_w, pos_w, ch_t, -1.0, rollback=True)

    out["shard_apply_rollback"] = dict(
        ms=device_ms(rb_k, 50, "shard_apply"), plain_ms=time_cuda(rb_t, 4), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), bound(nb, no))))
    torch.cuda.synchronize()
    return out


def k9_exchange_bytes(sh, G):
    """Bytes K9 writes a slot beside the state: each shard's packed extrema
    and (total, id) pair, and the column's domain row."""
    return sh.P * (ref.NUM_EXT * 4 + 8) + G * 4


def hold_k9(where, eng, dev, seed, waves):
    """K9 against its twin and against the per-slot kernels (K1 -> K7 -> K8)
    in the mid-replay window of :func:`shard_window` (:func:`hold_shards`'s
    seed, so its state): from the boundary's K8 release, one K9 launch over
    ``waves`` waves, the twin (``ref.shard_chunk_replay``) and the per-slot
    kernels over the same waves — every state plane, the scratch rows, the
    shard buffers and the choice buffer bit for bit. Then K9's launch over
    the window timed from the state after the release (device time by
    torch.profiler) beside its twin's wall and the window's least time
    (:meth:`Work.k6`, the window as one function with the binds it made,
    plus :func:`k9_exchange_bytes` a slot). Returns the record."""
    plan = eng.plan
    C, W = plan.C, plan.idx.shape[1]
    b, tb_9, ch_9 = shard_window(eng, dev, seed)
    w0, w1 = b * C, min(b * C + waves, (b + 1) * C)
    snap0, ch0 = {k: x.clone() for k, x in _planes(tb_9).items()}, ch_9.clone()
    (tb_t, ch_t), (tb_s, ch_s) = ((_clone_shard_tables(tb_9), ch_9.clone()) for _ in range(2))
    n9 = K.shard_chunk_replay.launches
    run_waves(plan, tb_9, ch_9, w0, w1, plain=False, route="shard")
    if K.shard_chunk_replay.launches != n9 + 1:
        raise AssertionError(f"{where}: the window took {K.shard_chunk_replay.launches - n9} "
                             "K9 launches")
    run_waves(plan, tb_t, ch_t, w0, w1, plain=True, route="shard")
    run_waves(plan, tb_s, ch_s, w0, w1, plain=False, route="shard_slot")

    def same(name, tb, ch):
        same_planes(f"{where}: K9 vs {name} over waves [{w0}, {w1})", tb_9, ch_9, tb, ch)
        for f in ("ext", "best_v", "best_i", "cdom"):
            if not torch.equal(getattr(tb_9.shards, f), getattr(tb.shards, f)):
                raise AssertionError(f"{where}: K9 vs {name}: shards.{f} differs")

    same("its twin", tb_t, ch_t)
    same("the per-slot kernels", tb_s, ch_s)
    k9_plan = plan_of(K.shard_chunk_replay)
    window = plan.idx[w0:w1]
    cols = np.arange(w0 * W, w1 * W).reshape(window.shape)
    live = window >= 0
    after = ch_9[0].cpu().numpy()
    a = np.full((1, eng.pods.num_pods), PAD, np.int64)
    a[0, window[live]] = after[cols[live]]
    rec = dict(P=eng.layout.P, boundary=b, waves=w1 - w0, slots=int(live.sum()),
               placed=int((a >= 0).sum()), max_abs_err=0.0, cluster=k9_plan)
    # K9's launch over the window from the state after the release.
    for name, x in _planes(tb_9).items():
        x.copy_(snap0[name])
    ch_9.copy_(ch0)
    rel_ids, rel_pos = (torch.as_tensor(x, device=dev) for x in plan.buckets[b])
    K.shard_apply(K.Bound(tb_9), rel_ids, rel_pos, ch_9, -1.0)
    snap, ch_snap = {k: x.clone() for k, x in _planes(tb_9).items()}, ch_9.clone()
    desc = plan.device_desc(dev)
    b9 = K.Bound(tb_9)

    def restore(tb, ch):
        for name, x in _planes(tb).items():
            x.copy_(snap[name])
        ch.copy_(ch_snap)

    def k9(_):
        restore(tb_9, ch_9)
        K.shard_chunk_replay(b9, desc.idx, desc.gang, ch_9, w0, w1)

    def twin(_):
        restore(tb_t, ch_t)
        ref.shard_chunk_replay(tb_t, desc.idx, desc.gang, ch_t, w0, w1)

    ms = device_ms(k9, 10, match="shard_chunk_replay") or time_cuda(k9, 10)
    plain_ms = time_cuda(twin, 1, warm=0)
    same("its twin, timed", tb_t, ch_t)
    nb, no = Work(eng.pods, tb_9).k6(window, plan.gang_wave[w0:w1], a, w0)
    nb += rec["slots"] * k9_exchange_bytes(tb_9.shards, tb_9.state.match_count.shape[1])
    bound_ms, bound_by = bound(nb, no)
    rec.update(ms=ms, us_per_slot=ms * 1e3 / max(rec["slots"], 1), plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    print(f"{where}: K9 == its twin == the per-slot kernels (K1 -> K7 -> K8) over waves "
          f"[{w0}, {w1}) from boundary {b}'s release ({rec['slots']} slots, {rec['placed']} "
          f"placed; every plane, the shard buffers, the choices); K9 (cluster "
          f"{json.dumps(k9_plan)}) {ms * 1e3:.1f} us a launch, {rec['us_per_slot']:.2f} us a "
          f"slot (bound {bound_ms * 1e3:.3f} us by {bound_by}; twin {plain_ms:.1f} ms)",
          flush=True)
    return rec


def shard_route_launches(where, launches, plan):
    """The shard route's launches in a run (counters zeroed just before it):
    one K9 a chunk, K8 at each release and nowhere else, none of K1-K7."""
    releases = sum(bk is not None for bk in plan.buckets)
    want = dict(shard_chunk_replay=len(plan.buckets), shard_apply=releases,
                shard_apply_release=releases, shard_apply_bind=0, shard_apply_rollback=0,
                filter_score=0, normalize_select=0, apply_placements=0, chunk_replay=0,
                shard_select=0)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{where}: launches {launches}, expected {want}")


def shard_slot_launches(where, launches, plan):
    """The per-slot shard route's launches: K1 and K7 a slot, K8 a slot plus
    each gang wave and release, none of K2, K3, K6 or K9."""
    slots = int((plan.idx >= 0).sum())
    gang_waves = int(plan.gang_wave.sum())
    releases = sum(bk is not None for bk in plan.buckets)
    want = dict(filter_score=slots, shard_select=slots,
                shard_apply=slots + gang_waves + releases, shard_apply_bind=slots,
                shard_apply_rollback=gang_waves, shard_apply_release=releases,
                normalize_select=0, apply_placements=0, chunk_replay=0, shard_chunk_replay=0)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{where}: launches {launches}, expected {want}")


def check_reduced_shards(results, dev):
    """The reduced sharded replay (SHARD_REDUCED: 100 nodes over 3 shards, two
    pad rows; 600 pods, durationMean 50, gangs 0.1 x 4) on every route — the
    shard route on K9 (one launch a chunk), the per-slot shard route on the
    kernels (K1 -> K7 -> K8 a slot), K9's twin and the per-slot twins on the
    card and on the CPU, and the replicated K6 route — then all of it again
    paged: assignments, placed and ``used`` identical; each kernel run
    launches what its route launches and nothing else."""
    sr = SHARD_REDUCED
    ec, ep = case(sr["nodes"], sr["pods"], gang_fraction=0.1)
    out = {}
    for paged in (False, True):
        mk = lambda d, P, **kw: TorchReplayEngine(ec, ep, FrameworkConfig(),
                                                  chunk_waves=sr["chunk_waves"], device=d,
                                                  node_shards=P, paged=paged, **kw)
        where = f"reduced shards (paged={paged})"
        K.reset_launch_counts()
        eng = mk(dev, sr["node_shards"])
        res = eng.replay()
        launches = K.launch_counts()
        if res.route != "shard":
            raise AssertionError(f"{where}: route {res.route}")
        shard_route_launches(where, launches, eng.plan)
        K.reset_launch_counts()
        _, slot_wall, slot_a, _, _ = eng._run(route="shard_slot")
        slot_launches = K.launch_counts()
        shard_slot_launches(f"{where}, per-slot route", slot_launches, eng.plan)
        slot_used = eng.last_tables.state.used[0, : ec.num_nodes].cpu().numpy()
        routes = {"K9's twin on the CPU": mk("cpu", sr["node_shards"]).replay(),
                  "replicated K6": mk(dev, 1).replay()}
        plain_card = mk(dev, sr["node_shards"], plain=True)
        routes.update({
            "K9's twin on the card": plain_card._run(route="shard")[2][0],
            "the per-slot twins on the card": plain_card.replay(),
            "the per-slot twins on the CPU": mk("cpu", sr["node_shards"])._run(
                route="shard_slot")[2][0]})
        for name, r in routes.items():
            a = r if isinstance(r, np.ndarray) else r.assignments
            if not np.array_equal(a, res.assignments) or (
                    not isinstance(r, np.ndarray) and (
                        r.placed != res.placed or not np.array_equal(r.state.used,
                                                                      res.state.used))):
                raise AssertionError(f"{where}: {name} differs")
        if not np.array_equal(slot_a[0], res.assignments) or not np.array_equal(
                slot_used, res.state.used):
            raise AssertionError(f"{where}: the per-slot kernels differ from K9")
        out["paged" if paged else "resident"] = dict(
            placed=res.placed, unschedulable=res.unschedulable, launches=launches,
            slot_route_launches=slot_launches, slot_route_wall_s=slot_wall,
            walls_s={k: r.wall_clock_s for k, r in routes.items()
                     if not isinstance(r, np.ndarray)},
            pager_stalls=eng.last_pager.stalls if paged else None)
        print(f"{where} ({sr['nodes']} nodes over {sr['node_shards']} shards, {sr['pods']} "
              f"pods): placed {res.placed} on K9 == the per-slot kernels == "
              f"{' == '.join(routes)} (assignments, used); launches {json.dumps(launches)}; "
              f"per-slot route {json.dumps(slot_launches)}", flush=True)
    results["reduced_shards"] = out


def check_shard_pins(results, dev):
    """SHARD_CUT on the card (node_shards=4, paged): placed, unschedulable and
    the assignments' sha256 equal SHARD_PINS."""
    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    sc = SHARD_CUT
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=sc["nodes"], tasks=sc["tasks"], seed=SEED))
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=sc["chunk_waves"],
                            node_shards=sc["node_shards"], paged=True, device=dev)
    K.reset_launch_counts()
    res = eng.replay()
    shard_route_launches("shard cut", K.launch_counts(), eng.plan)
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=assignments_sha256(res.assignments))
    if got != SHARD_PINS or res.route != "shard":
        raise AssertionError(f"shard cut: {got} (route {res.route}) != SHARD_PINS {SHARD_PINS}")
    results["shard_cut"] = dict(**sc, **got, wall_s=res.wall_clock_s,
                                pager_stalls=eng.last_pager.stalls)
    print(f"shard cut ({sc['nodes']} nodes over {sc['node_shards']} shards x {sc['tasks']} "
          f"tasks, paged, route {res.route}: one K9 a chunk): placed {res.placed}, sha256 "
          f"{got['sha256'][:16]} == SHARD_PINS", flush=True)


def run_config13(results, dev):
    """config13 as shipped through the CLI ``run`` on the card (nodeShards 8,
    pagedWaves, chunkWaves 512), counters zeroed just before and read just
    after: the shard route, one K9 a chunk and K8 at each release, nothing
    else; the assignments equal the same trace replicated on K6
    (node_shards=1) and on the per-slot shard route (K1 and K7 once a slot, K8
    a slot plus each gang wave and release) in the same call, whose wall is
    taken between two more K9 runs; the walls, placements/s, set-up split, the
    pager's stalls on both routes; K9's time a slot over the first chunk
    (CUDA events) beside the per-slot route's bounds summed over the chunk;
    then K1 on the sharded tables, K7 and K8 held against their twins launch
    by launch at P = 8 and at P = 3 (two pad rows) in mid-replay windows,
    their device times per launch in a profiled chunk of the per-slot route
    and at the window's state, with their bounds, twins and torch.argmax; and
    K9 held against its twin and the per-slot kernels in the same windows,
    and timed there beside its twin and its bound. Returns the kernel rows'
    numbers, the run's launches, the per-slot route's, the holds and K9's
    window records."""
    import contextlib
    import io

    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.framework import registry

    factory = registry.get_strategy("torch")
    made = []
    registry._STRATEGIES["torch"] = lambda *a, **kw: made.append(factory(*a, **kw)) or made[-1]
    out = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with LogLines() as lines, contextlib.redirect_stdout(out):
            rc = cli.main(["run", os.path.join(ROOT, CONFIG13), "--device", dev.type])
    finally:
        registry._STRATEGIES["torch"] = factory
    command_s = time.perf_counter() - t0
    launches = K.launch_counts()
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"config13 run: the CLI returned {rc}")
    eng = made[0]
    row = json.loads([x for x in out.getvalue().splitlines() if x.startswith("{")][-1])
    ec, ep, plan = eng.ec, eng.pods, eng.plan
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    cfg = SimConfig.load(os.path.join(ROOT, CONFIG13))
    if ((ec.num_nodes, ep.num_pods) != (cfg.borg.nodes, cfg.borg.tasks)
            or eng.last_route != "shard" or eng.layout.P != cfg.node_shards or not eng.paged):
        raise AssertionError(f"config13 run: {ec.num_nodes} nodes, {ep.num_pods} tasks, route "
                             f"{eng.last_route}, {eng.layout}, paged {eng.paged}")
    slots = int((plan.idx >= 0).sum())
    gang_waves = int(plan.gang_wave.sum())
    releases = sum(bk is not None for bk in plan.buckets)
    shard_route_launches("config13 run", launches, plan)
    a_sh, placed, _ = assignments_from_choices(plan, eng.last_choices, ep.bound_node)
    if int(placed[0]) != row["placed"] or row["placed"] + row["unschedulable"] != ep.num_pods:
        raise AssertionError(f"config13 run: placed {row['placed']} / {int(placed[0])}")
    pager = eng.last_pager

    def pager_rec(pg):
        return dict(stalls=pg.stalls, stall_s=pg.stall_s, waits=pg.waits,
                    prefetches=pg.prefetches, prefetch_wall_s=pg.prefetch_wall_s,
                    page_rows=pg.rows)

    # The per-slot shard route of the same engine, between two more K9 runs.
    walls = {}
    K.reset_launch_counts()
    _, walls["shard_slot"], a_slot, _, _ = eng._run(route="shard_slot")
    slot_launches = K.launch_counts()
    slot_pager = pager_rec(eng.last_pager)
    shard_slot_launches("config13, per-slot route", slot_launches, plan)
    _, walls["shard_again"], a_again, _, _ = eng._run(route="shard")
    k9_pager = pager_rec(eng.last_pager)
    # One more K9 run under torch.profiler: the card's busy share on the route
    # and K9's device time a slot over the whole run.
    by_k9 = {}
    (_, walls["shard_profiled"], a_prof, _, _), busy9 = profiled_busy_s(
        lambda: eng._run(route="shard"), by_k9)
    k9_run = dict(wall_s=walls["shard_profiled"], device_busy_s=busy9,
                  device_busy_share=busy9 / walls["shard_profiled"],
                  k9_device_s=sum(t for k, t in by_k9.items() if "shard_chunk_replay" in k),
                  pager=pager_rec(eng.last_pager))
    k9_run["k9_us_per_slot"] = k9_run["k9_device_s"] * 1e6 / slots
    for name, a in (("the per-slot shard route", a_slot), ("a second K9 run", a_again),
                    ("the profiled K9 run", a_prof)):
        if not np.array_equal(a[0], a_sh[0]):
            bad = np.nonzero(a[0] != a_sh[0])[0]
            raise AssertionError(f"config13: the K9 run != {name} at pods {bad[:5].tolist()}")
    print(f"config13 routes in one call: K9 (CLI) {row['wall_clock_s']:.3f}s, per-slot "
          f"K1 -> K7 -> K8 {walls['shard_slot']:.3f}s, K9 again {walls['shard_again']:.3f}s "
          f"(beside {EARLIER['config13_wall_s']}s on the per-slot route before K9); assignments "
          f"equal; pager K9 {json.dumps(pager_rec(pager))}, per-slot {json.dumps(slot_pager)}, "
          f"K9 again {json.dumps(k9_pager)}; profiled K9 run: wall "
          f"{walls['shard_profiled']:.3f}s, device busy {busy9:.3f}s "
          f"({k9_run['device_busy_share']:.1%}), K9 {k9_run['k9_us_per_slot']:.2f} us a slot",
          flush=True)
    setup = [m.groups() for m in (re.search(r"set-up: trace ([\d.]+)s, engine ([\d.]+)s", x)
                                  for x in lines.lines) if m]
    cfg_c = cfg.chunk_waves
    rep = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=plan.idx.shape[1],
                            chunk_waves=cfg_c, device=dev)
    K.reset_launch_counts()
    res_rep = rep.replay()
    if res_rep.route != "chunk" or not np.array_equal(res_rep.assignments, a_sh[0]):
        bad = np.nonzero(res_rep.assignments != a_sh[0])[0]
        raise AssertionError(f"config13: the sharded run != the replicated K6 run at pods "
                             f"{bad[:5].tolist()} (route {res_rep.route})")
    mark("e config13 CLI run, per-slot and K6 runs")
    # K9 alone over the first chunk (no release before it), from the initial
    # state, timed by CUDA events around its one launch.
    if plan.buckets[0] is not None:
        raise AssertionError("config13: a release before the first chunk")
    tb_e, ch_e = eng._tables(), new_choices(plan, 1, ep.bound_node, dev)
    desc = plan.device_desc(dev)
    b_e = K.Bound(tb_e)
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    K.shard_chunk_replay(b_e, desc.idx, desc.gang, ch_e, 0, plan.C)
    ev[1].record()
    torch.cuda.synchronize()
    first_slots = int((plan.idx[: plan.C] >= 0).sum())
    k9_us = ev[0].elapsed_time(ev[1]) * 1e3 / first_slots
    k9_plan = plan_of(K.shard_chunk_replay)
    del tb_e, ch_e, b_e
    # The per-slot route over its first chunk, profiled: device time a launch.
    by_kernel = {}
    tb_p = eng._tables()
    ch_p = new_choices(plan, 1, ep.bound_node, dev)
    K.reset_launch_counts()
    t_chunk = time.perf_counter()
    _, busy_s = profiled_busy_s(lambda: (run_waves(plan, tb_p, ch_p, 0, plan.C, plain=False,
                                                   route="shard_slot"),
                                         torch.cuda.synchronize()), by_kernel)
    chunk_wall = time.perf_counter() - t_chunk
    chunk_launches = K.launch_counts()
    per_launch = {}
    for name, key in (("filter_score_shards", "ksim_filter_score_kernel"),
                      ("shard_select", "shard_select"), ("shard_apply", "shard_apply")):
        dev_s = sum(t for k, t in by_kernel.items() if key in k)
        n_l = chunk_launches["filter_score" if name == "filter_score_shards" else name]
        per_launch[name] = dev_s * 1e3 / n_l if n_l and dev_s else None
    work = Work(ep, eng._tables())
    # The bounds of the run's launches, summed over the first chunk's slots.
    b1 = b7 = 0.0
    for p in plan.idx[: plan.C].reshape(-1).tolist():
        if p >= 0:
            nb, no = work.k1(p)
            b1 += bound(nb, no)[0]
            nb, no = work.k2_scen(1)
            b7 += bound(nb + (2 * 8 * 7 + 32 + 2 * work.G) * 4, no)[0]
    bound_chunk = dict(filter_score_shards_ms=b1, shard_select_ms=b7)
    print(f"config13 first chunk ({first_slots} slots): K9 {k9_us:.2f} us a slot (CUDA events, "
          f"cluster {json.dumps(k9_plan)}); the per-slot route's K1 + K7 bounds summed "
          f"{(b1 + b7) * 1e3 / first_slots:.4f} us a slot", flush=True)
    mark("e config13 profiled chunk")
    holds, times, times_p3, k9_holds = {}, {}, {}, {}
    for P in (8, 3):
        he = eng if P == 8 else TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=cfg_c,
                                                  node_shards=P, device=dev)
        rec, tb_k, ch_k, tb_t, ch_t, live, rel, rolled = hold_shards(f"config13 P={P}", he,
                                                                      dev, SEED + P)
        holds[P] = rec
        t_p = time_shards(Work(ep, tb_k), tb_k, ch_k, tb_t, ch_t, live, rel, rolled, dev)
        if P == 8:
            times = t_p
        else:
            times_p3 = t_p
        del tb_k, tb_t
        k9_holds[P] = hold_k9(f"config13 P={P}", he, dev, SEED + P, rec["waves"])
    mark("e config13 holds, times")
    results["config13"] = dict(
        assignments_sha256=assignments_sha256(a_sh[0]),
        nodes=ec.num_nodes, tasks=ep.num_pods, node_shards=eng.layout.P,
        n_local=eng.layout.n_local, chunk_waves=plan.C, chunks=len(plan.buckets),
        slots=slots, gang_waves=gang_waves, releases=releases, route=eng.last_route,
        placed=row["placed"], unschedulable=row["unschedulable"], wall_s=row["wall_clock_s"],
        placements_per_s=row["placements_per_sec"], command_s=command_s,
        setup_trace_s=float(setup[0][0]), setup_engine_s=float(setup[0][1]),
        setup_s=eng.setup_s, launches=launches,
        pager=pager_rec(pager),
        replicated_k6=dict(wall_s=res_rep.wall_clock_s, route=res_rep.route,
                           placed=res_rep.placed),
        shard_slot=dict(wall_s=walls["shard_slot"], launches=slot_launches, pager=slot_pager),
        shard_again=dict(wall_s=walls["shard_again"], pager=k9_pager), shard_profiled=k9_run,
        k9_first_chunk=dict(us_per_slot=k9_us, slots=first_slots, cluster=k9_plan,
                            bound_ms_per_slot_route=b1 + b7),
        k9_holds=k9_holds,
        first_chunk=dict(launches=chunk_launches, device_ms_per_launch=per_launch,
                         device_busy_s=busy_s, profiled_wall_s=chunk_wall,
                         bounds_ms=bound_chunk),
        holds=holds, kernel_times=times, kernel_times_p3=times_p3,
        utilization=row["utilization"])
    print(f"config13 through the CLI run on the card ({ec.num_nodes} nodes over "
          f"{eng.layout.P} shards of {eng.layout.n_local}, {ep.num_pods} tasks, chunkWaves "
          f"{plan.C}, paged, route {eng.last_route}): placed {row['placed']}, unschedulable "
          f"{row['unschedulable']} == the replicated K6 run ({res_rep.wall_clock_s:.3f}s); "
          f"set-up trace {float(setup[0][0]):.2f}s, engine {float(setup[0][1]):.2f}s "
          f"({json.dumps({k: round(v, 3) for k, v in eng.setup_s.items()})}); replay wall "
          f"{row['wall_clock_s']:.3f}s, {row['placements_per_sec']:.1f} placements/s; command "
          f"{command_s:.1f}s; launches {json.dumps(launches)}; pager stalls {pager.stalls} "
          f"({pager.stall_s:.4f}s, {pager.waits} waits); first chunk (profiled: wall "
          f"{chunk_wall:.3f}s, device busy {busy_s:.3f}s) device ms a launch "
          f"{json.dumps(per_launch)}, bounds {json.dumps(bound_chunk)}; kernel times "
          f"{json.dumps(times)}", flush=True)
    return times, launches, slot_launches, holds, k9_holds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a CUDA "
              "card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device_kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {device_kind}", flush=True)
    results = {"nvidia_smi": smi, "device": device_kind, "step_s": STEP_S}
    dev = torch.device("cuda")
    _last_mark[0] = t_start

    t0 = time.perf_counter()
    K.build(verbose=True)
    results["build_s"] = K.last_build_s
    print(f"kernels built in {K.last_build_s:.2f}s "
          f"({time.perf_counter() - t0:.2f}s with loading)", flush=True)
    results["k9_attrs"] = K.shard_chunk_replay_attrs()
    print(f"K9 shard_chunk_replay (cudaFuncGetAttributes): {json.dumps(results['k9_attrs'])}",
          flush=True)
    results["k6_attrs"] = {m: K.chunk_replay_attrs(m == "attributed")
                           for m in ("summary", "attributed")}
    print(f"K6 chunk_replay (cudaFuncGetAttributes): {json.dumps(results['k6_attrs'])}",
          flush=True)

    t0 = time.perf_counter()
    ec, ep = case(5000, 50_000)
    results["encode_s"] = time.perf_counter() - t0
    print(f"config2 shape encoded: {ec.num_nodes} nodes, {ep.num_pods} pods, "
          f"R={ec.num_resources} G={ec.num_groups} D={ec.max_domains} "
          f"T={ec.node_domain.shape[0]} ({results['encode_s']:.1f}s)", flush=True)

    mark("1-2 build, encode")
    check_kernels_s1(ec, ep, results, dev)
    check_kernels_s4(ec, ep, results, dev)
    mark("3-4 kernel checks S=1, S=4")
    check_reduced_replay(results)
    mark("5 reduced replay")
    check_reduced_whatif(results)
    mark("6 reduced what-if")

    # Step 7: the config2 single replay, kernel path; counters from zero.
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=1024)
    K.reset_launch_counts()
    res = eng.replay()
    launches_c2 = K.launch_counts()
    check_result(ec, ep, res)
    check_chunk_launches("config2 replay", launches_c2, eng.plan)
    k6_plan_c2 = plan_of(K.chunk_replay)
    by_kernel_c2 = {}
    res_p, busy_s = profiled_busy_s(eng.replay, by_kernel_c2)
    k6_us_c2 = k6_device_s(by_kernel_c2) * 1e6 / int((eng.plan.idx >= 0).sum())
    if not np.array_equal(res_p.assignments, res.assignments):
        raise AssertionError("the profiled replay placed differently")
    results["chunk_loop_bound_ms_config2"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, res.assignments[None], launches_c2)
    print(f"config2 chunk-loop bound (B6): {json.dumps(results['chunk_loop_bound_ms_config2'])} "
          f"ms", flush=True)
    mk = lambda: (eng._tables(), new_choices(eng.plan, 1, ep.bound_node, dev))
    _, _, twin_c2 = hold_twin("config2", eng.plan, mk, min(K6_TWIN_WAVES, eng.plan.C))
    results["config2"] = dict(
        route=res.route, chunks=len(eng.plan.buckets),
        nodes=ec.num_nodes, pods=ep.num_pods, wall_s=res.wall_clock_s,
        placements_per_s=res.placements_per_sec, placed=res.placed,
        unschedulable=res.unschedulable, launches=launches_c2,
        phases=res.telemetry.phases if res.telemetry is not None else None,
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None, k6_twin=twin_c2,
        k6_us_per_slot=k6_us_c2, k6_cluster=k6_plan_c2,
    )
    print(f"config2 replay (5000 nodes, 50000 pods, route {res.route}): wall "
          f"{res.wall_clock_s:.3f}s, "
          f"{res.placements_per_sec:.1f} placements/s, placed {res.placed}, launches "
          f"{json.dumps(launches_c2)}; profiled: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_s:.3f}s, K6 {k6_us_c2:.2f} us a slot (cluster {json.dumps(k6_plan_c2)})",
          flush=True)
    del eng, res, res_p
    mark("7 config2 replay")

    # Step 8: the main path, the headline what-if; counters from zero.
    hs = HEADLINE
    t0 = time.perf_counter()
    ec, ep = case(hs["nodes"], hs["pods"])
    scen = uniform_scenarios(ec, hs["scenarios"], seed=0)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=hs["chunk_waves"],
                       collect_assignments=True)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    warm = eng.run()
    launches = K.launch_counts()
    k6_plan_h = plan_of(K.chunk_replay)
    check_chunk_launches("headline", launches, eng.plan)
    # K3 counted by mode where it launches: one release a bucket, the binds
    # and rollbacks inside K6.
    want_k3 = dict(bind=0, rollback=0,
                   release=sum(bk is not None for bk in eng.plan.buckets))
    if any(launches[f"apply_placements_{m}"] != n for m, n in want_k3.items()):
        raise AssertionError(f"headline: K3 launches by mode {launches} for {want_k3}")
    check_whatif_result(ep, warm, hs["scenarios"])
    runs = [eng.run() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.placed, warm.placed):
            raise AssertionError("the headline placed differently from run to run")
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    single = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=hs["chunk_waves"]).replay()
    if int(warm.placed[0]) != single.placed:
        raise AssertionError(f"scenario 0 placed {int(warm.placed[0])}, the single replay "
                             f"{single.placed}")
    by_kernel = {}
    res_p, busy_s = profiled_busy_s(eng.run, by_kernel)
    k6_s = k6_device_s(by_kernel)
    # (b) the per-slot route of the same batch: the same assignments, its
    # launches (the K1-K3 rows' slot_route_launches) and its wall.
    slot_launches, slot_wall = slot_route("headline", eng, warm.assignments)
    rel_launches = sum(bk is not None for bk in eng.plan.buckets)
    rollbacks = int(eng.plan.gang_wave.sum())
    results["headline"] = dict(
        **hs, setup_s=setup_s, chunk_waves_run=eng.plan.C, chunks=len(eng.plan.buckets),
        completions_on=warm.completions_on, route=warm.route, launches=launches,
        launches_detail=dict(release=rel_launches, rollback=rollbacks,
                             k6=launches["chunk_replay"]),
        slot_route=dict(launches=slot_launches, wall_s=slot_wall,
                        sha256=assignments_sha256(warm.assignments)),
        k6_device_s=k6_s, k6_ms_per_launch=k6_s * 1e3 / launches["chunk_replay"],
        k6_us_per_slot=k6_s * 1e6 / int((eng.plan.idx >= 0).sum()), k6_cluster=k6_plan_h,
        device_s_by_kernel=by_kernel,
        walls_s=walls, warmup_wall_s=warm.wall_clock_s, wall_s=wall,
        placements_per_s=warm.total_placed / wall, total_placed=warm.total_placed,
        placed_min=int(warm.placed.min()), placed_max=int(warm.placed.max()),
        scenario0_placed=int(warm.placed[0]), single_replay_placed=single.placed,
        single_replay_wall_s=single.wall_clock_s,
        utilization_cpu_mean=float(warm.utilization_cpu.mean()),
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None,
    )
    print(f"headline what-if ({hs['scenarios']} scenarios x {hs['nodes']} nodes x "
          f"{hs['pods']} pods, chunkWaves {hs['chunk_waves']}, completions + gangs, route "
          f"{warm.route}): "
          f"median wall {wall:.3f}s of {[round(w, 3) for w in walls]}, "
          f"{warm.total_placed / wall:.1f} aggregate placements/s, placed "
          f"{int(warm.placed.min())}..{int(warm.placed.max())} per scenario; scenario 0 "
          f"{int(warm.placed[0])} == single replay {single.placed}; K6 cluster "
          f"{json.dumps(k6_plan_h)}; launches "
          f"{json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%}); the per-slot route places alike "
          f"(assignments' sha256 {assignments_sha256(warm.assignments)[:16]}) in "
          f"{slot_wall:.3f}s, launches {json.dumps(slot_launches)}", flush=True)
    mark("8 headline runs")
    k6 = hold_chunk_replay("headline", eng, dev, results, warm.assignments)

    # Each kernel held against its twin, and timed, at the headline shapes.
    rng = np.random.default_rng(SEED + 128)
    tb_t = eng._tables()
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, tb_t.cluster, tb_t.consts,
                                                   hs["scenarios"], rng, dev)
    held = hold_kernels(f"S={hs['scenarios']} kernel checks (N={hs['nodes']})", ep, tb_t, tb_k,
                        pre, pre_nodes, 40, rng, dev)
    mark("8 headline K6 hold and kernel checks")
    kernels, release = time_kernels(ep, tb_t, held, dev)
    results["kernels"], results["apply_release"] = kernels, release
    results["chunk_loop_bound_ms_headline"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, warm.assignments, launches)
    print(f"headline chunk-loop bound (B6): "
          f"{json.dumps(results['chunk_loop_bound_ms_headline'])} ms; release of "
          f"{release['pairs']} pods x {release['scenarios']} scenarios: {release['ms']:.4f} ms, "
          f"bound {release['bound_ms']:.6f} ms", flush=True)
    headline_s0 = warm.assignments[0].copy()
    headline_case = (ec, ep)
    del eng, warm, runs, res_p, single, tb_t, tb_k, held

    mark("8 headline hold, kernel times")
    # K6 beyond what the card holds at once; K3's release on the Borg cut.
    hold_beyond_card(ec, ep, dev, results)
    mark("8 K6 at S=300")
    check_releases(results, dev)
    mark("8 K3 release cases")
    # (c)-(d): Borg-shaped traces, config4 at 10,000 x 1,000,000 on K6.
    run_config4(results, dev)
    mark("c config4 holds")
    k6_slot = {name: dict(us_per_slot=results[key][f], C=results[key][c]["C"])
               for name, key, f, c in (("headline", "headline", "k6_us_per_slot", "k6_cluster"),
                                       ("config2", "config2", "k6_us_per_slot", "k6_cluster"),
                                       ("config4", "config4", "k6_us_per_slot", "k6_cluster"))}
    for path, rec in k6_slot.items():
        rec["earlier_us_per_slot"] = EARLIER["k6_us_per_slot"][path]
    results["k6_us_per_slot"] = k6_slot
    print("K6 device time a slot (torch.profiler; config4 CUDA events), beside PR 10's: "
          + json.dumps(k6_slot), flush=True)
    print(f"K3's release of {release['pairs']} pods x {release['scenarios']} scenarios: "
          f"{release['ms'] * 1e3:.1f} us beside PR 8's {EARLIER['release_ms']['headline']} ms; "
          f"deterministic index_add_ {release['library_ms'] * 1e3:.1f} us", flush=True)
    check_borg_pins(results, dev)
    mark("d Borg cut pins")
    # (e) node-plane shards (row B13) and paged pod waves: the reduced replay
    # on four routes, SHARD_PINS, config13 through the CLI.
    check_reduced_shards(results, dev)
    mark("e reduced shards")
    check_shard_pins(results, dev)
    mark("e shard cut pins")
    shtimes, shlaunches, shslot, shholds, k9holds = run_config13(results, dev)
    # Steps 9-11: tier preemption.
    check_reduced_preempt(results)
    mark("9 reduced preemption")
    pkernels, plaunches, pslot = run_preempt_paths(results, dev)
    print(f"K3's release with tier planes: "
          f"{pkernels['apply_placements_tier_release']['ms'] * 1e3:.1f} us beside PR 8's "
          f"{EARLIER['release_ms']['tier']} ms", flush=True)
    mark("11 tier kernel times")
    # Steps 12-15: the retry buffer.
    check_reduced_retry(results)
    mark("12 reduced retry")
    rkernels, rlaunches = run_retry_paths(results, dev)
    mark("15 retry kernel times")
    # Steps 16-19: label perturbations (set_label).
    check_reduced_relabel(results)
    mark("16 reduced relabel")
    lkernels, llaunches, lslot = run_label_paths(results, headline_s0, dev)
    mark("18-19 label kernel times, cut, outside")
    # Steps 20-21: series and timeline telemetry.
    check_reduced_series(results, dev)
    mark("20 reduced series")
    skernels = run_series_paths(results, dev)
    mark("21 (d) config13 at series")
    # P1-P3: per-scenario policy rows (row B1w) and the policy tuner.
    polkernels, pollaunches, polslot = run_policy_paths(results, *headline_case, dev)
    check_policy_cut(results, dev)
    mark("P2 policy cut")
    run_tune_cli(results, dev)
    mark("P3 config11 tune")
    results["wall_s_total"] = time.perf_counter() - t_start
    print("step walls (s): " + json.dumps({k: round(v, 1) for k, v in STEP_S.items()}),
          flush=True)

    # Each row's launches are its path's main run's (the chunk route runs
    # K1's and K2's bodies inside K6: they launch 0 times there);
    # slot_route_launches are the same batch's on the per-slot route.
    table = []
    for k, m in kernels.items():
        src, replaces = SOURCES[k]
        table.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[K3_ROW_MODE.get(k, k)],
            "slot_route_launches": slot_launches[K3_ROW_MODE.get(k, k)],
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **({"cluster": m["cluster"]} if "cluster" in m else {}),
        })
    src, replaces = SOURCES["chunk_replay"]
    table.append({
        "name": "chunk_replay", "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches["chunk_replay"], "max_abs_err": k6["max_abs_err"], "ms": k6["ms"],
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        # no single PyTorch call runs a chunk of the scheduler's waves
        "library_ms": None, "cluster": k6["cluster"],
    })
    # K3's release at the headline (its launches counted under the release
    # mode): library_ms is one deterministic index_add_ of the same
    # requests, which keeps no pair order within a node — a yardstick, not a
    # path.
    table.append({
        "name": "apply_placements_release", "route": "cuda",
        "source": SOURCES["apply_placements"][0],
        "replaces": "kubernetes_simulator_tpu/sim/whatif.py:1620",
        "launches": launches["apply_placements_release"], "max_abs_err": release["max_abs_err"],
        "ms": release["ms"], "plain_ms": release["plain_ms"], "bound_ms": release["bound_ms"],
        "bound_by": release["bound_by"], "library_ms": release["library_ms"],
    })
    for k, m in pkernels.items():
        kernel, replaces = PREEMPT_SOURCES[k]
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0], "replaces": replaces,
            "launches": plaunches[K3_ROW_MODE.get(k, kernel)],
            "slot_route_launches": pslot[K3_ROW_MODE.get(k, kernel)],
            "max_abs_err": 0.0, "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            **({"cluster": m["cluster"]} if "cluster" in m else {}),
        })
    for k, m in rkernels.items():
        kernel, replaces = RETRY_SOURCES[k] if k in RETRY_SOURCES else (k, SOURCES[k][1])
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0], "replaces": replaces,
            "launches": rlaunches[K3_ROW_MODE.get(k, kernel)], "max_abs_err": 0.0, "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    for k, (kernel, replaces) in LABEL_SOURCES.items():
        m = lkernels[kernel]
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0], "replaces": replaces,
            "launches": llaunches[K3_ROW_MODE.get(k, kernel)],
            "slot_route_launches": lslot[K3_ROW_MODE.get(k, kernel)],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    for k, m in skernels.items():
        kernel, replaces = SERIES_SOURCES[k]
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0],
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **{x: m[x] for x in ("cluster", "window_slots", "us_per_slot", "summary_ms")
               if x in m},
        })
    for k, (kernel, replaces) in POLICY_SOURCES.items():
        m = polkernels[kernel]
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0], "replaces": replaces,
            "launches": pollaunches[kernel], "slot_route_launches": polslot[kernel],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            # no single PyTorch call computes a per-scenario weighted total
            "library_ms": None,
        })
    for k, (kernel, replaces) in SHARD_SOURCES.items():
        m = shtimes[k]
        # config13's CLI run (K9: K1, K7 and K8's bind and rollback launch 0
        # times) and the same engine on the per-slot shard route, counters
        # zeroed just before each: K8 by mode
        key = {"filter_score_shards": "filter_score", "shard_apply": "shard_apply_bind"}.get(k, k)
        table.append({
            "name": k, "route": "cuda", "source": SOURCES[kernel][0], "replaces": replaces,
            "launches": shlaunches[key], "slot_route_launches": shslot[key],
            "max_abs_err": max(h["max_abs_err"] for h in shholds.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **({"cluster": m["cluster"]} if "cluster" in m else {}),
        })
    # K9 over config13's window at P = 8 (the run's shards); its time a slot
    # over the run's first chunk beside it.
    m = k9holds[8]
    src, replaces = SOURCES["shard_chunk_replay"]
    table.append({
        "name": "shard_chunk_replay", "route": "cuda", "source": src, "replaces": replaces,
        "launches": shlaunches["shard_chunk_replay"], "slot_route_launches": 0,
        "max_abs_err": max(h["max_abs_err"] for h in k9holds.values()), "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        # no single PyTorch call runs a chunk of the scheduler's waves
        "library_ms": None, "cluster": m["cluster"], "window_slots": m["slots"],
        "us_per_slot_first_chunk": results["config13"]["k9_first_chunk"]["us_per_slot"],
    })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"done in {results['wall_s_total']:.1f}s", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
