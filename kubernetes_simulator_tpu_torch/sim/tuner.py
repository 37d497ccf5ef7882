"""Policy tuner: batched scheduler-policy search over the scenario axis.

Counterpart: ``kubernetes_simulator_tpu/sim/tuner.py`` (``make_objective``
:144, ``normalize_constraints`` :107, ``SearchSpace`` :189, ``TuneResult``
:263, ``PolicyTuner`` :300) with the device evaluator, the held-out sweep
and the greedy CPU oracle; and ``parallel/mesh.py:198`` ``fit_population``
in its one-process, no-mesh case.

The per-scenario policy row (:mod:`..ops.policy` ``POLICY_COLS`` — one
Score weight per plugin plus the NodeResourcesFit strategy selector) is an
input of the what-if engine's kernels (K1 reads the selector, K2 the
weights), so a whole candidate population evaluates in one batched sweep,
and a host-side seeded search loop (random search or the cross-entropy
method) walks the weight space against a configurable scalar objective.

Layout: a population of P candidate rows × S_t train scenarios flattens
onto the scenario axis as (candidate-major) [P·S_t] rows — candidate i
owns rows [i·S_t, (i+1)·S_t). Between rounds only the row VALUES change
(``WhatIfEngine.set_policies`` copies them into the engine's device
tensor), so the search runs on one engine set up once
(``TuneResult.compile_count`` reports the engine's set-ups: 1).

The winner is re-evaluated two ways: on a HELD-OUT scenario split (one
extra 2·S_h-row sweep, winner vs the config's default policy) and by
``greedy_replay`` per held-out scenario over the perturbed host clusters
(the CPU oracle), whose objective must match the device objective within
a pinned envelope.

The trajectory streams as schema-v3 JSONL rows (``run_type: "tune"``;
scripts/check_metrics_schema.py) with no wall-clock field, so a fixed seed
and config give byte-identical files — and the same bytes as the JAX
package's ``tune``: the same ``np.random.default_rng`` draws, the same
objectives.

Refused by name: the host evaluator (``evaluator: cpu``, and ``auto`` when
the objective needs it: the CPU event engine, queue A item 13) and a mesh
(the scenario axis over several cards, queue A item 10).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..framework.framework import FrameworkConfig
from ..ops.policy import IDX_FIT_LEAST, POLICY_COLS, POLICY_WEIGHT_COLS
from ..plugins.builtin import TUNABLE_FIT_STRATEGIES, tunable_parameters
from ..utils.metrics import TUNE_SCHEMA_VERSION, log
from .greedy import greedy_replay
from .whatif import Scenario, ScenarioSet, WhatIfEngine, uniform_scenarios

#: Objective terms every engine path provides.
_ALWAYS_METRICS = ("placementRate", "unschedulable", "utilizationCpu")
_RESULT_METRICS = {
    "placementRate": None,  # computed from placed/unschedulable
    "unschedulable": "unschedulable",
    "utilizationCpu": "utilization_cpu",
    "preemptions": "preemptions",
    "retryDropped": "retry_dropped",
    "evictions": "evictions",
    "latencyP50": "latency_p50",
    "latencyP90": "latency_p90",
    "latencyP99": "latency_p99",
    "strandedCpu": "stranded_cpu",
    "fragIndexCpu": "frag_index_cpu",
    "packingEfficiency": "packing_efficiency",
}

#: Terms the CPU oracle (greedy_replay) can recompute exactly — the
#: envelope check is skipped (with a log note) for objectives outside it.
_ORACLE_METRICS = {
    "placementRate", "unschedulable", "utilizationCpu",
    "strandedCpu", "fragIndexCpu", "packingEfficiency",
}

DEFAULT_OBJECTIVE = {"placementRate": 1.0}


def _metric_series(res, key: str) -> np.ndarray:
    """Per-scenario [S] f64 series for one objective term, or raise with
    the engine mode the term needs."""
    if key == "placementRate":
        placed = np.asarray(res.placed, np.float64)
        unsched = np.asarray(res.unschedulable, np.float64)
        return placed / np.maximum(placed + unsched, 1.0)
    val = getattr(res, _RESULT_METRICS[key])
    if val is None:
        raise ValueError(
            f"objective term {key!r} is unavailable on this what-if path "
            "(latency quantiles / preemptions / evictions ride the kube "
            "host mirrors, which the policy axis does not support) — use "
            f"terms from {sorted(_ALWAYS_METRICS)}"
        )
    return np.asarray(val, np.float64)


def normalize_constraints(constraints) -> List[dict]:
    """Validate penalty-constraint specs. Each entry is ``{"metric":
    <term>, "max": x | "min": x, "penalty": p}`` — ``max`` bounds the
    metric from above, ``min`` from below; ``penalty`` (default 1.0, must
    be > 0) scales the hinge. Returns normalized copies (exactly one bound
    key, float values)."""
    out: List[dict] = []
    for i, c in enumerate(constraints or []):
        where = f"constraints[{i}]"
        if not isinstance(c, dict):
            raise ValueError(f"{where}: expected a mapping, got {c!r}")
        metric = c.get("metric")
        if metric not in _RESULT_METRICS:
            raise ValueError(
                f"{where}: unknown metric {metric!r} — known: {sorted(_RESULT_METRICS)}"
            )
        has_max, has_min = "max" in c, "min" in c
        if has_max == has_min:
            raise ValueError(
                f"{where}: need exactly one of 'max' or 'min' (got "
                f"{sorted(set(c) & {'max', 'min'}) or 'neither'})"
            )
        penalty = float(c.get("penalty", 1.0))
        if not penalty > 0:
            raise ValueError(f"{where}: penalty must be > 0, got {penalty}")
        unknown = sorted(set(c) - {"metric", "max", "min", "penalty"})
        if unknown:
            raise ValueError(f"{where}: unknown key(s) {unknown}")
        norm = {"metric": metric, "penalty": penalty}
        norm["max" if has_max else "min"] = float(c["max" if has_max else "min"])
        out.append(norm)
    return out


def make_objective(
    weights: Optional[Dict[str, float]], constraints=None
) -> Tuple[Dict[str, float], List[dict], Callable]:
    """Validate an objective spec and return (weights, constraints, fn)
    where fn maps a WhatIfResult to a per-scenario [S] f64 objective
    (HIGHER IS BETTER — express costs with negative weights). Each
    violated constraint bound subtracts ``penalty · relu(violation)``; a
    NaN constraint metric contributes zero violation."""
    w = dict(DEFAULT_OBJECTIVE if weights is None else weights)
    unknown = sorted(set(w) - set(_RESULT_METRICS))
    if unknown:
        raise ValueError(
            f"unknown objective term(s) {unknown} — known: {sorted(_RESULT_METRICS)}"
        )
    if not w:
        raise ValueError("objective must contain at least one term")
    cons = normalize_constraints(constraints)

    def fn(res) -> np.ndarray:
        out = None
        for key, wt in w.items():
            term = float(wt) * _metric_series(res, key)
            out = term if out is None else out + term
        for c in cons:
            v = _metric_series(res, c["metric"])
            if "max" in c:
                viol = np.maximum(v - c["max"], 0.0)
            else:
                viol = np.maximum(c["min"] - v, 0.0)
            out = out - c["penalty"] * np.nan_to_num(viol, nan=0.0)
        return out

    return w, cons, fn


def tune_config_errors(tu) -> List[str]:
    """The reference's ``validate`` checks of a ``tune:`` section
    (kubernetes_simulator_tpu/cli.py:783-837), as error strings."""
    errors = []
    if tu.algo not in ("cem", "random"):
        errors.append(f"tune.algo: must be 'cem' or 'random', got {tu.algo!r}")
    if tu.population < 2:
        errors.append("tune.population: must be >= 2")
    if tu.rounds < 1:
        errors.append("tune.rounds: must be >= 1")
    if not 0.0 < tu.elite_frac <= 1.0:
        errors.append("tune.eliteFrac: must be in (0, 1]")
    if tu.train_scenarios < 1 or tu.heldout_scenarios < 1:
        errors.append(
            "tune.scenarios: train and heldout must both be >= 1 "
            "(the acceptance check runs on the held-out split)"
        )
    if tu.evaluator not in ("auto", "device"):
        errors.append(
            f"tune.evaluator: must be 'auto' or 'device', got {tu.evaluator!r}"
        )
    try:
        cons = normalize_constraints(tu.constraints)
    except ValueError as e:
        errors.append(f"tune.constraints: {e}")
        cons = []
    for term in list(tu.objective or {}) + [c["metric"] for c in cons]:
        if term not in _RESULT_METRICS:
            errors.append(
                f"tune.objective: unknown term '{term}' "
                f"(known: {', '.join(sorted(_RESULT_METRICS))})"
            )
        elif term not in _ALWAYS_METRICS and tu.evaluator == "device":
            errors.append(
                f"tune.objective: term '{term}' rides the kube host mirrors, which the "
                "batched policy sweep does not support — drop 'evaluator: device' or use "
                f"terms from {', '.join(sorted(_ALWAYS_METRICS))}"
            )
    wb = tu.weight_bounds
    if wb is not None and (len(wb) != 2 or wb[0] >= wb[1]):
        errors.append("tune.weightBounds: must be [lo, hi] with lo < hi")
    if tu.cpu_envelope < 0:
        errors.append("tune.cpuEnvelope: must be >= 0")
    return errors


def fit_population(population: int, mesh=None) -> int:
    """The population a sweep runs (``parallel/mesh.py:198``'s one-process,
    no-mesh case: the requested one, at least 1). A mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(
            "a policy sweep over a mesh (tune.mesh: true, the scenario axis over several "
            "cards) is not ported yet (queue A item 10); use the JAX package"
        )
    return max(int(population), 1)


@dataclass(frozen=True)
class SearchSpace:
    """The searched dimensions, derived from the config's tunable-parameter
    surface (plugins.builtin.tunable_parameters). Weight columns of
    disabled plugins and an inert strategy selector are PINNED to their
    defaults."""

    lo: np.ndarray  # [5] per-weight-column lower bound
    hi: np.ndarray  # [5] upper bound
    defaults: np.ndarray  # [len(POLICY_COLS)] the config's own policy
    weight_mask: np.ndarray  # [5] bool — searched weight columns
    tune_strategy: bool  # search the fit_least selector?

    @classmethod
    def from_config(
        cls,
        config: Optional[FrameworkConfig],
        weight_bounds: Optional[Tuple[float, float]] = None,
        tune_strategy: bool = True,
    ) -> "SearchSpace":
        params = {p["name"]: p for p in tunable_parameters(config)}
        nW = len(POLICY_WEIGHT_COLS)
        lo = np.zeros(nW)
        hi = np.zeros(nW)
        mask = np.zeros(nW, bool)
        defaults = np.zeros(len(POLICY_COLS), np.float32)
        for i, name in enumerate(POLICY_WEIGHT_COLS):
            p = params[name]
            lo[i], hi[i] = p["lo"], p["hi"]
            if weight_bounds is not None:
                lo[i], hi[i] = weight_bounds
            mask[i] = p["enabled"]
            defaults[i] = p["default"]
        strat = params["NodeResourcesFit.strategy"]
        defaults[IDX_FIT_LEAST] = float(strat["default"] == "LeastAllocated")
        if np.any(lo >= hi):
            raise ValueError(f"weight bounds must satisfy lo < hi, got {lo}..{hi}")
        return cls(
            lo=lo, hi=hi, defaults=defaults, weight_mask=mask,
            tune_strategy=bool(tune_strategy and strat["enabled"]),
        )

    def clip(self, vecs: np.ndarray) -> np.ndarray:
        """Project candidate rows into the space: clip weights to bounds,
        binarize the selector, pin unsearched columns."""
        out = np.asarray(vecs, np.float32).copy()
        nW = len(POLICY_WEIGHT_COLS)
        out[:, :nW] = np.clip(out[:, :nW], self.lo, self.hi)
        pinned = ~np.concatenate([self.weight_mask, [self.tune_strategy]])
        out[:, pinned] = self.defaults[None, pinned]
        out[:, IDX_FIT_LEAST] = (out[:, IDX_FIT_LEAST] > 0.5).astype(np.float32)
        return out

    def describe(self, vec: np.ndarray) -> Dict[str, float]:
        """A policy row as a {column: value} dict for JSONL/reporting (the
        selector reported as the strategy name)."""
        out = {name: round(float(vec[i]), 6) for i, name in enumerate(POLICY_WEIGHT_COLS)}
        out["fitStrategy"] = TUNABLE_FIT_STRATEGIES[int(vec[IDX_FIT_LEAST] > 0.5)]
        return out


@dataclass
class TuneResult:
    best_policy: Dict[str, float]  # SearchSpace.describe of the winner
    best_vector: np.ndarray  # [len(POLICY_COLS)] f32
    train_objective: float
    heldout_objective: float
    default_heldout_objective: float
    rounds: int
    population: int
    evaluations: int  # candidate×train-scenario device evaluations
    wall_clock_s: float
    compile_count: Optional[int]  # set-ups of the train engine (pin: 1)
    cpu_objective: Optional[float] = None  # oracle mean over held-out
    cpu_envelope: Optional[float] = None  # |device − cpu|, None if skipped
    trajectory: List[dict] = field(default_factory=list)
    population_requested: Optional[int] = None
    objective_constraints: List[dict] = field(default_factory=list)
    evaluator: str = "device"
    #: wall seconds of the train engine's set-up (plan and device tables,
    #: once a search), the rest of the search, the held-out sweep (its own
    #: set-up included) and the oracle
    phase_s: Dict[str, float] = field(default_factory=dict)

    def improved(self) -> bool:
        return self.heldout_objective > self.default_heldout_objective


class PolicyTuner:
    """Seeded search over scheduler score policies against one trace.

    ``algo``: "cem" (cross-entropy method: Gaussian weight columns +
    Bernoulli strategy selector, elite refit with a std floor) or "random"
    (uniform in bounds). Both carry the incumbent best as candidate 0 of
    every round (round 0's incumbent is the config's own default policy).
    ``device`` is the what-if engines' device ("cuda": the kernels;
    "cpu": their plain twins).
    """

    def __init__(
        self,
        ec,
        pods,
        config: Optional[FrameworkConfig] = None,
        *,
        algo: str = "cem",
        population: int = 16,
        rounds: int = 6,
        seed: int = 0,
        elite_frac: float = 0.25,
        objective: Optional[Dict[str, float]] = None,
        constraints: Optional[List[dict]] = None,
        evaluator: str = "auto",
        train_scenarios: int = 4,
        heldout_scenarios: int = 2,
        scenario_seed: int = 0,
        p_node_down: float = 0.02,
        p_capacity: float = 0.3,
        p_taint: float = 0.1,
        weight_bounds: Optional[Tuple[float, float]] = None,
        tune_strategy: bool = True,
        wave_width: int = 8,
        chunk_waves: int = 1024,
        completions: Optional[bool] = None,
        mesh=None,
        cpu_oracle: bool = True,
        cpu_envelope: float = 1e-6,
        device="cuda",
    ):
        if algo not in ("cem", "random"):
            raise ValueError(f"algo must be 'cem' or 'random', got {algo!r}")
        if rounds < 1 or population < 2:
            raise ValueError("need rounds >= 1 and population >= 2")
        if train_scenarios < 1 or heldout_scenarios < 1:
            raise ValueError(
                "need train_scenarios >= 1 and heldout_scenarios >= 1 "
                "(the acceptance check is on the held-out split)"
            )
        if not 0.0 < elite_frac <= 1.0:
            raise ValueError("elite_frac must be in (0, 1]")
        self.ec, self.pods, self.config = ec, pods, config
        self.algo = algo
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.elite_frac = float(elite_frac)
        self.space = SearchSpace.from_config(
            config, weight_bounds=weight_bounds, tune_strategy=tune_strategy
        )
        (
            self.objective_weights,
            self.objective_constraints,
            self._objective,
        ) = make_objective(objective, constraints)
        if evaluator not in ("auto", "device", "cpu"):
            raise ValueError(
                f"evaluator must be 'auto', 'device' or 'cpu', got {evaluator!r}"
            )
        terms = set(self.objective_weights) | {c["metric"] for c in self.objective_constraints}
        needs_host = not terms <= set(_ALWAYS_METRICS)
        if evaluator == "device" and needs_host:
            raise ValueError(
                f"objective/constraint term(s) {sorted(terms - set(_ALWAYS_METRICS))} ride "
                "the kube host mirrors, which the batched policy sweep does not support — "
                "use evaluator='cpu' (every candidate scored on the CPU event engine) or "
                f"restrict terms to {sorted(_ALWAYS_METRICS)}"
            )
        if evaluator == "cpu" or needs_host:
            why = ("evaluator='cpu'" if evaluator == "cpu" else
                   f"evaluator='auto' with the term(s) {sorted(terms - set(_ALWAYS_METRICS))}")
            raise NotImplementedError(
                f"{why} selects the host evaluator (every candidate scored on the CPU event "
                "engine, CpuReplayEngine), which is not ported yet (queue A item 13); use "
                f"the JAX package, or terms from {sorted(_ALWAYS_METRICS)}"
            )
        self.evaluator = "device"
        self.S_t = int(train_scenarios)
        self.S_h = int(heldout_scenarios)
        self.population_requested = int(population)
        self.population = fit_population(population, mesh)
        # One scenario pool, split train/held-out: scenario 0 (the
        # unperturbed base) lands in TRAIN; the held-out split is
        # all-perturbed.
        pool = uniform_scenarios(
            ec, self.S_t + self.S_h, seed=scenario_seed,
            p_node_down=p_node_down, p_capacity=p_capacity, p_taint=p_taint,
        )
        self.train_split: List[Scenario] = list(pool[: self.S_t])
        self.heldout_split: List[Scenario] = list(pool[self.S_t:])
        self._engine_kw = dict(
            config=config, wave_width=wave_width, chunk_waves=chunk_waves,
            completions=completions, device=device,
        )
        self.cpu_oracle = bool(cpu_oracle)
        self.cpu_envelope = float(cpu_envelope)
        self._train_engine: Optional[WhatIfEngine] = None

    # -- population sampling ------------------------------------------------

    def _sample(self, rng, mean, std, theta) -> np.ndarray:
        P = self.population
        nW = len(POLICY_WEIGHT_COLS)
        vecs = np.tile(self.space.defaults, (P, 1)).astype(np.float32)
        if self.algo == "random":
            vecs[:, :nW] = rng.uniform(self.space.lo, self.space.hi, size=(P, nW))
        else:
            vecs[:, :nW] = rng.normal(mean, std, size=(P, nW))
        if self.space.tune_strategy:
            p_least = 0.5 if self.algo == "random" else theta
            vecs[:, IDX_FIT_LEAST] = (rng.random(P) < p_least).astype(np.float32)
        return self.space.clip(vecs)

    def _refit(self, elites, mean, std, theta):
        """CEM elite refit with a std floor (keeps exploration alive) —
        random search ignores the distribution state entirely."""
        if self.algo == "random":
            return mean, std, theta
        nW = len(POLICY_WEIGHT_COLS)
        floor = 0.05 * (self.space.hi - self.space.lo)
        mean = elites[:, :nW].astype(np.float64).mean(axis=0)
        std = np.maximum(elites[:, :nW].astype(np.float64).std(axis=0), floor)
        if self.space.tune_strategy:
            theta = float(np.clip(elites[:, IDX_FIT_LEAST].mean(), 0.05, 0.95))
        return mean, std, theta

    # -- evaluation ---------------------------------------------------------

    def _flat_policies(self, cand: np.ndarray) -> np.ndarray:
        """[P, K] candidates → [P·S_t, K] candidate-major flat rows, the
        layout the train engine's scenario list was built with."""
        return np.repeat(cand, self.S_t, axis=0)

    def _policy_config(self, vec: np.ndarray) -> FrameworkConfig:
        """A candidate row materialized as an ordinary FrameworkConfig
        (the oracle's policy carrier)."""
        desc = self.space.describe(vec)
        strategy = desc.pop("fitStrategy")
        base = self.config if self.config is not None else FrameworkConfig()
        return base.with_policy(
            desc, fit_strategy=strategy if self.space.tune_strategy else None
        )

    def _train_eval(self, cand: np.ndarray) -> np.ndarray:
        """Evaluate the whole population in ONE sweep; returns the [P]
        per-candidate objective (mean over its train scenarios)."""
        flat = self._flat_policies(cand)
        if self._train_engine is None:
            t0 = time.perf_counter()
            self._train_engine = WhatIfEngine(
                self.ec, self.pods, self.train_split * self.population,
                policies=flat, **self._engine_kw,
            )
            self._setup_s = time.perf_counter() - t0
        else:
            self._train_engine.set_policies(flat)
        per_scenario = self._objective(self._train_engine.run())
        return per_scenario.reshape(self.population, self.S_t).mean(axis=1)

    def _heldout_eval(self, best_vec: np.ndarray):
        """One 2-policy sweep on the held-out split: winner vs the config's
        default policy. Returns (best_obj, default_obj, per-scenario winner
        objectives, engine)."""
        pol = np.concatenate([
            np.repeat(best_vec[None], self.S_h, axis=0),
            np.repeat(self.space.defaults[None], self.S_h, axis=0),
        ])
        eng = WhatIfEngine(
            self.ec, self.pods, self.heldout_split * 2, policies=pol, **self._engine_kw,
        )
        per_scenario = self._objective(eng.run())
        best = per_scenario[: self.S_h]
        default = per_scenario[self.S_h:]
        return float(best.mean()), float(default.mean()), best, eng

    def _oracle_eval(self, best_vec: np.ndarray, eng: WhatIfEngine):
        """Re-evaluate the winner with ``greedy_replay`` per held-out
        scenario — the perturbed host clusters with the winning weights
        materialized as an ordinary FrameworkConfig."""
        terms = set(self.objective_weights) | {c["metric"] for c in self.objective_constraints}
        if not terms <= _ORACLE_METRICS:
            log.info(
                "tune: CPU-oracle check skipped — objective uses terms outside %s",
                sorted(_ORACLE_METRICS),
            )
            return None
        cfg = self._policy_config(best_vec)
        sset = ScenarioSet(self.ec, self.heldout_split)
        chunk = eng.chunk_waves if eng.completions_on else None
        rows = []
        for ec_s in sset.host_clusters():
            r = greedy_replay(
                ec_s, self.pods, cfg, wave_width=eng.wave_width,
                completions_chunk_waves=chunk,
            )
            fr = r.fragmentation or {}
            rows.append(SimpleNamespace(
                placed=np.array([float(r.placed)]),
                unschedulable=np.array([float(r.unschedulable)]),
                utilization_cpu=np.array([r.utilization.get("cpu", 0.0)]),
                preemptions=np.array([float(r.preemptions)]),
                retry_dropped=np.array([float(r.retry_dropped)]),
                evictions=np.array([float(r.evictions)]),
                latency_p50=None, latency_p90=None, latency_p99=None,
                stranded_cpu=np.array([fr.get("stranded", {}).get("cpu", 0.0)]),
                frag_index_cpu=np.array([fr.get("frag_index", {}).get("cpu", 0.0)]),
                packing_efficiency=np.array([fr.get("packing_efficiency", 1.0)]),
            ))
        return np.concatenate([self._objective(r) for r in rows])

    # -- the search loop ----------------------------------------------------

    def run(self, writer=None) -> TuneResult:
        """Run the search. ``writer`` (utils.metrics.JsonlWriter) streams
        the trajectory; rows are written WITHOUT the wall-clock stamp so a
        fixed seed + config yields byte-identical files."""
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        nW = len(POLICY_WEIGHT_COLS)
        mean = self.space.defaults[:nW].astype(np.float64)
        std = (self.space.hi - self.space.lo) / 4.0
        theta = 0.5
        best_vec = self.space.clip(self.space.defaults[None])[0]
        best_obj = -math.inf
        trajectory: List[dict] = []

        def emit(row: dict) -> None:
            row = {"schema": TUNE_SCHEMA_VERSION, "run_type": "tune", **row}
            trajectory.append(row)
            if writer is not None:
                writer.write(row, stamp_ts=False)

        n_elite = max(1, int(math.ceil(self.elite_frac * self.population)))
        for rd in range(self.rounds):
            cand = self._sample(rng, mean, std, theta)
            # Elitism: the incumbent rides as candidate 0 (round 0's
            # incumbent is the config default).
            cand[0] = best_vec
            objs = self._train_eval(cand)
            order = np.argsort(-objs, kind="stable")  # ties → lower index
            mean, std, theta = self._refit(cand[order[:n_elite]], mean, std, theta)
            if objs[order[0]] > best_obj:
                best_obj = float(objs[order[0]])
                best_vec = cand[order[0]].copy()
            for i in range(self.population):
                emit({
                    "kind": "tune-candidate", "round": rd, "candidate": i,
                    "policy": self.space.describe(cand[i]),
                    "objective": round(float(objs[i]), 9),
                    "split": "train",
                })
            emit({
                "kind": "tune-round", "round": rd,
                "best_objective": round(best_obj, 9),
                "round_best_objective": round(float(objs[order[0]]), 9),
                "mean_objective": round(float(objs.mean()), 9),
                "best_candidate": int(order[0]),
            })
            log.info(
                "tune: round %d/%d best=%.6f (incumbent %.6f)",
                rd + 1, self.rounds, float(objs[order[0]]), best_obj,
            )
        t1 = time.perf_counter()
        held_obj, held_default, held_rows, held_eng = self._heldout_eval(best_vec)
        t2 = time.perf_counter()
        cpu_obj = cpu_env = None
        if self.cpu_oracle:
            oracle_rows = self._oracle_eval(best_vec, held_eng)
            if oracle_rows is not None:
                cpu_obj = float(oracle_rows.mean())
                cpu_env = float(np.abs(oracle_rows - held_rows).max())
                if cpu_env > self.cpu_envelope:
                    log.warning(
                        "tune: CPU-oracle objective diverges from the device objective by "
                        "%.3g (> envelope %.3g)", cpu_env, self.cpu_envelope,
                    )
        t3 = time.perf_counter()
        compile_count = self._train_engine.setups
        emit({
            "kind": "tune-result",
            "best_policy": self.space.describe(best_vec),
            "train_objective": round(best_obj, 9),
            "heldout_objective": round(held_obj, 9),
            "default_heldout_objective": round(held_default, 9),
            "cpu_objective": round(cpu_obj, 9) if cpu_obj is not None else None,
            "cpu_envelope": round(cpu_env, 12) if cpu_env is not None else None,
            "rounds": self.rounds,
            "population": self.population,
            "evaluations": self.rounds * self.population * self.S_t,
            "objective_weights": {k: float(v) for k, v in self.objective_weights.items()},
            "objective_constraints": self.objective_constraints,
            "evaluator": self.evaluator,
            "algo": self.algo,
            "seed": self.seed,
        })
        return TuneResult(
            best_policy=self.space.describe(best_vec),
            best_vector=best_vec,
            train_objective=best_obj,
            heldout_objective=held_obj,
            default_heldout_objective=held_default,
            rounds=self.rounds,
            population=self.population,
            evaluations=self.rounds * self.population * self.S_t,
            wall_clock_s=time.perf_counter() - t0,
            compile_count=compile_count,
            cpu_objective=cpu_obj,
            cpu_envelope=cpu_env,
            trajectory=trajectory,
            population_requested=self.population_requested,
            objective_constraints=self.objective_constraints,
            evaluator=self.evaluator,
            phase_s={"setup": self._setup_s, "search": t1 - t0 - self._setup_s,
                     "heldout": t2 - t1, "oracle": t3 - t2},
        )
