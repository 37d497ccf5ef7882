"""CLI of the port: replay a YAML config, or run its what-if batch, on
the card.

    python -m kubernetes_simulator_tpu_torch run config.yaml [--device cpu] [--strategy cpu]
        [--timeline-out t.json]
    python -m kubernetes_simulator_tpu_torch what-if config.yaml [--device cpu]
    python -m kubernetes_simulator_tpu_torch tune config.yaml [--device cpu]
    python -m kubernetes_simulator_tpu_torch serve config.yaml [--device cpu] < queries.ndjson
    python -m kubernetes_simulator_tpu_torch validate config.yaml
    (every subcommand: [--profile-dir DIR], a torch.profiler trace of the run)

Counterpart: ``kubernetes_simulator_tpu/cli.py`` (``cmd_run`` :83,
``cmd_whatif`` :140; both pass ``whatIf.retryBuffer``, :100 and :182,
and ``devicePreemption`` — tier, or kube through the retry buffer;
``cmd_tune`` :205). The config is parsed as the JAX package parses it
(utils.config); sections of modes the port does not carry yet are refused
with an error naming them; a ``workload.borg`` section (config4's 10,000
nodes x 1,000,000 tasks) is checked as the reference's ``validate`` checks
it, and its seed stamps the rows. ``run`` writes one JSONL replay row,
``what-if`` the ``whatif_rows`` (stdout, or the config's ``output``), and
each an INFO summary line with placements/sec and the route the chunks
took (``chunk``: one K6 launch a chunk; ``slot``: K1 → K2 → K3 a slot);
``run`` passes ``nodeShards`` and ``pagedWaves`` to the engine (:101-102; route
``shard``: one K9 a chunk), after the reference's checks of them
(:735-757), and the flight recorder (``flightRecorder:``, :103-109) and the
``overlap:`` gates (the reference exports them to the environment,
:1011-1030; here ``pagerThread`` goes to the engine, and
``twoPhaseExchange`` is logged: either value runs K9's one exchange).
``what-if`` and ``tune`` run over the scenario mesh of every local card
(:func:`.parallel.mesh.make_mesh`) when ``whatIf.mesh`` / ``tune.mesh`` is
set (:171, :221; on ``--device cpu`` a one-device CPU mesh), and the
what-if rows say ``"mesh": true``. ``tune`` writes the
policy search's trajectory (schema-v3 rows without a wall-clock stamp, to
``tune.output`` or ``output``) and INFO lines with the winner, the
held-out objectives, the CPU oracle's envelope and the walls. ``run --timeline-out`` (or
``telemetry.timelineOut``) collects at granularity ``timeline`` and writes
the simulated cluster timeline as a Chrome trace (:87-129). An enabled
``chaos:`` section (:func:`_chaos_timeline`, the reference's :50-75) gives
``run`` one node-event timeline (``chaos.seed``) and ``what-if`` one a
scenario past 0 (``chaos.seed + s``; scenario 0 stays clean, :150-169).
``run`` with ``strategy: cpu`` (or ``--strategy cpu``, the reference's
flag, :85-86) replays on the CPU event engine (:mod:`.sim.runtime`) with
only the telemetry and the chaos timeline, as the reference (:96-120), and
writes a ``replay-cpu`` row. ``tune`` scores on the CPU event engine when
the tuner's evaluator resolves to the host (``evaluator: cpu``, or ``auto``
with terms the batched sweep does not carry: config12). ``serve``
(:267-335) answers a ``service:`` section's NDJSON queries through the
resident query service (:mod:`.sim.service`). ``validate`` (:894-914)
prints the reference's JSON report of a config's checks
(:func:`validate_config`) and exits 1 where it lists an error.
``--profile-dir`` (:918-926) traces the command's run with
:func:`.utils.profiling.device_trace` and also arms the chunk loop's
annotations (``KSIM_PROFILE_DIR``), which the reference leaves to the
environment.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import yaml

from .framework.registry import get_strategy
from .utils.config import SimConfig, build_encoded_case, config_errors, workload_seed
from .utils.metrics import JsonlWriter, config_hash, log, replay_row, whatif_rows
from .utils.profiling import device_trace


def _load(path: str) -> SimConfig:
    """The config at ``path``; a ``workload.borg`` section, a ``nodeShards``
    / ``pagedWaves`` setting, a flight recorder or an ``overlap:`` gate that
    fails the reference's checks (kubernetes_simulator_tpu/cli.py:487-517,
    :671-693, :735-757, :860-882; :func:`.utils.config.config_errors`)
    raises ``ValueError`` listing them."""
    cfg = SimConfig.load(path)
    errors = config_errors(cfg)
    if errors:
        raise ValueError("invalid config: " + "; ".join(errors))
    return cfg


def _chaos_timeline(cfg, ec, ep, seed):
    """One seeded chaos campaign from the ``chaos:`` section (the horizon
    defaults to the trace's last arrival — later events could never fire),
    warning of events past that arrival, which the device engines never
    apply (they replay no chunk past the final wave)."""
    from .sim.synthetic import make_chaos_timeline

    ch = cfg.chaos
    last_arrival = float(ep.arrival.max())
    horizon = ch.horizon if ch.horizon is not None else last_arrival
    events = make_chaos_timeline(
        ec.num_nodes, seed=seed, horizon=horizon, mtbf=ch.mtbf, mttr=ch.mttr,
        node_fraction=ch.node_fraction, max_events=ch.max_events,
    )
    late = sum(1 for ev in events if ev.time > last_arrival)
    if late:
        log.warning(
            "chaos: %d event(s) beyond the trace's last arrival (t=%.1f; chaos.horizon=%.1f) — "
            "device engines stop at the final wave and will never apply them",
            late, last_arrival, horizon,
        )
    return events


def _chaos_on(cfg) -> bool:
    return cfg.chaos is not None and cfg.chaos.enabled


def _mesh(on: bool, device: str):
    """The scenario mesh of a ``mesh: true`` section: every local card, or
    the one device asked for off a card; None when off."""
    from .parallel.mesh import make_mesh

    if not on:
        return None
    dev = torch.device(device)
    return make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])


def cmd_run(args) -> int:
    cfg = _load(args.config)
    if args.strategy:
        cfg.strategy = args.strategy
    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    timeline_out = getattr(args, "timeline_out", None) or cfg.timeline_out
    gran = cfg.telemetry
    if timeline_out and gran != "off":
        gran = "timeline"  # a timeline sink needs timeline events
    t0 = time.perf_counter()
    ec, ep = build_encoded_case(cfg)
    t1 = time.perf_counter()
    log.info("encoded %d nodes / %d pods", ec.num_nodes, ep.num_pods)
    if cfg.strategy == "cpu":
        return _run_cpu(args, cfg, raw, ec, ep, gran, timeline_out)
    kw = {}
    if cfg.flight_recorder is not None:
        from .sim.flight import FlightRecorderConfig

        kw["flight_recorder"] = FlightRecorderConfig(path=cfg.flight_recorder.path,
                                                     every=cfg.flight_recorder.every)
    ov = cfg.overlap
    if ov is not None:
        if ov.pager_thread is not None:
            kw["pager_thread"] = ov.pager_thread
        if ov.two_phase_exchange is not None:
            log.info("overlap.twoPhaseExchange: %s — either value runs K9's one selection "
                     "exchange inside the thread-block cluster (placements are the same)",
                     str(ov.two_phase_exchange).lower())
    engine = get_strategy("torch")(
        ec, ep, cfg.framework,
        wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        telemetry=gran, device=args.device, preemption=cfg.device_preemption,
        retry_buffer=cfg.whatif.retry_buffer, node_shards=cfg.node_shards,
        paged=cfg.paged_waves, **kw,
    )
    log.info("set-up: trace %.3fs, engine %.3fs (%s)", t1 - t0, time.perf_counter() - t1,
             ", ".join(f"{k} {v:.3f}s" for k, v in engine.setup_s.items()))
    context = {
        "seed": workload_seed(cfg), "engine": "torch", "config_hash": config_hash(raw),
    }
    events = None
    if _chaos_on(cfg):
        events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed)
        log.info("chaos: injecting %d node events", len(events))
    with JsonlWriter(cfg.output, context=context) as out:
        with device_trace(args.profile_dir):
            res = engine.replay(node_events=events) if events else engine.replay()
        out.write(replay_row("replay-torch", res, {"config": args.config,
                                                   "device": str(engine.device)}))
    _write_timeline(timeline_out, res, ec, ep)
    log.info(
        "placed %d/%d pods in %.3fs (%.0f placements/sec) on %s, route %s",
        res.placed, res.placed + res.unschedulable, res.wall_clock_s,
        res.placements_per_sec, engine.device, res.route,
    )
    return 0


def _run_cpu(args, cfg, raw: dict, ec, ep, gran: str, timeline_out) -> int:
    """``run`` on the CPU event engine (``strategy: cpu``): as the reference
    (kubernetes_simulator_tpu/cli.py:96-120) it takes only the telemetry
    granularity and the chaos timeline, and writes a ``replay-cpu`` row."""
    engine = get_strategy("cpu")(ec, ep, cfg.framework, telemetry=gran)
    context = {
        "seed": workload_seed(cfg), "engine": "cpu", "config_hash": config_hash(raw),
    }
    events = None
    if _chaos_on(cfg):
        events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed)
        log.info("chaos: injecting %d node events", len(events))
    with JsonlWriter(cfg.output, context=context) as out:
        with device_trace(args.profile_dir):
            res = engine.replay(node_events=events) if events else engine.replay()
        out.write(replay_row("replay-cpu", res, {"config": args.config, "device": "cpu"}))
    _write_timeline(timeline_out, res, ec, ep)
    log.info(
        "placed %d/%d pods in %.3fs (%.0f placements/sec) on the CPU event engine",
        res.placed, res.placed + res.unschedulable, res.wall_clock_s, res.placements_per_sec,
    )
    return 0


def _write_timeline(timeline_out, res, ec, ep) -> None:
    """The Chrome trace of ``res`` at ``timeline_out`` (when both are set)."""
    if timeline_out and res.telemetry is not None:
        from .sim.telemetry import write_chrome_trace

        n_ev = write_chrome_trace(
            timeline_out, res, arrival=ep.arrival, duration=ep.duration,
            requests=ep.requests, rindex=ec.vocab._r,
        )
        log.info("timeline: wrote %d trace events to %s", n_ev, timeline_out)


def cmd_whatif(args) -> int:
    from .sim.whatif import WhatIfEngine, uniform_scenarios

    cfg = _load(args.config)
    if cfg.whatif.scenarios <= 0:
        log.error("config has no whatIf.scenarios")
        return 2
    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    ec, ep = build_encoded_case(cfg)
    scen = uniform_scenarios(
        ec, cfg.whatif.scenarios, seed=cfg.whatif.seed, p_node_down=cfg.whatif.node_down_p,
        p_capacity=cfg.whatif.capacity_p, p_taint=cfg.whatif.taint_p,
    )
    if _chaos_on(cfg):
        # A failure sweep: scenario 0 stays the clean reference, every other
        # scenario gets its own seeded timeline.
        n_ev = 0
        for s in range(1, len(scen)):
            scen[s].events = _chaos_timeline(cfg, ec, ep, cfg.chaos.seed + s)
            n_ev += len(scen[s].events)
        log.info("chaos: %d timed events across %d scenario timelines", n_ev, len(scen) - 1)
    mesh = _mesh(cfg.whatif.mesh, args.device)
    eng = WhatIfEngine(
        ec, ep, scen, cfg.framework, wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        completions=cfg.whatif.completions, telemetry=cfg.telemetry, device=args.device,
        preemption=cfg.device_preemption, retry_buffer=cfg.whatif.retry_buffer, mesh=mesh,
    )
    context = {
        "seed": workload_seed(cfg), "engine": "torch", "config_hash": config_hash(raw),
    }
    with JsonlWriter(cfg.output, context=context) as out, device_trace(args.profile_dir):
        res = eng.run()
        for row in whatif_rows(res, {"config": args.config, "mesh": bool(mesh),
                                     "device": str(eng.device)}):
            out.write(row)
    log.info(
        "what-if: %d scenarios, %d placements in %.3fs (%.0f placements/sec aggregate) on %s, "
        "route %s%s",
        len(scen), res.total_placed, res.wall_clock_s, res.placements_per_sec, eng.device,
        res.route, f", mesh of {res.n_devices} device(s)" if mesh else "",
    )
    return 0


def cmd_tune(args) -> int:
    from .sim.tuner import PolicyTuner, tune_config_errors

    cfg = _load(args.config)
    if cfg.tune is None:
        log.error("config has no tune: section")
        return 2
    tu = cfg.tune
    errors = tune_config_errors(tu)
    if errors:
        for e in errors:
            log.error("config: %s", e)
        return 2
    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    ec, ep = build_encoded_case(cfg)
    log.info("encoded %d nodes / %d pods", ec.num_nodes, ep.num_pods)
    tuner = PolicyTuner(
        ec, ep, cfg.framework,
        algo=tu.algo, population=tu.population, rounds=tu.rounds,
        seed=tu.seed, elite_frac=tu.elite_frac, objective=tu.objective,
        constraints=tu.constraints, evaluator=tu.evaluator,
        train_scenarios=tu.train_scenarios, heldout_scenarios=tu.heldout_scenarios,
        scenario_seed=tu.scenario_seed,
        p_node_down=tu.node_down_p, p_capacity=tu.capacity_p, p_taint=tu.taint_p,
        weight_bounds=tuple(tu.weight_bounds) if tu.weight_bounds else None,
        tune_strategy=tu.tune_strategy,
        wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        completions=cfg.whatif.completions, mesh=_mesh(tu.mesh, args.device),
        cpu_oracle=tu.cpu_oracle, cpu_envelope=tu.cpu_envelope, device=args.device,
    )
    # The reference's row context: the config's strategy names the engine.
    context = {
        "seed": workload_seed(cfg), "engine": cfg.strategy, "config_hash": config_hash(raw),
    }
    with JsonlWriter(tu.output or cfg.output, context=context) as out, \
            device_trace(args.profile_dir):
        res = tuner.run(writer=out)
    log.info(
        "tune: %s over %d rounds x %d candidates (%d evaluations, %d set-up%s) in %.3fs on %s",
        tu.algo, res.rounds, res.population, res.evaluations, res.compile_count or 0,
        "" if res.compile_count == 1 else "s", res.wall_clock_s,
        args.device if res.evaluator == "device" else "the CPU event engine",
    )
    log.info(
        "tune: held-out objective %.6f vs default %.6f (%s); best policy %s",
        res.heldout_objective, res.default_heldout_objective,
        "improved" if res.improved() else "no improvement", res.best_policy,
    )
    if res.cpu_envelope is not None:
        log.info("tune: CPU-oracle objective %.6f (envelope %.3g)",
                 res.cpu_objective, res.cpu_envelope)
    log.info("tune: walls set-up %.3fs, search %.3fs, held-out %.3fs, oracle %.3fs",
             res.phase_s["setup"], res.phase_s["search"], res.phase_s["heldout"],
             res.phase_s["oracle"])
    return 0


def cmd_serve(args) -> int:
    """The resident query service (the reference's ``cmd_serve``,
    kubernetes_simulator_tpu/cli.py:267-335): NDJSON what-if queries from
    ``service.input`` (a file or named pipe) or stdin, answered by a pooled
    :class:`~.sim.service.QueryService` on the card (``--device cpu``: the
    twins), schema-v7 ``query`` / ``query-result`` / ``query-error`` rows to
    the config's ``output``."""
    from .sim.service import QueryService, serve_lines

    cfg = SimConfig.load(args.config)
    if cfg.service is None:
        log.error("config has no service: section")
        return 2
    errors = config_errors(cfg)
    if errors:
        for e in errors:
            log.error("config: %s", e)
        return 2
    sv = cfg.service
    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    ec, ep = build_encoded_case(cfg)
    log.info("encoded %d nodes / %d pods", ec.num_nodes, ep.num_pods)
    flight = None
    if cfg.flight_recorder is not None:
        from .sim.flight import FlightRecorder, FlightRecorderConfig

        flight = FlightRecorder(
            FlightRecorderConfig(path=cfg.flight_recorder.path, every=cfg.flight_recorder.every),
            meta={"mode": "serve"},
        )
    # The reference's row context: the config's strategy names the engine.
    context = {
        "seed": workload_seed(cfg), "engine": cfg.strategy, "config_hash": config_hash(raw),
    }
    with JsonlWriter(cfg.output, context=context) as out:
        service = QueryService(
            ec, ep, cfg.framework,
            max_batch=sv.max_batch, batch_deadline_s=sv.batch_deadline_s,
            max_engines=sv.max_engines, granularity=sv.granularity,
            retry_buffer=sv.retry_buffer, writer=out, flight=flight,
            wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves, device=args.device,
        )
        try:
            with device_trace(args.profile_dir):
                if sv.input is not None:
                    # A named pipe blocks here until a producer connects.
                    with open(sv.input) as f:
                        stats = serve_lines(service, f, out)
                else:
                    stats = serve_lines(service, sys.stdin, out)
        finally:
            if flight is not None:
                flight.close()
    log.info(
        "serve: %d queries in %d batches (%d cold build%s, %d warm, %d error%s) on %s",
        stats["queries"], stats["batches"], stats["cold_builds"],
        "" if stats["cold_builds"] == 1 else "s", stats["warm_hits"], stats["errors"],
        "" if stats["errors"] == 1 else "s", args.device,
    )
    return 0


def validate_config(cfg: SimConfig) -> list:
    """The reference's structural checks of a config
    (kubernetes_simulator_tpu/cli.py:633-891 ``validate_config``), in its
    order and words, as actionable error strings (empty: valid): strategy,
    profile, workload, what-if, preemption, node shards and pages, chaos,
    tune, telemetry, chunk grid, flight recorder, overlap and service. The
    port's device strategies are ``jax`` and ``torch`` where the reference
    names its ``jax``; the fleet's sections never reach here (the parse
    refuses them, ROADMAP queue A item 11). One order differs: the reference
    lists kube's checks before the retry buffer's with
    ``whatIf.completions: false``, here after it."""
    import os

    from .framework.registry import available_strategies
    from .plugins.builtin import PLUGIN_FACTORIES
    from .sim import runtime as _rt  # noqa: F401  (registers "cpu")
    from .sim import torch_runtime as _trt  # noqa: F401  (registers "torch")
    from .sim.telemetry import _LEVELS
    from .utils.config import (STRATEGIES, borg_errors, chaos_errors, flight_errors,
                               kube_errors, overlap_errors, service_errors, shard_errors,
                               value_errors)

    errors = []
    known = sorted(set(available_strategies()) | set(STRATEGIES))
    if cfg.strategy not in known:
        errors.append(f"strategy: unknown '{cfg.strategy}' (registered: {', '.join(known)})")
    device = cfg.strategy != "cpu"
    ww = cfg.wave_width
    for e in cfg.framework.plugins or []:
        if not isinstance(e, dict) or "name" not in e:
            errors.append(f"profile.plugins: entry must be a mapping with name:, got {e!r}")
            continue
        if e.get("name") not in PLUGIN_FACTORIES:
            errors.append(f"profile.plugins: unknown plugin '{e.get('name')}' "
                          f"(known: {', '.join(sorted(PLUGIN_FACTORIES))})")
    for name, w in (cfg.framework.weights or {}).items():
        if name not in PLUGIN_FACTORIES:
            errors.append(f"profile.weights: unknown plugin '{name}'")
        elif not isinstance(w, (int, float)) or w < 0:
            errors.append(f"profile.weights.{name}: must be a number >= 0")
    if cfg.borg is not None:
        errors.extend(borg_errors(cfg))
    else:
        if cfg.cluster.nodes <= 0:
            errors.append("cluster.nodes: must be > 0")
        wl = cfg.workload
        if wl is not None:
            if wl.pods <= 0:
                errors.append("workload.pods: must be > 0")
            if wl.gang_fraction and wl.gang_size > ww:
                errors.append(f"workload.gangSize ({wl.gang_size}) exceeds waveWidth ({ww}): a "
                              "gang must fit in one wave")
    dp = cfg.device_preemption
    if cfg.whatif.scenarios < 0:
        errors.append("whatIf.scenarios: must be >= 0")
    errors.extend(value_errors(cfg) + kube_errors(cfg))
    errors.extend(shard_errors(cfg) + chaos_errors(cfg))
    errors.extend(_tune_errors(cfg))
    if cfg.telemetry not in _LEVELS:
        errors.append(f"telemetry.granularity: must be one of {', '.join(_LEVELS)}, got "
                      f"{cfg.telemetry!r}")
    if cfg.timeline_out:
        d = os.path.dirname(cfg.timeline_out) or "."
        if not os.path.isdir(d):
            errors.append(f"telemetry.timelineOut: directory not found: {d}")
    if cfg.chunk_waves <= 0:
        errors.append("chunkWaves: must be > 0")
    if ww <= 0:
        errors.append("waveWidth: must be > 0 (or 'auto')")
    if dp and not device:
        errors.append("devicePreemption requires strategy: jax (the cpu engine runs kube "
                      "PostFilter preemption instead)")
    if cfg.flight_recorder is not None and not device:
        errors.append("flightRecorder requires strategy: jax (the cpu engine has no chunk "
                      "loop to record)")
    errors.extend(flight_errors(cfg))
    errors.extend(overlap_errors(cfg))
    errors.extend(service_errors(cfg))
    return errors


def _tune_errors(cfg: SimConfig) -> list:
    """The reference's checks of a ``tune:`` section (cli.py:782-843)."""
    tu = cfg.tune
    if tu is None:
        return []
    from .sim.tuner import _ALWAYS_METRICS, _RESULT_METRICS, normalize_constraints

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
        errors.append("tune.scenarios: train and heldout must both be >= 1 (the acceptance "
                      "check runs on the held-out split)")
    if tu.evaluator not in ("auto", "device", "cpu"):
        errors.append(f"tune.evaluator: must be 'auto', 'device' or 'cpu', got "
                      f"{tu.evaluator!r}")
    try:
        cons = normalize_constraints(tu.constraints)
    except ValueError as e:
        errors.append(f"tune.constraints: {e}")
        cons = []
    for term in list(tu.objective or {}) + [c["metric"] for c in cons]:
        if term not in _RESULT_METRICS:
            errors.append(f"tune.objective: unknown term '{term}' (known: "
                          f"{', '.join(sorted(_RESULT_METRICS))})")
        elif term not in _ALWAYS_METRICS and tu.evaluator == "device":
            errors.append(f"tune.objective: term '{term}' rides the kube host mirrors, which "
                          "the batched policy sweep does not support — drop 'evaluator: "
                          f"device' or use terms from {', '.join(sorted(_ALWAYS_METRICS))}")
    wb = tu.weight_bounds
    if wb is not None and (len(wb) != 2 or wb[0] >= wb[1]):
        errors.append("tune.weightBounds: must be [lo, hi] with lo < hi")
    if tu.cpu_envelope < 0:
        errors.append("tune.cpuEnvelope: must be >= 0")
    return errors


def cmd_validate(args) -> int:
    """Print the reference's JSON report of a config's checks (cli.py:894-914)
    and exit 1 where it lists an error. A parse-time error (a malformed
    value, a section the port refuses: the fleet's ``dcn`` and
    ``faultline``, ROADMAP queue A item 11) is the report's only error."""
    import json

    try:
        with open(args.config) as f:
            cfg = SimConfig.parse(yaml.safe_load(f) or {})
    except (ValueError, KeyError, NotImplementedError) as e:
        print(json.dumps({"errors": [str(e)]}, indent=2))
        return 1
    errors = validate_config(cfg)
    nodes = cfg.borg.nodes if cfg.borg else cfg.cluster.nodes
    tasks = cfg.borg.tasks if cfg.borg else (cfg.workload.pods if cfg.workload else 1000)
    print(json.dumps({"strategy": cfg.strategy, "nodes": nodes, "tasks": tasks,
                      "workload": "borg" if cfg.borg else "synthetic",
                      "devicePreemption": cfg.device_preemption,
                      "whatif_scenarios": cfg.whatif.scenarios,
                      "errors": errors}, indent=2))
    return 1 if errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_simulator_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn, text in (
        ("run", cmd_run, "replay a config's trace"),
        ("what-if", cmd_whatif, "run a config's what-if scenario batch"),
        ("tune", cmd_tune, "search a config's scheduler Score policy (the tune: section)"),
        ("serve", cmd_serve, "answer NDJSON what-if queries (the service: section)"),
        ("validate", cmd_validate, "check a config and print the report as JSON"),
    ):
        r = sub.add_parser(name, help=text)
        r.add_argument("config")
        r.add_argument(
            "--profile-dir", default=None,
            help="torch.profiler trace output dir (arms the chunk loop's annotations)",
        )
        r.add_argument(
            "--device", default="cuda",
            help="torch device (default cuda: the kernels; cpu: their plain twins)",
        )
        if name == "run":
            r.add_argument(
                "--strategy", choices=["cpu", "jax", "torch"],
                help="override the config's strategy (cpu: the CPU event engine)",
            )
            r.add_argument(
                "--timeline-out", default=None,
                help="write the simulated cluster timeline as a Chrome trace JSON "
                     "(Perfetto-loadable); implies telemetry granularity 'timeline'",
            )
        r.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    if args.profile_dir:
        import os

        # The annotations (utils/profiling.py) arm on KSIM_PROFILE_DIR; an
        # operator's explicit value wins.
        os.environ.setdefault("KSIM_PROFILE_DIR", args.profile_dir)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
