"""CLI of the port: replay a YAML config, or run its what-if batch, on
the card.

    python -m kubernetes_simulator_tpu_torch run config.yaml [--device cpu] [--timeline-out t.json]
    python -m kubernetes_simulator_tpu_torch what-if config.yaml [--device cpu]
    python -m kubernetes_simulator_tpu_torch tune config.yaml [--device cpu]

Counterpart: ``kubernetes_simulator_tpu/cli.py`` (``cmd_run`` :83,
``cmd_whatif`` :140; both pass ``whatIf.retryBuffer``, :100 and :182;
``cmd_tune`` :205). The config is parsed as the JAX package parses it
(utils.config); sections of modes the port does not carry yet are refused
with an error naming them. ``run`` writes one JSONL replay row,
``what-if`` the ``whatif_rows`` (stdout, or the config's ``output``), and
each an INFO summary line with placements/sec; ``tune`` writes the
policy search's trajectory (schema-v3 rows without a wall-clock stamp, to
``tune.output`` or ``output``) and INFO lines with the winner, the
held-out objectives, the CPU oracle's envelope and the walls. ``run --timeline-out`` (or
``telemetry.timelineOut``) collects at granularity ``timeline`` and writes
the simulated cluster timeline as a Chrome trace (:87-129).
"""

from __future__ import annotations

import argparse
import sys

import yaml

from .framework.registry import get_strategy
from .utils.config import SimConfig, build_encoded_case
from .utils.metrics import JsonlWriter, config_hash, log, replay_row, whatif_rows


def cmd_run(args) -> int:
    cfg = SimConfig.load(args.config)
    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    timeline_out = getattr(args, "timeline_out", None) or cfg.timeline_out
    gran = cfg.telemetry
    if timeline_out and gran != "off":
        gran = "timeline"  # a timeline sink needs timeline events
    ec, ep = build_encoded_case(cfg)
    log.info("encoded %d nodes / %d pods", ec.num_nodes, ep.num_pods)
    engine = get_strategy("torch")(
        ec, ep, cfg.framework,
        wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        telemetry=gran, device=args.device, preemption=cfg.device_preemption,
        retry_buffer=cfg.whatif.retry_buffer,
    )
    context = {
        "seed": int(cfg.workload.seed), "engine": "torch", "config_hash": config_hash(raw),
    }
    with JsonlWriter(cfg.output, context=context) as out:
        res = engine.replay()
        out.write(replay_row("replay-torch", res, {"config": args.config,
                                                   "device": str(engine.device)}))
    if timeline_out and res.telemetry is not None:
        from .sim.telemetry import write_chrome_trace

        n_ev = write_chrome_trace(
            timeline_out, res, arrival=ep.arrival, duration=ep.duration,
            requests=ep.requests, rindex=ec.vocab._r,
        )
        log.info("timeline: wrote %d trace events to %s", n_ev, timeline_out)
    log.info(
        "placed %d/%d pods in %.3fs (%.0f placements/sec) on %s",
        res.placed, res.placed + res.unschedulable, res.wall_clock_s,
        res.placements_per_sec, engine.device,
    )
    return 0


def cmd_whatif(args) -> int:
    from .sim.whatif import WhatIfEngine, uniform_scenarios

    cfg = SimConfig.load(args.config)
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
    eng = WhatIfEngine(
        ec, ep, scen, cfg.framework, wave_width=cfg.wave_width, chunk_waves=cfg.chunk_waves,
        completions=cfg.whatif.completions, telemetry=cfg.telemetry, device=args.device,
        preemption=cfg.device_preemption, retry_buffer=cfg.whatif.retry_buffer,
    )
    context = {
        "seed": int(cfg.workload.seed), "engine": "torch", "config_hash": config_hash(raw),
    }
    with JsonlWriter(cfg.output, context=context) as out:
        res = eng.run()
        for row in whatif_rows(res, {"config": args.config, "mesh": False,
                                     "device": str(eng.device)}):
            out.write(row)
    log.info(
        "what-if: %d scenarios, %d placements in %.3fs (%.0f placements/sec aggregate) on %s",
        len(scen), res.total_placed, res.wall_clock_s, res.placements_per_sec, eng.device,
    )
    return 0


def cmd_tune(args) -> int:
    from .sim.tuner import PolicyTuner, tune_config_errors

    cfg = SimConfig.load(args.config)
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
        completions=cfg.whatif.completions,
        cpu_oracle=tu.cpu_oracle, cpu_envelope=tu.cpu_envelope, device=args.device,
    )
    # The reference's row context: the config's strategy names the engine.
    context = {
        "seed": int(cfg.workload.seed), "engine": cfg.strategy, "config_hash": config_hash(raw),
    }
    with JsonlWriter(tu.output or cfg.output, context=context) as out:
        res = tuner.run(writer=out)
    log.info(
        "tune: %s over %d rounds x %d candidates (%d evaluations, %d set-up%s) in %.3fs on %s",
        tu.algo, res.rounds, res.population, res.evaluations, res.compile_count,
        "" if res.compile_count == 1 else "s", res.wall_clock_s, args.device,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_simulator_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn, text in (
        ("run", cmd_run, "replay a config's trace"),
        ("what-if", cmd_whatif, "run a config's what-if scenario batch"),
        ("tune", cmd_tune, "search a config's scheduler Score policy (the tune: section)"),
    ):
        r = sub.add_parser(name, help=text)
        r.add_argument("config")
        r.add_argument(
            "--device", default="cuda",
            help="torch device (default cuda: the kernels; cpu: their plain twins)",
        )
        if name == "run":
            r.add_argument(
                "--timeline-out", default=None,
                help="write the simulated cluster timeline as a Chrome trace JSON "
                     "(Perfetto-loadable); implies telemetry granularity 'timeline'",
            )
        r.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
