"""CLI of the port: replay a YAML config, or run its what-if batch, on
the card.

    python -m kubernetes_simulator_tpu_torch run config.yaml [--device cpu] [--timeline-out t.json]
    python -m kubernetes_simulator_tpu_torch what-if config.yaml [--device cpu]

Counterpart: ``kubernetes_simulator_tpu/cli.py`` (``cmd_run`` :83,
``cmd_whatif`` :140; both pass ``whatIf.retryBuffer``, :100 and :182). The config is parsed as the JAX package parses it
(utils.config); sections of modes the port does not carry yet are refused
with an error naming them. ``run`` writes one JSONL replay row,
``what-if`` the ``whatif_rows`` (stdout, or the config's ``output``), and
each an INFO summary line with placements/sec. ``run --timeline-out`` (or
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes_simulator_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn, text in (
        ("run", cmd_run, "replay a config's trace"),
        ("what-if", cmd_whatif, "run a config's what-if scenario batch"),
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
