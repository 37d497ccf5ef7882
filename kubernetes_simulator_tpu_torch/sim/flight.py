"""Flight recorder: streaming in-flight observability for long replays —
one JSONL event per chunk boundary (plus one per page stall) so an
hour-scale Borg-headline run is watchable while it executes and
attributable afterwards.

Counterpart: ``kubernetes_simulator_tpu/sim/flight.py`` —
``FLIGHT_WALL_FIELDS``, ``rss_peak_mib``, ``FlightRecorderConfig`` (:93),
``FlightRecorder`` (:117; ``chunk`` :171, ``page`` :267, ``fold`` :305,
``close`` :374) and ``read_stream`` (:438), copied; rows go through the
port's :class:`..utils.metrics.JsonlWriter`, so the stream is the
reference's schema and ``scripts/bottleneck_report.py`` reads it unchanged.

Every row carries the virtual time at the chunk boundary, the slots
dispatched so far, a rolling placements-per-second gauge, the phase-timer
deltas since the previous row, the pager's state (prefetch depth, misses,
exposed wall, waits, prefetch wall, invalidations) and the host RSS
high-water; the ``start`` row the residency estimate
(``replicated_resident_bytes``). ``KSIM_DETERMINISTIC_JSONL=1`` zeroes the
wall-derived fields (``FLIGHT_WALL_FIELDS``), so a fixed-seed stream is
byte-stable.

The recorder is off by default and only reads clocks and counters at
chunk cadence (:meth:`..sim.torch_runtime.TorchReplayEngine.replay` calls
it after each chunk's launches are enqueued): no launch, no
synchronisation, no change to a placement. Where the port's single replay
differs from the reference's loop, its rows differ so:

- ``placed`` rides only the ``end`` row. The reference's chunk rows carry
  its host fold of the fetched choices (completions on, and the boundary
  mirror's count on the retry path); the port fetches the choice buffer
  once a run, so a per-chunk count would cost a synchronisation a chunk.
  The rolling gauge reads ``dispatched``.
- No ``boundary_fold`` row. The reference writes one where its retry path
  folds a chunk into the host mirror (sim/jax_runtime.py:1690, :1852);
  the port has no mirror: K6's retry mode runs the boundary on the card
  inside the chunk's one launch, the host never waits for it, and its
  cost is inside the chunk's ``dispatch`` and the run's ``device_wait``.
  :meth:`FlightRecorder.fold` stays, unused.
- No ``exchange_probe_s`` (nor ``exchange_slots`` / ``exchange_est_s``).
  The reference times a probe of its per-slot cross-device selection
  exchange under ``nodeShards``; K9 exchanges inside the thread-block
  cluster of each slot, with nothing on the host to time.
- The phase deltas are the port's phases (``dispatch``,
  ``dispatch_<route>``): the reference's ``host_mirror`` releases are K3's
  or K8's launches here.

The ``checkpoint``, ``query`` and ``fleet`` rows and the per-process sink
suffix are the reference's and fire only with the modes that emit them
(the single replay's checkpoints, the service, the fleet: ROADMAP queue A
item 11);
:data:`EVENT_SINKS` is where the fleet's events would arrive.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from .telemetry import PhaseTimers

# Wall-clock-derived row fields zeroed under KSIM_DETERMINISTIC_JSONL
# (kept PRESENT as numbers so schema-v5 validation still sees them).
# Values inside the "phases" delta dict are zeroed too — phase timers
# are perf_counter deltas. Everything else in a flight row (chunk
# cursor, virtual time, dispatch/placement counts, pager stall/
# invalidation COUNTS, prefetch depth, checkpoint blob bytes, residency
# estimate) is deterministic for a fixed seed and stays.
# ``pager_waits`` is a COUNT but rides this list anyway: whether a
# threaded prefetch finished before ``get`` asked is a race outcome
# (round 19), unlike miss/invalidation counts which are structural.
FLIGHT_WALL_FIELDS = (
    "wall_s",
    "rolling_pps",
    "stall_s",
    # Round 21: the renewal age observed at a steal/speculate decision
    # is wall-clock evidence (the threshold it exceeded is config and
    # stays). Trace stamps (trace/span/parent/link) are handled in
    # _emit: dropped entirely in deterministic mode so streams are
    # byte-identical with KSIM_TRACE on and off.
    "renew_age_s",
    "pager_stall_s",
    "pager_prefetch_s",
    "pager_wait_s",
    "pager_waits",
    "exchange_probe_s",
    "exchange_est_s",
    "ckpt_wall_s",
    "rss_peak_mib",
    # Round 22: serving-plane query rows carry the batch's wall latency
    # (cold-vs-warm evidence). Queue depth / occupancy / warm flag are
    # structural and stay.
    "latency_s",
)

#: Sinks of fleet coordination events (the reference's
#: ``parallel.dcn.EVENT_SINKS``): a live recorder registers
#: :meth:`FlightRecorder.fleet_event` here. Nothing in the port emits
#: fleet events before the fleet is ported (ROADMAP queue A item 11).
EVENT_SINKS: list = []


def output_path_for_process(path: Optional[str], pid: int = 0) -> Optional[str]:
    """Per-process sink (the reference's ``parallel.dcn
    .output_path_for_process``): process 0 keeps ``path``, process ``pid``
    writes ``<path>.p<pid>``. The port runs one process."""
    if path is None:
        return None
    return path if pid == 0 else f"{path}.p{pid}"


# Rolling placements/sec window: events, not seconds — chunk cadence is
# workload-dependent and the gauge should react within a few chunks.
_ROLL_WINDOW = 8


def rss_peak_mib() -> float:
    """Host RSS high-water in MiB (``getrusage`` ``ru_maxrss``; KiB on
    Linux, bytes on macOS). 0.0 where the resource module is absent —
    never raises, the recorder must not take a run down."""
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        scale = 2**20 if sys.platform == "darwin" else 2**10
        return round(peak * scale / 2**20, 1)
    except Exception:
        return 0.0


@dataclass
class FlightRecorderConfig:
    """``flightRecorder:`` YAML section / ``flight_recorder=`` engine
    kwarg. ``path`` is the JSONL sink (suffixed ``.p<pid>`` per process
    under DCN, like every other sink); ``every`` is the chunk cadence
    (1 = every chunk boundary; page/checkpoint/fold events always
    emit)."""

    path: str
    every: int = 1

    @classmethod
    def resolve(cls, v) -> Optional["FlightRecorderConfig"]:
        """None stays None (recorder off — the default); a path string
        becomes a config; a config or live recorder passes through."""
        if v is None or isinstance(v, (FlightRecorderConfig, FlightRecorder)):
            return v
        if isinstance(v, str):
            return cls(path=v)
        raise ValueError(
            f"flight_recorder: expected a path, FlightRecorderConfig or "
            f"None, got {v!r}"
        )


class FlightRecorder:
    """Streaming JSONL emitter for one replay. Construct via
    :meth:`open` (engines) or directly with a config; call
    :meth:`chunk` once per chunk boundary and :meth:`page` /
    :meth:`checkpoint` / :meth:`fold` as those events occur, then
    :meth:`close`. Owns a :class:`PhaseTimers` so a telemetry-off run
    still gets phase deltas (the engine routes its ``_tick`` here when
    no collector exists)."""

    def __init__(self, cfg: FlightRecorderConfig, meta: Optional[dict] = None):
        from ..utils.metrics import JsonlWriter

        self.cfg = cfg
        self.phases = PhaseTimers()  # used when telemetry is off
        self._meta = dict(meta or {})
        self._writer = JsonlWriter(output_path_for_process(cfg.path))
        self._t0 = time.perf_counter()
        self._last_phases: Dict[str, float] = {}
        self._roll: deque = deque(maxlen=_ROLL_WINDOW)  # (wall, progressed)
        self._events = 0
        self._emit(
            {
                "event": "start",
                "chunk": -1,
                "wall_s": 0.0,
                "rss_peak_mib": rss_peak_mib(),
                **self._meta,
            }
        )
        # Fleet-event subscription: the fleet's lease/steal/claim events
        # land in this stream as "fleet" rows. Unregistered on close.
        self._fleet_sink = self.fleet_event
        EVENT_SINKS.append(self._fleet_sink)

    @classmethod
    def open(cls, spec, meta: Optional[dict] = None) -> Optional["FlightRecorder"]:
        """Engine entry point: ``spec`` is whatever the ``flight_recorder``
        kwarg carried (None / path / config / live recorder). Returns a
        live recorder or None (off). A recorder instance passes through
        so callers can share one across resume legs."""
        cfg = FlightRecorderConfig.resolve(spec)
        if cfg is None:
            return None
        if isinstance(cfg, FlightRecorder):
            return cfg
        return cls(cfg, meta=meta)

    # -- event emitters ----------------------------------------------------

    def chunk(
        self,
        ci: int,
        t_virtual: Optional[float] = None,
        dispatched: Optional[int] = None,
        placed: Optional[int] = None,
        phase_acc: Optional[Dict[str, float]] = None,
        pager=None,
        exchange_probe_s: Optional[float] = None,
        exchange_slots: Optional[int] = None,
        ckpt_publish: Optional[dict] = None,
        kv_retry: Optional[dict] = None,
    ) -> None:
        """One chunk-boundary row. ``phase_acc`` is the CUMULATIVE phase
        accumulator (the collector's or this recorder's own) — the row
        carries deltas since the previous chunk row. ``pager`` is a
        ``_PodPager`` (or anything with stalls/stall_s/prefetches/depth).
        ``exchange_probe_s`` is one timed round of the selection-exchange
        probe; ``exchange_est_s`` scales it to the chunk's slot count
        (the per-slot all_gather runs once per slot inside the scan).
        ``kv_retry`` (round 17) is the chunk's KV retry delta — retries
        burned, give-ups, backoff wall — attributing coordination-plane
        flakiness (real or faultline-injected) to the chunk it hit."""
        self._events += 1
        if self.cfg.every > 1 and (ci % self.cfg.every) != 0:
            return
        wall = time.perf_counter() - self._t0
        acc = dict(phase_acc if phase_acc is not None else self.phases.acc)
        delta = {
            k: round(v - self._last_phases.get(k, 0.0), 6)
            for k, v in sorted(acc.items())
        }
        self._last_phases = acc
        progressed = placed if placed is not None else dispatched
        rolling = 0.0
        if progressed is not None:
            self._roll.append((wall, int(progressed)))
            if len(self._roll) >= 2:
                (w0, p0), (w1, p1) = self._roll[0], self._roll[-1]
                if w1 > w0:
                    rolling = (p1 - p0) / (w1 - w0)
        row = {
            "event": "chunk",
            "chunk": int(ci),
            "wall_s": round(wall, 6),
            "rolling_pps": round(rolling, 1),
            "phases": delta,
            "rss_peak_mib": rss_peak_mib(),
        }
        if t_virtual is not None:
            import math

            row["t_virtual"] = (
                round(float(t_virtual), 6)
                if math.isfinite(float(t_virtual))
                else None
            )
        if dispatched is not None:
            row["dispatched"] = int(dispatched)
        if placed is not None:
            row["placed"] = int(placed)
        if pager is not None:
            row["pager_depth"] = int(getattr(pager, "depth", 0))
            row["pager_stalls"] = int(getattr(pager, "stalls", 0))
            row["pager_stall_s"] = round(
                float(getattr(pager, "stall_s", 0.0)), 6
            )
            # Round-19 overlap ledger: the prefetch fetches' own wall
            # (hidden when the pager thread is on, loop-exposed when
            # off), blocking waits on in-flight prefetches, and staged
            # pages invalidated by resume jumps. Always present so the
            # stream is byte-identical threaded on vs off under the
            # deterministic scrub.
            row["pager_prefetch_s"] = round(
                float(getattr(pager, "prefetch_wall_s", 0.0)), 6
            )
            row["pager_waits"] = int(getattr(pager, "waits", 0))
            row["pager_wait_s"] = round(
                float(getattr(pager, "wait_s", 0.0)), 6
            )
            row["pager_invalidations"] = int(
                getattr(pager, "invalidations", 0)
            )
        if exchange_probe_s is not None:
            row["exchange_probe_s"] = round(float(exchange_probe_s), 6)
            if exchange_slots:
                row["exchange_slots"] = int(exchange_slots)
                row["exchange_est_s"] = round(
                    float(exchange_probe_s) * int(exchange_slots), 6
                )
        if ckpt_publish:
            row["dcn_publish"] = dict(ckpt_publish)
        if kv_retry:
            row["dcn_retry"] = dict(kv_retry)
        self._emit(row)

    def page(
        self, ci: int, stall_s: float, stalls: int,
        invalidations: Optional[int] = None,
    ) -> None:
        """A pager prefetch MISS (the synchronous fetch the prefetch
        exists to hide) — emitted per stall, they are the exceptional
        case the report looks for. ``invalidations`` (round 19) rides
        along when a resume jump discarded the staged page: previously
        that surfaced as a plain stall, under-reporting what the pager
        threw away."""
        row = {
            "event": "page",
            "chunk": int(ci),
            "stall_s": round(float(stall_s), 6),
            "pager_stalls": int(stalls),
            "wall_s": round(time.perf_counter() - self._t0, 6),
        }
        if invalidations:
            row["pager_invalidations"] = int(invalidations)
        self._emit(row)

    def checkpoint(
        self, ci: int, nbytes: int, wall_s: float, sink: str = "local"
    ) -> None:
        """A checkpoint left the engine: ``sink`` is "local" (npz blob on
        disk) or "dcn" (KV publication). ``nbytes`` is the blob size —
        deterministic, so it survives the JSONL scrub."""
        self._emit(
            {
                "event": "checkpoint",
                "chunk": int(ci),
                "ckpt_bytes": int(nbytes),
                "ckpt_wall_s": round(float(wall_s), 6),
                "ckpt_sink": sink,
                "wall_s": round(time.perf_counter() - self._t0, 6),
            }
        )

    def fold(self, ci: int, wall_s: float) -> None:
        """A boundary-mode mirror fold resolved (the host-side D2H +
        bookkeeping the lazy path tries to overlap)."""
        self._emit(
            {
                "event": "boundary_fold",
                "chunk": int(ci),
                "stall_s": round(float(wall_s), 6),
                "wall_s": round(time.perf_counter() - self._t0, 6),
            }
        )

    def query(
        self,
        batch: int,
        queued: int,
        occupancy: float,
        warm: bool,
        latency_s: float,
        engines: int,
    ) -> None:
        """One serving-plane batch resolved (round 22, sim.service): how
        many queries coalesced, the scenario-axis occupancy, whether the
        pool answered warm (value swap against a resident executable) or
        cold (fresh compile), and the batch wall. Everything but
        ``latency_s`` is deterministic for a fixed query sequence."""
        self._emit(
            {
                "event": "query",
                "chunk": -1,
                "batch": int(batch),
                "queue_depth": int(queued),
                "batch_occupancy": round(float(occupancy), 4),
                "warm": bool(warm),
                "engines": int(engines),
                "latency_s": round(float(latency_s), 6),
                "wall_s": round(time.perf_counter() - self._t0, 6),
            }
        )

    def fleet_event(self, event: dict) -> None:
        """One fleet coordination event (parallel.dcn._mirror_event):
        lease / steal / speculate / block_done / spec_lost / join /
        claim / recovered, plus the round-20 durability events —
        journal_adopt (a completed block adopted from the durable
        journal without re-execution) and journal_resume (a checkpoint
        restore whose winning cursor came from the journal rather than
        the live KV store). Round 21 adds ckpt_load / ckpt_fallback and
        the faultline fault_* kinds, each stamped with its causal trace
        identity (trace/span/parent — parallel.trace) by dcn before this
        sink sees it. Flattened into the row — every field but the wall
        clocks is deterministic for a fixed schedule."""
        ev = dict(event)
        # ckpt_publish events name their kind under "kind" (pinned by
        # test_durable); pop BOTH so the payload can never shadow the
        # row's own kind="flight" stamp (round 21 fix — shadowed rows
        # were invisible to read_stream).
        kind = ev.pop("event", None) or ev.pop("kind", None) or "?"
        ev.pop("kind", None)
        self._emit(
            {
                "event": "fleet",
                "fleet_event": str(kind),
                "chunk": -1,
                "wall_s": round(time.perf_counter() - self._t0, 6),
                **ev,
            }
        )

    def close(self, summary: Optional[dict] = None) -> None:
        try:
            EVENT_SINKS.remove(self._fleet_sink)
        except ValueError:
            pass
        if self._writer is None:
            return
        row = {
            "event": "end",
            "chunk": -1,
            "wall_s": round(time.perf_counter() - self._t0, 6),
            "rss_peak_mib": rss_peak_mib(),
            "events": self._events,
        }
        if summary:
            row.update(summary)
        self._emit(row)
        self._writer.close()
        self._writer = None

    # -- plumbing ----------------------------------------------------------

    def _emit(self, row: dict) -> None:
        from ..utils.metrics import deterministic_jsonl

        if self._writer is None:
            return
        row = {"kind": "flight", **row}
        if deterministic_jsonl():
            for k in FLIGHT_WALL_FIELDS:
                if k in row:
                    row[k] = 0.0
            if isinstance(row.get("phases"), dict):
                row["phases"] = {k: 0.0 for k in row["phases"]}
            # Round 19: with the background publisher and the retrying
            # publisher thread interleaving KV traffic with the loop,
            # WHICH chunk row a publish/retry delta lands on is a race
            # outcome — every numeric in these blocks is scrubbed, not
            # just the ``_s`` walls.
            for blk in ("dcn_publish", "dcn_retry"):
                if isinstance(row.get(blk), dict):
                    row[blk] = {
                        k: (
                            (0.0 if isinstance(v, float) else 0)
                            if isinstance(v, (int, float))
                            and not isinstance(v, bool)
                            else v
                        )
                        for k, v in row[blk].items()
                    }
            # Round 21: trace identity fields are deterministic values
            # but their PRESENCE depends on KSIM_TRACE — drop them so
            # deterministic streams are byte-identical stamping-on vs
            # stamping-off (the parity bar); live streams keep them.
            for k in ("trace", "span", "parent", "link"):
                row.pop(k, None)
        try:
            self._writer.write(row)
        except OSError:
            # Telemetry must never take the replay down mid-flight; a
            # full disk degrades to a truncated stream, not a crash.
            self._writer = None


def read_stream(path: str):
    """Parsed flight rows from ``path`` (list of dicts, malformed lines
    skipped). Shared by bottleneck_report and the tests."""
    import json

    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and row.get("kind") == "flight":
                    rows.append(row)
    except OSError:
        return []
    return rows
