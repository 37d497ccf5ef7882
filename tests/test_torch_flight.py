"""The port's flight recorder (kubernetes_simulator_tpu_torch.sim.flight), its
pager gate and counters, and the ``overlap:`` section, on the CPU at small
sizes, against the JAX package's (tests/test_flight.py, tests/test_overlap.py).

The recorder is an observer: placements are the same with it on and off in
every single-replay mode the port runs (plain, node shards, paged pod waves,
the retry buffer) and with the pager's thread on and off; a fixed-seed
stream is byte-stable under KSIM_DETERMINISTIC_JSONL; its rows follow the
JAX recorder's field by field over the deterministic fields, except where
the module docstring of sim/flight.py says the port's loop differs; and
scripts/bottleneck_report.py and scripts/check_metrics_schema.py read it.
Inputs are made from seeds by the JAX package's generators and carried into
the port as numpy arrays (tests/torch_port_case.py)."""

import json
import os
import sys
import time

import numpy as np
import pytest
import yaml

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.flight import read_stream as j_read_stream
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch import cli
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim.flight import (
    FLIGHT_WALL_FIELDS,
    FlightRecorder,
    FlightRecorderConfig,
    read_stream,
    rss_peak_mib,
)
from kubernetes_simulator_tpu_torch.sim.pager import PodPager
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine
from kubernetes_simulator_tpu_torch.utils.config import SimConfig, config_errors

from torch_port_case import port_case

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.abspath(os.path.join(ROOT, "scripts")))

#: Engine modes of tests/test_flight.py that the port runs (its kube
#: boundary mode is not ported; the retry buffer is the port's boundary path).
MODES = {
    "plain": {},
    "nodeShards": {"node_shards": 2},
    "pagedWaves": {"paged": True},
    "pagedWaves-unthreaded": {"paged": True, "pager_thread": False},
    "retryBuffer": {"retry_buffer": 64},
}

#: Fields of the JAX recorder's rows that the port's rows do not carry, and
#: why (sim/flight.py's module docstring).
SKIPPED = {
    # the reference's host fold of fetched choices; the port fetches once a
    # run, so ``placed`` rides the end row only
    "placed": "chunk rows only",
    # phase names are each engine's own (the reference's host_mirror
    # releases are K3's launches in the port); the values are wall clock
    "phases": "engine-specific keys",
    # the reference's timed probe of its cross-device exchange; K9
    # exchanges inside the thread-block cluster
    "exchange_probe_s": "no host exchange", "exchange_slots": "no host exchange",
    "exchange_est_s": "no host exchange",
}
#: Row kinds the reference writes and the port does not: its retry path's
#: host-mirror folds (the port runs the boundary inside K6's retry mode).
SKIPPED_EVENTS = ("boundary_fold",)


def _case(n_nodes=24, n_pods=160, seed=7):
    """tests/test_flight.py's case."""
    cluster = make_cluster(n_nodes, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(
        n_pods, seed=seed, with_affinity=True, with_spread=True,
        with_tolerations=True, gang_fraction=0.1, gang_size=4,
        duration_mean=40.0,
    )
    return encode(cluster, pods)


@pytest.fixture(scope="module")
def case():
    ec, ep = _case()
    return ec, ep, port_case(ec, ep)


def _replay(pcase, **kw):
    pec, pep = pcase
    return TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=4, device="cpu",
                             telemetry="off", **kw).replay()


def _stable_summary(res):
    row = dict(res.summary())
    for k in ("wall_clock_s", "placements_per_sec"):
        row.pop(k, None)
    return row


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recorder_bit_parity(case, tmp_path, mode):
    """Recorder on vs off, and the pager's thread on vs off: the same
    assignments and stable summaries; the stream opens, records every chunk
    boundary and closes with the placed count."""
    _, _, pcase = case
    off = _replay(pcase, **MODES[mode])
    path = str(tmp_path / f"{mode}.jsonl")
    on = _replay(pcase, flight_recorder=path, **MODES[mode])
    np.testing.assert_array_equal(on.assignments, off.assignments)
    assert _stable_summary(on) == _stable_summary(off)
    rows = read_stream(path)
    assert rows[0]["event"] == "start" and rows[-1]["event"] == "end"
    assert rows[-1]["placed"] == on.placed
    eng = TorchReplayEngine(*pcase, chunk_waves=4, device="cpu", **MODES[mode])
    chunks = [r["chunk"] for r in rows if r["event"] == "chunk"]
    assert chunks == list(range(len(eng.plan.buckets))) == list(range(rows[-1]["events"]))


def test_deterministic_stream_byte_stable(case, tmp_path, monkeypatch):
    """Under KSIM_DETERMINISTIC_JSONL the replay row is byte-identical with
    the recorder on and off, two streams of the same run are byte-identical
    (paged: the pager's thread on in one, off in the other), and every
    wall-derived field is zero."""
    from kubernetes_simulator_tpu_torch.utils.metrics import JsonlWriter, replay_row

    monkeypatch.setenv("KSIM_DETERMINISTIC_JSONL", "1")
    _, _, pcase = case
    blobs = {}
    for tag, kw in (("off", {}), ("on1", dict(flight_recorder=str(tmp_path / "f1.jsonl"))),
                    ("on2", dict(flight_recorder=str(tmp_path / "f2.jsonl"),
                                 pager_thread=False))):
        res = _replay(pcase, paged=True, **kw)
        p = tmp_path / f"res_{tag}.jsonl"
        with JsonlWriter(str(p)) as w:
            w.write(replay_row("replay-torch", res))
        blobs[tag] = p.read_bytes()
    assert blobs["off"] == blobs["on1"] == blobs["on2"]
    assert (tmp_path / "f1.jsonl").read_bytes() == (tmp_path / "f2.jsonl").read_bytes()
    rows = read_stream(str(tmp_path / "f1.jsonl"))
    assert any(r["event"] == "page" for r in rows)
    for row in rows:
        for k in FLIGHT_WALL_FIELDS:
            if k in row:
                assert row[k] == 0.0, f"{row['event']}: {k} not scrubbed"
        assert all(v == 0.0 for v in (row.get("phases") or {}).values())


def _comparable(rows):
    """The rows' deterministic fields, SKIPPED and SKIPPED_EVENTS left out."""
    out = []
    for r in rows:
        if r["event"] in SKIPPED_EVENTS:
            continue
        out.append({k: v for k, v in r.items() if k not in SKIPPED or r["event"] == "end"})
    return out


@pytest.mark.parametrize("mode", ["pagedWaves", "retryBuffer"])
def test_stream_equals_reference_stream(case, tmp_path, monkeypatch, mode):
    """The port's deterministic stream against the JAX recorder's on the
    same case, field by field: start metadata (nodes, pods, shards, paged,
    engine, chunk waves, residency estimate), each chunk row's index,
    virtual time, dispatched slots and pager gauges, each page row, the
    end row's event count and placed. Skipped: SKIPPED's fields and
    SKIPPED_EVENTS' rows (reasons there)."""
    monkeypatch.setenv("KSIM_DETERMINISTIC_JSONL", "1")
    ec, ep, pcase = case
    kw = {k: v for k, v in MODES[mode].items() if k != "pager_thread"}
    JaxReplayEngine(ec, ep, J_Config(), chunk_waves=4, telemetry="off",
                    flight_recorder=str(tmp_path / "j.jsonl"), **kw).replay()
    _replay(pcase, flight_recorder=str(tmp_path / "t.jsonl"), **kw)
    want = j_read_stream(str(tmp_path / "j.jsonl"))
    got = read_stream(str(tmp_path / "t.jsonl"))
    if mode == "retryBuffer":
        assert any(r["event"] == "boundary_fold" for r in want)
    assert _comparable(got) == _comparable(want)


def test_recorder_every_cadence(case, tmp_path):
    """every=N thins chunk rows to the cadence, as the reference's
    FlightRecorder does; page rows, start and end always emit."""
    rec = FlightRecorder(FlightRecorderConfig(path=str(tmp_path / "f.jsonl"), every=3))
    for ci in range(7):
        rec.chunk(ci, dispatched=ci)
    rec.close()
    rows = read_stream(str(tmp_path / "f.jsonl"))
    assert [r["chunk"] for r in rows if r["event"] == "chunk"] == [0, 3, 6]
    _, _, pcase = case
    path = str(tmp_path / "e.jsonl")
    _replay(pcase, paged=True, flight_recorder=FlightRecorderConfig(path=path, every=2))
    rows = read_stream(path)
    n = rows[-1]["events"]
    assert [r["chunk"] for r in rows if r["event"] == "chunk"] == list(range(0, n, 2))
    assert [r["chunk"] for r in rows if r["event"] == "page"] == [0]
    assert FlightRecorderConfig.resolve(None) is None
    assert FlightRecorderConfig.resolve("x.jsonl").every == 1
    with pytest.raises(ValueError, match="flight_recorder"):
        FlightRecorderConfig.resolve(123)
    assert rss_peak_mib() > 0.0


@pytest.mark.parametrize("threaded", [True, False])
def test_pager_stall_counters_on_crafted_slow_page_trace(case, threaded):
    """tests/test_flight.py's crafted slow page: a sleeping gather, a
    prefetch-miss access pattern, exact miss counts, a wall bound; a
    prefetch the loop reaches before the worker is done is a wait, not a
    miss; a page staged for another chunk is an invalidation."""
    _, _, (pec, pep) = case
    eng = TorchReplayEngine(pec, pep, chunk_waves=1, device="cpu", paged=True)
    plan = eng.plan
    DELAY = 0.02
    pager = PodPager(pep, plan.idx, plan.C, plan.buckets, "cpu", threaded=threaded)
    fetched = []
    fetch = pager._fetch

    def slow_fetch(c):
        fetched.append(c)
        time.sleep(DELAY)
        return fetch(c)

    pager._fetch = slow_fetch
    try:
        assert (pager.depth, pager.stalls, pager.prefetches) == (0, 0, 0)
        pager.get(0)  # nothing prefetched: a miss
        assert pager.stalls == 1 and pager.stall_s >= DELAY and pager.last_stall_s >= DELAY
        pager.prefetch(1)
        assert pager.depth == 1 and pager.prefetches == 1
        pager.get(1)  # prefetched: no miss (threaded: a wait on the worker)
        assert pager.stalls == 1 and pager.depth == 0
        assert pager.waits == (1 if threaded else 0)
        assert pager.prefetch_wall_s >= DELAY
        pager.prefetch(2)
        pager.get(5)  # a jump: the staged page dropped, a second miss
        assert (pager.stalls, pager.invalidations) == (2, 1)
        assert pager.stall_s >= 2 * DELAY
        assert fetched == [0, 1, 2, 5]
    finally:
        pager.close()


def test_page_rows_equal_the_pagers_counts(case, tmp_path):
    """A paged replay's stream: a page row for each miss, the chunk rows'
    pager gauges ending at the pager's own counts."""
    _, _, pcase = case
    path = str(tmp_path / "p.jsonl")
    eng = TorchReplayEngine(*pcase, chunk_waves=4, device="cpu", paged=True,
                            flight_recorder=path)
    eng.replay()
    rows = read_stream(path)
    pages = [r for r in rows if r["event"] == "page"]
    chunks = [r for r in rows if r["event"] == "chunk"]
    pager = eng.last_pager
    assert len(pages) == pager.stalls + pager.invalidations >= 1
    assert pages[-1]["pager_stalls"] == pager.stalls
    assert all("pager_stalls" in r and "pager_depth" in r for r in chunks)
    last = chunks[-1]
    assert (last["pager_stalls"], last["pager_waits"], last["pager_depth"]) == (
        pager.stalls, pager.waits, 0)
    assert last["pager_prefetch_s"] == round(pager.prefetch_wall_s, 6)


def test_bottleneck_report_and_schema_read_the_port_stream(case, tmp_path, capsys):
    """scripts/bottleneck_report.py (through the JAX package's read_stream)
    names a regime from a port stream, and the stream validates against the
    row schema."""
    from bottleneck_report import REGIMES, main as report_main  # noqa: E402
    from check_metrics_schema import validate_file  # noqa: E402

    _, _, pcase = case
    path = str(tmp_path / "fl.jsonl")
    _replay(pcase, node_shards=2, paged=True, flight_recorder=path)
    assert validate_file(path) == []
    assert report_main([path]) == 0
    out = capsys.readouterr().out
    assert "DOMINANT REGIME:" in out and any(r in out for r in REGIMES)


# -- the overlap: section (tests/test_overlap.py's cases) ------------------


def test_overlap_spec_parsing():
    cfg = SimConfig.from_dict({
        "strategy": "jax",
        "overlap": {"pagerThread": True, "twoPhaseExchange": False},
    })
    assert cfg.overlap.pager_thread is True
    assert cfg.overlap.background_publisher is None
    assert cfg.overlap.two_phase_exchange is False
    assert SimConfig.from_dict({}).overlap is None
    with pytest.raises(ValueError, match="overlap.pagerThread"):
        SimConfig.from_dict({"overlap": {"pagerThread": "yes"}})


def test_overlap_validation_refusals():
    """A gate explicitly on without the machinery it overlaps is refused
    with the reference's message; backgroundPublisher: true is refused by
    name (the port has no checkpoint publication); opt-outs are fine."""
    from kubernetes_simulator_tpu.cli import _overlap_errors
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig

    d = {"strategy": "jax", "overlap": {"pagerThread": True}}
    assert config_errors(SimConfig.from_dict(d)) == _overlap_errors(J_SimConfig.from_dict(d))
    assert any("pagedWaves" in e for e in config_errors(SimConfig.from_dict(d)))
    assert config_errors(SimConfig.from_dict(dict(d, pagedWaves=True))) == []
    with pytest.raises(NotImplementedError, match="backgroundPublisher"):
        SimConfig.from_dict({"overlap": {"backgroundPublisher": True}})
    cfg = SimConfig.from_dict({"overlap": {"pagerThread": False, "backgroundPublisher": False,
                                           "twoPhaseExchange": False}})
    assert config_errors(cfg) == []


def test_validate_accepts_example_config18():
    from kubernetes_simulator_tpu.cli import validate_config
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig

    path = os.path.join(ROOT, "examples", "config18_overlap.yaml")
    cfg = SimConfig.load(path)
    assert cfg.node_shards == 2 and cfg.paged_waves
    assert (cfg.overlap.pager_thread, cfg.overlap.two_phase_exchange,
            cfg.overlap.background_publisher) == (True, True, False)
    assert cfg.flight_recorder is not None
    assert config_errors(cfg) == [] == validate_config(J_SimConfig.load(path))


def test_config18_cut_gates_place_alike(tmp_path, monkeypatch):
    """config18 cut to 256 pods through the CLI run, pagerThread x
    twoPhaseExchange: the same replay row (but its config hash and its
    phase timers' walls) and, under KSIM_DETERMINISTIC_JSONL,
    byte-identical recorder streams."""
    monkeypatch.setenv("KSIM_DETERMINISTIC_JSONL", "1")
    monkeypatch.chdir(tmp_path)
    raw = yaml.safe_load(open(os.path.join(ROOT, "examples", "config18_overlap.yaml")))
    raw["workload"]["synthetic"]["pods"] = 256
    rows, streams = [], []
    for thread in (True, False):
        for two in (True, False):
            raw["overlap"].update(pagerThread=thread, twoPhaseExchange=two)
            raw["output"] = f"out_{thread}_{two}.jsonl"
            raw["flightRecorder"] = f"fl_{thread}_{two}.jsonl"
            (tmp_path / "c.yaml").write_text(yaml.safe_dump(raw))
            assert cli.main(["run", "c.yaml", "--device", "cpu"]) == 0
            row = json.loads((tmp_path / raw["output"]).read_text())
            row["telemetry"].pop("phases")
            rows.append({k: v for k, v in row.items() if k != "config_hash"})
            streams.append((tmp_path / raw["flightRecorder"]).read_bytes())
    assert all(r == rows[0] for r in rows) and rows[0]["placed"] > 0
    assert all(s == streams[0] for s in streams)
