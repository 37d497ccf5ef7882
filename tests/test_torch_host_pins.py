"""The constants chip_smoke.py holds the port's host engine and query
service against, recomputed on the CPU with the JAX package:

- CPU_PINS: ``CpuReplayEngine`` on examples/config1_default_cpu.yaml as
  shipped (100 nodes x 1,000 pods, strategy cpu) — what ``python -m
  kubernetes_simulator_tpu run`` of that config runs: placed,
  unschedulable and the assignments' sha256;
- SERVICE_PINS: ``python -m kubernetes_simulator_tpu serve`` of
  examples/config20_service.yaml as shipped (64 nodes x 2,048 pods, kube,
  retryBuffer 64, maxBatch 3) and of its chunkWaves 32 cut, SERVICE_STREAM
  on stdin: the service's stats and its query-result rows
  (chip_smoke.service_digest);
- TUNE12_PINS come from ``python -m kubernetes_simulator_tpu tune
  examples/config12_utilization.yaml`` (about 45 s on the CPU), run from an
  empty directory: the trajectory file's rows and sha256, the winner and the
  objectives of its last row. tests/test_torch_tuner_host.py holds the
  port's host evaluator to the JAX one on a cut of that search.

The cases chip_smoke.py builds through the port's config must encode what
the JAX package's config builds."""

import io
import os
import sys

import yaml

from kubernetes_simulator_tpu.cli import main as j_cli
from kubernetes_simulator_tpu.sim.runtime import CpuReplayEngine
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case
from kubernetes_simulator_tpu_torch.utils.config import SimConfig
from kubernetes_simulator_tpu_torch.utils.config import build_encoded_case as t_build

from torch_port_case import assert_same, port_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _same_case(path):
    """The port's and the JAX package's encoded case of one config file."""
    jcfg, tcfg = J_SimConfig.load(path), SimConfig.load(path)
    ec, ep = build_encoded_case(jcfg)
    pec, pep = t_build(tcfg)
    want_ec, want_ep = port_case(ec, ep)
    assert_same(pec, want_ec, "ec")
    assert_same(pep, want_ep, "ep")
    return jcfg, ec, ep


def test_pinned_cpu_constants():
    cfg, ec, ep = _same_case(os.path.join(ROOT, chip_smoke.CONFIG1))
    assert cfg.strategy == "cpu"
    res = CpuReplayEngine(ec, ep, cfg.framework, telemetry=cfg.telemetry.granularity).replay()
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.CPU_PINS


def test_tune12_case_and_pins_shape():
    """config12's case encodes alike; its pins name what the card checks."""
    _same_case(os.path.join(ROOT, chip_smoke.CONFIG12))
    assert set(chip_smoke.TUNE12_PINS) == {"rows", "sha256", "best_policy", "train_objective",
                                           "heldout_objective", "default_heldout_objective"}


def test_pinned_service_constants(tmp_path, monkeypatch):
    """The JAX CLI's serve on each of SERVICE_CONFIGS, the stream on stdin:
    stats and query-result rows == SERVICE_PINS; one query-error row."""
    import json

    from kubernetes_simulator_tpu.sim import service as JS

    _same_case(os.path.join(ROOT, chip_smoke.CONFIG20))
    monkeypatch.setattr(chip_smoke, "SERVICE_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    made = []

    class Service(JS.QueryService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(JS, "QueryService", Service)
    for name, changes in chip_smoke.SERVICE_CONFIGS.items():
        path = (os.path.join(ROOT, chip_smoke.CONFIG20) if not changes
                else chip_smoke.service_config(name, changes))
        with open(path) as f:
            assert yaml.safe_load(f)["service"]["maxBatch"] == 3
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(chip_smoke.SERVICE_STREAM)
                                                      + "\n"))
        out = tmp_path / "service_results.jsonl"
        if out.exists():
            out.unlink()
        made.clear()
        assert j_cli(["serve", path]) == 0
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        got = dict(stats=made[0].stats(), rows=chip_smoke.service_digest(rows))
        assert [r["kind"] for r in rows].count("query-error") == 1
        assert got == chip_smoke.SERVICE_PINS[name], name
    # Shipped, config20's 256 waves are one chunk: the drains land at the
    # trailing boundary and evict nothing; the cut's drains evict.
    assert sum(r["evictions"] for r in chip_smoke.SERVICE_PINS["config20"]["rows"]) == 0
    assert all(r["evictions"] > 0 for r in chip_smoke.SERVICE_PINS["cut32"]["rows"])
