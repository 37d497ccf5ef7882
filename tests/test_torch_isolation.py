"""The port stands alone: it imports and replays with JAX blocked, never
imports the JAX package, runs on the card by default (raising where there
is none), and refuses the modes it does not carry yet by name (and runs the
ones it has ported since they were refused)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kubernetes_simulator_tpu_torch"

_BLOCKED_REPLAY = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jax.numpy"] = None
import kubernetes_simulator_tpu_torch as k
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.models.encode import encode
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine
import kubernetes_simulator_tpu_torch.cli, kubernetes_simulator_tpu_torch.convert
import kubernetes_simulator_tpu_torch.ops.cpu, kubernetes_simulator_tpu_torch.ops.policy
import kubernetes_simulator_tpu_torch.sim.greedy, kubernetes_simulator_tpu_torch.sim.tuner
import kubernetes_simulator_tpu_torch.parallel.mesh, kubernetes_simulator_tpu_torch.sim.flight
import kubernetes_simulator_tpu_torch.framework.queue, kubernetes_simulator_tpu_torch.sim.service
import kubernetes_simulator_tpu_torch.api, kubernetes_simulator_tpu_torch.sim.checkpoint
import kubernetes_simulator_tpu_torch.utils.profiling
from kubernetes_simulator_tpu_torch.framework.registry import get_strategy
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded
from kubernetes_simulator_tpu_torch.sim.borg_etl import load_borg2019
bec, bep, _ = make_borg_encoded(BorgSpec(nodes=8, tasks=200, seed=1))
bres = TorchReplayEngine(bec, bep, FrameworkConfig(), device="cpu", chunk_waves=4).replay()
assert bres.route == "chunk" and bres.placed > 0 and K.chunk_replay.launches == 0
cluster = make_cluster(6, seed=1, taint_fraction=0.3)
pods, _ = make_workload(30, seed=1, with_affinity=True, with_spread=True,
                        with_tolerations=True, gang_fraction=0.1, gang_size=2,
                        duration_mean=1.0, arrival_rate=20.0)
ec, ep = encode(cluster, pods)
res = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", wave_width=4,
                        chunk_waves=2).replay()
assert res.placed > 0, res.placed
import os, tempfile
ck = os.path.join(tempfile.mkdtemp(), "ck.npz")
eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", wave_width=4, chunk_waves=2)
eng.replay(checkpoint_path=ck, checkpoint_every=2)
again = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", wave_width=4,
                          chunk_waves=2).replay(checkpoint_path=ck, resume=True)
assert (again.assignments == res.assignments).all() and eng.last_saves
from kubernetes_simulator_tpu_torch.api import Simulator
assert Simulator(cluster, pods, device="cpu", wave_width=4, chunk_waves=2).run().placed == res.placed
cres = get_strategy("cpu")(ec, ep, FrameworkConfig(), telemetry="timeline").replay()
assert cres.placed > 0 and cres.telemetry.events, cres.placed
from kubernetes_simulator_tpu_torch.sim.service import QueryService
svc = QueryService(ec, ep, FrameworkConfig(), max_batch=1, retry_buffer=8, device="cpu",
                   wave_width=4, chunk_waves=2)
svc.submit({"op": "defrag", "nodes": [0], "drainAt": 0.5})
assert svc.close()[0]["kind"] == "query-result"
bad = [m for m in sys.modules if m == "kubernetes_simulator_tpu"
       or m.startswith("kubernetes_simulator_tpu.")]
assert not bad, bad
print("OK", res.placed)
"""


def test_port_imports_and_replays_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_REPLAY], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_jax_or_reference_imports(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        assert top != "kubernetes_simulator_tpu", f"{path} imports {name}"


def _tiny_case():
    from kubernetes_simulator_tpu_torch.models.encode import encode
    from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload

    return encode(make_cluster(4, seed=0), make_workload(6, seed=0)[0])


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ec, ep = _tiny_case()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchReplayEngine(ec, ep)
    assert TorchReplayEngine(ec, ep, device="cpu").replay().placed == 6


def test_cli_default_device_raises_without_a_card(monkeypatch, tmp_path):
    from kubernetes_simulator_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "cluster: {synthetic: {nodes: 5, seed: 0}}\n"
        "workload: {synthetic: {pods: 12, seed: 0}}\n"
        f"output: {tmp_path / 'out.jsonl'}\n"
    )
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["run", str(cfg)])
    assert cli.main(["run", str(cfg), "--device", "cpu"]) == 0
    import json

    row = json.loads((tmp_path / "out.jsonl").read_text().splitlines()[-1])
    assert row["kind"] == "replay-torch" and row["placed"] == 12 and row["device"] == "cpu"


#: Sections once refused that the port runs now: each config of
#: :func:`test_config_refuses_later_sections_by_name` with one of them
#: parses and runs on the CPU through the CLI command that reads it.
_PORTED_SECTIONS = {
    "whatIf: {scenarios: 4, mesh: true}": ("what-if", ""),
    "overlap: {pagerThread: true}": ("run", "pagedWaves: true\nchunkWaves: 1\n"),
    "flightRecorder: {path: f.jsonl}": ("run", "chunkWaves: 1\n"),
    "devicePreemption: kube": ("run", "whatIf: {retryBuffer: 8}\nchunkWaves: 1\n"),
    "chaos: {enabled: true}": ("run", "whatIf: {retryBuffer: 8}\nchunkWaves: 1\n"),
    "service: {maxBatch: 2}": ("serve", "devicePreemption: kube\nwhatIf: {retryBuffer: 8}\n"
                                        "chunkWaves: 1\n"),
}


@pytest.mark.parametrize(
    "section",
    ["whatIf: {scenarios: 4, mesh: true}", "chaos: {enabled: true}", "devicePreemption: kube",
     "overlap: {pagerThread: true}", "flightRecorder: {path: f.jsonl}",
     "dcn: {recovery: {enable: true}}", "service: {maxBatch: 2}"],
)
def test_config_refuses_later_sections_by_name(section, tmp_path, monkeypatch):
    import json

    import yaml

    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    d = yaml.safe_load(section)
    if section not in _PORTED_SECTIONS:
        with pytest.raises(NotImplementedError, match=list(d)[0]):
            SimConfig.from_dict(d)
        return
    cmd, extra = _PORTED_SECTIONS[section]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.yaml").write_text(
        "cluster: {synthetic: {nodes: 5, seed: 0}}\n"
        "workload: {synthetic: {pods: 12, seed: 0}}\n"
        f"output: out.jsonl\n{extra}{section}\n"
    )
    SimConfig.load("c.yaml")
    if cmd == "serve":
        import io
        import sys

        monkeypatch.setattr(sys, "stdin", io.StringIO(
            '{"op": "defrag", "nodes": [0, 1], "drainAt": 0.5}\n'))
    assert cli.main([cmd, "c.yaml", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in (tmp_path / "out.jsonl").read_text().splitlines()]
    if cmd == "serve":
        assert [r["kind"] for r in rows] == ["query", "query-result"]
        assert rows[-1]["placed"] == 12
        return
    if cmd == "what-if":
        assert [r["mesh"] for r in rows] == [True] * 5
        assert [r["placed"] for r in rows[1:]] == [12] * 4
        return
    assert rows[-1]["placed"] == 12
    if "flightRecorder" in section:
        from kubernetes_simulator_tpu_torch.sim.flight import read_stream

        events = [r["event"] for r in read_stream("f.jsonl")]
        assert events[0] == "start" and events[-1] == "end" and "chunk" in events


@pytest.mark.parametrize(
    "kw",
    [dict(engine="v2", preemption="kube", retry_buffer=8), dict(preemption="kube"),
     dict(preemption="kube", retry_buffer=8), dict(node_shards=2, retry_buffer=8),
     dict(paged=True, preemption=True),
     dict(flight_recorder="f.jsonl")],
)
def test_engine_refuses_later_modes(kw, tmp_path, monkeypatch):
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

    ec, ep = _tiny_case()
    if kw.get("preemption") == "kube":
        # Ported since: kube preemption through the retry buffer (the
        # reference's error without a buffer); placed as the port's anchor.
        from kubernetes_simulator_tpu_torch.sim.greedy import greedy_replay

        if not kw.get("retry_buffer"):
            with pytest.raises(ValueError, match="retry_buffer > 0"):
                TorchReplayEngine(ec, ep, device="cpu", **kw)
            return
        res = TorchReplayEngine(ec, ep, device="cpu", chunk_waves=1, **kw).replay()
        want = greedy_replay(ec, ep, completions_chunk_waves=1, preemption="kube",
                             retry_buffer=8)
        np.testing.assert_array_equal(res.assignments, want.assignments)
        return
    if "flight_recorder" in kw:
        # Ported since: the recorder streams the replay it watches.
        from kubernetes_simulator_tpu_torch.sim.flight import read_stream

        monkeypatch.chdir(tmp_path)
        res = TorchReplayEngine(ec, ep, device="cpu", chunk_waves=1, **kw).replay()
        rows = read_stream("f.jsonl")
        assert res.placed == 6 and rows[-1]["event"] == "end" and rows[-1]["placed"] == 6
        return
    with pytest.raises(NotImplementedError):
        TorchReplayEngine(ec, ep, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(checkpoint_path="ck.npz"), dict(resume=True),
                                dict(node_events=[object()], checkpoint_path="ck.npz")])
def test_replay_refuses_later_modes(kw, tmp_path, monkeypatch):
    """Ported since: checkpoint/resume (queue A item 6d). As the reference's
    replay, a path without a cadence writes nothing and ``resume`` without a
    path starts from chunk 0 (both place as a plain replay), and a timeline
    whose entries are not events is refused (by the reference's validator,
    which reads their fields) before any checkpoint work."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

    monkeypatch.chdir(tmp_path)
    ec, ep = _tiny_case()
    if "node_events" in kw:
        with pytest.raises(AttributeError):
            TorchReplayEngine(ec, ep, device="cpu").replay(**kw)
        assert not (tmp_path / "ck.npz").exists()
        return
    res = TorchReplayEngine(ec, ep, device="cpu").replay(**kw)
    assert res.placed == 6 and not (tmp_path / "ck.npz").exists()


def test_wrappers_take_the_twin_only_on_cpu():
    """On CPU tensors the wrappers run the plain twins and count nothing."""
    from kubernetes_simulator_tpu_torch.ops import kernels as K
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

    ec, ep = _tiny_case()
    K.reset_launch_counts()
    TorchReplayEngine(ec, ep, device="cpu").replay()
    assert K.launch_counts() == {"filter_score": 0, "normalize_select": 0,
                                 "apply_placements": 0, "retry_boundary": 0,
                                 "first_reject": 0, "first_reject_fold": 0,
                                 "chunk_replay": 0, "shard_select": 0, "shard_apply": 0,
                                 "shard_chunk_replay": 0, "evict_node": 0,
                                 "apply_placements_bind": 0, "apply_placements_rollback": 0,
                                 "apply_placements_release": 0,
                                 "shard_apply_bind": 0, "shard_apply_rollback": 0,
                                 "shard_apply_release": 0}
    assert np.all(np.isfinite(ec.allocatable))


@pytest.mark.parametrize(
    "name,strategy",
    [("config1_default_cpu.yaml", "cpu"), ("config2_full_plugins_5k.yaml", None),
     ("config3_whatif_256.yaml", None), ("config4_borg_1m.yaml", None),
     ("config8_kube_preempt.yaml", None), ("config11_tune.yaml", None),
     ("config12_utilization.yaml", None), ("config13_borgscale.yaml", None),
     ("config15_headline.yaml", None), ("config18_overlap.yaml", None),
     ("config20_service.yaml", None)],
)
def test_example_configs_parse_or_refuse(name, strategy):
    """The repo's example configs: the run, what-if, tune and serve configs
    parse with the JAX package's values (config4's workload.borg section
    field for field; the flight recorder, the overlap gates and the scenario
    mesh; kube preemption and its buffer; config20's service section);
    config1's strategy cpu (ported since: the CPU event engine) parses."""
    import dataclasses

    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, config_errors

    path = ROOT / "examples" / name
    cfg = SimConfig.load(str(path))
    raw = yaml.safe_load(path.read_text())
    ref = J_SimConfig.load(str(path))
    assert config_errors(cfg) == []
    if strategy:
        assert cfg.strategy == ref.strategy == strategy
    assert (cfg.service is None) == (ref.service is None)
    if cfg.service is not None:
        assert dataclasses.asdict(cfg.service) == dataclasses.asdict(ref.service)
    for port, jax in ((cfg.flight_recorder, ref.flight_recorder), (cfg.overlap, ref.overlap)):
        assert (port is None) == (jax is None)
        if port is not None:
            assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert (cfg.whatif.mesh, cfg.node_shards, cfg.paged_waves, cfg.chunk_waves) == (
        ref.whatif.mesh, ref.node_shards, ref.paged_waves, ref.chunk_waves)
    assert (cfg.device_preemption, cfg.whatif.retry_buffer) == (
        ref.device_preemption, ref.whatif.retry_buffer)
    if "borg" in raw["workload"]:
        assert cfg.workload is None and ref.workload is None
        assert dataclasses.asdict(cfg.borg) == dataclasses.asdict(ref.borg)
        b = raw["workload"]["borg"]
        assert (cfg.borg.nodes, cfg.borg.tasks) == (b["nodes"], b["tasks"])
        assert cfg.chunk_waves == ref.chunk_waves == raw["chunkWaves"]
        assert (cfg.node_shards, cfg.paged_waves) == (ref.node_shards, ref.paged_waves)
        return
    syn = raw["cluster"]["synthetic"]
    assert cfg.cluster.nodes == syn["nodes"]
    assert cfg.workload.pods == raw["workload"]["synthetic"]["pods"]
    assert cfg.chunk_waves == raw.get("chunkWaves", 1024)
    wi = raw.get("whatIf") or {}
    assert cfg.whatif.scenarios == wi.get("scenarios", 0)
    assert cfg.whatif.seed == wi.get("seed", 0)


def test_config11_tune_section_parses_like_the_reference():
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    path = str(ROOT / "examples" / "config11_tune.yaml")
    got, want = SimConfig.load(path).tune, J_SimConfig.load(path).tune
    for f in ("algo", "population", "rounds", "seed", "elite_frac", "objective", "constraints",
              "evaluator", "train_scenarios", "heldout_scenarios", "scenario_seed",
              "node_down_p", "capacity_p", "taint_p", "weight_bounds", "tune_strategy",
              "cpu_oracle", "cpu_envelope", "output", "mesh"):
        assert getattr(got, f) == getattr(want, f), f
