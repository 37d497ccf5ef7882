"""Walls of the port's summary route on an NVIDIA card, to hold one checkout
against another in a single call (parent, change, change, parent):

- headline: the what-if of 128 ``uniform_scenarios(seed=0)`` over
  ``chip_smoke.case(2000, 20000)`` (chunkWaves 512; K6 a chunk);
- config2: the single replay of ``chip_smoke.case(5000, 50000)``
  (chunkWaves 1024; K6);
- config4: ``examples/config4_borg_1m.yaml`` as the CLI ``run`` builds it
  (10,000 nodes x 1,000,000 Borg tasks; K6);
- config13: ``examples/config13_borgscale.yaml`` likewise (10,000 x 100,000
  over 8 node shards, paged; K9);
- config7: the what-if of ``examples/config7_retry_completions.yaml`` as
  shipped (64 scenarios x 500 nodes x 20,000 pods, retryBuffer 256; K6's
  retry mode);
- config8: the single replay of ``examples/config8_kube_preempt.yaml`` as
  the CLI ``run`` builds it (60 x 4,000, kube, retryBuffer 256; K6's kube
  pass).

Each is one engine, a warm-up run, then three timed runs (the engine's
own wall: host clock around the chunk loop, ending in the one fetch); and
what K6's source compiles to (:func:`k6_report`: ptxas's registers,
stack, spills and shared memory, and a hash of each kernel's SASS). Prints
one JSON line and, with ``--out``, writes it there.

    python scripts/summary_walls.py [--root CHECKOUT] [--out FILE] [--only a,b]

``--root`` names the checkout whose package and ``chip_smoke.py`` run (by
default the one that holds this script)."""

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile


def k6_report(K):
    """What the checkout's K6 sources (``csrc/chunk_replay.cu`` and any
    :data:`EXTRA_SOURCES` of it, each a translation unit) compile to, each
    alone, with the kernels' flags into a cubin: ptxas's lines for each
    kernel (registers, stack, spills, shared memory) and, from ``cuobjdump
    -sass``, each kernel's instruction count and the sha256 of its
    instructions without addresses or encodings (equal hashes: the same
    code)."""
    flags = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    srcs = (K.KERNELS["chunk_replay"], *getattr(K, "EXTRA_SOURCES", {}).get("chunk_replay", ()))
    ptxas, sass = [], ""
    with tempfile.TemporaryDirectory() as tmp:
        for src in srcs:
            cubin = os.path.join(tmp, src + ".cubin")
            proc = subprocess.run(
                [K._nvcc(), "-cubin", "-Xptxas=-v", *flags, "-I", str(K.CSRC), "-o", cubin,
                 str(K.CSRC / src)], capture_output=True, text=True, check=True)
            ptxas += [x.strip() for x in (proc.stdout + proc.stderr).splitlines()
                      if "Function properties" in x or "Used" in x or "spill" in x]
            sass += subprocess.run([os.path.join(os.path.dirname(K._nvcc()), "cuobjdump"),
                                    "-sass", cubin], capture_output=True, text=True,
                                   check=True).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name:
            kernels[name].append(m.group(1))
    return dict(
        ptxas=ptxas,
        sass={k: dict(instructions=len(v),
                      sha256=hashlib.sha256("\n".join(v).encode()).hexdigest())
              for k, v in kernels.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="headline,config2,config4,config13")
    args = ap.parse_args()
    out_path = os.path.abspath(args.out) if args.out else None
    root = os.path.abspath(args.root or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("summary_walls: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
    from kubernetes_simulator_tpu_torch.ops import kernels as K
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, build_encoded_case

    K.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = dict(root=root, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    try:
        out["k6"] = k6_report(K)
    except (OSError, subprocess.CalledProcessError) as e:  # the walls still count
        out["k6"] = dict(error=str(e))

    def timed(eng, run):
        run()
        walls = [run() for _ in range(3)]
        return dict(median_s=statistics.median(walls), walls_s=walls, route=eng.last_route)

    def from_config(path):
        cfg = SimConfig.load(os.path.join(root, path))
        ec, ep = build_encoded_case(cfg)
        return TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                                 chunk_waves=cfg.chunk_waves, node_shards=cfg.node_shards,
                                 paged=cfg.paged_waves, telemetry="summary")

    only = args.only.split(",")
    for name in only:
        if name == "headline":
            hs = cs.HEADLINE
            ec, ep = cs.case(hs["nodes"], hs["pods"])
            eng = WhatIfEngine(ec, ep, uniform_scenarios(ec, hs["scenarios"], seed=0),
                               FrameworkConfig(), chunk_waves=hs["chunk_waves"])
        elif name == "config2":
            ec, ep = cs.case(5000, 50_000)
            eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=1024,
                                    telemetry="summary")
        elif name == "config7":
            cfg, ec, ep = cs.config7_case()
            eng = WhatIfEngine(ec, ep, uniform_scenarios(ec, cfg.whatif.scenarios,
                                                         seed=cfg.whatif.seed),
                               cfg.framework, wave_width=cfg.wave_width,
                               chunk_waves=cfg.chunk_waves, retry_buffer=cfg.whatif.retry_buffer)
        elif name == "config8":
            cfg, ec, ep = cs.config8_case()
            eng = TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                                    chunk_waves=cfg.chunk_waves, preemption=cfg.device_preemption,
                                    retry_buffer=cfg.whatif.retry_buffer, telemetry="summary")
        else:
            eng = from_config(cs.CONFIG4 if name == "config4" else cs.CONFIG13)
        out[name] = timed(eng, lambda: eng._run(joint=True)[1] if isinstance(
            eng, TorchReplayEngine) else eng._run()[1])
        del eng
        torch.cuda.empty_cache()
    line = json.dumps(out)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
