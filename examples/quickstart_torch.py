"""Quickstart on PyTorch — FaaSTube's public API through the port
(``src/repro_torch``), on an NVIDIA GPU or, with ``--device cpu``, on
the CPU through the kernels' plain versions.

1. The paper's data plane: store()/fetch() through the tube on a DGX-V100
   topology; watch GPU-oriented passing beat host-oriented passing.
2. Compute/transfer overlap: observe landed trigger batches on a fetch,
   partial-consume the prefix, and run a workflow with
   ``TubeConfig.overlap`` pipelining stage compute against transfers.
3. Multi-path routing: the same pathfinder striping a reshard across
   edge-disjoint paths on a torus of chips.
4. Fleet-scale parallel simulation: the same trace on the sharded
   engine at ``workers=0`` (byte-identical reference) and ``workers=2``
   (conservative-lookahead BSP across processes).
5. A reduced LM through the serving engine (real compute on the device).
6. The model-swapping serving tier: checkpoint cache + SLO-aware swap.
7. The real data plane: the SAME TransferPlans executed with actual
   bytes (``backend="torch"``: slab stores on the device, a page-locked
   staging ring, the gather/scatter kernels) — simulated milliseconds
   next to measured wall milliseconds, byte-identical payloads.

The last line printed is a JSON summary of sections 5 and 7.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.api import FAASTUBE, INFLESS, FaaSTube  # noqa: E402
from repro_torch.core.pathfinder import PathFinder            # noqa: E402
from repro_torch.core.topology import dgx_v100, tpu_torus     # noqa: E402


def demo_tube():
    print("=== 1. GPU-oriented vs host-oriented data passing (128 MB) ===")
    for cfg in (INFLESS, FAASTUBE):
        tube = FaaSTube(dgx_v100(), cfg)
        done = {}
        tube.store("producer", "act0", 128.0, "gpu1", 0.0)
        tube.fetch("consumer", "act0", "gpu4", 0.0,
                   on_ready=lambda s, t: done.setdefault("t", t))
        tube.sim.run()
        print(f"  {cfg.name:10s} gFunc(gpu1) -> gFunc(gpu4): "
              f"{done['t']:7.2f} ms")


def demo_overlap():
    print("\n=== 2. Compute/transfer overlap: partial-input stages ===")
    tube = FaaSTube(dgx_v100(), FAASTUBE)
    tube.store("producer", "act1", 64.0, "gpu1", 0.0)

    def on_progress(sim, h):
        if h.done_mb < h.total_mb:
            prefix = tube.consume("act1", "gpu1", sim.now, partial=True)
            print(f"  t={sim.now:6.2f} ms  landed {h.done_mb:5.1f}"
                  f"/{h.total_mb:.0f} MB (readable prefix "
                  f"{prefix:.1f} MB)")
    tube.fetch("consumer", "act1", "gpu4", 0.0, on_progress=on_progress,
               on_ready=lambda s, t: print(f"  t={t:6.2f} ms  complete"))
    tube.sim.run()

    from repro_torch.serving.executor import run_closed_loop
    from repro_torch.serving.workflow import WORKFLOWS
    ov = dataclasses.replace(FAASTUBE, overlap=True, name="faastube-ov")
    for cfg in (FAASTUBE, ov):
        eng = run_closed_loop(dgx_v100, cfg, WORKFLOWS["traffic"],
                              n_requests=4)
        mk = max(r.t_done for r in eng.completed)
        tag = "overlap on " if cfg.overlap else "overlap off"
        print(f"  {tag}  4x traffic workflow makespan: {mk:7.2f} ms")


def demo_torus():
    print("\n=== 3. Multi-path ICI routing on the v5e torus ===")
    topo = tpu_torus(8, 8, hosts=False)
    pf = PathFinder(topo, transit="chip")
    allocs = pf.select_paths("reshard", "chip0_0", "chip3_2")
    for a in allocs:
        print(f"  path bw={a.bw:5.1f} GB/s  {' > '.join(a.path)}")
    agg = sum(a.bw for a in allocs)
    print(f"  aggregate {agg:.0f} GB/s vs 50 GB/s single dimension-ordered "
          f"route ({agg / 50:.1f}x)")


def demo_modelzoo():
    print("\n=== 6. Model-swapping serving tier (checkpoint cache) ===")
    import random

    from repro_torch.serving.modelcache import ModelCache, make_profile

    rng = random.Random(9)
    trace = []
    for _ in range(12):
        t, name = rng.uniform(0.0, 400.0), f"m{rng.randint(0, 3)}"
        trace.append((t, name))
        if rng.random() < 0.5:        # bursts build the queue skew
            trace += [(t + 2.0 * (j + 1), name) for j in range(2)]
    trace.sort()
    for policy in ("slo", "lru"):
        cfg = dataclasses.replace(FAASTUBE, store_cap_mb=700.0)
        tube = FaaSTube(dgx_v100(), cfg)
        mc = ModelCache(tube, policy=policy)
        for i in range(4):
            mc.register(make_profile(f"m{i}", "synth", [40.0] * 8),
                        "gpu0", 0.0)
        for t, name in trace:
            tube.sim.call_at(t, lambda sim, n=name, t=t: mc.request(n, t))
        tube.sim.run()
        cold = sorted(ms for (_t, ms, c) in mc.ttft if c)
        p99 = cold[max(0, int(len(cold) * 0.99) - 1)]
        print(f"  {policy:3s} victims: cold p99 {p99:7.2f} ms over "
              f"{len(cold)} cold starts, {mc.stats['evictions']} evictions")


# the 4-node fleet of section 4: ``benchmarks/fleet.py``'s plan, carried
# here so that the example needs the port alone
FLEET_MIX = ("driving", "video", "traffic", "image")


def bursty_arrivals(n: int, scale_ms: float, seed: int) -> list[float]:
    """``benchmarks/workloads.py``'s bursty pattern: bursts of 3-8
    back-to-back requests, 2-4 burst lengths apart."""
    rng = np.random.default_rng(seed)
    ts, t = [], 0.0
    while len(ts) < n:
        burst = int(rng.integers(3, 9))
        for k in range(min(burst, n - len(ts))):
            ts.append(t + k * scale_ms * 0.05)
        t += scale_ms * burst * rng.uniform(2.0, 4.0)
    ts = np.maximum(np.asarray(ts[:n]), 0.0)
    ts.sort()
    return [float(x) for x in ts]


def build_plan(cfg, seed: int = 0, *, n_nodes: int, n_apps: int,
               reqs_per_app: int, scale_ms: float = 40.0):
    """The fleet trace as a ShardPlan: ``n_apps`` workflow instances
    round-robin over ``n_nodes`` dgx-v100 nodes, every 4th with its last
    GPU stage on the next node."""
    from repro_torch.core.shard import ShardPlan
    from repro_torch.core.topology import cluster
    from repro_torch.serving.workflow import WORKFLOWS
    topo = cluster(n_nodes, base=dgx_v100)
    apps, placements = [], {}
    cursor = [0] * n_nodes
    by_node = {n: [g for g in topo.gpus if g.startswith(f"n{n}:")]
               for n in range(n_nodes)}
    for k in range(n_apps):
        base = WORKFLOWS[FLEET_MIX[k % len(FLEET_MIX)]]
        w = dataclasses.replace(base, name=f"{base.name}@{k}")
        node = k % n_nodes
        gpu_stages = [s for s in w.stages if s.kind == "gpu"]
        pl = {s.name: by_node[node][(cursor[node] + i) % len(by_node[node])]
              for i, s in enumerate(gpu_stages)}
        cursor[node] += len(gpu_stages)
        if k % 4 == 3:
            pl[gpu_stages[-1].name] = by_node[(node + 1) % n_nodes][0]
        placements[w.name] = pl
        apps.append(w)
    arr = {w.name: bursty_arrivals(reqs_per_app, scale_ms, seed + k)
           for k, w in enumerate(apps)}
    return ShardPlan(cfg=cfg, n_nodes=n_nodes, apps=apps,
                     placements=placements, arrivals=arr, seed=seed)


def demo_sharded(workers=(0, 2)):
    print("\n=== 4. Sharded parallel simulation (workers=N) ===")
    # runs before any device work: the workers fork
    from repro_torch.core.shard import ShardedTube

    plan = build_plan(FAASTUBE, n_nodes=4, n_apps=8, reqs_per_app=2)
    for nw in workers:
        res = ShardedTube(plan, workers=nw).run()
        p99 = sorted(r.t_done - r.t_arrive for r in res.completed)[-1]
        mode = "byte-identical reference" if nw == 0 else \
            f"{res.rounds} BSP rounds, lookahead {res.lookahead_ms} ms"
        print(f"  workers={nw}: {len(res.completed)} workflows, "
              f"p99 {p99:7.2f} ms, {res.n_events} events ({mode})")


def demo_engine(device: str) -> list:
    print(f"\n=== 5. Serving a reduced LM (real compute on {device}) ===")
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = get_arch("minicpm-2b").reduced()
    params = M.init_params(cfg, 0, device)
    eng = Engine(cfg, ShapeSpec("t", 64, 2, "decode"), params, device=device)
    toks, _ = eng.generate({"tokens": torch.ones((2, 8), dtype=torch.int32)},
                           max_new_tokens=8)
    print(f"  generated token ids: {toks.tolist()}")
    return toks.tolist()


def demo_backend(device: str) -> dict:
    print("\n=== 7. Real bytes behind the simulator (backend=\"torch\") ===")
    # the backend arms a real data plane: every identified plan ALSO
    # moves actual bytes through slab stores and the double-buffered
    # chunked-copy pipeline, strictly outside the sim event stream —
    # the simulated trace below is identical to demo_tube's
    import time

    from repro_torch.core.backend_torch import (
        TorchBackend, nbytes_of, synth_payload)

    backend = "torch" if device == "cuda" else TorchBackend(
        store_mb=2 * FAASTUBE.store_cap_mb,
        host_mb=max(4 * FAASTUBE.store_cap_mb, 256.0), device=device)
    tube = FaaSTube(dgx_v100(), FAASTUBE, backend=backend)
    done = {}
    tube.store("producer", "act0", 32.0, "gpu1", 0.0)
    t0 = time.perf_counter()
    tube.fetch("consumer", "act0", "gpu4", 0.0,
               on_ready=lambda s, t: done.setdefault("t", t))
    tube.sim.run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    landed = tube.backend.read_object("act0", "gpu4")
    ok = bool(np.array_equal(landed, synth_payload("act0", nbytes_of(32.0))))
    rep = tube.backend.reports[-1]
    print(f"  32 MB gpu1 -> gpu4: simulated {done['t']:.2f} ms, "
          f"measured {rep.wall_ms:.2f} ms wall ({wall_ms:.0f} ms incl. "
          f"sim)")
    print(f"  payload at gpu4 byte-identical to oracle: {ok}; "
          f"{rep.n_batches} trigger batches, events "
          f"{[mb for mb, _ in rep.events]}")
    assert ok, "the landed bytes differ from synth_payload"
    return {"sim_ms": done["t"], "wall_ms": rep.wall_ms, "bytes_equal": ok,
            "kind": rep.kind, "n_batches": rep.n_batches,
            "device": str(tube.backend.device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    demo_tube()
    demo_overlap()
    demo_torus()
    demo_sharded()
    tokens = demo_engine(args.device)
    demo_modelzoo()
    backend = demo_backend(args.device)
    from repro_torch.kernels.chunked_copy import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    print(json.dumps({"quickstart": {
        "tokens": tokens, "backend": backend,
        "launches": {"gather_chunks": K.gather_chunks.launches,
                     "scatter_chunks": K.scatter_chunks.launches,
                     "flash_attention": FK.flash_attention.launches}}}))


if __name__ == "__main__":
    main()
