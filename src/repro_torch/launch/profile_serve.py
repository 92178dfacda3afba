"""Where the serving path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch minicpm-2b] [--layers N] [--steps 8] [--trace PATH] [--mesh]

Builds ``Engine(--arch)`` at full width in bf16 on ``cuda`` (random
weights from a seed; ``--layers`` cuts the depth) at the shape
``chip_smoke.py`` serves (8 requests of 1024 prompt positions, inputs
from ``io.synthetic_batch``: an encoder-decoder's are split evenly
between frames and tokens), warms it with one prefill and one
decode step, then runs one prefill and ``--steps`` decode steps under
``torch.profiler``; with ``--mesh``, on the 1x1 NCCL smoke mesh under
the serving rules (the sharded bodies and their collectives on groups
of one), without it on no mesh.  For
each phase it prints the host wall time (after a device synchronise),
the device's busy time (the union of kernel, memcpy and memset
intervals in the trace), the idle share, and the kernels that take most
device time.  The trace is written as Chrome JSON to ``--trace``.  Fails
when there is no card or when the trace holds no device event.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
BATCH, PROMPT, TOP = 8, 1024, 12


def _busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, -1.0
    for ts, dur in sorted((e["ts"], e["dur"]) for e in events):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def _report(name: str, wall_s: float, events, top: int) -> dict:
    busy = _busy_us(events) / 1e6
    by_name = defaultdict(float)
    for e in events:
        by_name[e["name"]] += e["dur"] / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"{name}: wall {wall_s * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall_s:.3f}, "
          f"{len(events)} device events")
    for kname, secs in ranked:
        print(f"  {secs * 1e3:9.3f} ms  {secs / busy:6.3f}  {kname[:110]}")
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy * 1e3,
            "idle_share": 1 - busy / wall_s, "n_events": len(events),
            "top": [[k, s * 1e3] for k, s in ranked]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default="chiprun_out/serve_trace.json")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on the 1x1 NCCL smoke mesh")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import io
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, extend_caches

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    B, n = BATCH, args.steps
    batch = io.synthetic_batch(cfg, ShapeSpec("t", PROMPT, B, "prefill"), 0)
    L = batch["tokens"].shape[1]
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_smoke_mesh
        mesh = make_smoke_mesh("cuda")
    eng = Engine(cfg, ShapeSpec("serve", L + n + 1, B, "decode"),
                 M.init_params(cfg, 0, "cuda"), mesh=mesh)
    ctx = M.decode_ctx(cfg, eng.ctx, prompt_len=L, cache_len=L + n + 1,
                       enc_len=batch["frames"].shape[1]
                       if "frames" in batch else 0)

    def prefill():
        logits, caches = eng.prefill(batch)
        return torch.argmax(logits, -1)[:, None].to(torch.int32), \
            extend_caches(cfg, caches, L + n + 1, ctx=eng.ctx, from_len=L)

    def decode(tok, caches, steps):
        for i in range(steps):
            logits, caches = eng.decode(caches, tok, L + i, ctx)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return tok

    decode(*prefill(), 1)                       # warm-up
    torch.cuda.synchronize()
    walls = {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        # each phase ends in a synchronise inside its labelled region, so
        # its device work lies within the region on the trace's clock
        t0 = time.perf_counter()
        with torch.profiler.record_function("phase:prefill"):
            tok, caches = prefill()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.profiler.record_function("phase:decode"):
            decode(tok, caches, n)
            torch.cuda.synchronize()
        walls = {"prefill": t1 - t0, "decode": time.perf_counter() - t1}
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in trace if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise SystemExit("profile_serve: the trace holds no device event")
    regions = {e["name"].removeprefix("phase:"): (e["ts"], e["ts"] + e["dur"])
               for e in trace if e.get("cat") == "user_annotation"
               and e["name"].startswith("phase:")}
    out = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.n_layers, "batch": B, "prompt_len": L,
           "steps": n, "mesh": args.mesh}
    for name, (a, b) in regions.items():
        evs = [e for e in dev if a <= e["ts"] < b]
        label = name if name == "prefill" else f"decode ({n} steps)"
        out[name] = _report(label, walls[name], evs, TOP)
    print(json.dumps(out))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
