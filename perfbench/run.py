"""Run one cell of the benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error.
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled slice of the
window whose Chrome trace is left in ``build/perfbench/``.  Exits
nonzero, with no result, without enough CUDA devices, without the port
under ``src/``, or when the process holds JAX or the JAX package.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build"
# every kernel cache inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    import system

    spec = harness.bench()
    cell = harness.cell(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    system.import_port()
    import drivers
    import traffic as T
    from tracing import Tracer

    device = torch.device("cuda", 0)
    mix = T.load(cell["traffic"])
    trace_path = BUILD / "perfbench" / f"{args.workload}.trace.json"
    ctx = drivers.Ctx(
        workload=args.workload,
        config=harness.config_file(spec, cell["config"]),
        traffic=mix,
        limits=harness.load_json(HERE / "limits" / f"{args.workload}.json"),
        seed=args.seed, seconds=args.seconds, device=device,
        started=STARTED,
        tracer_for=(lambda first, count, per_item: Tracer(
            first, count, trace_path, ctx.sync, per_item))
        if args.trace else None)
    out = drivers.DRIVERS[mix["driver"]](ctx)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        if out.slice is None:
            print(f"perfbench: the window ended before the traced slice "
                  f"(items {mix['trace_after']}..)", file=sys.stderr)
            return 1
        dev["busy_s"] = out.slice.busy_s
        dev["window_s"] = out.slice.window_s
    line = harness.result(spec, args.workload, ctx, out, bool(args.trace),
                          dev)
    held = harness.forbidden_modules()
    if held:
        print(f"perfbench: the process holds {held}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
