"""The control and the lower readings behind each cell's limit.

    python3 perfbench/control.py --workload <name> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds <s>

For each seed, runs the cell's driver as a benchmark run does (a
window of ``--seconds``, then the comparison) and prints one JSON line:
the program's reading of each number compared and, on the control
seeds, the control's.  The control is the plain reference put in the
program's place at the nearest precision below the configuration's
bf16: every matrix product in float8 e4m3 (the family's reference with
``quant="fp8"``), its first token at each compared position judged by
the float32 reference.  For the swap tier, whose checkpoints are bytes,
the control is a reload of each bf16 checkpoint rounded to fp8 and
back: the bytes that then differ from the tenant's own.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def fp8_roundtrip_differ(payload) -> int:
    """Bytes of a bf16 checkpoint that change when its values are
    rounded to float8 e4m3, each 4096-value row scaled by its largest
    magnitude to the format's range, and back."""
    import torch
    n = payload.numel() // 2 * 2
    vals = payload[:n].view(torch.bfloat16)
    bad = 0
    step = 1 << 28
    for s in range(0, vals.numel(), step):
        part = vals[s:s + step]
        m = part.numel() // 4096 * 4096
        rows = part[:m].float().nan_to_num(0.0, 0.0, 0.0).view(-1, 4096)
        scale = rows.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
        back = ((rows / scale).to(torch.float8_e4m3fn).float() * scale) \
            .to(torch.bfloat16).view(-1)
        bad += int((back.view(torch.uint8)
                    != part[:m].view(torch.uint8)).sum())
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="key=value of the traffic mix, e.g. more sessions "
                         "compared in a shorter window")
    args = ap.parse_args(argv)
    import torch

    import drivers
    import harness
    import system
    import traffic as T
    system.import_port()
    spec = harness.bench()
    cell = harness.cell(spec, args.workload)
    config = harness.config_file(spec, cell["config"])
    mix = T.load(cell["traffic"])
    for kv in args.set:
        k, v = kv.split("=", 1)
        mix[k] = json.loads(v)
    limits = harness.load_json(HERE / "limits" / f"{args.workload}.json")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = drivers.Ctx(workload=args.workload, config=config, traffic=mix,
                          limits=limits, seed=seed, seconds=args.seconds,
                          device=device, started=time.perf_counter(),
                          control=seed in controls)
        out = drivers.DRIVERS[mix["driver"]](ctx)
        line = {"seed": seed, "correct": out.correct,
                "attempted": out.attempted,
                **{k: v for k, (v, _) in out.compared.items()},
                **{k: v for k, v in out.records.items()
                   if k.endswith(("_gap", "_share", "compared"))},
                **out.e2e, "setup_s": out.setup_s,
                "memory_peak_bytes": out.memory_peak_bytes}
        if mix["driver"] == "swap" and ctx.control:
            cfg = system.arch_config(config["arch"])
            prof = system.checkpoint_profile(cfg, "control")
            n = system.nbytes_of(prof.total_mb)
            line["control_bytes_differ"] = sum(
                fp8_roundtrip_differ(T.payload(seed, t, n, device))
                for t in range(mix["tenants"]))
        print(json.dumps(line), flush=True)
        del ctx, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"control: {time.perf_counter() - STARTED:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
