"""Shared pieces of the benchmark's CPU tests: each cell's configuration
and mix cut to a size a test run holds, and a driver context on the
CPU in float32."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import drivers  # noqa: E402
import harness  # noqa: E402
import system  # noqa: E402
import traffic as T  # noqa: E402

system.import_port()

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12)

#: the widths every small configuration takes; depth, families and the
#: configuration's own flags and init gains stay as they are
SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
         "d_ff": 96, "vocab_size": 500}
SMALL_MIX = {
    "prefill": {"tokens_per_batch": 64, "lengths": [8, 16, 32],
                "trace_after": 0, "trace_items": 2},
    "decode": {"batch": 4, "prompt_len": 8, "cache_len": 24,
               "trace_after": 0, "trace_items": 2},
    "swap": {"store_cap_mb": 6.0, "host_cache_mb": 64.0},
}
#: a swap cell's small checkpoint spans two 2 MB slab rows
SWAP_VOCAB = 20000


def small_config(name: str) -> dict:
    cfg = harness.config_file(harness.bench(), name)
    arch = dict(cfg["arch"], **SMALL)
    arch["n_kv_heads"] = 2 if cfg["arch"]["n_kv_heads"] < \
        cfg["arch"]["n_heads"] else SMALL["n_heads"]
    if arch.get("n_experts"):
        arch.update(n_experts=4, top_k=2)
    return dict(cfg, arch=arch)


def small_mix(mix: str) -> dict:
    m = T.load(mix)
    return dict(m, **SMALL_MIX[m["driver"]])


def cells() -> list:
    return harness.bench()["workloads"]


def ctx(workload: str, seed: int = SEEDS[0], seconds: float = 0.3,
        control: bool = False) -> drivers.Ctx:
    """A driver context for ``workload`` at the small size on the CPU,
    held to the cell's own limits."""
    c = harness.cell(harness.bench(), workload)
    config, mix = small_config(c["config"]), small_mix(c["traffic"])
    if mix["driver"] == "swap":
        config["arch"]["vocab_size"] = SWAP_VOCAB
    return drivers.Ctx(
        workload=workload, config=config, traffic=mix,
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        seed=seed, seconds=seconds, device=torch.device("cpu"),
        started=time.perf_counter(), dtype=torch.float32, control=control)


def run(workload: str, **kw) -> drivers.Outcome:
    c = ctx(workload, **kw)
    return drivers.DRIVERS[c.traffic["driver"]](c)


def result_line(workload: str, **kw) -> dict:
    """The rest of a run past the look for a chip: the driver, then the
    result line ``run.py`` prints."""
    c = ctx(workload, **kw)
    out = drivers.DRIVERS[c.traffic["driver"]](c)
    return harness.result(harness.bench(), workload, c, out, False,
                          {"platform": "cpu"})
