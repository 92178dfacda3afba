"""One run of one cell: resolve the cell's configuration, traffic mix
and limits by the names in ``BENCHMARK.json``, run the mix's driver,
read the metrics and print the result.

Everything that belongs to one configuration, mix or per-layer metric
is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` (whose
``read(ctx, outcome)`` returns the metric, or None where it finds
nothing to read).  A configuration's ``reference`` names its model
family: ``reference/<reference>.py``, the plain float32 forward, and
``families/<reference>.py``, its leaves, their place in the port's
tree and its counts.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")


def config_file(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"perfbench: no configuration {name!r}")


def metrics_for(spec: dict, workload: str, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def _load(kind: str, name: str):
    """``<kind>/<name>.py`` under ``HERE`` as a module, loaded once."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"perfbench_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if not path.is_file():
        raise SystemExit(f"perfbench: no {path}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def reader(name: str):
    return _load("metrics", name).read


def family(name: str):
    """The model family ``name``'s leaves, tree and counts."""
    return _load("families", name)


def reference(name: str):
    """The model family ``name``'s plain float32 forward."""
    return _load("reference", name)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the process's
    modules by default), compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def number(x) -> float:
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"not a finite number: {x}")
    return x


def result(spec: dict, workload: str, ctx, out, trace: bool,
           device: dict) -> dict:
    """The result line's object; ``compared`` comes last."""
    if trace:
        metrics = {}
        for m in metrics_for(spec, workload, "per_layer"):
            v = reader(m["name"])(ctx, out)
            if v is not None:
                metrics[m["name"]] = {"value": number(v), "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": number(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_for(spec, workload, "end_to_end")}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.slice is not None:
        line["breakdown"] = out.slice.breakdown
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.compared.items()}
    return line
