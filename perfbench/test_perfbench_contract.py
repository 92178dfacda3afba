"""The benchmark's shape: what it imports, and that every cell, metric
and limit named in ``BENCHMARK.json`` has its file."""
import ast
import json
import re
import sys
from pathlib import Path

import pytest

import drivers
import harness

HERE = Path(__file__).resolve().parent
SPEC = harness.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "torch", "numpy"}


def test_forbidden_modules_compare_whole_top_level_names():
    held = ["torch", "repro_torch", "repro_torch.models", "jaxtyping"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core", "flax.linen"]) \
        == ["flax", "repro"]
    assert harness.forbidden_modules(["jax", "jaxlib.xla"]) == ["jax",
                                                                 "jaxlib"]


def test_benchmark_names_its_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and 1 <= SPEC["run_seconds"] <= 51
    root = HERE.parent
    for c in SPEC["configs"]:
        assert NAME.match(c["name"])
        f = json.loads((root / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())
    for m in SPEC["per_layer"]:
        assert NAME.match(m["name"])
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_every_reference_has_both_modules(config):
    """A configuration's ``reference`` names its family: the plain
    forward and the family's leaves, tree and counts."""
    ref = json.loads((HERE.parent / config["file"]).read_text())["reference"]
    assert NAME.match(ref)
    assert (HERE / "reference" / f"{ref}.py").is_file()
    assert (HERE / "families" / f"{ref}.py").is_file()


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in SPEC["workloads"]:
        mine = {m["name"] for m in harness.metrics_for(SPEC, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = harness.metrics_for(SPEC, w["name"], "per_layer")
        assert layer
        assert all(m["moves"] in mine for m in layer)


def test_result_line_puts_compared_last():
    out = drivers.Outcome(e2e={"ttft_p95_ms": 1.5}, attempted=4, failed=0,
                          compared={"widest_gap": (0.001, 0.01)},
                          setup_s=2.0, memory_peak_bytes=7)
    w = "minicpm-2b.prefill"
    line = harness.result(SPEC, w, None, out, False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True
    assert line["metrics"] == {"ttft_p95_ms": {"value": 1.5, "unit": "ms"},
                               "setup_s": {"value": 2.0, "unit": "s"}}
    out.compared["widest_gap"] = (0.02, 0.01)
    assert harness.result(SPEC, w, None, out, False, {})["correct"] is False


def test_run_prints_no_result_without_a_card_or_the_port(tmp_path):
    """In a directory holding only the benchmark, and on a machine
    without CUDA, the command exits nonzero and prints nothing."""
    import shutil
    import subprocess
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "minicpm-2b.prefill", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and res.stdout == ""
