"""The port's simulated clock against the reference's, and its imports.

The port keeps its own copies of the JAX package's framework-free
modules (simulator, policies, facade).  These tests hold the copies to
the reference: the golden transfer matrix (``golden_transfers.run_all``)
driven through the port's facade must reproduce the reference's rows
exactly and the committed golden file positionally; the backend-armed
facade trace must equal the reference's; each copy's source must be the
reference's with only ``repro.`` renamed in its imports (and, in
``api.py``, the backend branch); and no file of the port may import
``jax`` or anything of ``repro``.
"""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import golden_transfers as G  # noqa: E402
from test_backend_jax import _facade_run  # noqa: E402

from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    nbytes_of,
    synth_payload,
)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
COPIES = ["errors.py", "core/topology.py", "core/pinned_buffer.py",
          "core/linksim.py", "core/pathfinder.py", "core/pcie_scheduler.py",
          "core/elastic_pool.py", "core/index.py", "core/transfer.py",
          "core/migration.py", "core/chaos_api.py", "core/api.py",
          "core/faults.py", "core/shard.py", "serving/modelcache.py",
          "configs/__init__.py", "configs/base.py", "configs/dbrx_132b.py",
          "configs/gemma3_27b.py", "configs/grok_1_314b.py",
          "configs/jamba_1_5_large.py", "configs/minicpm_2b.py",
          "configs/nemotron_4_15b.py", "configs/qwen2_72b.py",
          "configs/qwen2_vl_2b.py", "configs/whisper_medium.py",
          "configs/xlstm_1_3b.py", "serving/workflow.py",
          "serving/executor.py", "distributed/fault.py",
          "launch/hlo_analysis.py"]


@pytest.fixture(scope="module")
def ref_rows():
    return G.run_all()


def _use_port(monkeypatch):
    monkeypatch.setattr(G, "FaaSTube", tapi.FaaSTube)
    monkeypatch.setattr(G, "SYSTEMS", tapi.SYSTEMS)
    monkeypatch.setattr(G, "cluster", ttopo.cluster)
    monkeypatch.setattr(G, "dgx_v100", ttopo.dgx_v100)


def test_port_run_all_equals_reference(monkeypatch, ref_rows):
    _use_port(monkeypatch)
    port = G.run_all()
    assert type(G.configs()["faastube"]) is tapi.TubeConfig
    assert port == ref_rows


@pytest.mark.parametrize("name", sorted(G.configs()))
def test_port_matches_golden_file(monkeypatch, name):
    """Each config's committed rows, positionally, as
    tests/test_transfer_equiv.py checks the reference."""
    with open(G.GOLDEN) as f:
        want = json.load(f)[name]
    _use_port(monkeypatch)
    have = G.run_config(name, G.configs()[name])
    assert len(have) >= len(want)
    for (label, val), (hlabel, hval) in zip(want, have):
        assert (hlabel, hval) == (label, val)


def _port_facade_run(backend):
    tube = tapi.FaaSTube(ttopo.dgx_v100(), tapi.FAASTUBE, backend=backend)
    trace = {"ready": [], "progress": []}
    tube.store("prod", "x", 24.0, "host", 0.0)
    tube.store("prod", "y", 16.0, "gpu0", 0.0)
    tube.fetch("cons", "x", "gpu1", 0.0,
               on_ready=lambda s, t: trace["ready"].append(("x", t)),
               on_progress=lambda s, h: trace["progress"].append(
                   (h.data_id if hasattr(h, "data_id") else "x",
                    h.done_mb)))
    tube.fetch("cons", "y", "gpu4", 1.0,
               on_ready=lambda s, t: trace["ready"].append(("y", t)))
    tube.sim.run()
    trace["now"] = tube.sim.now
    return trace, tube


def test_facade_trace_equals_reference():
    ref, _ = _facade_run(None)
    plain, _ = _port_facade_run(None)
    assert plain == ref


def test_facade_trace_unchanged_with_backend_armed():
    """Arming the port's backend changes no simulated event, and the
    bytes land where the simulator says they are."""
    ref, _ = _facade_run(None)
    armed, tube = _port_facade_run(TorchBackend(device="cpu"))
    assert armed == ref
    for did, ep, mb in (("x", "gpu1", 24.0), ("y", "gpu4", 16.0)):
        np.testing.assert_array_equal(tube.backend.read_object(did, ep),
                                      synth_payload(did, nbytes_of(mb)))
    assert [r.kind for r in tube.backend.reports] == ["h2g", "g2g"]


def _renamed(text: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  text, flags=re.M)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference(rel):
    """A copied module is the reference module with its imports renamed;
    api.py differs only inside its backend branch (jax -> torch),
    configs/base.py only inside ``cache_jdtype`` (a torch dtype) and
    serving/modelcache.py only inside ``profile_from_arch`` (it walks
    the port's spec trees), whose length may differ: the lines before
    and after it must be the reference's."""
    ref = _renamed((REF / rel).read_text()).splitlines()
    port = (PORT / rel).read_text().splitlines()
    if rel == "serving/modelcache.py":
        def span(lines):
            lo = lines.index("def profile_from_arch(arch, *, tp: int = 1, "
                             "name: str | None = None,")
            hi = next(i for i in range(lo, len(lines))
                      if lines[i].startswith("# ---"))
            return lo, hi
        (rlo, rhi), (plo, phi) = span(ref), span(port)
        assert port[:plo] == ref[:rlo] and port[phi:] == ref[rhi:]
        assert "import jax" not in "\n".join(port[plo:phi])
        return
    assert len(port) == len(ref)
    diff = [i for i, (a, b) in enumerate(zip(ref, port)) if a != b]
    if rel == "core/api.py":
        lo = next(i for i, ln in enumerate(port)
                  if "# data-plane backend" in ln)
        hi = next(i for i, ln in enumerate(port)
                  if ln.strip() == "self.backend = backend")
    elif rel == "configs/base.py":
        lo = next(i for i, ln in enumerate(port)
                  if ln.strip() == "def cache_jdtype(self):")
        hi = lo + 3
    else:
        assert diff == []
        return
    assert diff and all(lo <= i < hi for i in diff), diff


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 15
    # the mesh layer's modules, the twins of the reference's
    assert {f"{m}.py" for m in ("distributed/mesh", "distributed/compression",
                                "distributed/resharding", "launch/mesh",
                                "launch/dryrun", "launch/hlo_analysis")} \
        <= {f.relative_to(PORT).as_posix() for f in files
            if f.is_relative_to(PORT)}
    # the torch twins of the JAX examples
    assert {f.name for f in examples} >= {
        "quickstart_torch.py", "serve_workflow_torch.py",
        "train_small_torch.py"}
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
    assert bad == []
