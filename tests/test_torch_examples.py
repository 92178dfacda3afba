"""The torch twins of the JAX examples (``examples/*_torch.py``), reduced,
on the CPU: the quickstart's simulated figures against the JAX
example's own functions (both run on the framework-free copies), its
real data plane's bytes, the serve workflow's replies from the JAX
example's weights carried over, and the small training run's restart.
"""
from __future__ import annotations

import importlib.util
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist                         # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quick():
    return _load("quickstart"), _load("quickstart_torch")


def _printed(capsys, fn, *args) -> list[str]:
    fn(*args)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("demo", ["demo_tube", "demo_overlap", "demo_torus",
                                  "demo_modelzoo"])
def test_quickstart_sim_sections_match_reference(quick, capsys, demo):
    """Sections 1-3 and 6: the same printed figures, line for line."""
    ref, twin = quick
    want = _printed(capsys, getattr(ref, demo))
    assert len(want) > 2
    assert _printed(capsys, getattr(twin, demo)) == want


def test_quickstart_sharded_section_matches_reference(quick, capsys,
                                                      monkeypatch):
    """Section 4 at ``workers=0`` (no worker is forked in a process that
    has started JAX): the twin's own copy of ``build_plan`` gives the
    reference's plan, workflows, p99 and event count."""
    from repro.core import shard as RS
    real = RS.ShardedTube
    monkeypatch.setattr(RS, "ShardedTube",
                        lambda plan, workers=0: real(plan, workers=0))
    ref, twin = quick
    want = _printed(capsys, ref.demo_sharded)[:3]
    got = _printed(capsys, twin.demo_sharded, (0,))
    assert got == want and "workers=0: 16 workflows" in got[2]


def test_quickstart_engine_and_backend_on_cpu(quick, capsys):
    """Section 5 generates 8 tokens a row; section 7 lands bytes equal to
    ``synth_payload`` at gpu4 through the plain copies."""
    _, twin = quick
    toks = twin.demo_engine("cpu")
    assert len(toks) == 2 and all(len(r) == 8 for r in toks)
    res = twin.demo_backend("cpu")
    assert res["bytes_equal"] and res["device"] == "cpu"
    assert res["kind"] == "g2g" and res["sim_ms"] > 0 and res["n_batches"] > 0
    capsys.readouterr()


def test_serve_twin_gives_reference_replies(capsys):
    """The JAX example's reduced weights (seed key 0), carried over by
    ``param.from_numpy``, give the JAX example's reply tokens."""
    import jax
    import numpy as np

    from repro.configs import get_arch as jget_arch
    from repro.models import model as JM
    from repro_torch.models import param as PM

    ref = _load("serve_workflow")
    ref.main()
    want = re.search(r"reply token ids: (\[.*\])",
                     capsys.readouterr().out).group(1)
    params = {}
    for arch in ("minicpm-2b", "qwen2-72b"):
        tree = JM.init_params(jget_arch(arch).reduced(), jax.random.key(0))
        params[arch] = PM.from_numpy(
            jax.tree.map(np.asarray, tree), device="cpu")
    assert not dist.is_initialized()
    res = _load("serve_workflow_torch").run("cpu", params)
    assert not dist.is_initialized()
    assert str(res["replies"][0]) == want
    assert res["speedup"] > 2.0


def test_train_twin_tiny_resumes():
    """``--tiny``, a few steps: the second run resumes at the first half's
    last checkpoint and ends at the step count, every loss finite."""
    assert not dist.is_initialized()
    res = _load("train_small_torch").run(steps=4, batch=2, seq=32, tiny=True,
                                         device="cpu")
    assert not dist.is_initialized()
    assert res["step"] == 4 and res["resumed_from"] == res["first_half"] == 2
    assert len(res["losses"]) == 4
    assert all(math.isfinite(x) for x in res["losses"])
