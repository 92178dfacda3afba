"""The port's named ranges (``repro_torch.spans``) on the CPU: a shared
no-op with no profiler collecting; under ``torch.profiler`` one range a
site, nested where the work nests, leaving the arithmetic and the
backend's report as they are."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.backend_torch import (  # noqa: E402
    TorchBackend,
    nbytes_of,
    synth_payload,
)
from repro_torch.core.linksim import LinkSim  # noqa: E402
from repro_torch.core.pathfinder import PathFinder  # noqa: E402
from repro_torch.core.pinned_buffer import CircularPinnedBuffer  # noqa: E402
from repro_torch.core.transfer import CUT_THROUGH, TransferEngine  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402


def _ft_ranges(prof, tmp_path) -> list:
    """The profiled ``ft:`` ranges as (name, start, end), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("ft:")), key=lambda r: r[1])


def test_span_is_one_shared_no_op_without_a_profiler(tmp_path):
    a, b = spans.span("ft:x"), spans.span("ft:y")
    assert a is b is spans._OFF
    with a:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with b:
                torch.ones(4).sum()
    assert _ft_ranges(prof, tmp_path) == []


def test_moe_prefill_marks_each_layer_and_leaves_its_outputs(tmp_path):
    """A reduced DBRX prefill: one ``ft:attn.core``, ``ft:moe`` and
    ``ft:moe.rank`` a layer, the rank inside the MoE, all inside the
    one ``ft:engine.prefill``; logits and caches bit-equal to the same
    prefill with no profiler."""
    cfg = get_arch("dbrx-132b").reduced()
    eng = Engine(cfg, ShapeSpec("serve", 16, 2, "prefill"),
                 M.init_params(cfg, 3, "cpu"), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    with torch.no_grad():
        plain = eng.prefill({"tokens": toks})
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = eng.prefill({"tokens": toks})
    got = _ft_ranges(prof, tmp_path)
    names = [n for n, _, _ in got]
    assert names.count("ft:engine.prefill") == 1
    for n in ("ft:attn.core", "ft:moe", "ft:moe.rank"):
        assert names.count(n) == cfg.n_layers, (n, names)
    (_, e0, e1), = [r for r in got if r[0] == "ft:engine.prefill"]
    assert all(e0 <= a and b <= e1 for _, a, b in got)
    moes = [(a, b) for n, a, b in got if n == "ft:moe"]
    for _, a, b in (r for r in got if r[0] == "ft:moe.rank"):
        assert any(m0 <= a and b <= m1 for m0, m1 in moes)
    flat_p = [plain[0], *torch.utils._pytree.tree_leaves(plain[1])]
    flat_t = [traced[0], *torch.utils._pytree.tree_leaves(traced[1])]
    assert len(flat_p) == len(flat_t) > 1
    assert all(torch.equal(p, t) for p, t in zip(flat_p, flat_t))


def test_host_to_device_walk_stages_once_a_trigger_batch(tmp_path):
    """``TorchBackend(device="cpu")`` moving 23 MB host -> gpu1 cut
    through (12 chunks, 3 trigger batches): one ``ft:backend.execute``
    holding one ``ft:backend.stage`` a batch; the report's hops and
    progress as with no profiler."""
    reps = []
    for traced in (False, True):
        topo = ttopo.dgx_v100()
        eng = TransferEngine(LinkSim(topo), PathFinder(topo),
                             CircularPinnedBuffer(), topo,
                             staging=CUT_THROUGH)
        be = TorchBackend(device="cpu")
        plan = eng.compile("h2g", "t", "host", "gpu1", 23.0, data_id="w")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                rep = be.execute(plan)
        else:
            rep = be.execute(plan)
        np.testing.assert_array_equal(be.read_object("w", "gpu1"),
                                      synth_payload("w", nbytes_of(23.0)))
        reps.append(rep)
    plain, rep = reps
    got = _ft_ranges(prof, tmp_path)
    walks = [r for r in got if r[0] == "ft:backend.execute"]
    stages = [r for r in got if r[0] == "ft:backend.stage"]
    assert len(walks) == 1 and rep.n_batches == 3
    assert len(stages) == rep.n_batches
    (_, w0, w1), = walks
    assert all(w0 <= a and b <= w1 for _, a, b in stages)
    assert rep.hop_trace == plain.hop_trace
    assert [mb for mb, _ in rep.events] == [mb for mb, _ in plain.events]
