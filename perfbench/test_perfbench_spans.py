"""The readers of the port's own spans (``spans.py`` and the six metrics
that read it) on Chrome traces made by hand: host time as the union of
a name's ranges, device time matched to its launch by correlation id
(also a kernel that runs after its launching range has closed), idle
gaps credited to the ranges open at their middle, and nothing to read
from a program without the spans."""
import json
import types

import pytest

import harness
import spans
import tracing

ITEMS = {"minicpm-2b.swap": {6: (0, 100), 7: (100, 200)},
         "minicpm-2b.decode": {40: (0, 100), 41: (100, 200)},
         "dbrx-132b-l4.prefill": {4: (0, 100), 5: (100, 200)}}


def _range(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "tid": 1}


def _launch(corr, ts, dev_a, dev_b, cat="cuda_runtime"):
    return [{"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
             "dur": 1, "tid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": dev_a,
             "dur": dev_b - dev_a, "tid": 7, "args": {"correlation": corr}}]


def _case(tmp_path, monkeypatch, workload, events):
    """The readers' (ctx, out) for ``workload`` over ``events``, its
    items' ranges and the slice range added, the trace where ``run.py``
    leaves it."""
    items = ITEMS[workload]
    ev = [_range(tracing.SLICE, 0, 200)] + events + [
        _range(f"{tracing.ITEM}{i}", a, b) for i, (a, b) in items.items()]
    (tmp_path / f"{workload}.trace.json").write_text(
        json.dumps({"traceEvents": ev}))
    monkeypatch.setattr(spans, "TRACES", tmp_path)
    s = tracing.Slice(window_s=200e-6, busy_s=0.0, device=[],
                      items={i: (a / 1e6, b / 1e6)
                             for i, (a, b) in items.items()})
    return (types.SimpleNamespace(workload=workload),
            types.SimpleNamespace(slice=s, records={}))


def _read(name, ctx, out):
    return harness.reader(name)(ctx, out)


def test_swap_readers_by_hand(tmp_path, monkeypatch):
    ev = [_range("ft:backend.execute", 5, 95),
          _range("ft:backend.execute", 105, 195),
          _range("ft:backend.stage", 10, 30), _range("ft:backend.stage", 50, 60),
          _range("ft:backend.stage", 110, 140),
          _range("ft:copy.wait", 35, 45), _range("ft:copy.wait", 150, 170),
          # a wait outside the walk, and a walk outside the items
          _range("ft:copy.wait", 96, 99), _range("ft:backend.execute", 250, 260)]
    ctx, out = _case(tmp_path, monkeypatch, "minicpm-2b.swap", ev)
    # stage 20 + 10 + 30 over the walks' 90 + 90
    assert _read("staging_share.swap", ctx, out) == pytest.approx(100 * 60 / 180)
    # waits inside the walks 10 + 20 us over 2 cold starts
    assert _read("ring_wait_ms.swap", ctx, out) == pytest.approx(15e-3)


def test_decode_readers_by_hand(tmp_path, monkeypatch):
    ev = [_range("ft:engine.decode", 0, 60), _range("ft:engine.decode", 100, 165),
          _range("ft:attn.core", 10, 30), _range("ft:attn.core", 110, 130),
          # launched inside attention at 12, runs at 40-70, after the
          # range has closed
          *_launch(1, 12, 40, 70), *_launch(2, 40, 70, 90),
          *_launch(3, 70, 92, 96),                    # the loop's argmax
          *_launch(4, 115, 115, 135, cat="cuda_driver"),
          *_launch(5, 140, 135, 150), *_launch(6, 170, 170, 180),
          *_launch(9, 250, 250, 260)]                 # outside the items
    ctx, out = _case(tmp_path, monkeypatch, "minicpm-2b.decode", ev)
    sp = spans.read(ctx, out)
    assert sp.busy_s == pytest.approx(99e-6)
    assert sp.device_s("ft:attn.core") == pytest.approx(50e-6)
    assert _read("decode_attn_share.decode", ctx, out) == \
        pytest.approx(100 * 50 / 99)
    # gaps 0-40 (middle in attention, inside the step), 90-92, 96-100,
    # 100-115 and 150-170 (inside the step), 180-200: 40 + 15 + 20 us in
    # the steps over 2 steps; the rest lies outside them
    assert sp.idle_s("ft:attn.core") == pytest.approx(40e-6)
    assert _read("engine_idle_ms.decode", ctx, out) == pytest.approx(37.5e-3)


def test_moe_readers_by_hand(tmp_path, monkeypatch):
    ev = [_range("ft:moe", 20, 80), _range("ft:moe.rank", 30, 40),
          _range("ft:moe", 120, 180), _range("ft:moe.rank", 130, 140),
          *_launch(11, 25, 25, 45), *_launch(12, 35, 45, 75),
          *_launch(17, 36, 50, 60),           # on another stream, overlaps
          *_launch(13, 85, 80, 95),
          *_launch(14, 135, 135, 155), *_launch(15, 150, 155, 175),
          *_launch(16, 190, 185, 195)]
    ctx, out = _case(tmp_path, monkeypatch, "dbrx-132b-l4.prefill", ev)
    # busy 20 + 30 + 15 + 20 + 20 + 10; the MoE's 90, the rank's 30 + 20
    assert _read("moe_share.prefill", ctx, out) == pytest.approx(100 * 90 / 115)
    assert _read("moe_rank_share.prefill", ctx, out) == \
        pytest.approx(100 * 50 / 115)


NEW = {"minicpm-2b.swap": ("staging_share.swap", "ring_wait_ms.swap"),
       "minicpm-2b.decode": ("decode_attn_share.decode",
                             "engine_idle_ms.decode"),
       "dbrx-132b-l4.prefill": ("moe_share.prefill", "moe_rank_share.prefill")}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_readers_find_nothing_without_the_spans(tmp_path, monkeypatch,
                                                workload):
    """A program without the spans (its kernels and items are there),
    no trace file, or no slice: every reader returns None."""
    ctx, out = _case(tmp_path, monkeypatch, workload,
                     _launch(1, 10, 10, 20))
    for name in NEW[workload]:
        assert _read(name, ctx, out) is None
    (tmp_path / f"{workload}.trace.json").unlink()
    for name in NEW[workload]:
        assert _read(name, ctx, out) is None
        assert _read(name, ctx, types.SimpleNamespace(slice=None,
                                                      records={})) is None
