"""The port's own spans (``repro_torch.spans``: ranges named ``ft:...``)
in the traced slice's Chrome trace, within the slice's items.  For each
span name: its host time (the union of its ranges), the device time of
the kernels, copies and sets launched inside one of its ranges (matched
from the launch's ``cuda_runtime`` or ``cuda_driver`` event to the
device event by ``args.correlation``, as ``chip_smoke.py``'s
``_correlated_ms`` does), and the device's idle time credited to it:
each idle gap of an item goes to the innermost ``ft:`` range open at
the gap's middle, and so to every range that holds that one.

Where the trace holds no ``ft:`` range (a program without the spans),
``read`` gives a ``Spans`` that has none of them, and each reader
returns None.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

from tracing import DEVICE_CATS, ITEM, gaps
from work import busy_union

PREFIX = "ft:"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
#: where ``run.py`` leaves a cell's trace
TRACES = Path(__file__).resolve().parents[1] / "build" / "perfbench"


def _union(iv) -> list:
    """Sorted disjoint [start, end) intervals covering ``iv``."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(iv: list):
    """A test of whether a time lies in one of the sorted disjoint
    intervals ``iv``."""
    starts = [a for a, _ in iv]

    def test(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < iv[i][1]
    return test


def _overlap(iv: list, jv: list) -> float:
    """Length of the intersection of two disjoint interval lists."""
    n, i, j = 0.0, 0, 0
    while i < len(iv) and j < len(jv):
        a, b = max(iv[i][0], jv[j][0]), min(iv[i][1], jv[j][1])
        n += max(0.0, b - a)
        if iv[i][1] < jv[j][1]:
            i += 1
        else:
            j += 1
    return n


class Spans:
    """The ``ft:`` ranges of a trace's items.  Times in seconds."""

    def __init__(self, events: list, items: list):
        ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith(ITEM)}
        self.items = sorted(ranges[f"{ITEM}{i}"] for i in items
                            if f"{ITEM}{i}" in ranges)
        self.n_items = len(self.items)
        in_items = _inside(self.items)
        self.ranges = defaultdict(list)          # name -> [(tid, a, b)]
        for e in events:
            if e.get("cat") == "user_annotation" and \
                    e["name"].startswith(PREFIX) and in_items(e["ts"]):
                self.ranges[e["name"]].append(
                    (e["tid"], e["ts"], e["ts"] + e["dur"]))
        self.launches = [(e["tid"], e["ts"], e["args"]["correlation"])
                         for e in events if e.get("cat") in LAUNCH_CATS
                         and "correlation" in e.get("args", {})
                         and in_items(e["ts"])]
        launched = {c for _, _, c in self.launches}
        self.device = [(e["ts"], e["dur"], e.get("args", {})
                        .get("correlation")) for e in events
                       if e.get("cat") in DEVICE_CATS]
        self._mine = [(ts, dur, c) for ts, dur, c in self.device
                      if c in launched]
        self.busy_s = busy_union((ts, dur) for ts, dur, _ in self._mine) / 1e6
        self._idle = self._credit_idle()

    def has(self, name: str) -> bool:
        return bool(self.ranges.get(name))

    def _union_of(self, name: str) -> list:
        return _union((a, b) for _, a, b in self.ranges.get(name, []))

    def host_s(self, name: str, within: str | None = None) -> float:
        """Host time in ``name``'s ranges (inside ``within``'s, if
        given), within the items."""
        iv = self.items
        if within is not None:
            iv = _union((max(a, c), min(b, d)) for a, b in iv
                        for c, d in self._union_of(within)
                        if max(a, c) < min(b, d))
        return _overlap(self._union_of(name), iv) / 1e6

    def device_s(self, name: str) -> float:
        """Device busy time of the work launched inside ``name``'s
        ranges, by the launch's thread and correlation id."""
        per_tid = defaultdict(list)
        for tid, a, b in self.ranges.get(name, []):
            per_tid[tid].append((a, b))
        per_tid = {t: _inside(_union(iv)) for t, iv in per_tid.items()}
        ids = {c for tid, ts, c in self.launches
               if tid in per_tid and per_tid[tid](ts)}
        return busy_union((ts, dur) for ts, dur, c in self._mine
                          if c in ids) / 1e6

    def idle_s(self, name: str) -> float:
        """The items' idle device time credited to ``name``: gaps whose
        middle lies inside one of its ranges, at any depth."""
        return self._idle.get(name, 0.0)

    def _credit_idle(self) -> dict:
        mids = []
        for a, b in self.items:
            dev = [(None, max(ts, a), min(ts + dur, b) - max(ts, a))
                   for ts, dur, _ in self.device if ts < b and ts + dur > a]
            mids += [((g0 + g1) / 2, g1 - g0) for g0, g1 in gaps(dev, a, b)]
        ranges = sorted((a, b, n) for n, rs in self.ranges.items()
                        for _, a, b in rs)
        credit, open_, k = defaultdict(float), [], 0
        for mid, length in sorted(mids):
            while k < len(ranges) and ranges[k][0] <= mid:
                open_.append(ranges[k])
                k += 1
            open_ = [r for r in open_ if r[1] > mid]
            for name in {n for _, _, n in open_}:
                credit[name] += length / 1e6
        return dict(credit)


def read(ctx, out) -> Spans | None:
    """The spans of the cell's traced slice, or None without one."""
    s = out.slice
    path = TRACES / f"{ctx.workload}.trace.json"
    if s is None or not path.is_file():
        return None
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return Spans(events, sorted(s.items))
