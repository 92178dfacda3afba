"""The traced slice of a run: ``torch.profiler`` over a few items of the
window (batches, steps or cold starts), each inside a named range, the
whole slice inside one range that ends after a device synchronise.  The
Chrome trace is written under ``build/perfbench/`` and read back here:
device intervals (kernels, copies, sets), the host's operations, and
the ranges."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

from work import busy_union

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime"}
SLICE = "pb:slice"
ITEM = "pb:item:"


@dataclass
class Slice:
    """What the traced slice holds.  Times in seconds; ``items`` maps an
    item's index to its (start, end) on the trace's clock and the
    driver's description of it (``meta``)."""
    window_s: float
    busy_s: float
    device: list                      # (name, start_s, dur_s)
    items: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    def device_in(self, index: int) -> list:
        a, b = self.items[index]
        return [e for e in self.device if a <= e[1] < b]


class Tracer:
    """Profiles items ``first .. first + count - 1`` of a loop: call
    ``before(i)`` before item i and ``after(i)`` after it.  Where each
    item ends in a synchronise (a prefill batch, a cold start:
    ``per_item``), its range holds its device work and the slice is the
    items' ranges alone, leaving out the driver's work between them;
    decode steps run on unsynchronised, as in the window, and the slice
    is the one range around them."""

    def __init__(self, first: int, count: int, path: Path, sync,
                 per_item: bool):
        self.first, self.count, self.path, self.sync = first, count, path, sync
        self.per_item = per_item
        self.prof = self.range = self.item = None
        self.meta = {}
        self.slice: Slice | None = None

    def active(self, i: int) -> bool:
        return self.first <= i < self.first + self.count

    def holds(self, i: int) -> bool:
        """Whether item ``i`` must still run: the slice has begun and
        not ended.  The window stays open until it ends."""
        return self.prof is not None and self.active(i)

    def before(self, i: int):
        if i == self.first:
            self.sync()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.range = torch.profiler.record_function(SLICE)
            self.range.__enter__()
        if self.active(i):
            self.item = torch.profiler.record_function(f"{ITEM}{i}")
            self.item.__enter__()

    def after(self, i: int, meta=None):
        if not self.active(i):
            return
        self.item.__exit__(None, None, None)
        self.meta[i] = meta
        if i == self.first + self.count - 1:
            self.sync()
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
            self.prof = None
            self.slice = read(self.path, self.meta, self.per_item)


def read(path: Path, meta: dict, per_item: bool) -> Slice:
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("pb:")}
    if SLICE not in ranges:
        raise RuntimeError(f"{path}: no {SLICE} range in the trace")
    items = {int(k[len(ITEM):]): v for k, v in ranges.items()
             if k.startswith(ITEM)}
    spans = sorted(items.values()) if per_item else [ranges[SLICE]]
    dev, host, busy, window, idle = [], [], 0.0, 0.0, []
    for a, b in spans:
        mine = sorted((e["name"], e["ts"], e["dur"]) for e in events
                      if e.get("cat") in DEVICE_CATS and a <= e["ts"] < b)
        dev += mine
        host += [(e["ts"], e["dur"], e["name"]) for e in events
                 if e.get("cat") in HOST_CATS and e["ts"] < b
                 and e["ts"] + e["dur"] > a]
        busy += busy_union((ts, min(dur, b - ts)) for _, ts, dur in mine)
        window += b - a
        idle += gaps(mine, a, b)
    host.sort()
    return Slice(window_s=window / 1e6, busy_s=busy / 1e6,
                 device=[(n, ts / 1e6, d / 1e6) for n, ts, d in dev],
                 items={i: (s / 1e6, e / 1e6) for i, (s, e) in items.items()},
                 meta=meta,
                 breakdown={"device_ops": top_ops(dev),
                            "idle_gaps": idle_by_host(idle, host)})


def top_ops(dev, n: int = 10) -> list:
    """The device operations that took most time: [[name, seconds]]."""
    by = defaultdict(float)
    for name, _, dur in dev:
        by[name] += dur / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def gaps(dev, a: float, b: float) -> list:
    """Idle intervals (start, end) of the device between a and b."""
    out, end = [], a
    for _, ts, dur in sorted(dev, key=lambda e: e[1]):
        if ts > end:
            out.append((end, ts))
        end = max(end, ts + dur)
    if b > end:
        out.append((end, b))
    return out


def idle_by_host(idle, host, n: int = 10, scan: int = 4000) -> list:
    """Idle time by what the host was doing in the middle of each gap
    (the innermost host operation open then; ``_no_host_op_`` where none
    was): [[name, seconds]], the longest first.  ``host`` is sorted."""
    starts = [h[0] for h in host]
    by = defaultdict(float)
    for g0, g1 in idle:
        name = "_no_host_op_"
        mid = (g0 + g1) / 2
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - scan, -1), -1):
            ts, dur, nm = host[k]
            if ts + dur > mid:
                name = nm
                break
        by[name] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
