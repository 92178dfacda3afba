"""SLO-aware PCIe transfer scheduling (paper §6.1) with two traffic
classes (paper §7: migration must not starve foreground fetches).

Foreground (``FOREGROUND``): SLO-admitted fetches.  Rate_least(f) =
data_size / (L_slo - L_infer) — the minimum bandwidth that still meets
f's SLO.  The scheduler admits each function with that weight on the
link simulator's DRR queues (the simulator's chunk interleaving IS the
paper's proportional batched triggering).  When every admitted flow is
foreground, the residual idle bandwidth goes to the function with the
tightest SLO.

Background (``BACKGROUND``): spill / reload / prefetch migration
traffic.  Background flows are granted only the *residual* bandwidth
``bw_all - sum(rate_least)``, split evenly among them; the grant is
re-derived on every admit/complete, so background is demoted the moment
a foreground flow arrives (its rate_least shrinks the residual) and
promoted back as foreground flows drain.  The link simulator enforces
the class boundary per link: a background chunk is dispatched only when
no foreground chunk is available on that link (strict priority at chunk
granularity), so a foreground flow's floor survives even when the
aggregate residual is larger than any single link.

Weight churn interacts with the burst-coalesced engine: every
`set_rate_weight` whose value actually changes checkpoints the in-flight
burst's deficit replay at the old weight (see linksim).  `_reweigh` is
therefore careful to only push weights that changed, and `complete`
evicts the departed function's weight/deficit/class state from the
simulator once its transfers have drained.

``admit(..., t=now)`` / ``complete(..., t=now)`` additionally track
per-transfer SLO attainment for foreground flows with a real SLO: a
flow whose completion exceeds its slack (slo_ms - infer_ms) is counted
in ``fg_missed`` and recorded in ``slo_misses`` — the signal the
isoperf CI gate asserts on.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.linksim import LinkSim
from repro_torch.core.pinned_buffer import BACKGROUND, FOREGROUND  # noqa: F401

#: slo_ms at or above this is "no real SLO" (the 1e9 default used by
#: best-effort fetches) — admitted, but excluded from miss accounting.
SLO_UNTRACKED_MS = 1e8


@dataclass
class _Flow:
    func: str
    size_mb: float
    slo_ms: float
    infer_ms: float
    cls: str = FOREGROUND
    refs: int = 1        # concurrent admissions under this func id
    rl: float = 0.0      # cached rate_least; see _refresh_rl
    slack: float = 0.0   # cached slo_ms - infer_ms (tightest-flow key)
    seq: int = field(default_factory=itertools.count().__next__)

    def __post_init__(self):
        self._refresh_rl()

    @property
    def tkey(self):
        """Tightest-flow total order: slack, ties by admission order —
        exactly what min(flows.values(), key=slack) resolves to, since
        dict iteration is insertion order."""
        return (self.slack, self.seq)

    def _refresh_rl(self):
        self.slack = self.slo_ms - self.infer_ms
        self.rl = self.size_mb / max(self.slack, 1e-3)

    @property
    def rate_least(self) -> float:       # GB/s == MB/ms
        return self.rl


class PcieScheduler:
    def __init__(self, sim: LinkSim, bw_all: float, *,
                 bg_floor: float = 1e-3):
        self.sim = sim
        self.bw_all = bw_all
        #: minimum aggregate background weight when foreground demand
        #: oversubscribes bw_all (keeps bg flows defined; the per-link
        #: class priority, not this number, is what protects foreground)
        self.bg_floor = bg_floor
        self.flows: dict[str, _Flow] = {}
        self.bg_flows: dict[str, _Flow] = {}
        # class-churn observability
        self.demotions = 0       # bg grant shrunk by a foreground admit
        self.promotions = 0      # bg grant regrown by a foreground exit
        # per-transfer SLO attainment (foreground flows admitted with t=)
        self.fg_tracked = 0
        self.fg_missed = 0
        self.slo_misses: list[tuple[str, float, float]] = []
        self._admit_t: dict[str, deque] = {}
        # running sum of foreground rate_least floors and incrementally
        # tracked tightest flow — _reweigh runs on every admit/complete,
        # so O(flows) aggregates would make the scheduler O(flows^2) at
        # fleet concurrency
        self._total_rl = 0.0
        self._tightest: _Flow | None = None

    # ------------------------------------------------------------ admit ---
    def admit(self, func: str, size_mb: float, slo_ms: float = 1e9,
              infer_ms: float = 0.0, *, cls: str = FOREGROUND,
              t: float | None = None):
        """Admit one transfer.  Concurrent admissions under the same
        func id (a fan-in stage fetching several deps) are refcounted:
        the func keeps ONE DRR weight (latest SLO context wins) but
        stays admitted — and counted in the residual — until every
        admission completes, and each tracked admission gets its own
        FIFO-paired SLO-miss check."""
        if cls == BACKGROUND:
            fl = self.bg_flows.get(func)
            if fl is not None:
                fl.refs += 1
            else:
                self.bg_flows[func] = _Flow(func, size_mb, slo_ms,
                                            infer_ms, cls)
                self.sim.set_func_class(func, BACKGROUND)
        else:
            fl = self.flows.get(func)
            if fl is not None:
                fl.refs += 1
                fl.size_mb, fl.slo_ms, fl.infer_ms = \
                    size_mb, slo_ms, infer_ms
                self._total_rl -= fl.rl
                was_tightest = fl is self._tightest
                fl._refresh_rl()
                self._total_rl += fl.rl
                if was_tightest:
                    self._retighten()     # may have gone looser
                elif fl.tkey < self._tightest.tkey:
                    self._tightest = fl
            else:
                fl = self.flows[func] = _Flow(func, size_mb, slo_ms,
                                              infer_ms, cls)
                self._total_rl += fl.rl
                if self._tightest is None or fl.tkey < self._tightest.tkey:
                    self._tightest = fl
                if self.bg_flows:
                    # a NEW foreground flow shrinks the residual grant;
                    # a refs bump re-uses the existing floor
                    self.demotions += 1
            if t is not None and slo_ms < SLO_UNTRACKED_MS:
                self._admit_t.setdefault(func, deque()).append(
                    (t, slo_ms - infer_ms))
        self._reweigh()

    def complete(self, func: str, t: float | None = None):
        fl = self.flows.get(func)
        if fl is None:
            bfl = self.bg_flows.get(func)
            if bfl is not None:
                bfl.refs -= 1
                if bfl.refs > 0:
                    return
                del self.bg_flows[func]
        else:
            # one admission record retires per completion; the miss math
            # only runs when the caller supplies the completion time —
            # complete(func) without t releases an admission that was
            # never served (an aborted demand reload) without charging a
            # phantom miss.  Pairing is FIFO per func id: exact as long
            # as concurrent same-func admissions share their admit time
            # and slack (true for the executor, which fetches a stage's
            # deps in one loop at one sim.now — callers staggering
            # tracked admissions under one func id would need tickets)
            pend = self._admit_t.get(func)
            if pend:
                t_admit, slack = pend.popleft()
                if not pend:
                    del self._admit_t[func]
                if t is not None:
                    self.fg_tracked += 1
                    if t - t_admit > slack + 1e-9:
                        self.fg_missed += 1
                        self.slo_misses.append((func, t - t_admit, slack))
            fl.refs -= 1
            if fl.refs > 0:
                return          # siblings still in flight: keep the flow
            del self.flows[func]
            self._total_rl -= fl.rl
            if not self.flows:
                self._total_rl = 0.0    # re-anchor accumulated float drift
            if fl is self._tightest:
                self._retighten()       # amortized O(1): 1-in-F completes
            if self.bg_flows:
                # the flow's LAST completion regrows the residual grant
                self.promotions += 1
        # bound weights/_deficit/class growth across long traces: evict
        # the departed function's state once its transfers have drained
        self.sim.clear_func(func)
        self._reweigh()

    # ------------------------------------------------------------ weights -
    def residual_bw(self) -> float:
        """Bandwidth left after every foreground floor: the background
        class's aggregate grant."""
        return max(self.bw_all - self._total_rl, 0.0)

    def _retighten(self):
        self._tightest = min(self.flows.values(),
                             key=lambda f: f.tkey, default=None)

    def _reweigh(self):
        total_least = self._total_rl
        idle = max(self.bw_all - total_least, 0.0)
        w_tbl = self.sim.weights
        set_w = self.sim.set_rate_weight
        if self.flows:
            scale = min(1.0, self.bw_all / max(total_least, 1e-9))
            tightest = self._tightest
            bg_idle = self.bg_flows
            for f in self.flows.values():
                w = f.rl * scale
                if f is tightest and not bg_idle:
                    # no background class active: the idle bandwidth goes
                    # to the tightest-SLO foreground flow (§6.1 rule)
                    w += idle
                if w < 1e-6:
                    w = 1e-6
                # ~95% of per-admit weight refreshes land on the value
                # already installed (identical rate floors at scale):
                # skip the call, not just its body — this loop runs
                # O(flows) on every admit/complete
                if w_tbl.get(f.func, 1.0) != w:
                    set_w(f.func, w)
        if self.bg_flows:
            # residual-bandwidth grant, split evenly across bg flows;
            # recomputed here on every admit/complete = demote/promote
            w = max(idle, self.bg_floor) / len(self.bg_flows)
            if w < 1e-6:
                w = 1e-6
            for f in self.bg_flows.values():
                if w_tbl.get(f.func, 1.0) != w:
                    set_w(f.func, w)
