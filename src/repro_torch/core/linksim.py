"""Discrete-event link simulator — the timing model for every benchmark.

Chunk-level semantics, burst-coalesced execution.  Each directed link
transfers one chunk at a time at full link bandwidth; concurrency and
bandwidth sharing emerge from chunk interleaving, exactly the granularity
at which FaaSTube (and CUDA DMA engines) actually operate.  Scheduling
policy per link:

  fifo — native GPU PCIe scheduling (the paper's baseline behaviour)
  drr  — deficit-round-robin weighted by the scheduler's per-function rate
         allocations (FaaSTube's proportional batched triggering)

Traffic classes (§7 migration isolation): a function registered as
background via `set_func_class(func, "bg")` keeps its own DRR ring per
link, served only when no foreground chunk is available on that link —
strict priority at chunk granularity, so SLO-admitted foreground floors
survive any amount of spill/reload traffic.  A fully-arrived foreground
burst is never preempted by a background arrival (the newcomer just
queues); a background burst IS preempted by any foreground arrival at
the next chunk boundary, and background fills foreground arrival gaps
(work conservation — that idle time is the "residual bandwidth" the
scheduler grants the class).  Per-class delivered MB is tallied in
`mb_by_class` for the isolation benchmarks.  With no background
functions registered, every path below is byte-identical to the
single-class engine.

Engine design (the burst-coalesced event engine)
------------------------------------------------
The original engine simulated one heap event per chunk-hop, which put
~2.2M events through `step` for a single paper figure.  This engine keeps
chunk-exact *semantics* but dispatches at burst granularity:

* A transfer's chunks travel per path as a `_Burst`: `n` chunks of
  `chunk` MB (the final chunk carries the true size remainder) plus an
  *availability schedule* — piecewise-regular segments `(t0, interval,
  count)` giving the time each chunk reaches the link (submit-time batch
  triggering at hop 0, the upstream link's finish schedule afterwards).

* When a link's DRR/FIFO pick would hand the same function N consecutive
  chunks (the overwhelmingly common case — most links have 0 or 1 active
  flows), the whole run is dispatched as ONE `_Service` with a closed-form
  finish schedule `f_k = max(avail_k, f_{k-1}) + size_k/bw` — identical
  chunk timing, one heap event.  Multi-hop pipelining is preserved by
  forwarding the finish schedule to the next hop as that hop's
  availability schedule the moment the first chunk lands (not when the
  burst ends).

* Preemption point = next chunk boundary.  When a new function's chunks
  arrive at a link mid-burst, the in-flight burst is truncated at the end
  of the chunk currently on the wire: the stale completion event is
  invalidated via a per-link generation counter, the remaining chunks are
  returned to the queue, and per-chunk DRR/FIFO arbitration takes over —
  so fairness under contention matches the chunk-exact engine.  (The one
  permitted divergence class: chunk-boundary *ties* — an arrival landing
  exactly on a boundary, or competing chunks whose arrival times
  coincide in arrival-starved interleaves — may resolve one chunk slot
  differently, because the burst engine derives boundary times from
  segment arithmetic while the chunk-exact engine accumulates them and
  orders same-instant events by heap sequence.  A 200-scenario
  randomized sweep shows 98% exact matches, worst case ~3% — one chunk
  slot.)  Truncation cascades to downstream hops
  that were already promised the full schedule.  Under FIFO, a burst
  whose remaining chunks all *arrived* before the newcomer is NOT
  preempted (FIFO would drain them first anyway).

* DRR deficit counters are replayed in closed form when a coalesced burst
  completes (or is preempted / re-weighted mid-flight), so the credit a
  function accumulates while running solo matches the chunk-exact engine
  when contention arrives later.  `PcieScheduler` weight churn checkpoints
  this replay at the old weight before the new weight applies.

* **Round coalescing (contended links).**  When K functions share a link,
  the engine no longer dispatches one heap event per DRR chunk-pick.
  `_serve_round` runs the *real* weighted-DRR pick loop forward in
  virtual time — including deficit skips, the no-decrement fallback take,
  starvation (a function whose next chunk has not arrived leaves the ring
  and rejoins at the tail when it does), class priority, and the
  background aging guard — and commits the whole fair-share segment as a
  single `_Round` service: per-function finish schedules, one "done"
  heap event at the segment end.  A segment ends on a burst exhaustion
  at its final hop (a potential transfer completion, whose callbacks
  must fire at that instant) or when nothing further is serveable; it is
  *truncated at the current chunk boundary* by any mid-segment state
  change — an arrival on the link, a wake that changes ring membership,
  a weight change, or a class transition.  Truncation restores the
  ring/deficit/guard snapshot taken at segment start and deterministically
  replays the first `keep` picks (the loop is a pure function of static
  availability schedules), then cascades the cut to downstream hops per
  member burst.  Because the committed pick sequence IS the chunk-exact
  pick sequence, per-transfer completion times are byte-identical by
  construction; `tests/test_linksim_equiv.py` pins this on randomized
  contended multi-class traces.

* Events are plain tuples `(t, seq, kind, payload)` (no dataclass
  comparison on the heap), link bandwidth is cached per link keyed on
  `Topology.version`, and per-function queue/deficit/weight state is
  evicted once a function has no transfers in flight, so long traces do
  not leak.

`LinkSim(..., coalesce=False)` forces chunk-per-event dispatch through
the same pick logic — the semantic reference (equivalent to the seed
engine) used by the equivalence tests in `tests/test_linksim_equiv.py`.

Staging back-pressure: `submit(..., stage=ring, stage_mb=w,
stage_cls=..., stage_key=host)` makes a transfer reserve `w` MB of the
bounded circular pinned ring (per staging host) before its first chunk
may move; a full ring parks the launch on the ring's waiter queue and
the wait is real transfer latency.  The reservation is released at
transfer completion (see pinned_buffer.py for the occupancy/class
rules).

Time unit: ms.  Sizes: MB.  Bandwidth GB/s (== MB/ms, so t = size/bw).

Cost model knobs (paper-calibrated):
  pin_ms_per_mb   = 0.7   (70 ms / 100 MB pinned allocation, Fig. 5b)
  trigger_ms      = 0.01  (per chunk-batch launch overhead)
  alloc_ms        = 1.0 + 0.002/MB (cudaMalloc-style device allocation)
  ipc_ms          = 0.3   (CUDA IPC handle open per buffer)
"""
from __future__ import annotations

import itertools
import math
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass
from functools import partial
from heapq import heappop, heappush

from repro_torch.core.pinned_buffer import FOREGROUND
from repro_torch.core.topology import Topology, PCIE_UNPINNED

PIN_MS_PER_MB = 0.7
TRIGGER_MS = 0.01
BATCH_CHUNKS = 5
IPC_MS = 0.3

_INF = float("inf")

#: total events processed across every LinkSim instance in this process —
#: read by benchmarks/simperf.py to report events/sec per figure.
TOTAL_EVENTS = 0


def alloc_ms(size_mb: float) -> float:
    return 1.0 + 0.002 * size_mb


@dataclass(slots=True)
class Transfer:
    tid: int
    func: str
    size_mb: float
    paths: list          # [(path tuple, bw weight)]
    t_submit: float
    chunks_done: int = 0
    n_chunks: int = 0
    t_done: float = -1.0
    extra_latency: float = 0.0    # pin/alloc costs folded in
    on_done: object = None        # callback(sim, transfer)
    unpinned: bool = False        # host-adjacent hops capped at 3 GB/s
    stage: object = None          # staging ring holding this transfer's
    stage_mb: float = 0.0         # ..occupancy window, released on finish
    stage_cls: str = FOREGROUND   # ring-occupancy class (fg | bg)
    stage_key: str = "host"       # which host's ring (rings are per host)
    failed: str = ""              # non-empty: failure cause (fault model)
    parked: bool = False          # launch parked on a full staging ring
    on_progress: object = None    # callback(sim, landed_mb) at trigger-batch
    #                               boundaries of the FINAL hop (None: no
    #                               poke events are ever scheduled)
    src_segs: object = None       # optional source availability schedule
    #                               [(t0, interval, count), ...]: chunks
    #                               enter hop 0 per this schedule instead
    #                               of the submit-time trigger ramp (used
    #                               by cross-shard staged handoff to
    #                               stitch cut-through over a boundary)


class _Burst:
    """A run of chunks of one transfer travelling one path, at one hop.

    ``avail`` is a piecewise-regular schedule ``[(t0, interval, count),
    ...]`` giving the time chunk ``i`` becomes available at this hop.
    ``taken`` chunks from the front have already been dispatched; the
    final chunk has size ``last`` (the transfer's true size remainder),
    all others ``chunk``.
    """
    __slots__ = ("seq", "tid", "func", "path", "hop", "n", "taken",
                 "chunk", "last", "avail")

    def __init__(self, tid, func, path, hop, n, chunk, last, avail):
        self.seq = -1            # arrival order at the link; set on enqueue
        self.tid = tid
        self.func = func
        self.path = path
        self.hop = hop
        self.n = n
        self.taken = 0
        self.chunk = chunk
        self.last = last
        self.avail = avail


class _Service:
    """Chunks in flight on one link (a coalesced burst or a single pick)."""
    __slots__ = ("gen", "link", "burst", "start", "count", "fsegs", "dur",
                 "dur_last", "busy", "replayed", "downstream", "coalesced",
                 "func", "max_avail", "end")

    def __init__(self, gen, link, burst, start, count, fsegs, dur, dur_last,
                 busy, coalesced, downstream, max_avail, end):
        self.gen = gen
        self.link = link
        self.burst = burst
        self.start = start
        self.count = count
        self.fsegs = fsegs        # finish schedule of the served chunks
        self.dur = dur            # regular-chunk service time
        self.dur_last = dur_last  # service time of the final served chunk
        self.busy = busy          # total busy ms charged to link_busy_ms
        self.replayed = 0         # DRR picks already folded into _deficit
        self.downstream = downstream   # _Burst forwarded to the next hop
        self.coalesced = coalesced
        self.func = burst.func
        self.max_avail = max_avail     # last served chunk's arrival time
        self.end = end


class _RPart:
    """One member burst's share of a round-coalesced segment."""
    __slots__ = ("burst", "taken0", "count", "fsegs", "downstream", "busy",
                 "last_f", "dur", "bw")

    def __init__(self, burst, taken0, bw):
        self.burst = burst
        self.taken0 = taken0      # burst.taken at segment start
        self.count = 0            # chunks served in this segment
        self.fsegs: list[tuple] = []
        self.downstream = None
        self.busy = 0.0
        self.last_f = 0.0         # finish of the part's latest chunk
        self.bw = bw              # effective link bw for this transfer
        self.dur = burst.chunk / bw   # regular-chunk service time


class _Round:
    """A round-coalesced fair-share segment on a contended link: the
    committed weighted-DRR pick sequence between two state-change
    epochs, delivered as one heap event.

    ``picks_f``/``picks_d`` are the per-pick finish times / service
    durations (finish - dur == the pick's wire start, also across idle
    gaps).  ``snap`` is the (fg ring, bg ring, deficits, aging counter)
    state at segment start — truncation restores it and replays the
    first `keep` picks deterministically.
    """
    __slots__ = ("gen", "link", "start", "end", "picks_f", "picks_d",
                 "parts", "snap", "busy", "all_fg", "gapless", "horizon",
                 "wsnap", "bgsnap")

    def __init__(self, gen, link, start, end, picks_f, picks_d, parts,
                 snap, busy, all_fg, gapless, horizon):
        self.gen = gen
        self.link = link
        self.start = start
        self.end = end
        self.picks_f = picks_f
        self.picks_d = picks_d
        self.parts = parts
        self.snap = snap
        self.busy = busy
        self.all_fg = all_fg      # every pick is foreground class
        self.gapless = gapless    # picks are back-to-back from `start`
        #: last arrival seq visible when the segment was planned — a
        #: truncation replay must not see bursts that arrived later,
        #: or it would diverge from the committed prefix
        self.horizon = horizon
        #: plan-time weights / bg-class membership of every function
        #: that could influence the segment (ring members + queued) —
        #: replays read these, so later weight churn, weight eviction,
        #: or class flips cannot desynchronize the committed prefix
        self.wsnap: dict = {}
        self.bgsnap: set = set()


# ---------------------------------------------------------------- segments --

def _seg_at(segs, i):
    """Time of the i-th element of a piecewise-regular schedule."""
    for t0, iv, cnt in segs:
        if i < cnt:
            return t0 + iv * i
        i -= cnt
    raise IndexError(i)


def _seg_slice(segs, skip, take):
    """Sub-schedule covering entries [skip, skip+take)."""
    out = []
    for t0, iv, cnt in segs:
        if take <= 0:
            break
        if skip >= cnt:
            skip -= cnt
            continue
        c = cnt - skip
        if c > take:
            c = take
        out.append((t0 + iv * skip, iv, c))
        take -= c
        skip = 0
    return out


def _seg_prefix(segs, keep):
    """First `keep` entries of a schedule and the time of entry keep-1."""
    out, last = [], 0.0
    for t0, iv, cnt in segs:
        if keep <= 0:
            break
        c = min(cnt, keep)
        out.append((t0, iv, c))
        last = t0 + iv * (c - 1)
        keep -= c
    return out, last


def _seg_count_le(segs, t):
    """How many schedule entries are <= t."""
    n = 0
    for t0, iv, cnt in segs:
        if t0 > t:
            break
        if iv <= 0.0:
            n += cnt
            continue
        k = int((t - t0) / iv) + 1          # entries t0, t0+iv, ...
        n += min(cnt, max(k, 0))
        if k < cnt:
            break
    return n


def _emit(out, t0, iv, cnt):
    """Append a finish segment, merging contiguous equal-interval runs."""
    if out:
        lt0, liv, lc = out[-1]
        if lc == 1:
            if abs((t0 - lt0) - iv) <= 1e-9:
                out[-1] = (lt0, iv, cnt + 1)
                return
        elif abs(liv - iv) <= 1e-9 and abs(lt0 + liv * lc - t0) <= 1e-9:
            out[-1] = (lt0, liv, lc + cnt)
            return
    out.append((t0, iv, cnt))


def _serve_seg(f, t0, iv, cnt, d, out):
    """Closed-form service of cnt chunks (avail t0+iv*k, service time d
    each) on a link whose previous chunk finished at f.  Appends finish
    segments to `out`, returns the last finish time.

    f_k = max(t0 + iv*k, f_{k-1}) + d — three regimes: server-bound
    (iv <= d: back-to-back after the first chunk), arrival-bound
    (iv > d, link idle), or a server-bound head catching up to an
    arrival-bound tail.
    """
    if iv <= d + 1e-12:
        f0 = (t0 if t0 > f else f) + d
        _emit(out, f0, d, cnt)
        return f0 + d * (cnt - 1)
    if f <= t0 + 1e-12:
        _emit(out, t0 + d, iv, cnt)
        return t0 + d + iv * (cnt - 1)
    head = int((f - t0) / (iv - d)) + 1      # chunks still server-bound
    if head >= cnt:
        _emit(out, f + d, d, cnt)
        return f + d * cnt
    _emit(out, f + d, d, head)
    _emit(out, t0 + head * iv + d, iv, cnt - head)
    return t0 + (cnt - 1) * iv + d


# ------------------------------------------------------------------ engine --

class LinkSim:
    def __init__(self, topo: Topology, *, policy: str = "drr",
                 chunk_mb: float = 2.0, pinned_cached: bool = True,
                 unpinned_hosts: bool = False, coalesce: bool = True,
                 bg_every: int = 0):
        self.topo = topo
        self.policy = policy
        self.chunk_mb = chunk_mb
        self.pinned_cached = pinned_cached
        self.unpinned_hosts = unpinned_hosts
        self.coalesce = coalesce
        #: aging/quantum guard (DRR only): after `bg_every` consecutive
        #: foreground chunks served on a link while background work was
        #: available there, the next pick serves one background chunk —
        #: a continuously backlogged foreground can no longer starve
        #: migration.  0 keeps strict per-link class priority.
        self.bg_every = bg_every
        self.now = 0.0
        self.n_events = 0
        self._seq = itertools.count()
        self._arr_seq = itertools.count()
        self._events: list[tuple] = []
        # single event-push funnel: every scheduling site goes through
        # `self._push(ev)` so a sharded engine (core/shard.py) can route
        # events to per-node heaps by rebinding one attribute.  Bound to
        # a C-level partial here — zero overhead for the global heap.
        self._push = partial(heappush, self._events)
        # per-link scheduling state; func-keyed entries are evicted when a
        # function has no transfers in flight (see _finish_transfer)
        self._active: dict[tuple, _Service] = {}
        self._gen: dict[tuple, int] = {}
        self._queues: dict[tuple, dict[str, deque]] = {}
        self._fifo: dict[tuple, deque] = {}
        self._rr: dict[tuple, deque] = {}        # foreground DRR ring
        self._rrb: dict[tuple, deque] = {}       # background DRR ring
        self._cls_bg: set[str] = set()           # funcs in the bg class
        self._fgrun: dict[tuple, int] = {}       # fg chunks since last bg
        self.mb_by_class = {"fg": 0.0, "bg": 0.0}
        # round-planning mode: while set, starvation wakes on _plan_link
        # are captured into _plan_pend instead of the heap (the planner
        # processes rejoins internally; residual wakes are pushed at
        # commit time)
        self._plan_link = None
        self._plan_pend: list | None = None
        self._plan_seq = 0
        self._plan_horizon = None   # replay mode: max burst seq visible
        self._plan_pmin = _INF      # earliest pending internal rejoin
        self._plan_w = None         # replay mode: plan-time weights
        self._plan_bg = None        # replay mode: plan-time bg classes
        self._arr_hi = -1           # last arrival seq handed out
        self._deficit: dict[tuple, dict[str, float]] = {}
        self._wake: dict[tuple, float] = {}
        self.weights: dict[str, float] = {}
        self.transfers: dict[int, Transfer] = {}
        self._tid = itertools.count()
        self.link_busy_ms: dict[tuple, float] = {}
        self._func_tr: dict[str, int] = {}       # live transfers per func
        # links a func ever queued on — an insertion-ordered dict used
        # as a set: iteration order must be deterministic (weight-churn
        # truncations walk it, and their relative order shifts heap
        # sequence numbers), and set iteration is salted per process
        self._func_links: dict[str, dict] = {}
        self._pending_clear: set[str] = set()    # clear_func awaiting drain
        self._bw_cache: dict[tuple, tuple] = {}
        self._bw_version = -1
        # ---- fault model (core/faults.py) -------------------------------
        # `_chaos` arms the failure checks; until the first kill_link /
        # fail_transfer / retime_link call it stays False and every
        # fault guard below short-circuits on one attribute read — the
        # no-fault event stream is byte-identical to the pre-fault
        # engine (pinned by tests/test_transfer_equiv.py).
        self._chaos = False
        self._dead_links: set[tuple] = set()     # both directions of
        self._freeze: set[tuple] = set()         # ..each killed edge


    # ------------------------------------------------------------ submit --
    @staticmethod
    def _round_involves(svc, func) -> bool:
        """Whether func participates in a committed round segment.
        ``wsnap`` holds every ring member and queued function at plan
        time — the rings/queues themselves evolve eagerly through the
        whole plan, so they cannot tell mid-segment relevance.  A
        function outside this set cannot be picked before the segment
        ends, and truncation replays read the plan-time weight/class
        snapshots, so a change to it needs no cut."""
        return func in svc.wsnap

    def set_rate_weight(self, func: str, weight: float):
        weight = max(weight, 1e-6)
        old = self.weights.get(func, 1.0)
        if weight != old:
            # checkpoint the deficit replay of any coalesced burst in
            # flight at the OLD weight before the new one takes effect;
            # a round-coalesced segment's pick pattern depends on the
            # weight, so it is cut at the chunk boundary (the replay
            # inside _trunc_round runs from the plan-time snapshots) and
            # re-planned by the next dispatch under the new one
            for link in self._func_links.get(func, ()):
                svc = self._active.get(link)
                if svc is None:
                    continue
                if type(svc) is _Round:
                    if self._round_involves(svc, func):
                        self._trunc_round(svc, self._keep_round(svc))
                elif svc.coalesced and svc.func == func:
                    picks = self._keep_count(svc)
                    self._replay_deficit(link, func, picks - svc.replayed)
                    svc.replayed = max(svc.replayed, picks)
        self.weights[func] = weight

    def set_func_class(self, func: str, cls: str):
        """Assign func to a traffic class ("fg" default, "bg" for
        migration traffic).  Background funcs queue on a separate DRR
        ring per link that is only served when no foreground chunk is
        available there.  Class membership follows the set_rate_weight
        contract: it outlives individual transfers and is evicted by
        clear_func.

        A MID-FLIGHT transition (the function still has bursts queued)
        is a segment boundary for round-coalesced service, and the
        function's queued ring membership moves to its new class ring —
        re-entering at the tail like a fresh arrival, identically in
        both engines (the chunk-exact reference runs this same code)."""
        new_bg = cls == "bg"
        if new_bg == (func in self._cls_bg):
            return
        old_rings = self._rrb if func in self._cls_bg else self._rr
        new_rings = self._rrb if new_bg else self._rr
        for link in self._func_links.get(func, ()):
            svc = self._active.get(link)
            if type(svc) is _Round and (
                    self._round_involves(svc, func)
                    or self._queues.get(link, {}).get(func)):
                # the second clause catches a function that arrived
                # AFTER the segment was planned (a background arrival
                # against an all-fg gapless round does not truncate):
                # its transition changes which class ring its queued
                # chunks contend from, so the segment must end here
                self._trunc_round(svc, self._keep_round(svc))
            elif (self.policy == "drr" and svc is not None
                    and type(svc) is not _Round
                    and svc.coalesced and svc.count > 1):
                if func != svc.func:
                    if self._queues.get(link, {}).get(func):
                        # a queued function switching class against a
                        # solo coalesced burst mirrors _enqueue's
                        # arrival rule: a promotion to foreground
                        # preempts at the next chunk boundary exactly as
                        # a fresh fg arrival would, while a demotion to
                        # background (vs a foreground burst, guard off)
                        # keeps waiting
                        arrived = svc.max_avail <= self.now + 1e-12
                        if not (arrived and new_bg
                                and svc.func not in self._cls_bg
                                and not self.bg_every):
                            self._truncate(svc, self._keep_count(svc))
                else:
                    q = self._queues.get(link)
                    if q and any(g != func and dq for g, dq in q.items()):
                        # the RUNNING function's own class changed with
                        # other work queued: its remaining chunks now
                        # contend under a different priority, so the
                        # burst ends at the boundary and per-pick
                        # arbitration takes over
                        self._truncate(svc, self._keep_count(svc))
            rr = old_rings.get(link)
            if rr is not None and func in rr:
                rr.remove(func)
                if self._queues.get(link, {}).get(func):
                    nr = new_rings.get(link)
                    if nr is None:
                        nr = new_rings[link] = deque()
                    if func not in nr:
                        nr.append(func)
        if new_bg:
            self._cls_bg.add(func)
        else:
            self._cls_bg.discard(func)

    def _ring(self, link, func, create: bool = False):
        """The DRR ring (fg or bg) func belongs to on this link.  In
        replay mode the plan-time class membership decides, so a class
        flip after the segment was committed cannot re-route a replayed
        rejoin."""
        bg = self._plan_bg if self._plan_bg is not None else self._cls_bg
        rings = self._rrb if func in bg else self._rr
        rr = rings.get(link)
        if rr is None and create:
            rr = rings[link] = deque()
        return rr

    def clear_func(self, func: str):
        """Evict func's rate weight and per-link deficit credit — bounds
        the growth of `weights` / `_deficit` across long traces.

        Called by PcieScheduler.complete; with transfers still in
        flight the eviction is deferred until the last one drains.
        Weights set directly via set_rate_weight stay put until
        clear_func is called — a transfer draining does NOT reset the
        caller's chosen weight (only deficit credit is dropped then).
        """
        if self._func_tr.get(func):
            self._pending_clear.add(func)    # evict once drained
            return
        self._pending_clear.discard(func)
        self.weights.pop(func, None)
        self._cls_bg.discard(func)
        self._drop_func_state(func)

    def _drop_func_state(self, func: str):
        self._func_tr.pop(func, None)
        for link in self._func_links.pop(func, ()):
            dd = self._deficit.get(link)
            if dd is not None:
                dd.pop(func, None)
            # purge stale DRR ring membership: a drained function has no
            # queued bursts anywhere, so a lingering ring entry is pure
            # re-scan overhead that accumulates across long traces
            for rings in (self._rr, self._rrb):
                rr = rings.get(link)
                if rr is not None and func in rr:
                    rr.remove(func)
                if rr is not None and not rr:
                    del rings[link]
            q = self._queues.get(link)
            if q is not None:
                dq = q.get(func)
                if dq is not None and not dq:
                    del q[func]
                if not q:
                    del self._queues[link]

    def call_at(self, t: float, fn):
        """Schedule an arbitrary callback(sim) at time t."""
        self._push((t, next(self._seq), "call", fn))

    # ------------------------------------------------------------- faults --
    def _cut_active(self, link):
        """Truncate whatever service is running on `link` at the current
        chunk boundary (committed prefix kept, remainder requeued)."""
        svc = self._active.get(link)
        if svc is None:
            return
        if type(svc) is _Round:
            self._trunc_round(svc, self._keep_round(svc))
        else:
            self._truncate(svc, self._keep_count(svc))

    def kill_link(self, a: str, b: str, cause: str = ""):
        """Fail the edge a-b at the current instant.

        In-flight coalesced service is truncated at the failure epoch
        (the chunk on the wire completes; nothing after it does), every
        transfer with chunks queued on the edge is failed with a
        structured cause, and future arrivals onto the edge fail their
        transfer on contact.  Call BEFORE removing the edge from the
        topology (PathFinder.fail_link): truncation replay prices the
        committed prefix at the bandwidth it actually ran at.
        """
        self._chaos = True
        links = ((a, b), (b, a))
        self._dead_links.update(links)
        self._freeze.update(links)
        victims: dict[int, None] = {}
        try:
            for link in links:
                self._cut_active(link)
                q = self._queues.get(link)
                if q:
                    for dq in q.values():
                        for bb in dq:
                            if bb.taken < bb.n:
                                victims[bb.tid] = None
        finally:
            self._freeze.difference_update(links)
        cause = cause or f"link {a}-{b}"
        for tid in victims:
            self.fail_transfer(tid, cause)

    def retime_link(self, a: str, b: str, bw: float):
        """Change the edge's bandwidth mid-flight (brownout/restore).

        Active services are cut at the current chunk boundary at the OLD
        bandwidth (the committed prefix physically ran at it), then the
        topology edge is rescaled and the remainder re-dispatches at the
        new rate from the next boundary on.
        """
        self._chaos = True
        links = ((a, b), (b, a))
        self._freeze.update(links)
        try:
            for link in links:
                self._cut_active(link)
            self.topo.set_bw(a, b, bw)      # invalidates the bw cache
        finally:
            self._freeze.difference_update(links)
        for link in links:
            if link not in self._active:
                self._dispatch(link)

    def fail_transfer(self, tid: int, cause: str = "failed"):
        """Fail one in-flight transfer: truncate every service carrying
        its chunks at the committed boundary, purge its queued bursts,
        and surface a failed completion (``tr.failed`` set, ``on_done``
        fired, staging window released, NO delivered-MB credit) once the
        last committed chunk lands.  Idempotent; no-op on transfers that
        already completed."""
        tr = self.transfers.get(tid)
        if tr is None or tr.t_done >= 0 or tr.failed:
            return
        self._chaos = True
        tr.failed = cause
        t_fire = self.now
        for link in tuple(self._func_links.get(tr.func, ())):
            svc = self._active.get(link)
            if svc is not None:
                if type(svc) is _Round:
                    if any(p.burst.tid == tid for p in svc.parts):
                        self._trunc_round(svc, self._keep_round(svc))
                elif svc.burst.tid == tid:
                    self._truncate(svc, self._keep_count(svc))
            svc = self._active.get(link)     # truncation may replace it
            if svc is not None:
                involved = (any(p.burst.tid == tid for p in svc.parts)
                            if type(svc) is _Round
                            else svc.burst.tid == tid)
                if involved and svc.end > t_fire:
                    t_fire = svc.end         # last committed chunk lands
            self._purge_failed(link)
        if tr.parked:
            return    # completes at the staging-ring grant (_launch)
        if t_fire <= self.now:
            self._finish_failed(tr)
        else:
            self.call_at(t_fire, lambda sim, tr=tr: sim._finish_failed(tr))

    def _purge_failed(self, link):
        """Drop queued bursts of failed transfers from one link's
        scheduling state.  Re-run after every truncation while the fault
        model is armed: a snapshot restore re-merges member bursts into
        the queue, which would otherwise resurrect purged chunks."""
        q = self._queues.get(link)
        transfers = self.transfers
        if q:
            for f in list(q):
                dq = q[f]
                live = [bb for bb in dq if not transfers[bb.tid].failed]
                if len(live) == len(dq):
                    continue
                if live:
                    q[f] = deque(live)
                    continue
                del q[f]
                for rings in (self._rr, self._rrb):
                    rr = rings.get(link)
                    if rr is not None and f in rr:
                        rr.remove(f)
            if not q:
                self._queues.pop(link, None)
        fifo = self._fifo.get(link)
        if fifo:
            live = [bb for bb in fifo if not transfers[bb.tid].failed]
            if len(live) != len(fifo):
                self._fifo[link] = deque(live)

    def _finish_failed(self, tr):
        """Failed-completion path: identical bookkeeping to success
        (stage release, func-state drain, ``on_done`` — callers read
        ``tr.failed`` to route the error) minus the delivered-MB
        credit."""
        if tr.t_done >= 0:
            return
        self._finish_transfer(tr)

    def submit(self, func: str, paths, size_mb: float, *,
               t: float | None = None, pin_fresh_mb: float = 0.0,
               alloc_fresh_mb: float = 0.0, ipc_handles: int = 0,
               on_done=None, on_progress=None, unpinned: bool = False,
               stage=None, stage_mb: float = 0.0,
               stage_cls: str = FOREGROUND,
               stage_key: str = "host", avail_segs=None) -> int:
        """Submit a (possibly multi-path) transfer.  paths: [(path, bw)].

        ``stage``/``stage_mb``: staging back-pressure.  The transfer must
        reserve ``stage_mb`` of the staging ring (``stage.try_reserve``)
        before its first chunk may move; when the ring is full the launch
        is parked on the ring's FIFO (``stage.wait``) and fires at the
        grant time — the wait is real latency on the transfer.  The
        reservation is released at transfer completion, waking waiters.

        ``on_progress``: optional ``cb(sim, landed_mb)`` fired at
        trigger-batch boundaries as chunks land on the FINAL hop (plus
        at every final-hop service completion).  When None — the default
        — no poke events are ever scheduled, so the heap event stream is
        byte-identical to a progress-free run.
        """
        t = self.now if t is None else t
        tid = next(self._tid)
        tr = Transfer(tid, func, size_mb, list(paths), t, on_done=on_done,
                      unpinned=unpinned, on_progress=on_progress,
                      src_segs=avail_segs)
        # fixed costs charged before the first chunk moves
        if pin_fresh_mb > 0:
            tr.extra_latency += PIN_MS_PER_MB * pin_fresh_mb
        if alloc_fresh_mb > 0:
            tr.extra_latency += alloc_ms(alloc_fresh_mb)
        tr.extra_latency += IPC_MS * ipc_handles
        start = t + tr.extra_latency

        n_chunks = max(1, math.ceil(size_mb / self.chunk_mb - 1e-9))
        # the final chunk carries the true remainder so sub-chunk transfers
        # are not rounded up to a full chunk_mb
        last_mb = size_mb - (n_chunks - 1) * self.chunk_mb
        tr.n_chunks = n_chunks
        total_bw = sum(bw for _, bw in tr.paths) or 1.0
        # stripe chunks across paths proportional to path bandwidth (§6.2)
        alloc = [max(1, round(n_chunks * bw / total_bw)) for _, bw in tr.paths]
        while sum(alloc) > n_chunks:
            alloc[alloc.index(max(alloc))] -= 1
        while sum(alloc) < n_chunks:
            alloc[alloc.index(min(alloc))] += 1
        real = []
        ci = 0
        for (path, _bw), n in zip(tr.paths, alloc):
            if len(path) < 2:            # degenerate: src == dst, instant
                tr.n_chunks -= n
                continue
            if n > 0:
                real.append((tuple(path), n, ci))
            ci += n
        self.transfers[tid] = tr
        if tr.n_chunks <= 0 or not real:
            tr.n_chunks = 0
            tr.t_done = start
            if tr.on_done is not None:
                self.call_at(start, lambda sim, tr=tr: tr.on_done(sim, tr))
            return tid
        self._func_tr[func] = self._func_tr.get(func, 0) + 1
        if stage is not None and stage_mb > 0.0:
            tr.stage, tr.stage_mb, tr.stage_cls = stage, stage_mb, stage_cls
            tr.stage_key = stage_key
            # ring full (or transfers already parked that this one must
            # not jump): park the launch; it fires when an in-flight
            # window is released (back-pressure — the wait is part of
            # the transfer's latency, t_submit stays put)
            if not stage.reserve_or_wait(
                    stage_mb,
                    lambda t_grant, tr=tr, real=real, lm=last_mb:
                    self._launch(tr, real, lm,
                                 max(t_grant, tr.t_submit)
                                 + tr.extra_latency),
                    stage_cls, stage_key):
                tr.parked = True
                return tid
        self._launch(tr, real, last_mb, start)
        return tid

    def _launch(self, tr: Transfer, real, last_mb: float, start: float):
        """Schedule the per-path chunk arrival events of a transfer."""
        tr.parked = False
        if tr.failed:
            # failed while parked on a full staging ring: the grant just
            # reserved the window — complete as failed now, releasing it
            self._finish_failed(tr)
            return
        trig = TRIGGER_MS / BATCH_CHUNKS
        src = tr.src_segs
        if src is not None and (len(real) != 1 or src[0][0] < start
                                or sum(s[2] for s in src) != real[0][1]):
            # the upstream schedule only applies to a single-path launch
            # whose chunk count matches and whose first chunk is not
            # already in the past — otherwise the data is simply present
            # and the normal trigger ramp is the correct semantics
            src = None
        for pi, (path, n, ci0) in enumerate(real):
            # batched triggering: chunk ci launches at start + (ci//B)*trig.
            # Represented as one linear segment at the average trigger rate
            # (trig per chunk): the per-chunk shift is < TRIGGER_MS and the
            # launch rate is always faster than any link's service rate, so
            # chunk finish times are unchanged.
            segs = list(src) if src is not None \
                else [(start + ci0 * trig, trig, n)]
            is_last_path = pi == len(real) - 1
            b = _Burst(tr.tid, tr.func, path, 0, n, self.chunk_mb,
                       last_mb if is_last_path else self.chunk_mb, segs)
            self._push((segs[0][0], next(self._seq), "arrive", b))

    # ------------------------------------------------------------ engine --
    def _link_bw(self, link) -> tuple:
        """(bandwidth, host_adjacent) for a link, cached on topo.version."""
        if self._bw_version != self.topo.version:
            self._bw_cache.clear()
            self._bw_version = self.topo.version
        hit = self._bw_cache.get(link)
        if hit is None:
            a, b = link
            bw = self.topo.bw(a, b)
            if self.unpinned_hosts and ("host" in a or "host" in b or
                                        "pcie" in a or "pcie" in b):
                bw = min(bw, PCIE_UNPINNED)
            host_adj = any(
                n.startswith(("host", "pcie")) or ":host" in n or ":pcie" in n
                for n in link)
            hit = (bw, host_adj)
            self._bw_cache[link] = hit
        return hit

    def _eff_bw(self, link, tr) -> float:
        bw, host_adj = self._link_bw(link)
        if tr.unpinned and host_adj:
            bw = min(bw, PCIE_UNPINNED)
        return max(bw, 1e-9)

    def _wake_push(self, link, t, func=None):
        """Re-check a link at time t — for `func`, this re-enacts the
        chunk-exact engine's rr rejoin: a starved function leaves the
        round-robin ring and re-enters at the TAIL when its next chunk
        arrives, which is exactly this wake's fire time.

        While a round segment is being planned on `link`, the wake is
        captured into the plan's pending-rejoin list instead: the
        planner processes rejoins internally and only pushes real wakes
        for entries still pending at commit."""
        if t == _INF:
            # a queue whose remaining entries are all exhausted has no
            # future availability: there is nothing to wake for, and an
            # infinity-timestamped event would drag sim.now to infinity
            # when the heap finally drains
            return
        if self._plan_pend is not None and link == self._plan_link \
                and func is not None:
            self._plan_seq += 1
            self._plan_pend.append((t, self._plan_seq, func))
            if t < self._plan_pmin:
                self._plan_pmin = t
            return
        key = (link, func)
        cur = self._wake.get(key)
        if cur is not None and cur <= t + 1e-12:
            return
        self._wake[key] = t
        self._push((t, next(self._seq), "wake", key))

    def _wake_fire(self, key):
        self._wake.pop(key, None)
        link, func = key
        if func is not None and self.policy == "drr":
            dq = self._queues.get(link, {}).get(func)
            if dq:
                b, fut = self._avail_front(dq, self.now)
                if b is not None:
                    # a ring-membership change is a segment boundary for
                    # an active round: cut it at the chunk boundary
                    # BEFORE the rejoin, so the restored+replayed ring is
                    # the one the newcomer appends to
                    svc = self._active.get(link)
                    need_cut = type(svc) is _Round
                    if need_cut:
                        rr = self._ring(link, func)
                        need_cut = rr is None or func not in rr
                    if need_cut:
                        self._trunc_round(svc, self._keep_round(svc))
                    rr = self._ring(link, func, create=True)
                    if func not in rr:
                        rr.append(func)       # rejoin at the tail
                elif fut < _INF:
                    self._wake_push(link, fut, func)
        if link not in self._active:
            self._dispatch(link)

    # ---------------------------------------------------------- queueing --
    def _enqueue(self, link, b):
        if b.taken >= b.n:            # emptied by an upstream truncation
            return
        q = self._queues.get(link)
        if self.coalesce and not q and link not in self._active:
            # fast path: idle link, no queue — serve the burst in place.
            # (arrival events fire exactly at the first chunk's
            # availability, so no wake is needed; a later preemption
            # re-registers the remainder through _truncate.)
            self._func_links.setdefault(b.func, {})[link] = None
            if self.policy == "fifo":
                fifo = self._fifo.get(link)
                if fifo is None:
                    fifo = self._fifo[link] = deque()
                fifo.append(b)
            self._serve_burst(link, b, b.n - b.taken)
            return
        if q is None:
            q = self._queues[link] = {}
        dq = q.get(b.func)
        if dq is None:
            dq = q[b.func] = deque()
        dq.append(b)
        self._func_links.setdefault(b.func, {})[link] = None
        svc = self._active.get(link)
        if type(svc) is _Round:
            # an arrival is a segment boundary for round-coalesced
            # service — cut at the chunk boundary BEFORE the ring append
            # below, so the newcomer lands at the tail of the
            # restored+replayed ring (chunk-exact arrival order).  The
            # one exception mirrors the class rule: a background arrival
            # cannot obtain service before a gapless all-foreground
            # segment ends (strict priority, no idle to fill), so that
            # segment stands — unless the aging guard owes background a
            # slot.
            if not (b.func in self._cls_bg and svc.all_fg and svc.gapless
                    and not self.bg_every):
                self._trunc_round(svc, self._keep_round(svc))
        if self.policy == "fifo":
            f = self._fifo.get(link)
            if f is None:
                f = self._fifo[link] = deque()
            f.append(b)
        else:
            # arrival-order rr membership: the arriving burst's first
            # chunk is available NOW, so the function (re)joins its
            # class's ring at the tail exactly as a chunk arrival would
            # in the chunk-exact engine
            rr = self._ring(link, b.func, create=True)
            if b.func not in rr:
                rr.append(b.func)
        svc = self._active.get(link)
        if svc is None:
            self._dispatch(link)
        elif type(svc) is _Round:
            return
        elif svc.coalesced and svc.count > 1:
            # A new entry arrived mid-burst: preemption point is the next
            # chunk boundary.  A burst whose remaining chunks all already
            # arrived is NOT preempted by FIFO (it drains older chunks
            # first anyway), nor by a same-function entry (within one
            # function, chunks are served in arrival order either way),
            # nor by a BACKGROUND arrival against a foreground burst
            # (class priority: migration waits for the link); any other
            # DRR arrival preempts, and any arrival preempts a burst
            # still waiting on future chunks — the chunk-exact engine
            # would fill those idle gaps.
            arrived = svc.max_avail <= self.now + 1e-12
            if arrived and (self.policy == "fifo" or b.func == svc.func
                            or (b.func in self._cls_bg
                                and svc.func not in self._cls_bg
                                and not self.bg_every)):
                return
            self._truncate(svc, self._keep_count(svc))

    def _avail_front(self, dq, now):
        """Oldest available (arrival-time, seq) burst of one function's
        queue, plus the earliest future availability if none is ready.

        In replay mode (`_plan_horizon` set) bursts that arrived after
        the segment being replayed was planned are invisible — the
        committed prefix was chosen without them."""
        while dq and dq[0].taken >= dq[0].n:
            dq.popleft()
        hz = self._plan_horizon
        if len(dq) == 1:
            # the overwhelmingly common shape: one live burst per func
            b = dq[0]
            if hz is not None and b.seq > hz:
                return None, _INF
            i = b.taken
            for t0, iv, cnt in b.avail:
                if i < cnt:
                    a = t0 + iv * i
                    break
                i -= cnt
            if a <= now + 1e-12:
                return b, _INF
            return None, a
        best = None
        bk = None
        fut = _INF
        for b in dq:
            if b.taken >= b.n or (hz is not None and b.seq > hz):
                continue
            a = _seg_at(b.avail, b.taken)
            if a <= now + 1e-12:
                k = (a, b.seq)
                if bk is None or k < bk:
                    best, bk = b, k
            elif a < fut:
                fut = a
        return best, fut

    # ------------------------------------------------------------- picks --
    def _pick_drr(self, link, now):
        """Class-priority DRR pick: serve the foreground ring; only when
        it yields no available chunk may the background ring send one
        (strict priority at chunk granularity — the background class
        gets exactly the link's residual capacity).

        With the aging guard enabled (`bg_every` > 0), a run of
        `bg_every` foreground chunks served while background work sat
        ready on the link forces the next pick to come from the
        background ring — one quantum, then the counter resets."""
        n = self.bg_every
        rrb = self._rrb.get(link) if (n or self._rrb) else None
        if n and rrb and self._fgrun.get(link, 0) >= n:
            f, b = self._pick_ring(link, rrb, now)
            if b is not None:
                self._fgrun[link] = 0
                return f, b
        f, b = self._pick_ring(link, self._rr.get(link), now)
        if b is None:
            if rrb is not None:
                f, b = self._pick_ring(link, rrb, now)
                if b is not None and n:
                    self._fgrun[link] = 0     # bg served in an fg gap
        elif n and rrb and self._bg_ready(link, rrb, now):
            self._fgrun[link] = self._fgrun.get(link, 0) + 1
        return f, b

    def _bg_ready(self, link, rrb, now):
        """Any background chunk available on this link right now?"""
        q = self._queues.get(link)
        if not q:
            return False
        for f in rrb:
            dq = q.get(f)
            if dq:
                b, _fut = self._avail_front(dq, now)
                if b is not None:
                    return True
        return False

    def _pick_ring(self, link, rr, now):
        """Port of the chunk-exact DRR pick over one ring's burst-front
        chunks."""
        weights = self._plan_w if self._plan_w is not None else self.weights
        q = self._queues[link]
        if not rr:
            return None, None
        dd = self._deficit.get(link)
        if dd is None:
            dd = self._deficit[link] = {}
        chunk = self.chunk_mb
        if len(rr) == 1:
            # dominant shape: one function on the ring.  The generic
            # loop's deficit miss falls through to the no-decrement
            # fallback take of the SAME burst (re-running _avail_front
            # on unchanged state), so the pick is unconditional here —
            # only the deficit arithmetic differs between a pass and a
            # fallback take, and both leave `dd[f]` exactly as below.
            f = rr[0]
            dq = q.get(f)
            if not dq:
                rr.popleft()
                q.pop(f, None)
                return None, None
            b, fut = self._avail_front(dq, now)
            if not dq:
                rr.popleft()
                q.pop(f, None)
                return None, None
            if b is None:
                rr.popleft()
                self._wake_push(link, fut, f)
                return None, None
            d = dd.get(f, 0.0) + weights.get(f, 1.0) * chunk
            dd[f] = d - chunk if d >= chunk else d
            return f, b
        qget = q.get
        ddget = dd.get
        wget = weights.get
        front = self._avail_front
        rotate = rr.rotate
        for _ in range(len(rr)):
            f = rr[0]
            dq = qget(f)
            if not dq:
                rr.popleft()
                q.pop(f, None)
                continue
            b, fut = front(dq, now)
            if not dq:
                rr.popleft()
                q.pop(f, None)
                continue
            if b is None:
                # starved: leave the ring now, rejoin at the tail when
                # the next chunk arrives (chunk-exact rr semantics)
                rr.popleft()
                self._wake_push(link, fut, f)
                continue
            d = ddget(f, 0.0) + wget(f, 1.0) * chunk
            if d >= chunk:
                dd[f] = d - chunk
                rotate(-1)
                return f, b
            dd[f] = d
            rotate(-1)
        if rr:
            f = rr[0]
            dq = qget(f)
            if dq:
                b, fut = front(dq, now)
                if b is not None:
                    return f, b
        return None, None

    def _pick_fifo(self, link):
        """Oldest available chunk across all queued entries, ordered by
        (arrival time, entry seq) — chunk-arrival FIFO, which is what the
        chunk-per-event engine's per-chunk seq ordering reduces to."""
        now = self.now
        fifo = self._fifo.get(link)
        if not fifo:
            return None, None
        while fifo and fifo[0].taken >= fifo[0].n:
            fifo.popleft()
        if not fifo:
            return None, None
        best = None
        bk = None
        fut = _INF
        for b2 in fifo:
            if b2.taken >= b2.n:
                continue
            a = _seg_at(b2.avail, b2.taken)
            if a <= now + 1e-12:
                k = (a, b2.seq)
                if bk is None or k < bk:
                    best, bk = b2, k
            elif a < fut:
                fut = a
        if best is not None:
            return best.func, best
        if fut < _INF:
            self._wake_push(link, fut)
        return None, None

    def _fifo_min_other(self, link, b):
        """Earliest arrival among OTHER queued entries' next chunks —
        every chunk of b arriving before that is older than any
        contender, so FIFO serves that whole prefix contiguously."""
        fut = _INF
        for b2 in self._fifo.get(link, ()):
            if b2 is b or b2.taken >= b2.n:
                continue
            a = _seg_at(b2.avail, b2.taken)
            if a < fut:
                fut = a
        return fut

    # ---------------------------------------------------------- dispatch --
    def _dispatch(self, link):
        if link in self._active:
            return
        if self._chaos and (link in self._dead_links
                            or link in self._freeze):
            return
        q = self._queues.get(link)
        if not q:
            return
        now = self.now
        if self.coalesce and len(q) == 1:
            (f, dq), = q.items()
            b, fut = self._avail_front(dq, now)
            if not dq:
                del q[f]
                rr = self._ring(link, f)
                if rr is not None and f in rr:
                    rr.remove(f)
                return
            if b is None:
                self._wake_push(link, fut)
                return
            m = b.n - b.taken
            if len(dq) > 1:
                # same function, several entries: chunks are served in
                # arrival order ACROSS entries, so cap this burst where
                # the next entry's front chunk becomes older
                mo = min((_seg_at(e.avail, e.taken) for e in dq
                          if e is not b and e.taken < e.n), default=_INF)
                if mo < _INF:
                    c = _seg_count_le(b.avail, mo + 1e-12) - b.taken
                    m = min(m, c) if c >= 1 else 1
            self._serve_burst(link, b, m)
            return
        if self.policy == "fifo":
            f, b = self._pick_fifo(link)
            if b is None:
                return
            remaining = b.n - b.taken
            if self.coalesce and remaining > 1:
                min_other = self._fifo_min_other(link, b)
                if min_other == _INF:
                    m = remaining
                else:
                    m = _seg_count_le(b.avail, min_other + 1e-12) - b.taken
                    if m < 1:
                        m = 1
                    elif m > remaining:
                        m = remaining
                if m > 1:
                    self._serve_burst(link, b, m)
                    return
        else:
            if self.coalesce:
                self._serve_round(link)
                return
            f, b = self._pick_drr(link, now)
            if b is None:
                return
        self._serve_burst(link, b, 1, picked=True)

    def _serve_burst(self, link, b, count, picked=False):
        if self.bg_every and b.func in self._cls_bg:
            # any background service resets the aging guard's run
            # counter, exactly as the pick-level reset does — a solo
            # coalesced bg burst has no picks to do it
            self._fgrun[link] = 0
        tr = self.transfers[b.tid]
        bw = self._eff_bw(link, tr)
        dur = b.chunk / bw
        start = b.taken
        now = self.now
        includes_last = start + count == b.n
        dur_last = b.last / bw if includes_last else dur
        fsegs: list[tuple] = []
        if count == 1:
            a = _seg_at(b.avail, start)
            f = (a if a > now else now) + dur_last
            fsegs.append((f, 0.0, 1))
            busy = dur_last
            max_avail = a
        else:
            n_reg = count - 1 if includes_last else count
            f = now
            busy = dur * n_reg
            max_avail = now
            sl = _seg_slice(b.avail, start, n_reg)
            for (t0, iv, cnt) in sl:
                f = _serve_seg(f, t0, iv, cnt, dur, fsegs)
            if sl:
                t0, iv, cnt = sl[-1]
                max_avail = t0 + iv * (cnt - 1)
            if includes_last:
                a = _seg_at(b.avail, b.n - 1)
                f = (a if a > f else f) + dur_last
                _emit(fsegs, f, 0.0, 1)
                busy += dur_last
                if a > max_avail:
                    max_avail = a
        b.taken = start + count
        q = self._queues.get(link)
        dq = q.get(b.func) if q else None
        if dq is not None:
            while dq and dq[0].taken >= dq[0].n:
                dq.popleft()
            if not dq:
                del q[b.func]
                # eager ring eviction at drain: the chunk-exact pick pops
                # an empty-queue function as a no-op visit, but a
                # coalesced solo phase has no picks — without this, a
                # drained function's stale ring entry survives into the
                # next contention epoch and re-arrivals keep a position
                # the reference engine would have recycled
                rr = self._ring(link, b.func)
                if rr is not None and b.func in rr:
                    rr.remove(b.func)
        self.link_busy_ms[link] = self.link_busy_ms.get(link, 0.0) + busy
        gen = self._gen.get(link, 0) + 1
        self._gen[link] = gen
        downstream = None
        if b.hop + 2 < len(b.path):
            # pipelined multi-hop forwarding: the next hop learns the
            # finish schedule the moment the first chunk lands on it
            downstream = _Burst(
                b.tid, b.func, b.path, b.hop + 1, count, b.chunk,
                b.last if b.taken == b.n else b.chunk, list(fsegs))
            self._push((fsegs[0][0], next(self._seq), "arrive", downstream))
        svc = _Service(gen, link, b, start, count, fsegs, dur, dur_last,
                       busy, coalesced=not picked, downstream=downstream,
                       max_avail=max_avail, end=f)
        self._active[link] = svc
        self._push((f, next(self._seq), "done", (link, gen)))
        if tr.on_progress is not None:
            self._arm_pokes(tr, b, count, fsegs)

    # ------------------------------------------------- round coalescing --
    def _plan_round(self, link, t0, max_picks=None):
        """Run the weighted-DRR pick loop forward from ``t0`` in virtual
        time, mutating ring/deficit/guard/burst state eagerly and
        recording the committed pick sequence.

        The loop IS the chunk-exact engine's per-link arbitration —
        deficit skips, the no-decrement fallback take, starvation (leave
        the ring, rejoin at the tail on arrival), class priority, and
        the aging guard — evaluated at each chunk boundary, so the
        committed sequence is byte-identical to chunk-per-event
        dispatch.  Starvation wakes raised inside the window are
        captured (not heap-pushed): rejoins due before the next boundary
        are processed in (time, push-order) sequence exactly as the
        chunk-exact wake events would fire; the remainder is returned to
        the caller to push as real wakes.

        Stops at a burst exhaustion on its final hop (a potential
        transfer completion, whose callbacks must fire at that instant),
        at ``max_picks`` (the truncation replay), or when nothing
        further is serveable.  Returns
        ``(picks_f, picks_d, parts, pend, busy, all_fg, gapless)``.
        """
        pend: list[tuple] = []
        self._plan_link = link
        self._plan_pend = pend
        picks_f: list[float] = []
        picks_d: list[float] = []
        parts: dict[int, _RPart] = {}
        order: list[_RPart] = []
        busy = 0.0
        all_fg = True
        gapless = True
        t = t0
        cls_bg = self._plan_bg if self._plan_bg is not None else self._cls_bg
        transfers = self.transfers
        pick = self._pick_drr
        self._plan_pmin = _INF
        try:
            while True:
                if pend and self._plan_pmin <= t + 1e-12:
                    due = sorted(e for e in pend if e[0] <= t + 1e-12)
                    if due:
                        q = self._queues.get(link, {})
                        for e in due:
                            pend.remove(e)
                            fut, _s, f = e
                            dq = q.get(f)
                            if not dq:
                                continue
                            # chunk-exact _wake_fire logic, evaluated at
                            # the wake's own fire time
                            b2, fut2 = self._avail_front(dq, fut)
                            if b2 is not None:
                                rr = self._ring(link, f, create=True)
                                if f not in rr:
                                    rr.append(f)
                            elif fut2 < _INF:
                                self._wake_push(link, fut2, f)  # captured
                        self._plan_pmin = min(
                            (e[0] for e in pend), default=_INF)
                        continue
                f, b = pick(link, t)
                if b is None:
                    if picks_f and pend:
                        nxt = self._plan_pmin
                        if nxt > t:
                            # idle until the next internal rejoin — the
                            # chunk-exact engine's wake-then-dispatch gap
                            t = nxt
                            gapless = False
                        continue
                    break
                part = parts.get(id(b))
                if part is None:
                    part = parts[id(b)] = _RPart(
                        b, b.taken, self._eff_bw(link, transfers[b.tid]))
                    order.append(part)
                dur = part.dur if b.taken < b.n - 1 else b.last / part.bw
                fend = t + dur
                b.taken += 1
                part.count += 1
                part.busy += dur
                fs = part.fsegs
                if fs:
                    lt0, liv, lc = fs[-1]
                    iv = fend - part.last_f
                    if lc == 1:
                        fs[-1] = (lt0, iv, 2)
                    elif abs(liv - iv) <= 1e-9:
                        fs[-1] = (lt0, liv, lc + 1)
                    else:
                        fs.append((fend, 0.0, 1))
                else:
                    fs.append((fend, 0.0, 1))
                part.last_f = fend
                picks_f.append(fend)
                picks_d.append(dur)
                busy += dur
                if f in cls_bg:
                    all_fg = False
                t = fend
                if b.taken >= b.n:
                    # burst exhausted: run _serve_burst's eager drain
                    # cleanup so a fully-drained function leaves its
                    # ring here exactly as it would chunk-by-chunk
                    q2 = self._queues.get(link)
                    dq2 = q2.get(f) if q2 else None
                    if dq2 is not None:
                        while dq2 and dq2[0].taken >= dq2[0].n:
                            dq2.popleft()
                        if not dq2:
                            del q2[f]
                            rr2 = self._ring(link, f)
                            if rr2 is not None and f in rr2:
                                rr2.remove(f)
                if max_picks is not None and len(picks_f) >= max_picks:
                    break
                if b.taken >= b.n and b.hop + 2 >= len(b.path):
                    break       # potential transfer completion at fend
        finally:
            self._plan_link = None
            self._plan_pend = None
        return picks_f, picks_d, order, pend, busy, all_fg, gapless

    def _serve_round(self, link):
        """Contended-DRR dispatch: commit one closed-form fair-share
        segment — whole weighted rounds between state-change epochs — as
        a single heap event instead of one event per chunk-pick."""
        now = self.now
        rr = self._rr.get(link)
        rrb = self._rrb.get(link)
        dd = self._deficit.get(link)
        snap = (tuple(rr) if rr else (),
                tuple(rrb) if rrb else (),
                dict(dd) if dd else {},
                self._fgrun.get(link, 0))
        # plan-time weight/class view for every func that could
        # influence the segment (ring members + anything queued, which
        # covers starved-out rejoiners): replays read these instead of
        # the live tables, which weight churn, clear_func eviction, or
        # class flips may mutate while the segment is active.  Built
        # BEFORE planning — the plan loop evicts drained entries.
        involved = set(snap[0]) | set(snap[1])
        q0 = self._queues.get(link)
        if q0:
            involved.update(q0)
        wget = self.weights.get
        wsnap = {f: wget(f, 1.0) for f in involved}
        bgsnap = involved & self._cls_bg
        picks_f, picks_d, order, pend, busy, all_fg, gapless = \
            self._plan_round(link, now)
        if not picks_f:
            for fut, _s, f in pend:
                self._wake_push(link, fut, f)
            return
        gen = self._gen.get(link, 0) + 1
        self._gen[link] = gen
        end = picks_f[-1]
        push = self._push
        for part in order:
            b = part.burst
            if b.hop + 2 < len(b.path):
                d = _Burst(b.tid, b.func, b.path, b.hop + 1, part.count,
                           b.chunk, b.last if b.taken == b.n else b.chunk,
                           list(part.fsegs))
                part.downstream = d
                push((part.fsegs[0][0], next(self._seq), "arrive", d))
            elif self.transfers[b.tid].on_progress is not None:
                self._arm_pokes(self.transfers[b.tid], b, part.count,
                                part.fsegs)
        self.link_busy_ms[link] = self.link_busy_ms.get(link, 0.0) + busy
        svc = _Round(gen, link, now, end, picks_f, picks_d, order, snap,
                     busy, all_fg, gapless, self._arr_hi)
        svc.wsnap = wsnap
        svc.bgsnap = bgsnap
        self._active[link] = svc
        push((end, next(self._seq), "done", (link, gen)))
        for fut, _s, f in pend:
            self._wake_push(link, fut, f)

    def _keep_round(self, svc) -> int:
        """Picks of a round segment already committed at self.now: every
        finished pick plus the one physically on the wire (its start is
        finish - dur, valid across idle gaps)."""
        now = self.now
        pf = svc.picks_f
        done = bisect_right(pf, now + 1e-12)
        if done >= len(pf):
            return len(pf)
        if pf[done] - svc.picks_d[done] <= now + 1e-12:
            done += 1
        return done

    def _trunc_round(self, svc, keep):
        """Cut a round segment back to its first `keep` picks: restore
        the ring/deficit/guard snapshot and the member bursts to segment
        start, deterministically replay the kept prefix (the pick loop
        is a pure function of static availability schedules), and
        cascade the cut to downstream hops per member burst."""
        count = len(svc.picks_f)
        if keep >= count:
            return
        if keep < 0:
            keep = 0
        link = svc.link
        gen = self._gen[link] + 1
        self._gen[link] = gen
        svc.gen = gen
        # restore scheduling state to segment start.  Functions that
        # joined a ring AFTER the snapshot without truncating (the only
        # such path: background arrivals against an all-foreground
        # gapless segment, which cannot obtain service before it ends)
        # must keep their tail position in arrival order — the replayed
        # window never visits the background ring of an all-fg segment,
        # so snapshot + late joiners at the tail is the chunk-exact ring.
        rrt, rrbt, dd0, fgrun0 = svc.snap
        cur = self._rr.get(link)
        ex_rr = [f for f in cur if f not in rrt] if cur else []
        cur = self._rrb.get(link)
        ex_rrb = [f for f in cur if f not in rrbt] if cur else []
        if rrt or link in self._rr:
            self._rr[link] = deque(rrt)
        if rrbt or link in self._rrb:
            self._rrb[link] = deque(rrbt)
        if dd0 or link in self._deficit:
            self._deficit[link] = dict(dd0)
        self._fgrun[link] = fgrun0
        # restore member bursts and their queue entries (in arrival
        # order; entries that arrived after segment start are already
        # queued and keep their seq position)
        q = self._queues.get(link)
        if q is None:
            q = self._queues[link] = {}
        funcs: dict[str, list] = {}
        for part in svc.parts:
            part.burst.taken = part.taken0
            funcs.setdefault(part.burst.func, []).append(part.burst)
        for f, bursts in funcs.items():
            dq = q.get(f)
            have = set(map(id, dq)) if dq else set()
            add = [b for b in bursts if id(b) not in have and b.taken < b.n]
            if not add:
                continue
            merged = list(dq or ()) + add
            merged.sort(key=lambda b: b.seq)
            q[f] = deque(merged)
        self.link_busy_ms[link] -= svc.busy
        old_parts = svc.parts
        if keep == 0:
            svc.parts = []
            svc.picks_f = []
            svc.picks_d = []
            svc.busy = 0.0
            if self._active.get(link) is svc:
                del self._active[link]    # stale done event finds no svc
            kept: dict[int, int] = {}
        else:
            self._plan_horizon = svc.horizon
            self._plan_w = svc.wsnap
            self._plan_bg = svc.bgsnap
            try:
                picks_f, picks_d, order, pend, busy, all_fg, gapless = \
                    self._plan_round(link, svc.start, max_picks=keep)
            finally:
                self._plan_horizon = None
                self._plan_w = None
                self._plan_bg = None
            self.link_busy_ms[link] += busy
            svc.parts = order
            svc.picks_f = picks_f
            svc.picks_d = picks_d
            svc.busy = busy
            svc.all_fg = all_fg
            svc.gapless = gapless
            svc.end = picks_f[-1]
            self._push((svc.end, next(self._seq), "done", (link, gen)))
            for fut, _s, f in pend:
                self._wake_push(link, fut, f)
            kept = {id(p.burst): p for p in order}
        # re-append post-snapshot joiners at their ring's tail
        for rings, extras in ((self._rr, ex_rr), (self._rrb, ex_rrb)):
            if not extras:
                continue
            rr2 = rings.get(link)
            if rr2 is None:
                rr2 = rings[link] = deque()
            for f in extras:
                if f not in rr2:
                    rr2.append(f)
        # cascade the cut to downstream hops per member burst
        for part in old_parts:
            d = part.downstream
            if d is None:
                continue
            np = kept.get(id(part.burst))
            k = np.count if np is not None else 0
            self._trim_downstream(d, k)
            if np is not None:
                np.downstream = d      # future cuts cascade again
        if self._chaos:
            # the restore above re-merged member bursts into the queue;
            # failed transfers' remainders must not be re-served
            self._purge_failed(link)
        if keep == 0:
            self._dispatch(link)

    def _trim_downstream(self, d, keep):
        """Trim a downstream burst to its first `keep` chunks and
        cascade into whatever service is consuming it."""
        if d.n <= keep:
            return
        d.n = keep
        d.last = d.chunk
        d.avail, _ = _seg_prefix(d.avail, keep)
        dlink = (d.path[d.hop], d.path[d.hop + 1])
        dsvc = self._active.get(dlink)
        if type(dsvc) is _Round:
            for p in dsvc.parts:
                if p.burst is d:
                    if p.taken0 + p.count > keep:
                        # committed-by-now picks only ever use chunks the
                        # upstream hop has already delivered, so the
                        # time-boundary cut never loses a valid pick
                        self._trunc_round(dsvc, self._keep_round(dsvc))
                    break
        elif dsvc is not None and dsvc.burst is d \
                and dsvc.start + dsvc.count > keep:
            self._truncate(dsvc, keep - dsvc.start)
        if d.taken >= d.n:
            # the trim consumed everything still queued downstream
            dq2 = self._queues.get(dlink, {}).get(d.func)
            if dq2 is not None and d in dq2:
                dq2.remove(d)
                if not dq2:
                    del self._queues[dlink][d.func]

    def _keep_count(self, svc) -> int:
        """Chunks of an in-flight burst already committed at self.now:
        everything finished plus the chunk physically on the wire — which
        is NONE when the link sits in an arrival-bound gap (the service
        schedule says the next chunk has not started yet)."""
        now = self.now
        done = _seg_count_le(svc.fsegs, now)
        if done >= svc.count:
            return svc.count
        f_next = _seg_at(svc.fsegs, done)
        d = svc.dur_last if done == svc.count - 1 else svc.dur
        return done + 1 if f_next - d <= now + 1e-12 else done

    def _truncate(self, svc, keep):
        """Cut a coalesced burst back to its first `keep` chunks (the one
        on the wire, if any, included) and cascade to downstream hops.
        keep == 0 cancels the service outright (preemption during an
        arrival-bound gap, before any chunk started)."""
        if keep >= svc.count:
            return
        if keep < 0:
            keep = 0
        link = svc.link
        new_busy = keep * svc.dur
        self.link_busy_ms[link] += new_busy - svc.busy
        svc.busy = new_busy
        svc.count = keep
        # the cut always drops the tail, so the service can no longer
        # include the burst's final (remainder-sized) chunk: a later
        # _keep_count must measure the on-wire chunk at the regular
        # duration, not the stale dur_last
        svc.dur_last = svc.dur
        gen = self._gen[link] + 1
        self._gen[link] = gen
        svc.gen = gen
        if keep == 0:
            if self._active.get(link) is svc:
                del self._active[link]     # stale done event finds no svc
        else:
            svc.fsegs, end = _seg_prefix(svc.fsegs, keep)
            svc.end = end
            self._push((end, next(self._seq), "done", (link, gen)))
        # return the cut chunks to the head of the function's queue
        # (a cascaded downstream burst may have been trimmed to exactly
        # its taken count — nothing left to requeue then)
        b = svc.burst
        b.taken = svc.start + keep
        if b.taken < b.n:
            q = self._queues.setdefault(link, {})
            dq = q.get(b.func)
            if dq is None:
                dq = q[b.func] = deque()
            if b not in dq:
                dq.appendleft(b)
            if self.policy == "drr":
                rr = self._ring(link, b.func, create=True)
                if b.func not in rr:
                    a = _seg_at(b.avail, b.taken)
                    # rr membership is only ever evaluated at pick time —
                    # the end of the chunk on the wire — so the function
                    # keeps its (head) position if its next chunk will
                    # have arrived by then, and rejoins at the tail via a
                    # wake otherwise (the chunk-exact rejoin-on-arrival)
                    pick_t = svc.end if keep > 0 else self.now
                    if a <= pick_t + 1e-12:
                        rr.appendleft(b.func)
                    else:
                        self._wake_push(link, a, b.func)
        # the _fifo deque still holds b at its original position
        d = svc.downstream
        if d is not None:
            self._trim_downstream(d, keep)
        if self._chaos:
            self._purge_failed(link)  # a requeued failed burst must not
        if keep == 0:                 # ..be re-served
            self._dispatch(link)      # link freed mid-gap: serve the queue

    def _replay_deficit(self, link, func, k):
        """Fold k solo-burst DRR picks into the deficit counter — per
        pick: d += w*c; if d >= c: d -= c (the chunk-exact engine's
        arithmetic, including the no-decrement fallback take).

        The replay iterates the per-pick update rather than using the
        algebraic closed form: the counter must be BIT-identical to
        chunk-by-chunk accumulation, because a later contended pick
        compares it against the chunk quantum with `>=` — a last-ulp
        difference from `k * (wc - c)`-style algebra is enough to flip a
        crossing that lands exactly on the quantum and desynchronize the
        two engines.  One float op per chunk is noise next to the event
        machinery this replay replaces."""
        if k <= 0 or self.policy != "drr":
            return
        c = self.chunk_mb
        w = self.weights.get(func, 1.0)
        dd = self._deficit.get(link)
        if dd is None:
            dd = self._deficit[link] = {}
        d = dd.get(func, 0.0)
        wc = w * c
        if d == 0.0 and wc == c:
            return                    # 0 + c; -c — exactly 0 every pick
        for _ in range(k):
            d += wc
            if d >= c:
                d -= c
        dd[func] = d

    # ----------------------------------------------------- progress ------
    def landed_mb(self, tid: int) -> float:
        """MB of a transfer physically landed at its destination by now:
        credited final-hop completions plus the committed prefix of any
        in-flight final-hop service.  Lazy — reads only live state, so a
        stale poke after truncation or a re-plan simply re-reads the
        truth (the committed-prefix invariant makes the count monotone
        across truncations)."""
        tr = self.transfers[tid]
        if tr.t_done >= 0 and not tr.failed:
            return tr.size_mb
        n = tr.chunks_done
        t = self.now + 1e-12
        for link in self._func_links.get(tr.func, ()):
            svc = self._active.get(link)
            if svc is None:
                continue
            if type(svc) is _Round:
                for p in svc.parts:
                    b = p.burst
                    if b.tid == tid and b.hop + 2 >= len(b.path):
                        n += _seg_count_le(p.fsegs, t)
            else:
                b = svc.burst
                if b.tid == tid and b.hop + 2 >= len(b.path):
                    n += _seg_count_le(svc.fsegs, t)
        return min(n * self.chunk_mb, tr.size_mb)

    def _fire_progress(self, tid):
        tr = self.transfers.get(tid)
        if tr is None or tr.on_progress is None or tr.failed \
                or tr.t_done >= 0:
            return
        tr.on_progress(self, self.landed_mb(tid))

    def _arm_pokes(self, tr, b, count, fsegs):
        """Schedule trigger-batch progress pokes over one final-hop
        service's finish schedule.  Pokes are pure wake-ups — they carry
        no link state, and chunks re-served after a truncation arm fresh
        pokes of their own."""
        if b.hop + 2 < len(b.path):
            return
        for k in range(BATCH_CHUNKS, count, BATCH_CHUNKS):
            self._push(
                (_seg_at(fsegs, k - 1), next(self._seq), "poke", b.tid))

    def _complete_service(self, t, link, gen):
        svc = self._active.get(link)
        if svc is None or svc.gen != gen:
            return                    # invalidated by truncation
        del self._active[link]
        if type(svc) is _Round:
            # ring/deficit/guard state was committed eagerly by the
            # planner; only transfer progress is credited here.  By
            # construction at most one member completes its transfer,
            # and it does so at the segment's end — this instant.
            for part in svc.parts:
                b = part.burst
                if b.hop + 2 >= len(b.path):
                    tr = self.transfers[b.tid]
                    tr.chunks_done += part.count
                    if tr.chunks_done >= tr.n_chunks and not tr.failed:
                        self._finish_transfer(tr)
                    elif tr.on_progress is not None:
                        self._fire_progress(b.tid)
            self._dispatch(link)
            return
        if svc.coalesced:
            self._replay_deficit(link, svc.func, svc.count - svc.replayed)
        b = svc.burst
        if b.hop + 2 >= len(b.path):
            tr = self.transfers[b.tid]
            tr.chunks_done += svc.count
            if tr.chunks_done >= tr.n_chunks and not tr.failed:
                self._finish_transfer(tr)
            elif tr.on_progress is not None:
                self._fire_progress(b.tid)
        self._dispatch(link)

    def _finish_transfer(self, tr):
        tr.t_done = self.now
        if tr.stage is not None:
            # return the staging-ring window; may launch parked transfers
            tr.stage.release(tr.stage_mb, self, tr.stage_cls,
                             tr.stage_key)
            tr.stage = None
        # per-class delivered bytes (before on_done, which may evict the
        # function's class registration via the scheduler); a failed
        # transfer delivered only a prefix — no credit
        if not tr.failed:
            cls = "bg" if tr.func in self._cls_bg else "fg"
            self.mb_by_class[cls] += tr.size_mb
        left = self._func_tr.get(tr.func, 1) - 1
        self._func_tr[tr.func] = left
        if tr.on_done is not None:
            tr.on_done(self, tr)
        if self._func_tr.get(tr.func, 0) <= 0:
            if tr.func in self._pending_clear:
                self._pending_clear.discard(tr.func)
                self.clear_func(tr.func)     # deferred scheduler eviction
            else:
                # drop per-link credit but keep a directly-set weight:
                # the set_rate_weight contract outlives one transfer
                self._drop_func_state(tr.func)

    # -------------------------------------------------------------- loop --
    def step(self) -> bool:
        if not self._events:
            return False
        return self._exec(heappop(self._events))

    def _exec(self, ev) -> bool:
        """Dispatch one popped event.  Split from ``step`` so the sharded
        engine (core/shard.py) can pop from per-node heaps and reuse the
        dispatch body unchanged."""
        t, _seq, kind, payload = ev
        if t > self.now:
            self.now = t
        self.n_events += 1
        if kind == "done":
            self._complete_service(t, payload[0], payload[1])
        elif kind == "arrive":
            if self._chaos:
                link = (payload.path[payload.hop],
                        payload.path[payload.hop + 1])
                if self.transfers[payload.tid].failed:
                    return True          # stranded chunks of a failure
                if link in self._dead_links:
                    self.fail_transfer(
                        payload.tid, f"link {link[0]}-{link[1]}")
                    return True
            payload.seq = self._arr_hi = next(self._arr_seq)
            link = (payload.path[payload.hop], payload.path[payload.hop + 1])
            self._enqueue(link, payload)
        elif kind == "wake":
            self._wake_fire(payload)
        elif kind == "poke":
            self._fire_progress(payload)
        else:                         # "call"
            payload(self)
        return True

    def run(self, until: float | None = None):
        global TOTAL_EVENTS
        events = self._events
        step = self.step
        n0 = self.n_events
        while events:
            if until is not None and events[0][0] > until:
                break
            step()
        TOTAL_EVENTS += self.n_events - n0
        return self.now

    def latency(self, tid: int) -> float:
        tr = self.transfers[tid]
        assert tr.t_done >= 0, f"transfer {tid} not complete"
        return tr.t_done - tr.t_submit
