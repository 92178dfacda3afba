"""TransferPlan / TransferEngine — the unified data plane (paper §5-§6).

Architecture
------------
Every data movement the system performs — fetch, put/return copy, g2g,
h2g, inter-node, spill, demand reload, prefetch — **compiles to a
declarative TransferPlan** and executes through ONE engine, instead of
the per-kind completion-closure chains the facade used to hand-roll:

    FaaSTube (policy facade: locations, index, capacity, SLO admission)
        │  compile(kind, src, dst, ...)
        ▼
    TransferPlan    ordered Hops + traffic class + SLO context +
        │           staging mode + pinned-staging policy
        ▼
    TransferEngine  path selection (PathFinder public API), pinned-ring
        │           acquisition + bounded staging occupancy, background
        │           arbitration (PcieScheduler), hop execution
        ▼
    LinkSim         chunk-level timing; multi-hop chunk handoff

A plan is a list of :class:`Hop` s.  Single-hop plans stripe across the
pathfinder's contention-aware parallel paths when ``hop.multipath`` is
set (Algorithm 1), falling back to **edge-disjoint topology stripes**
(`PathFinder.striped_paths`) when the residual graph is saturated — the
link simulator's DRR arbitration shares each physical link chunk by
chunk, so striping stays profitable even with zero free capacity.

Multi-hop plans (g2g staged through host memory, inter-node
gpu→host→net→host→gpu) execute in one of two staging modes:

``cut_through`` (FaaSTube's default, paper Fig. 5b)
    The hops are stitched into ONE multi-hop LinkSim path: a chunk
    enters hop *k+1* the moment it lands at hop *k*'s boundary (the
    simulator forwards per-chunk finish schedules downstream), so the
    transfer's completion is bounded by its bottleneck hop, not the sum
    of hops.  Host staging occupancy is **back-pressured by the bounded
    circular pinned ring**: each staged transfer reserves one
    trigger-batch window of ring space before its first chunk may move
    and a transfer that finds the ring full queues FIFO behind the
    release of an in-flight window (pinned_buffer.py enforces
    ``size_mb`` as in-flight staging bytes).

``store_forward`` (the host-oriented baselines; contrast arm)
    Hop *k+1* starts only when the ENTIRE hop-*k* copy has landed — the
    pre-refactor closure-chain behaviour, reproduced completion-time
    exact (pinned acquisition per staged hop included; see
    tests/test_transfer_equiv.py, pinned against goldens generated by
    the pre-refactor implementation).

Traffic classes ride the plan: ``cls="bg"`` plans (spill / prefetch)
are admitted through the PcieScheduler as per-transfer background flows
granted only residual bandwidth (§7); foreground SLO admission stays in
the facade because it is per logical operation (a demand reload rides
its blocking fetch's admission), but the plan still carries the SLO
context for observability and tests.

Failure semantics: the retry/degradation ladder
-----------------------------------------------
With a :class:`RecoveryPolicy` attached (``engine.recovery``, armed by
the chaos injector — ``None`` keeps the engine byte-identical to the
pre-fault data plane), a plan whose transfer fails (link kill, node
crash, staging-host loss, per-hop deadline) is retried under
capped-exponential backoff (``backoff_ms * 2^attempt``, capped at
``backoff_cap_ms``, at most ``max_retries`` retries), **resuming from
the last chunk that landed at the destination** rather than
restarting.  Each rung re-plans through PathFinder — whose caches have
already invalidated around the failed edges — and degrades the plan
shape:

    attempt 1   same shape, fresh routes (re-plan around dead links)
    attempt 2   striped multipath -> single path
    attempt 3+  cut_through -> store_forward; direct g2g -> host relay

Exhaustion surfaces a structured :class:`repro.errors.TransferFailed`
to the caller's ``on_fail`` (or, absent one, the failed LinkSim
transfer to ``on_done`` with ``tr.failed`` set).  Per-hop deadlines
(``deadline_base_ms + deadline_per_mb * size``) are armed per hop
submission and fail the hop through the simulator's own
``fail_transfer`` — deadline failures ride the same ladder.

Location helpers (`node_of` / `host_of` / `is_device`) live here — they
are data-plane vocabulary shared by the facade, the executor, and the
benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.linksim import BATCH_CHUNKS, IPC_MS, LinkSim
from repro_torch.core.pathfinder import PathFinder
from repro_torch.core.pcie_scheduler import BACKGROUND, FOREGROUND
from repro_torch.core.pinned_buffer import CircularPinnedBuffer
from repro_torch.core.topology import Topology
from repro_torch.errors import TransferFailed

HBM_COPY_BW = 600.0      # intra-device copy GB/s
SHM_MS = 0.001           # host shared-memory handoff

CUT_THROUGH = "cut_through"
STORE_FORWARD = "store_forward"

#: every movement kind a plan can carry; fetch/put resolve to one of
#: these in the facade's Fig. 8 dispatch
PLAN_KINDS = ("g2g", "h2g", "g2h", "internode", "h2h", "spill",
              "reload", "prefetch", "ipc", "shm")


def node_of(device: str) -> str:
    """Cluster node of a device name ("n3:gpu0" -> "n3", "gpu0" -> "")."""
    return device.split(":")[0] if ":" in device else ""


def host_of(device: str) -> str:
    """The host-memory endpoint on a device's node."""
    n = node_of(device)
    return f"{n}:host" if n else "host"


def is_device(name: str) -> bool:
    return name.startswith(("gpu", "chip")) or ":gpu" in name \
        or ":chip" in name


@dataclass
class Hop:
    """One leg of a plan: a point-to-point movement over one resource."""
    src: str
    dst: str
    kind: str                 # g2h | h2g | g2g | net | h2h
    multipath: bool = False   # stripe via PathFinder (Alg. 1 + fallback)
    routed: bool = True       # False: raw edge, bypass the pathfinder
    staged: bool = False      # passes through pinned host staging


@dataclass
class TransferPlan:
    kind: str                 # one of PLAN_KINDS
    func: str
    src: str
    dst: str
    size_mb: float
    hops: list[Hop] = field(default_factory=list)
    cls: str = FOREGROUND     # fg | bg (spill/prefetch migration)
    staging: str = CUT_THROUGH
    slo_ms: float = 1e9       # SLO context (carried for observability;
    infer_ms: float = 0.0     # fg admission itself stays in the facade)
    data_id: str = ""         # object identity: a real backend moves
    #                           THIS object's bytes when set ("" = no
    #                           real payload rides the plan)
    src_segs: object = None   # optional availability schedule of the
    #                           source bytes [(t0, interval, count), ...]:
    #                           the first hop's chunks enter per this
    #                           schedule instead of all-at-once — how a
    #                           cross-shard staged handoff (core/shard.py)
    #                           stitches cut-through over the boundary

    @property
    def local(self) -> bool:
        """True for same-address-space plans (ipc/shm): no link hops."""
        return not self.hops


@dataclass
class RecoveryPolicy:
    """Retry/deadline knobs for the engine's failure ladder (module
    docstring).  Attached as ``engine.recovery`` by the fault injector;
    the default deadline of 0 keeps the watchdog off, so an armed-but-
    fault-free run adds zero heap events."""
    max_retries: int = 4
    backoff_ms: float = 2.0
    backoff_cap_ms: float = 64.0
    deadline_base_ms: float = 0.0     # 0 = no per-hop deadline watchdog
    deadline_per_mb: float = 0.0

    def deadline_ms(self, size_mb: float) -> float:
        if self.deadline_base_ms <= 0.0:
            return 0.0
        return self.deadline_base_ms + self.deadline_per_mb * size_mb


class TransferHandle:
    """Progress-observable view of one plan execution.

    ``done_mb`` is the landed-at-destination prefix, monotone across
    cut-through stitching, retry re-plans (``_base`` carries the bytes
    credited by earlier rungs) and coalesced-round truncation (LinkSim's
    committed-prefix invariant).  Listeners — ``cb(sim, handle)`` — fire
    on every strictly-positive progress report, once at completion
    (``done_mb == total_mb``, ``t_done`` set) and once on terminal
    failure (``failed`` set).  Progress only ever rides submissions
    whose LinkSim path ends at the plan destination: an intermediate
    store-forward leg landing on a relay host reports nothing."""
    __slots__ = ("total_mb", "done_mb", "t_first", "t_done", "failed",
                 "_listeners", "_base")

    def __init__(self, total_mb: float):
        self.total_mb = total_mb
        self.done_mb = 0.0
        self.t_first = -1.0       # time the first progress report landed
        self.t_done = -1.0
        self.failed = None        # terminal failure cause
        self._listeners = []
        self._base = 0.0          # MB landed by earlier retry rungs

    @property
    def done(self) -> bool:
        return self.t_done >= 0

    def subscribe(self, cb):
        self._listeners.append(cb)

    def _notify(self, sim):
        for cb in tuple(self._listeners):
            cb(sim, self)

    def _report(self, sim, mb: float):
        new = min(self._base + mb, self.total_mb)
        if new <= self.done_mb + 1e-9:
            return                # stale poke / pre-resume re-report
        self.done_mb = new
        if self.t_first < 0:
            self.t_first = sim.now
        self._notify(sim)

    def _complete(self, sim):
        if self.t_done >= 0:
            return
        self.done_mb = self.total_mb
        self.t_done = sim.now
        if self.t_first < 0:
            self.t_first = sim.now
        self._notify(sim)

    def _fail(self, sim, err):
        if self.failed is not None or self.t_done >= 0:
            return
        self.failed = err
        self._notify(sim)


class TransferEngine:
    """Compiles and executes TransferPlans over one LinkSim clock."""

    def __init__(self, sim: LinkSim, pf: PathFinder,
                 pinned: CircularPinnedBuffer, topo: Topology, *,
                 g2g: str = "multipath", h2g: str = "parallel",
                 staging: str = CUT_THROUGH, sched=None, migrator=None,
                 bg_migration: bool = True, backend=None):
        self.sim = sim
        self.pf = pf
        self.pinned = pinned
        self.topo = topo
        self.g2g = g2g
        self.h2g = h2g
        self.staging = staging
        self.sched = sched            # PcieScheduler (bg arbitration)
        self.migrator = migrator      # flow ids + bg byte accounting
        self.bg_migration = bg_migration
        #: JaxBackend | None — a real data plane that moves each
        #: identified plan's actual bytes at submit time (wall clock),
        #: strictly outside the simulated event stream: arming it never
        #: changes a single sim event (tests/test_backend_jax.py)
        self.backend = backend
        #: RecoveryPolicy | None — None (the default) disables retry and
        #: deadlines entirely: the no-fault data plane stays byte-
        #: identical (tests/test_transfer_equiv.py)
        self.recovery = None
        self.retries = 0              # retry attempts actually launched
        self.failures = 0             # plans that exhausted the ladder

    # ------------------------------------------------------------ compile -
    def compile(self, kind: str, func: str, src: str, dst: str,
                size_mb: float, *, cls: str = FOREGROUND,
                slo_ms: float = 1e9, infer_ms: float = 0.0,
                data_id: str = "") -> TransferPlan:
        """Map one movement kind onto its hop list, class and staging."""
        assert kind in PLAN_KINDS, kind
        par = self.h2g == "parallel"
        hops: list[Hop] = []
        if kind == "g2g":
            if self.g2g == "host":
                # staged through host memory; cut-through stitches the
                # two PCIe legs, store-forward runs them sequentially
                hs, hd = host_of(src), host_of(dst)
                hops = [Hop(src, hs, "g2h", staged=True),
                        Hop(hd, dst, "h2g", staged=True)]
            else:
                hops = [Hop(src, dst, "g2g",
                            multipath=self.g2g == "multipath")]
        elif kind == "internode":
            hs, hd = host_of(src), host_of(dst)
            hops = [Hop(src, hs, "g2h", staged=True),
                    Hop(hs, hd, "net", routed=False),
                    Hop(hd, dst, "h2g", staged=True)]
        elif kind in ("h2g", "reload"):
            hops = [Hop(src, dst, "h2g", multipath=par, staged=True)]
        elif kind == "g2h":
            hops = [Hop(src, host_of(src), "g2h", multipath=par,
                        staged=True)]
        elif kind == "spill":
            hops = [Hop(src, dst, "g2h", staged=True)]
        elif kind == "prefetch":
            hops = [Hop(src, dst, "h2g", staged=True)]
        elif kind == "h2h":
            hops = [Hop(src, dst, "h2h")]
        # ipc / shm: same address space, no hops
        return TransferPlan(kind, func, src, dst, size_mb, hops, cls=cls,
                            staging=self.staging, slo_ms=slo_ms,
                            infer_ms=infer_ms, data_id=data_id)

    # ------------------------------------------------------------ execute -
    def submit(self, plan: TransferPlan, t: float, on_done=None,
               on_fail=None, handle: TransferHandle | None = None):
        """Execute a plan; ``on_done(sim, transfer|None)`` fires at the
        completion of its final hop on the LinkSim clock.

        ``on_fail(sim, TransferFailed)`` fires instead when the plan
        fails terminally (after the retry ladder, when ``recovery`` is
        armed; on the first failure otherwise).  Without an ``on_fail``,
        the failed LinkSim transfer is delivered to ``on_done`` with
        ``tr.failed`` set — legacy callers that never see faults are
        unaffected.

        ``handle``: optional TransferHandle observing landed-prefix
        progress; None (the default) arms nothing and leaves the event
        stream untouched."""
        if self.backend is not None and plan.data_id and not plan.local:
            # the real data plane: move the plan's actual bytes NOW
            # (synchronous wall-clock work), so by the time the sim
            # clock reports any landed prefix the bytes truly exist at
            # the destination — partial-consume reads real data.  The
            # sim event stream is untouched.
            self.backend.execute(plan)
        if handle is not None:
            user_done, user_fail = on_done, on_fail

            def on_done(sim, tr, _h=handle, _ud=user_done):
                if tr is not None and tr.failed:
                    _h._fail(sim, tr.failed)
                else:
                    _h._complete(sim)
                if _ud is not None:
                    _ud(sim, tr)
            if user_fail is not None:
                def on_fail(sim, err, _h=handle, _uf=user_fail):
                    _h._fail(sim, err)
                    _uf(sim, err)
        if plan.cls == BACKGROUND and self.sched is not None \
                and self.bg_migration:
            # migration traffic: admitted as a per-transfer background
            # flow, granted only the residual left by foreground floors
            flow = self.migrator.flow(plan.func) if self.migrator \
                else plan.func
            if self.migrator is not None:
                self.migrator.bg_submitted_mb += plan.size_mb
            self.sched.admit(flow, plan.size_mb, cls=BACKGROUND, t=t)
            inner = on_done

            def on_done(sim, tr, flow=flow, inner=inner):
                self.sched.complete(flow, t=sim.now)
                if inner is not None:
                    inner(sim, tr)
            if on_fail is not None:
                inner_fail = on_fail

                def on_fail(sim, err, flow=flow, inner=inner_fail):
                    # the flow's admission must release on EITHER
                    # terminal outcome, or the scheduler leaks it
                    self.sched.complete(flow, t=sim.now)
                    inner(sim, err)
            plan = TransferPlan(plan.kind, flow, plan.src, plan.dst,
                                plan.size_mb, plan.hops, cls=plan.cls,
                                staging=plan.staging, slo_ms=plan.slo_ms,
                                infer_ms=plan.infer_ms,
                                data_id=plan.data_id)
        if plan.local:
            lat = (IPC_MS + plan.size_mb / HBM_COPY_BW) \
                if plan.kind == "ipc" else SHM_MS
            if on_done is not None:
                self.sim.call_at(t + lat, lambda sim: on_done(sim, None))
            return None
        if self.recovery is None:
            return self._execute(plan, t,
                                 self._terminal(plan, on_done, on_fail, 1),
                                 handle)
        return self._attempt(plan, t, on_done, on_fail, 0, 0.0, handle)

    def _execute(self, plan: TransferPlan, t: float, on_done, handle=None):
        if len(plan.hops) == 1:
            return self._run_hop(plan, plan.hops[0], t, on_done, handle)
        if plan.staging == STORE_FORWARD:
            return self._run_store_forward(plan, 0, t, on_done, handle)
        return self._run_cut_through(plan, t, on_done, handle)

    # ------------------------------------------------------------ failure -
    def _terminal(self, plan: TransferPlan, on_done, on_fail, attempts):
        """Terminal completion callback: route a failed transfer to
        ``on_fail`` as a structured TransferFailed.  With no ``on_fail``
        the caller's own ``on_done`` is returned untouched — the
        no-fault path keeps the exact pre-fault callback object."""
        if on_fail is None:
            return on_done

        def cb(sim, tr):
            if tr is not None and tr.failed:
                on_fail(sim, TransferFailed(plan.func, plan.src, plan.dst,
                                            plan.kind, tr.failed, attempts))
            elif on_done is not None:
                on_done(sim, tr)
        return cb

    def _degraded(self, plan: TransferPlan, attempt: int,
                  size_mb: float) -> TransferPlan:
        """The plan shape for retry rung `attempt` (module docstring):
        1 = same shape re-planned, 2 = multipath off, 3+ = store-forward
        staging and direct g2g relayed through host memory."""
        hops = plan.hops
        staging = plan.staging
        if attempt >= 3:
            if plan.kind == "g2g" and len(hops) == 1:
                hs, hd = host_of(plan.src), host_of(plan.dst)
                hops = [Hop(plan.src, hs, "g2h", staged=True),
                        Hop(hd, plan.dst, "h2g", staged=True)]
            staging = STORE_FORWARD
        if attempt >= 2:
            hops = [Hop(h.src, h.dst, h.kind, multipath=False,
                        routed=h.routed, staged=h.staged) for h in hops]
        if attempt == 0 and size_mb == plan.size_mb:
            return plan
        return TransferPlan(plan.kind, plan.func, plan.src, plan.dst,
                            size_mb, hops, cls=plan.cls, staging=staging,
                            slo_ms=plan.slo_ms, infer_ms=plan.infer_ms,
                            data_id=plan.data_id)

    def _attempt(self, plan: TransferPlan, t: float, on_done, on_fail,
                 attempt: int, done_mb: float, handle=None):
        """One rung of the retry ladder: run the (possibly degraded)
        plan for the bytes not yet landed; on failure, back off and
        climb to the next rung, resuming from the new landed count."""
        rec = self.recovery
        if rec is None:      # disarmed between rungs: finish plain
            return self._execute(plan, t,
                                 self._terminal(plan, on_done, on_fail,
                                                attempt + 1), handle)
        left = plan.size_mb - done_mb
        if left <= 1e-9:
            # the failure raced completion: everything already landed
            if on_done is not None:
                self.sim.call_at(t, lambda sim: on_done(sim, None))
            return None
        eff = self._degraded(plan, attempt, left)

        def cb(sim, tr):
            if tr is None or not tr.failed:
                if on_done is not None:
                    on_done(sim, tr)
                return
            # chunks_done counts FINAL-hop completions, so it is only a
            # landed-at-destination count when the failed submission's
            # path actually ends at the plan's destination (single-hop,
            # multipath stripes, stitched cut-through — not an
            # intermediate store-forward leg)
            landed = 0.0
            if tr.paths and tuple(tr.paths[0][0])[-1] == plan.dst:
                landed = min(tr.chunks_done * sim.chunk_mb,
                             max(left - 1e-6, 0.0))
            # fail fast when the destination is unreachable on the
            # surviving topology (node crash severed every route): a
            # retry would fall back to a nonexistent direct edge at the
            # 1e-9 bw floor and "complete" at an astronomical time
            dead_end = self.pf.route(plan.src, plan.dst)[0] is None
            if attempt >= rec.max_retries or dead_end:
                self.failures += 1
                if on_fail is not None:
                    on_fail(sim, TransferFailed(
                        plan.func, plan.src, plan.dst, plan.kind,
                        tr.failed, attempt + 1))
                elif on_done is not None:
                    on_done(sim, tr)
                return
            self.retries += 1
            delay = min(rec.backoff_ms * (2 ** attempt),
                        rec.backoff_cap_ms)
            nd = done_mb + landed
            sim.call_at(sim.now + delay,
                        lambda sim2: self._attempt(plan, sim2.now,
                                                   on_done, on_fail,
                                                   attempt + 1, nd,
                                                   handle))
        if handle is not None:
            # this rung re-submits only the residual bytes: progress it
            # reports is relative to the rung, on top of what earlier
            # rungs landed (the handle's monotone guard absorbs the
            # chunk-rounding slack between the two counts)
            handle._base = done_mb
        return self._execute(eff, t, cb, handle)

    # ------------------------------------------------------- path choice --
    def _stripe_set(self, func: str, src: str, dst: str, t: float):
        """(alloc_key, [(path, bw)]) for a multipath hop: Algorithm 1
        allocations held until completion; on a saturated residual graph,
        edge-disjoint topology stripes (chunk-level DRR sharing)."""
        alloc_key = f"{func}@{t}"
        allocs = self.pf.select_paths(alloc_key, src, dst)
        if allocs:
            return alloc_key, [(a.path, a.bw) for a in allocs]
        paths = [(p, bw) for p, bw in self.pf.striped_paths(src, dst)
                 if p is not None]
        if not paths:
            paths = [((src, dst), max(self.topo.bw(src, dst), 1e-3))]
        return None, paths

    def _single_path(self, hop: Hop):
        if not hop.routed:
            return [((hop.src, hop.dst), 1.0)]
        path, bw = self.pf.route(hop.src, hop.dst)
        return [(path, bw)] if path else [((hop.src, hop.dst), 1e-3)]

    def _segment(self, hop: Hop):
        """Best current residual route for one leg of a stitched
        cut-through path (never allocated: the stitched transfer shares
        links chunk by chunk, exactly like the old `_stitch`)."""
        if not hop.routed:
            return (hop.src, hop.dst)
        p, _ = self.pf.shortest_residual_path(hop.src, hop.dst)
        if p is None:
            p, _ = self.pf.route(hop.src, hop.dst)
        return tuple(p) if p else (hop.src, hop.dst)

    def _stage_args(self, size_mb: float, hop, cls: str):
        """Bounded-ring occupancy for a staged movement: one
        trigger-batch window on the staging HOST's ring (rings are per
        host on clusters), reserved while the transfer is in flight and
        released by the simulator at its completion.  The plan's
        traffic class rides along — background windows are capped and
        queued behind foreground ones (pinned_buffer.py).  A multi-hop
        cut-through plan reserves on its first staging host (the source
        side; the destination ring drains at the same rate)."""
        if hop is None or not hop.staged \
                or self.pinned.policy != "circular":
            return {}
        win = self.pinned.window_mb(size_mb,
                                    BATCH_CHUNKS * self.sim.chunk_mb)
        key = hop.src if hop.kind == "h2g" else hop.dst
        return {"stage": self.pinned, "stage_mb": win, "stage_cls": cls,
                "stage_key": key}

    # --------------------------------------------------------- executors --
    def _run_hop(self, plan: TransferPlan, hop: Hop, t: float, on_done,
                 handle=None):
        """One hop = one LinkSim submission (the old `_submit_path`)."""
        alloc_key = None
        if hop.multipath:
            alloc_key, paths = self._stripe_set(plan.func, hop.src,
                                                hop.dst, t)
        else:
            paths = self._single_path(hop)
        pin, pinned_ok = (self.pinned.acquire(plan.size_mb)
                          if hop.kind in ("h2g", "g2h") else (0.0, True))

        def finish(sim, tr):
            if alloc_key is not None:
                self.pf.release(alloc_key)
            if on_done is not None:
                on_done(sim, tr)

        # progress rides only submissions landing at the plan's true
        # destination — never an intermediate store-forward leg
        prog = handle._report \
            if handle is not None and hop.dst == plan.dst else None
        src, plan.src_segs = plan.src_segs, None   # first hop only
        tid = self.sim.submit(plan.func, paths, plan.size_mb, t=t,
                              pin_fresh_mb=pin, on_done=finish,
                              on_progress=prog,
                              unpinned=not pinned_ok, avail_segs=src,
                              **self._stage_args(plan.size_mb, hop,
                                                 plan.cls))
        self._arm_deadline(tid, plan.size_mb, t)
        return tid

    def _arm_deadline(self, tid, size_mb: float, t: float):
        """Per-hop deadline watchdog (recovery armed + deadline knobs
        set only): a hop still unfinished at the deadline is failed
        through the simulator and rides the normal retry ladder."""
        rec = self.recovery
        if rec is None:
            return
        dl = rec.deadline_ms(size_mb)
        if dl > 0.0:
            self.sim.call_at(t + dl, lambda sim, tid=tid:
                             sim.fail_transfer(tid, "deadline"))

    def _run_store_forward(self, plan: TransferPlan, i: int, t: float,
                           on_done, handle=None):
        """Hop i, then the rest when its WHOLE copy lands (the old
        nested-closure `_g2g`-via-host / sequential `_internode`)."""
        hop = plan.hops[i]
        if i + 1 == len(plan.hops):
            return self._run_hop(plan, hop, t, on_done, handle)

        def next_hop(sim, tr):
            if tr is not None and tr.failed:
                # a mid-plan hop died: surface the failed transfer to
                # the terminal callback instead of running later hops
                if on_done is not None:
                    on_done(sim, tr)
                return
            self._run_store_forward(plan, i + 1, sim.now, on_done, handle)
        return self._run_hop(plan, hop, t, next_hop, handle)

    def _run_cut_through(self, plan: TransferPlan, t: float, on_done,
                         handle=None):
        """Stitch the hops into one multi-hop LinkSim path: chunks flow
        hop-overlapped, back-pressured by the bounded staging ring."""
        path: tuple = ()
        for hop in plan.hops:
            seg = self._segment(hop)
            path = path + (seg[1:] if path and path[-1] == seg[0] else seg)
        first_staged = next((h for h in plan.hops if h.staged), None)
        pin, pinned_ok = self.pinned.acquire(plan.size_mb) \
            if first_staged is not None else (0.0, True)
        src, plan.src_segs = plan.src_segs, None
        tid = self.sim.submit(plan.func, [(path, 1.0)], plan.size_mb,
                              t=t, pin_fresh_mb=pin,
                              unpinned=not pinned_ok, on_done=on_done,
                              on_progress=handle._report
                              if handle is not None else None,
                              avail_segs=src,
                              **self._stage_args(plan.size_mb,
                                                 first_staged, plan.cls))
        self._arm_deadline(tid, plan.size_mb, t)
        return tid
