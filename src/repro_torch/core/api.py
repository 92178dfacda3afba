"""FaaSTube facade (paper §5, Listing 1): unique_id / store / fetch.

The facade is the POLICY layer: it resolves locations through the
unified index, walks the store-side memory-pressure state machine, and
SLO-admits foreground work.  Every actual data movement compiles to a
declarative :class:`~repro.core.transfer.TransferPlan` and executes
through the :class:`~repro.core.transfer.TransferEngine` — one engine
for fetch, put, g2g, h2g, inter-node, spill, demand reload and prefetch,
instead of per-kind completion-closure chains (see transfer.py for the
plan/engine architecture, staging modes and the bounded pinned ring).

Fetch dispatch (paper Fig. 8): intra-GPU -> ipc plan; same-node
inter-GPU -> g2g plan (direct / multipath / via host per config);
host-GPU -> h2g/g2h plans (PCIe, SLO-rate controlled, staged through
the circular pinned buffer); inter-node -> internode plan
(gpu->host->net->host->gpu; cut-through chunks flow hop-overlapped,
store-forward baselines run the stages sequentially).

Store-side: every stored intermediate walks an explicit, transfer-
completion-driven location state machine (migration.py):

  DEVICE -> SPILLING -> HOST -> RELOADING -> DEVICE

Outputs land in the per-device ElasticPool, which *enforces*
``store_cap_mb``: an allocation that would exceed it forces synchronous
victim selection (queue-aware or LRU per TubeConfig) and the store's
ready time is deferred until enough spills complete to make room —
memory pressure stalls the producer, as on real hardware.  A victim's
HBM blocks are freed, and its index record's ``location`` flipped to
"host", only when the g2h copy COMPLETES; until then a racing fetch
coherently reads the still-valid device copy.  Reloads are sourced from
the host the item actually spilled to (inter-node when the consumer
lives on another node), allocate their destination buffer through the
same capacity machinery, and flip the record back to "device" on
completion — concurrent fetches park on the in-flight reload instead of
double-paying.  ``pool="none"`` baselines track resident bytes per
device so INFless+/DeepPlan+ exercise the same pressure path with LRU
victims.  Everything is timed on the LinkSim clock; systems differ only
in TubeConfig.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core.chaos_api import ChaosMixin
from repro_torch.core.elastic_pool import BLOCK_MB, ElasticPool, blocks_for
from repro_torch.core.index import DataIndex, DataRecord
from repro_torch.core.linksim import LinkSim, alloc_ms
from repro_torch.core.migration import (
    DEVICE, HOST, PARTIAL, RELOADING, SPILLING, MigrationMixin, Migrator,
    StoredItem)
from repro_torch.core.pathfinder import PathFinder
from repro_torch.core.pcie_scheduler import PcieScheduler
from repro_torch.core.pinned_buffer import CircularPinnedBuffer
from repro_torch.core.topology import PCIE_PINNED, Topology
from repro_torch.core.transfer import (
    CUT_THROUGH, STORE_FORWARD, TransferEngine, TransferHandle, host_of,
    is_device, node_of)
from repro_torch.errors import ObjectLost

# location helpers are shared data-plane vocabulary (transfer.py);
# legacy underscore spellings kept for callers of the old facade
_node_of = node_of
_host_of = host_of
_is_dev = is_device


@dataclass(frozen=True)
class TubeConfig:
    name: str = "faastube"
    g2g: str = "multipath"        # host | direct | multipath
    h2g: str = "parallel"         # single | parallel
    pinned: str = "circular"      # none | per_transfer | circular
    slo_sched: bool = True
    pool: str = "elastic"         # none | cache_all | elastic
    migration: str = "queue"      # queue | lru
    unified_index: bool = True
    # multi-hop staging mode (g2g via host, inter-node): cut_through
    # stitches the hops so chunks flow hop-overlapped through the
    # bounded pinned ring; store_forward (the host-oriented baselines,
    # and the contrast arm pinned by the equivalence suite) starts hop
    # k+1 only when the entire hop-k copy has landed — the old
    # ``internode="sequential"`` + two-stage g2g-via-host behaviour.
    staging: str = CUT_THROUGH
    store_cap_mb: float = 1024.0
    # admit spill/prefetch transfers as BACKGROUND-class flows (residual
    # bandwidth only); False submits them straight to the link simulator
    # at parity with foreground fetches (the pre-arbiter behaviour, kept
    # as the contrast arm for the isolation benchmarks)
    bg_migration: bool = True
    # aging/quantum guard against background starvation: serve one
    # background chunk after this many consecutive foreground chunks on
    # a link where background work sits ready.  0 (default) keeps
    # strict per-link class priority — background only rides foreground
    # arrival gaps, so a continuously backlogged foreground trace can
    # starve migration (the ROADMAP open item this knob closes).
    bg_guard: int = 0
    # compute/transfer overlap (paper Fig. 15a): opted-in executor
    # stages start computing when their first trigger batch lands and
    # pipeline against the residual transfer, partial-consuming their
    # inputs (PARTIAL residency).  False — the default everywhere,
    # including FAASTUBE — keeps the all-deps-complete gate and adds
    # zero heap events, byte-identical to the pre-overlap data plane.
    overlap: bool = False


# INFless+ moves data through pageable host memory (shared-memory data
# passing a la Pheromone; no DMA pinning) — this is what makes the
# paper's 92% data-passing fraction reproduce.  On the A10 box this
# leaves a pinning-only gap vs DeepPlan+ where the paper reports parity;
# fig17 asserts the property that actually matters there: DeepPlan's
# PARALLEL advantage vanishes without NVLink.
INFLESS = TubeConfig(name="infless+", g2g="host", h2g="single",
                     pinned="none", slo_sched=False, pool="none",
                     migration="lru", unified_index=False,
                     staging=STORE_FORWARD)
# DeepPlan's direct-host-access design pre-pins its staging at load time
# (cached pinned, no per-transfer cost); FaaSTube* pins per transfer —
# the paper's §9.3 says it stays "constrained by pinned memory allocation
# overhead".  The shared circular ring is FaaSTube's own PS optimization.
DEEPPLAN = TubeConfig(name="deepplan+", g2g="host", h2g="parallel",
                      pinned="circular", slo_sched=False, pool="none",
                      migration="lru", unified_index=False,
                      staging=STORE_FORWARD)
FAASTUBE_STAR = TubeConfig(name="faastube*", g2g="direct", h2g="parallel",
                           pinned="per_transfer", slo_sched=False,
                           pool="none", migration="lru", unified_index=True)
FAASTUBE = TubeConfig(name="faastube")

SYSTEMS = {c.name: c for c in (INFLESS, DEEPPLAN, FAASTUBE_STAR, FAASTUBE)}


class FaaSTube(ChaosMixin, MigrationMixin):
    def __init__(self, topo: Topology, cfg: TubeConfig = FAASTUBE,
                 sim: LinkSim | None = None, backend=None):
        self.topo = topo
        self.cfg = cfg
        # data-plane backend: None/"sim" keeps the pure simulator;
        # "torch" (or a ready TorchBackend instance) arms the real data
        # plane on cuda — every identified plan moves its actual bytes
        # through the chunked-copy pipeline at submit time, wall-clock
        # work that never perturbs a single simulated event
        if backend in (None, "", "sim"):
            self.backend = None
        elif backend == "torch":
            from repro_torch.core.backend_torch import TorchBackend
            # physical capacity, not policy: sized above the sim-side
            # store cap so transient double-residency (a spill's source
            # copy + its landed host copy, a fetch's fresh dst copy)
            # never faults — admission/spill POLICY stays with the sim
            self.backend = TorchBackend(
                store_mb=2 * cfg.store_cap_mb,
                host_mb=max(4 * cfg.store_cap_mb, 256.0))
        else:
            self.backend = backend
        # `sim` injection: the sharded engine (core/shard.py) substitutes
        # a ShardedLinkSim; default construction is unchanged
        self.sim = sim if sim is not None else \
            LinkSim(topo, policy="drr" if cfg.slo_sched else "fifo",
                    bg_every=cfg.bg_guard)
        self.index = DataIndex()
        self.pf = PathFinder(topo, transit="gpu,chip,pcie,host")
        self.pools: dict[str, ElasticPool] = {}
        self.items: dict[str, dict[str, StoredItem]] = {}
        self.migrator = Migrator(cfg.migration)
        # warmed=True: the tube daemon (and DeepPlan's model loader)
        # pre-pin the staging ring at STARTUP, off any request's critical
        # path — the one-time size_mb pin cost is paid, just not by a
        # request.  Bare CircularPinnedBuffer() charges it on first use.
        self.pinned = CircularPinnedBuffer(policy=cfg.pinned, warmed=True)
        self.sched = PcieScheduler(self.sim, bw_all=4 * PCIE_PINNED) \
            if cfg.slo_sched else None
        self.engine = TransferEngine(
            self.sim, self.pf, self.pinned, topo, g2g=cfg.g2g,
            h2g=cfg.h2g, staging=cfg.staging, sched=self.sched,
            migrator=self.migrator, bg_migration=cfg.bg_migration,
            backend=self.backend)
        self.stats = {"h2g_ms": 0.0, "g2g_ms": 0.0, "alloc_ms": 0.0,
                      "migrations": 0, "reloads": 0, "lost": 0}
        # fault model (core/faults.py drives these): crashed cluster
        # nodes, and callbacks cb(node, t) notified after a crash's
        # surviving topology is in place but BEFORE the node's stored
        # objects are invalidated — so the executor can remap placements
        # before lost-object errors start firing
        self.dead_nodes: set[str] = set()
        self.crash_listeners: list = []
        # pool="none" baselines have no block pool, but resident bytes per
        # device are still finite: tracked here so INFless+/DeepPlan+ hit
        # the same store_cap_mb pressure path (with LRU victims)
        self.resident: dict[str, float] = {}
        self.resident_peak: dict[str, float] = {}
        self._home: dict[str, str] = {}          # data_id -> store it lives in
        # allocations waiting for victim spills to free room, per device:
        # deque of (size_mb, func, grant) served FIFO as capacity returns
        self._pending: dict[str, deque] = {}
        # compute/transfer overlap bookkeeping: in-flight reader count
        # and progress handles per data_id, plus partial consumes whose
        # real release is deferred until the last reader lands
        self._readers: dict[str, int] = {}
        self._reader_handles: dict[str, list] = {}
        self._pending_consume: dict[str, str] = {}

    # --------------------------------------------------------------- api --
    def unique_id(self) -> str:
        return self.index.unique_id()

    def _pool(self, device: str) -> ElasticPool:
        if device not in self.pools:
            # host memory is not the contended resource: only device
            # stores enforce the paper's store capacity
            cap = self.cfg.store_cap_mb if is_device(device) else float("inf")
            self.pools[device] = ElasticPool(
                device, capacity_mb=cap,
                elastic=self.cfg.pool == "elastic")
            self.items.setdefault(device, {})
        return self.pools[device]

    # ------------------------------------------------- capacity machinery -
    def _phys_mb(self, device: str) -> float:
        """MB physically allocated on device right now."""
        if self.cfg.pool == "none":
            return self.resident.get(device, 0.0)
        return self._pool(device).used_mb

    def _mb_needed(self, size_mb: float) -> float:
        """Footprint of an allocation: block-rounded for pooled configs
        (must agree with ElasticPool.fits, or a sub-block remainder can
        make _make_room compute need <= 0 while fits() still fails —
        stalling a pending store forever)."""
        if self.cfg.pool == "none":
            return size_mb
        return blocks_for(size_mb) * BLOCK_MB

    def _held_mb(self, device: str) -> float:
        """Physically allocated + committed-pending MB."""
        return self._phys_mb(device) \
            + sum(self._mb_needed(size)
                  for size, _f, _g in self._pending.get(device, ()))

    def _headroom_mb(self, device: str) -> float:
        """Capacity left for opportunistic prefetch: the pool's headroom
        (or the resident-byte headroom for pool="none") minus pending
        committed allocations."""
        pend = sum(self._mb_needed(size)
                   for size, _f, _g in self._pending.get(device, ()))
        if self.cfg.pool == "none":
            return self.cfg.store_cap_mb \
                - self.resident.get(device, 0.0) - pend
        return self._pool(device).headroom_mb - pend

    def _try_alloc(self, device: str, func: str, size_mb: float,
                   now: float):
        """(buf_id, cost_ms) if the bytes fit on device now, else None.

        Oversized single items (> the whole store) are force-allocated:
        no victim selection can ever make room for them.
        """
        if self.cfg.pool == "none":
            cap = self.cfg.store_cap_mb
            have = self.resident.get(device, 0.0)
            if have + size_mb > cap and size_mb <= cap:
                return None
            self.resident[device] = have + size_mb
            if self.resident[device] > self.resident_peak.get(device, 0.0):
                self.resident_peak[device] = self.resident[device]
            return -1, alloc_ms(size_mb)         # cudaMalloc every output
        pool = self._pool(device)
        if not pool.fits(size_mb):
            if size_mb <= pool.capacity_mb:
                return None
            return pool.alloc(func, size_mb, now, force=True)
        return pool.alloc(func, size_mb, now)

    def _unalloc(self, device: str, buf: int, size_mb: float, t: float):
        """Undo a _try_alloc whose item died while the grant was pending."""
        if self.cfg.pool == "none":
            self.resident[device] = max(
                0.0, self.resident.get(device, 0.0) - size_mb)
        elif buf >= 0:
            self._pool(device).free(buf, t)

    def _release_item(self, item: StoredItem, rec, t: float):
        """Free whatever device memory the item currently holds."""
        dev = item.held
        if not dev:
            return
        item.held = ""
        if self.cfg.pool == "none":
            self.resident[dev] = max(
                0.0, self.resident.get(dev, 0.0) - item.size_mb)
        elif rec is not None and rec.buf_id >= 0:
            self._pool(dev).free(rec.buf_id, t)
            rec.buf_id = -1

    def _reserve(self, device: str, func: str, size_mb: float, now: float,
                 grant):
        """Obtain size_mb of device memory, spilling victims when the
        store is full.  ``grant(t, buf_id, cost_ms)`` fires once the
        bytes are allocated — immediately when there is room, otherwise
        when enough victim spills complete."""
        res = self._try_alloc(device, func, size_mb, now)
        if res is not None:
            grant(now, res[0], res[1])
            return
        self._pending.setdefault(device, deque()).append(
            (size_mb, func, grant))
        self._make_room(device, now)

    def _make_room(self, device: str, now: float):
        """Synchronous victim selection: start enough g2h spills that the
        pending allocations fit once they complete.  Spills already in
        flight count toward the freed total (no over-spilling)."""
        in_flight = sum(self._mb_needed(i.size_mb)
                        for i in self.items.get(device, {}).values()
                        if i.state == SPILLING)
        need = self._held_mb(device) - in_flight - self.cfg.store_cap_mb
        if need <= 0:
            return
        candidates = [i for i in self.items.get(device, {}).values()
                      if i.state == DEVICE and i.held]
        for v in self.migrator.pick_victims(candidates, need):
            self._spill(v, device, now)

    def _drain_pending(self, device: str, t: float):
        """Serve deferred allocations FIFO as capacity returns."""
        dq = self._pending.get(device)
        if not dq:
            return
        while dq:
            size_mb, func, grant = dq[0]
            res = self._try_alloc(device, func, size_mb, t)
            if res is None:
                break
            dq.popleft()
            grant(t, res[0], res[1])
        if dq:
            self._make_room(device, t)   # head still blocked: spill more
        else:
            self._pending.pop(device, None)

    # The spill/reload lifecycle (DEVICE->SPILLING->HOST->RELOADING->
    # DEVICE) lives in migration.py's MigrationMixin, next to the state
    # machine it walks; the fault entry points (fail_link / brownout /
    # crash_node / lose_host) and the failure transitions live in
    # chaos_api.py's ChaosMixin.  Both are mixed into this class.

    # --------------------------------------------------------------- store -
    def store(self, func: str, data_id: str, size_mb: float, device: str,
              now: float, *, consumer_pos: float = float("inf"),
              on_ready=None) -> float:
        """Store func's output on device.

        Returns the ready time (ms) for the synchronous path.  When the
        store must wait for capacity (victim spills in flight) the
        return value is a lower bound; pass ``on_ready(sim, t)`` to
        observe the true completion-driven ready time.
        """
        self._pool(device)               # ensure pool + item store exist
        item = StoredItem(data_id, size_mb, now, now, consumer_pos,
                          func=func)
        self.items[device][data_id] = item
        self._home[data_id] = device
        if self.backend is not None:
            # real bytes: materialize the object's payload into the
            # device's slab store (deterministic synthetic content —
            # the same oracle the conformance suite regenerates)
            item.slabs = self.backend.put_object(data_id, device,
                                                 size_mb=size_mb)
        rec = DataRecord(data_id, node_of(device), device, size_mb,
                         "device", -1)
        self.index.publish(rec)

        if not is_device(device):
            # host-side store: host memory is unbounded, never spills
            if self.cfg.pool == "none":
                buf, cost = -1, alloc_ms(size_mb)
            else:
                buf, cost = self.pools[device].alloc(func, size_mb, now)
            self.stats["alloc_ms"] += cost
            item.held = device
            rec.buf_id = buf
            ready = now + cost
            if on_ready is not None:
                self.sim.call_at(ready, lambda sim: on_ready(sim, ready))
            return ready

        def grant(t, buf, cost):
            if self.items.get(device, {}).get(data_id) is not item:
                self._unalloc(device, buf, item.size_mb, t)
                return                   # consumed while waiting for room
            self.stats["alloc_ms"] += cost
            item.held = device
            if buf >= 0:
                rec.buf_id = buf
            ready = t + cost
            if on_ready is not None:
                if ready > self.sim.now:
                    self.sim.call_at(ready,
                                     lambda sim: on_ready(sim, ready))
                else:
                    on_ready(self.sim, ready)

        self._reserve(device, func, size_mb, now, grant)
        return now   # lower bound; true ready time arrives via on_ready

    def adopt_host_object(self, func: str, data_id: str, size_mb: float,
                          host: str, now: float, *,
                          home: str | None = None,
                          avail_segs=None) -> StoredItem:
        """Register bytes that already exist on ``host`` (a deployed
        model checkpoint, a pre-staged dataset) without moving them.

        The item enters the store in HOST state exactly as if a spill
        had just completed, so a later fetch to a device takes the
        ordinary demand-reload path (``_movement`` sees spilled + device
        dst -> "reload") with no special cases.  ``home`` names the
        store the item is indexed under — pass the device that will
        serve it so the eventual ``_reload_complete`` rehome is the
        identity; defaults to ``host`` itself.
        """
        home = home or host
        self._pool(home)
        item = StoredItem(data_id, size_mb, now, now, func=func,
                          on_host=True, host=host,
                          avail_segs=avail_segs)
        self.items[home][data_id] = item
        self._home[data_id] = home
        rec = DataRecord(data_id, node_of(host), host, size_mb, "host", -1)
        self.index.publish(rec)
        if self.backend is not None:
            item.slabs = self.backend.put_object(data_id, host,
                                                 size_mb=size_mb)
        return item

    # --------------------------------------------------------------- fetch -
    def _movement(self, src: str, dst: str, spilled: bool) -> str:
        """Fig. 8 dispatch: resolve locations to a plan kind."""
        src_dev, dst_dev = is_device(src), is_device(dst)
        if spilled and dst_dev:
            return "reload"
        if spilled:
            # host-side consumer of host-resident data: a shm read on
            # the spill host's node (unqualified "host" consumers are
            # node-less cpu stages), but a NET transfer when the
            # consumer names another node's host
            return "shm" if node_of(src) == node_of(dst) \
                or not node_of(dst) else "h2h"
        if src == dst:
            return "ipc" if dst_dev else "shm"
        if src_dev and dst_dev:
            return "g2g" if node_of(src) == node_of(dst) else "internode"
        if src_dev:
            return "g2h"
        return "h2g"

    def fetch(self, func: str, data_id: str, dst: str, now: float, *,
              slo_ms: float = 1e9, infer_ms: float = 0.0, on_ready=None,
              on_error=None, on_progress=None):
        """Fetch data_id into dst's address space; on_ready(sim, t) called.

        ``on_error(sim, err)`` fires instead when the fetch fails
        terminally: the id is not (or no longer) in the index, the data
        was lost to a node crash, or the transfer exhausted the engine's
        retry ladder.  Without an ``on_error`` an unknown id raises, as
        it always did.

        ``on_progress(sim, handle)`` — the overlap contract: fires on
        every landed trigger batch with a monotone
        :class:`~repro.core.transfer.TransferHandle`; the handle is also
        returned.  None (the default) arms nothing: the event stream
        stays byte-identical to a progress-free run."""
        if node_of(dst) in self.dead_nodes:
            if on_error is not None:
                err = ObjectLost(data_id, node_of(dst),
                                 "destination node crashed")
                self.sim.call_at(now, lambda sim: on_error(sim, err))
            return
        try:
            rec, lk = self.index.lookup(node_of(dst), data_id)
        except KeyError:
            if on_error is None:
                raise
            err = ObjectLost(data_id, "", "not in index")
            self.sim.call_at(now, lambda sim: on_error(sim, err))
            return
        if not self.cfg.unified_index:
            lk += 0.1                     # per-op RPC instead of local pipe
        t0 = now + lk
        home = self._home.get(data_id)
        item = self.items.get(home, {}).get(data_id) \
            if home is not None else None
        if item is not None and item.state == RELOADING:
            # an h2g reload is already in flight: park this fetch; it is
            # re-dispatched (paying its own move from the landed copy)
            # when the reload completes, or failed over when the reload
            # fails and the item is unrecoverable
            def parked(sim, t, err=None):
                if err is not None:
                    if on_error is not None:
                        on_error(sim, err)
                    return
                self.fetch(func, data_id, dst, t, slo_ms=slo_ms,
                           infer_ms=infer_ms, on_ready=on_ready,
                           on_error=on_error, on_progress=on_progress)
            item.waiters.append(parked)
            return
        # HOST only: a SPILLING item's device copy is still valid — a
        # racing fetch coherently reads it through the normal paths below
        spilled = item is not None and item.state == HOST
        src = rec.device
        if item is not None:
            item.last_access = t0
        kind = self._movement(src, dst, spilled)
        if self.cfg.pool == "none" and is_device(dst) and src != dst \
                and not spilled:
            # receiver allocates the destination buffer with cudaMalloc;
            # pooled configs serve it from warm blocks for free (reloads
            # allocate through the store's capacity machinery instead)
            c = alloc_ms(rec.size_mb)
            self.stats["alloc_ms"] += c
            t0 += c

        # foreground-class admission with the caller's SLO context; a
        # demand reload of spilled data rides this same admission (it
        # blocks this fetch, so it is foreground work, not migration)
        if self.sched:
            self.sched.admit(func, rec.size_mb, slo_ms, infer_ms, t=now)

        def done(sim, tr=None):
            if self.sched:
                self.sched.complete(func, t=sim.now)
            if on_ready:
                on_ready(sim, sim.now)
            self._reader_done(data_id, sim)

        def failed(sim, err):
            # a failed fetch is not an SLO sample: release the admission
            # without a completion timestamp, then surface the cause
            if self.sched:
                self.sched.complete(func)
            if on_error is not None:
                on_error(sim, err)
            self._reader_done(data_id, sim)

        # in-flight reader refcount: a partial consume issued while any
        # reader is still landing defers the real release to the last
        # reader's completion (``_reader_done``)
        handle = None
        if on_progress is not None:
            handle = TransferHandle(rec.size_mb)
            handle.subscribe(on_progress)
            self._reader_handles.setdefault(data_id, []).append(handle)
        self._readers[data_id] = self._readers.get(data_id, 0) + 1

        if kind == "reload":
            self._demand_reload(func, item, rec, dst, t0, done, failed,
                                handle=handle)
            return handle
        a, b = src, dst
        if kind == "h2g" and not src:
            a = host_of(dst)
        plan = self.engine.compile(kind, func, a, b, rec.size_mb,
                                   slo_ms=slo_ms, infer_ms=infer_ms,
                                   data_id=data_id)
        self.engine.submit(plan, t0, on_done=done,
                           on_fail=failed if on_error is not None
                           else None, handle=handle)
        return handle

    def put(self, func: str, src_dev: str, size_mb: float, now: float, *,
            slo_ms: float = 1e9, infer_ms: float = 0.0, on_done=None,
            on_error=None, data_id: str = ""):
        """Return an output to the host (g2h), SLO-admitted like a fetch.

        Executor return copies used to bypass admission entirely and
        contend at the default DRR weight; routing them here keeps every
        foreground byte on the link under the scheduler's rate control.
        """
        if self.sched:
            self.sched.admit(func, size_mb, slo_ms, infer_ms, t=now)

        def done(sim, tr=None):
            if self.sched:
                self.sched.complete(func, t=sim.now)
            if on_done is not None:
                on_done(sim, tr)

        def failed(sim, err):
            if self.sched:
                self.sched.complete(func)
            if on_error is not None:
                on_error(sim, err)
        plan = self.engine.compile("g2h", func, src_dev,
                                   host_of(src_dev), size_mb,
                                   slo_ms=slo_ms, infer_ms=infer_ms,
                                   data_id=data_id)
        return self.engine.submit(plan, now, on_done=done,
                                  on_fail=failed if on_error is not None
                                  else None)

    # ------------------------------------------------------------ consume -
    def consume(self, data_id: str, device: str, now: float, *,
                partial: bool = False) -> float:
        """Mark data consumed: release its memory, serve allocations that
        were waiting for room, and prefetch spilled items back.

        ``partial=True`` is the overlap contract: the caller has started
        computing on the landed prefix while reader transfers are still
        in flight.  The item flips to PARTIAL residency — refused by
        victim selection, index location "partial" — and the real
        release is deferred to the last reader's completion
        (``_reader_done``).  Returns the MB the caller may already read:
        the smallest landed prefix across in-flight readers, or the full
        size once nothing is in flight."""
        if partial and self._readers.get(data_id, 0) > 0:
            home = self._home.get(data_id, device)
            it = self.items.get(home, {}).get(data_id)
            if it is not None:
                it.set_state(PARTIAL)
                self._pending_consume[data_id] = device
                rec = self.index.global_table.get(data_id)
                if rec is not None:
                    rec.location = "partial"
                handles = self._reader_handles.get(data_id)
                if handles:
                    return min(h.done_mb for h in handles)
                return 0.0
        return self._finish_consume(data_id, device, now)

    def _finish_consume(self, data_id: str, device: str,
                        now: float) -> float:
        """The destructive half of consume: drop the item and its index
        record, free the memory, serve pending allocations, prefetch
        spilled items back into the freed space."""
        self._readers.pop(data_id, None)      # late readers: no-op drains
        self._reader_handles.pop(data_id, None)
        self._pending_consume.pop(data_id, None)
        home = self._home.pop(data_id, device)
        it = self.items.get(home, {}).pop(data_id, None)
        rec = self.index.global_table.get(data_id)
        self.index.drop(data_id)
        if self.backend is not None:
            self.backend.drop_object(data_id)    # every real copy
        if it is None:
            return 0.0
        freed_dev = it.held or home      # RELOADING items hold on their dst
        self._release_item(it, rec, now)
        if not is_device(freed_dev):
            return it.size_mb
        self._drain_pending(freed_dev, now)
        if self.cfg.migration != "queue":
            return it.size_mb
        space = self._headroom_mb(freed_dev)
        spilled = list(self.items.get(freed_dev, {}).values())
        # need_mb keeps the headroom check block-consistent with
        # admission: without it an over-headroom prefetch is issued and
        # fails _try_alloc late (HOST -> RELOADING -> HOST churn)
        for p in self.migrator.pick_prefetch(spilled, space,
                                             need_mb=self._mb_needed):
            self._prefetch(p, freed_dev, now)
        return it.size_mb

    def _reader_done(self, data_id: str, sim):
        """One in-flight reader of ``data_id`` finished (fetch done or
        failed).  When the last reader drains and a partial consume was
        deferred, perform the real release now."""
        n = self._readers.get(data_id)
        if n is None:
            return              # already fully consumed / poisoned
        if n > 1:
            self._readers[data_id] = n - 1
            return
        self._readers.pop(data_id, None)
        self._reader_handles.pop(data_id, None)
        dev = self._pending_consume.pop(data_id, None)
        if dev is not None:
            self._finish_consume(data_id, dev, sim.now)
