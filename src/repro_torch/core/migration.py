"""Queue-aware data migration (paper §7.2) vs the LRU baseline, and the
data-location state machine every stored intermediate walks.

When the device store hits its capacity limit, victims must spill to host
memory.  LRU evicts the oldest — but in a serverless workflow the oldest
intermediate is usually the *next* one consumed (its downstream function was
enqueued first).  Queue-aware migration instead evicts the item whose
consumer sits furthest back in the request queue, clears consumed items
immediately, and prefetches spilled items back as memory frees up.

Location state machine (transfer-completion driven)
---------------------------------------------------

    DEVICE --spill picked--> SPILLING --g2h done--> HOST
    HOST --reload/prefetch--> RELOADING --h2g done--> DEVICE

State flips happen on *transfer completion*, never at submit time:

  * SPILLING keeps the HBM copy valid (a racing fetch may still read the
    device-resident bytes); the blocks are freed — and the index record's
    ``location`` flips to "host" — only when the g2h copy lands.
  * RELOADING holds the destination buffer from reload start (the DMA
    needs somewhere to land); concurrent fetches park on ``waiters`` and
    are re-dispatched when the copy completes.
  * PARTIAL marks an item whose consumer has started reading the landed
    prefix while the remainder is still in flight (compute/transfer
    overlap): the bytes are live on BOTH sides of an active DMA, so the
    item must never be picked as a spill victim; the facade performs
    the real release when the last in-flight reader completes.

The :class:`MigrationMixin` at the bottom is the facade's spill/reload
lifecycle — the transfer-completion driven transitions above, executed
through the TransferEngine.  It lives here, next to the state machine it
walks; ``api.py`` mixes it into :class:`~repro.core.api.FaaSTube`.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.pcie_scheduler import BACKGROUND
from repro_torch.core.transfer import host_of, is_device, node_of
from repro_torch.errors import ObjectLost

DEVICE = "device"        # resident in a device store
SPILLING = "spilling"    # g2h in flight; the HBM copy is valid until done
HOST = "host"            # spill landed: lives in host memory only
RELOADING = "reloading"  # h2g in flight back to a device
PARTIAL = "partial"      # consumer reads the landed prefix mid-transfer


@dataclass
class StoredItem:
    data_id: str
    size_mb: float
    t_stored: float
    last_access: float
    consumer_pos: float = float("inf")   # position of downstream fn in queue
    on_host: bool = False    # back-compat mirror of ``state == HOST``
    func: str = ""           # producing function (alloc/prefetch attribution)
    state: str = DEVICE
    host: str = ""           # the host this item spilled to
    held: str = ""           # device currently charged for the bytes
    waiters: list = field(default_factory=list)  # fetches parked on a reload
    avail_segs: object = None  # availability schedule of the host bytes
    #                            (cross-shard staged handoff: a reload
    #                            that starts before the boundary copy
    #                            fully lands pipelines against it)
    slabs: object = None     # real-payload slab handle (backend="jax"):
    #                          the _Obj naming the 2 MB rows this item's
    #                          actual bytes occupy; None on sim-only runs

    def __post_init__(self):
        if self.on_host and self.state == DEVICE:
            self.state = HOST
        self.on_host = self.state == HOST

    def set_state(self, state: str):
        self.state = state
        self.on_host = state == HOST


class Migrator:
    def __init__(self, policy: str = "queue"):
        assert policy in ("queue", "lru")
        self.policy = policy
        self.migrations = 0
        self.reloads = 0
        # background-class flow bookkeeping: every spill/prefetch
        # transfer is admitted to the PCIe scheduler under its own flow
        # id so migration traffic rides the BACKGROUND class (residual
        # bandwidth only) instead of contending with SLO fetches
        self._flow_seq = itertools.count()
        self.bg_submitted_mb = 0.0

    def flow(self, owner: str) -> str:
        """A unique background flow id for one migration transfer.

        ``owner`` (the producing function) is kept in the name for
        traceability, but the id is unique so a migration flow can never
        collide with the owner's own foreground admission."""
        return f"mig{next(self._flow_seq)}:{owner}"

    def pick_victims(self, items: list[StoredItem], need_mb: float
                     ) -> list[StoredItem]:
        """Choose device-resident items to spill until need_mb is covered.

        Only DEVICE-state items qualify: SPILLING ones are already on
        their way out, RELOADING ones are inbound, HOST ones are gone,
        and PARTIAL ones are mid-consumption — their bytes feed an
        active overlap read, so spilling one would corrupt the prefix
        the consumer already computed on.
        """
        resident = [i for i in items if i.state == DEVICE]
        if self.policy == "lru":
            order = sorted(resident, key=lambda i: i.last_access)
        else:
            # furthest-back consumer first; unconsumed (inf) are first of all
            order = sorted(resident, key=lambda i: -i.consumer_pos)
        out, acc = [], 0.0
        for it in order:
            if acc >= need_mb:
                break
            out.append(it)
            acc += it.size_mb
        self.migrations += len(out)
        return out

    def pick_prefetch(self, items: list[StoredItem], space_mb: float,
                      need_mb=None) -> list[StoredItem]:
        """Reload spilled (HOST-state) items whose consumers are soonest.

        ``need_mb(size)`` maps an item's raw size to its allocation
        footprint (block-rounded for pooled stores).  The facade passes
        its own ``_mb_needed`` so the headroom check here agrees with
        admission — without it a sub-block remainder lets an
        over-headroom prefetch through, which then flips the item
        HOST -> RELOADING -> HOST when the late allocation fails."""
        if need_mb is None:
            need_mb = lambda s: s                          # noqa: E731
        spilled = sorted([i for i in items if i.state == HOST],
                         key=lambda i: i.consumer_pos)
        out, acc = [], 0.0
        for it in spilled:
            if acc + need_mb(it.size_mb) > space_mb:
                break
            out.append(it)
            acc += need_mb(it.size_mb)
        self.reloads += len(out)
        return out


class MigrationMixin:
    """The facade's spill/reload lifecycle (mixed into FaaSTube).

    Methods here drive the DEVICE->SPILLING->HOST->RELOADING->DEVICE
    transitions through the TransferEngine; the failure transitions
    (``_reload_failed`` and friends) live in chaos_api.py with the rest
    of the fault model.  ``self`` is the FaaSTube facade: pools, items,
    index, engine, scheduler and stats are its attributes.
    """

    def _spill(self, v: StoredItem, device: str, now: float):
        """DEVICE -> SPILLING.  The HBM copy stays valid (and allocated)
        until the g2h transfer completes.  The plan is BACKGROUND class:
        the engine admits it as a per-transfer migration flow granted
        only residual bandwidth (or at foreground parity when
        ``bg_migration=False``, the contrast arm)."""
        v.set_state(SPILLING)
        v.host = host_of(device)
        self.stats["migrations"] += 1

        def landed(sim, tr=None):
            self._spill_complete(v, device, sim.now)

        def lost(sim, err):
            # g2h failed terminally: the device copy never left — it
            # stays authoritative.  Re-run victim selection; whatever
            # allocation forced this spill still needs the room.
            if self.items.get(device, {}).get(v.data_id) is not v \
                    or v.state != SPILLING:
                return
            v.set_state(DEVICE)
            v.host = ""
            self._make_room(device, sim.now)
        plan = self.engine.compile("spill", v.func or "migrate", device,
                                   v.host, v.size_mb, cls=BACKGROUND,
                                   data_id=v.data_id)
        self.engine.submit(plan, now, on_done=landed, on_fail=lost)

    def _spill_complete(self, v: StoredItem, device: str, t: float):
        """SPILLING -> HOST: free the HBM blocks and flip the index
        record to the host the data actually landed on."""
        if self.items.get(device, {}).get(v.data_id) is not v \
                or v.state != SPILLING:
            return          # consumed while the copy was in flight
        rec = self.index.global_table.get(v.data_id)
        self._release_item(v, rec, t)
        v.set_state(HOST)
        if rec is not None:
            self.index.relocate(rec, v.host, "host")
        be = getattr(self.engine, "backend", None)
        if be is not None:
            # the real bytes already landed on the host at submit time;
            # freeing the HBM blocks drops the device-side slab copy too
            be.drop_object(v.data_id, device)
            v.slabs = be.store_for(v.host).objects.get(v.data_id)
        self._drain_pending(device, t)

    def _demand_reload(self, func: str, item: StoredItem, rec, dst: str,
                       t0: float, done, fail=None, handle=None):
        """HOST -> RELOADING -> DEVICE: reload from the host the item
        spilled to (inter-node when the consumer sits on another node),
        paying destination allocation + PCIe h2g.  The index flips back
        to "device" only when the copy lands.  ``handle``: the fetch's
        TransferHandle — reload chunks landing at the destination ARE
        the fetch's progress."""
        self.stats["reloads"] += 1
        src_host = rec.device if rec.device and not is_device(rec.device) \
            else (item.host or host_of(dst))
        home = self._home.get(item.data_id, dst)
        item.set_state(RELOADING)

        def grant(t, buf, cost):
            if self.items.get(home, {}).get(item.data_id) is not item:
                # consumed while waiting for room: the fetch can never be
                # served, but its foreground admission must still be
                # released or the flow leaks (refs never reach 0 and its
                # rate_least shrinks the background residual forever).
                # No t: an unserved transfer is not an SLO miss.
                self._unalloc(dst, buf, item.size_mb, t)
                if self.sched:
                    self.sched.complete(func)
                return
            if node_of(dst) in self.dead_nodes:
                # destination crashed while the reload waited for room:
                # the host copy is untouched — put the item back and
                # fail over this fetch (and any parked on it)
                self._unalloc(dst, buf, item.size_mb, t)
                item.held = ""
                err = ObjectLost(item.data_id, node_of(dst),
                                 "destination node crashed")
                item.set_state(HOST)
                self._fail_waiters(item, err)
                if fail is not None:
                    fail(self.sim, err)      # releases the admission
                elif self.sched:
                    self.sched.complete(func)
                return
            self.stats["alloc_ms"] += cost
            item.held = dst
            if buf >= 0:
                rec.buf_id = buf

            def landed(sim, tr=None):
                self._reload_complete(item, rec, dst, sim)
                done(sim)

            def lost(sim, err):
                self._reload_failed(item, rec, home, err,
                                    redispatch=False)
                if fail is not None:
                    fail(sim, err)
            # the reload blocks a foreground fetch, so it rides that
            # fetch's own foreground admission (not the migration class)
            plan = self.engine.compile("reload", func, src_host, dst,
                                       rec.size_mb,
                                       data_id=item.data_id)
            plan.src_segs, item.avail_segs = item.avail_segs, None
            self.engine.submit(plan, t + cost, on_done=landed,
                               on_fail=lost if fail is not None else None,
                               handle=handle)

        self._reserve(dst, item.func or func, rec.size_mb, t0, grant)

    def _reload_complete(self, item: StoredItem, rec, dst: str, sim):
        """RELOADING -> DEVICE: rehome the item onto the destination
        store, flip the index, and re-dispatch any parked fetches."""
        home = self._home.get(item.data_id)
        if home is None \
                or self.items.get(home, {}).get(item.data_id) is not item:
            # consumed while the reload was in flight: drop the copy
            self._release_item(item, rec, sim.now)
            return
        if home != dst:
            del self.items[home][item.data_id]
            self._pool(dst)                      # ensure the store exists
            self.items[dst][item.data_id] = item
            self._home[item.data_id] = dst
        item.set_state(DEVICE)
        item.host = ""
        self.index.relocate(rec, dst, "device")
        waiters, item.waiters = item.waiters, []
        for w in waiters:
            w(sim, sim.now)
        self._drain_pending(dst, sim.now)

    def _prefetch(self, p: StoredItem, device: str, now: float):
        """Smart-migration prefetch: reload a HOST-state item into freed
        space before its consumer runs.  The allocation is attributed to
        the item's producing function (not a synthetic one) and its cost
        is charged like any other allocation."""
        prec = self.index.global_table.get(p.data_id)
        if prec is None:
            return
        src_host = p.host or host_of(device)
        p.set_state(RELOADING)
        res = self._try_alloc(device, p.func or "prefetch", p.size_mb, now)
        if res is None:
            p.set_state(HOST)            # space vanished: stay spilled
            return
        buf, cost = res
        self.stats["alloc_ms"] += cost
        p.held = device
        if buf >= 0:
            prec.buf_id = buf

        def back(sim, tr=None, p=p):
            self._reload_complete(p, prec, device, sim)

        def lost(sim, err, p=p):
            # background prefetch failed terminally: fall back to HOST
            # (the spilled copy is intact unless its node died) and
            # re-dispatch parked fetches — each pays its own demand
            # reload from the surviving copy
            self._reload_failed(p, prec, device, err, redispatch=True)
        plan = self.engine.compile("prefetch", p.func or "prefetch",
                                   src_host, device, p.size_mb,
                                   cls=BACKGROUND, data_id=p.data_id)
        self.engine.submit(plan, now + cost, on_done=back, on_fail=lost)
