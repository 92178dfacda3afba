"""Fault entry points of the FaaSTube facade (mixed into FaaSTube).

Failure transitions of the location state machine (fault model):

  SPILLING  --g2h failed-->  DEVICE   (the HBM copy never left; it
                                       stays authoritative)
  RELOADING --h2g failed-->  HOST     (source copy intact: parked
                                       fetches fail over, the item
                                       stays fetchable)
  RELOADING --source lost--> gone     (ObjectLost to every waiter)
  any state --node crash -->  gone    (store invalidated wholesale)

All of them run on *terminal* transfer failure — the engine's retry
ladder has already re-planned around the fault before these fire.  The
entry points themselves (``fail_link`` / ``brownout`` / ``crash_node``
/ ``lose_host``) are what ``core/faults.py`` schedules and what
``benchmarks/chaos.py`` drives; they were extracted from ``api.py`` so
the facade stays a policy layer — callers still reach them as
``tube.fail_link(...)`` through the mixin.
"""
from __future__ import annotations

from repro_torch.core.migration import DEVICE, HOST, RELOADING, StoredItem
from repro_torch.core.transfer import node_of
from repro_torch.errors import ObjectLost


class ChaosMixin:
    """FaaSTube's fault surface.  ``self`` is the facade: sim, topo,
    pathfinder, items, index, stats and dead_nodes are its attributes."""

    def _fail_waiters(self, item: StoredItem, err):
        """Fail over every fetch parked on the item with a structured
        cause (waiter signature: ``w(sim, t, err=None)``)."""
        waiters, item.waiters = item.waiters, []
        for w in waiters:
            w(self.sim, self.sim.now, err)

    def _lose_item(self, home: str, item: StoredItem, cause: str):
        """Drop an intermediate whose only copy is gone: release any
        held memory, retract the index record, fail parked fetches.
        A PARTIAL item's deferred-consume and in-flight reader
        bookkeeping is retired here too — the severed transfers fail
        terminally on their own, and the pending consume must not fire
        against a poisoned id."""
        rec = self.index.global_table.get(item.data_id)
        self._release_item(item, rec, self.sim.now)
        self.items.get(home, {}).pop(item.data_id, None)
        if self._home.get(item.data_id) == home:
            self._home.pop(item.data_id, None)
        self.index.drop(item.data_id)
        self._readers.pop(item.data_id, None)
        self._reader_handles.pop(item.data_id, None)
        self._pending_consume.pop(item.data_id, None)
        self.stats["lost"] += 1
        self._fail_waiters(item, ObjectLost(item.data_id, node_of(home),
                                            cause))

    def _reload_failed(self, item: StoredItem, rec, home: str, err, *,
                       redispatch: bool):
        """RELOADING failure transition: release the destination buffer;
        source copy intact -> back to HOST (parked fetches re-dispatched
        for background prefetches, failed over for demand reloads — a
        re-dispatch there could ping-pong against a persistent fault);
        source gone -> ObjectLost."""
        self._release_item(item, rec, self.sim.now)
        src_ok = item.host and node_of(item.host) not in self.dead_nodes
        if not src_ok:
            self._lose_item(home, item, "reload source lost")
            return
        item.set_state(HOST)
        if redispatch:
            waiters, item.waiters = item.waiters, []
            for w in waiters:
                w(self.sim, self.sim.now)
        else:
            self._fail_waiters(item, err)

    def fail_link(self, a: str, b: str, cause: str = ""):
        """Permanently fail the physical link a-b.

        Order matters: the simulator truncates in-flight service FIRST
        (the committed prefix is priced at the bandwidth it actually ran
        at), then the pathfinder removes the edge so every re-plan routes
        around it."""
        self.sim.kill_link(a, b, cause or f"link {a}-{b}")
        self.pf.fail_link(a, b)

    def brownout(self, a: str, b: str, factor: float,
                 duration_ms: float = 0.0):
        """Degrade link a-b to ``factor`` of its bandwidth, restoring
        after ``duration_ms`` (0 = permanent).  In-flight service is cut
        at the old rate and re-dispatched at the new one."""
        old = self.topo.bw(a, b)
        if old <= 0.0:
            return                      # edge already dead: nothing to do
        new = old * factor
        self.sim.retime_link(a, b, new)
        self.pf.retime_link(a, b, new - old)
        if duration_ms > 0.0:
            def restore(sim):
                cur = self.topo.bw(a, b)
                if cur <= 0.0:          # killed while browned out
                    return
                self.sim.retime_link(a, b, old)
                self.pf.retime_link(a, b, old - cur)
            self.sim.call_at(self.sim.now + duration_ms, restore)

    def crash_node(self, node: str):
        """Crash cluster node ``node`` ("n3"): sever every link touching
        it (in-flight transfers fail at the failure epoch and re-plan or
        surface), notify crash listeners (the executor remaps placements
        while the index is still coherent), then invalidate every object
        stored on the node — parked fetches fail over with ObjectLost."""
        if node in self.dead_nodes:
            return
        self.dead_nodes.add(node)
        pre = node + ":"
        t = self.sim.now
        pairs = sorted({tuple(sorted(e)) for e in self.topo.edges
                        if e[0].startswith(pre) or e[1].startswith(pre)})
        for a, b in pairs:
            self.sim.kill_link(a, b, f"node {node} crashed")
            self.pf.fail_link(a, b)
        for cb in list(self.crash_listeners):
            cb(node, t)
        for dev in sorted(d for d in self.items if d.startswith(pre)):
            for item in list(self.items[dev].values()):
                if item.state == RELOADING and item.held \
                        and not item.held.startswith(pre):
                    # reload already in flight toward a SURVIVING device:
                    # the severed source link fails that transfer, and
                    # the reload failure path decides the item's fate
                    continue
                self._lose_item(dev, item, f"node {node} crashed")
            # deferred allocations on the dead device: fire each grant —
            # the closures self-detect the vanished item / dead node and
            # release whatever admission or memory they were holding
            for _size, _func, grant in self._pending.pop(dev, ()):
                grant(t, -1, 0.0)
            self.pools.pop(dev, None)
            self.resident.pop(dev, None)

    def lose_host(self, host: str):
        """Lose a staging host's memory (pinned ring contents + spilled
        store) without taking its node down.  In-flight transfers staged
        through the host fail (and re-plan — the ring itself recovers);
        HOST-state items that spilled there are gone for good."""
        # snapshot first: failing a staged transfer can re-plan and
        # insert its replacement into sim.transfers mid-iteration
        staged = [tid for tid, tr in self.sim.transfers.items()
                  if tr.t_done < 0 and not tr.failed
                  and tr.stage is not None and tr.stage_key == host]
        for tid in staged:
            self.sim.fail_transfer(tid, f"host {host} lost")
        for dev in sorted(self.items):
            for item in list(self.items[dev].values()):
                if item.state == HOST and item.host == host:
                    self._lose_item(dev, item, f"host {host} lost")
                elif dev == host and item.state == DEVICE:
                    # stored directly in the host's memory (workflow
                    # inputs): contents lost with the host
                    self._lose_item(dev, item, f"host {host} lost")
