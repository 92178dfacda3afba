"""Sharded-by-node LinkSim: per-node simulation shards behind one driver.

The single global event heap is the scaling wall at fleet size: megafleet
(64 nodes / 512 GPUs) interleaves ~1.1M events through one heap even
though the hierarchical pathfinder already keeps all routing state
per-node.  This module partitions the simulation along the same seam —
one shard per cluster node (its PCIe/NVLink links, pinned ring, stores
and fault timers) plus a host-mesh boundary shard that owns every
inter-node link — and ships two execution modes behind one
:class:`ShardedTube` driver:

**Deterministic single-process mode** (``workers=0``).
    :class:`ShardedLinkSim` keeps a heap per shard and rotates shards by
    next-event-time: each step pops the global ``(t, seq)`` minimum
    across shard heads.  Sequence numbers are globally unique and
    monotone, so the pop order is *exactly* the single-heap order — this
    mode replays any scenario byte-identically to the global engine and
    is the correctness reference, pinned by the randomized equivalence
    sweeps in ``tests/test_shard_equiv.py``.

**Parallel mode** (``workers=N``).
    Node shards become independent simulations (own LinkSim, tube,
    executor over a single-node topology) distributed over N worker
    processes; the mesh shard runs in the driver.  Synchronization is
    classic conservative lookahead: time advances in windows of

        L = trigger_batch_mb / min mesh bandwidth

    (the first-chunk service latency of one cut-through trigger batch on
    the slowest host-mesh hop, ~0.8 ms at stock constants), and a
    boundary crossing emitted in window *r* takes effect in window *r+1*
    — legal because no remote effect of a crossing can precede its send
    time by less than L.  Boundary messages are pickled tuples; shard
    RNGs are seeded per shard; results are worker-count-invariant
    because every shard's inbox is a deterministic, sorted merge of the
    round's outboxes regardless of which process hosts which shard.
    Data crossings are staged handoffs: the owning shard reads the bytes
    to its host (real PCIe contention), the mesh shard moves host->host
    (real NET contention among all cross-node flows), and the receiving
    shard adopts the bytes with the mesh hop's finish schedule so its
    local reload pipelines against the tail — cut-through stitched
    across the boundary.  Control-sized crossings (< one trigger batch)
    may be delayed by up to one window; they are never delivered early.

    Not supported across shards in parallel mode: lineage recovery of a
    remote stage, and migration of boundary objects.  ``crash_node``
    retires the whole owning shard — its home requests fail, and
    in-flight crossings into it are dropped.
"""
from __future__ import annotations

import itertools
import os
import pickle
import random
import time
from dataclasses import dataclass, field
from heapq import heappop, heappush

from repro_torch.core import linksim as _L
from repro_torch.core.linksim import BATCH_CHUNKS, LinkSim
from repro_torch.core.topology import NET, Topology, cluster, dgx_v100
from repro_torch.core.transfer import is_device, node_of

#: boundary shard id — device names never contain '%'
MESH = "%mesh"
#: each shard numbers home requests from ``idx * _RID_STRIDE`` so rids —
#: and the data ids derived from them — are globally unique, which lets a
#: handed-off object keep its id on the receiving shard
_RID_STRIDE = 10_000_000
#: shadow requests live above every home range
_SHADOW_BASE = 10 ** 10


def owning_shard(device: str) -> str:
    """Shard that owns a device ("n3:gpu0" -> "n3"; un-prefixed names
    belong to the single implicit node '')."""
    return node_of(device)


def link_shard(a: str, b: str) -> str:
    sa, sb = node_of(a), node_of(b)
    return sa if sa == sb else MESH


def lookahead_ms(topo: Topology, chunk_mb: float = 2.0) -> float:
    """Safe lookahead window: first-chunk service latency of one
    cut-through trigger batch on the slowest inter-node hop."""
    mesh_bw = [bw for (a, b), bw in topo.edges.items()
               if node_of(a) != node_of(b) and bw > 0.0]
    bw = min(mesh_bw) if mesh_bw else NET
    return (BATCH_CHUNKS * chunk_mb) / bw


# ===================================================================== #
# Deterministic single-process mode: per-shard heaps, global rotation.  #
# ===================================================================== #

class ShardedLinkSim(LinkSim):
    """LinkSim with the event heap partitioned per node shard.

    Every push routes to the heap of the shard owning the event's link
    (cross-node links and ``call`` control events go to the boundary
    shard); ``step`` pops the global ``(t, seq)`` minimum across shard
    heads.  Because sequence numbers are unique and allocated in the
    same order as the global engine, the pop order — and therefore every
    simulated timestamp — is byte-identical to the single-heap engine.
    """

    def __init__(self, topo: Topology, **kw):
        super().__init__(topo, **kw)
        self._shard_heaps: dict[str, list] = {}
        self._ready: list = []          # lazy heap of (head key, shard)
        self._push = self._push_sharded

    # ------------------------------------------------------- routing --
    def _ev_shard(self, ev) -> str:
        kind = ev[2]
        if kind == "done" or kind == "wake":
            link = ev[3][0]
        elif kind == "arrive":
            b = ev[3]
            link = (b.path[b.hop], b.path[b.hop + 1])
        elif kind == "poke":
            tr = self.transfers.get(ev[3])
            if tr is None or not tr.paths:
                return MESH
            return node_of(tr.paths[0][0][-1])   # final-hop destination
        else:                                    # "call": control plane
            return MESH
        return link_shard(link[0], link[1])

    def _push_sharded(self, ev):
        sid = self._ev_shard(ev)
        h = self._shard_heaps.get(sid)
        if h is None:
            h = self._shard_heaps[sid] = []
        heappush(h, ev)
        if h[0] is ev:                  # new head: (re)advertise the shard
            heappush(self._ready, ((ev[0], ev[1]), sid))

    # ---------------------------------------------------------- loop --
    def _peek_key(self):
        """Current global minimum (t, seq) across shard heads, discarding
        stale advertisements."""
        ready = self._ready
        heaps = self._shard_heaps
        while ready:
            key, sid = ready[0]
            h = heaps.get(sid)
            if h and (h[0][0], h[0][1]) == key:
                return key, sid
            heappop(ready)              # stale: head moved since advertised
        return None, None

    def step(self) -> bool:
        key, sid = self._peek_key()
        if key is None:
            return False
        heappop(self._ready)
        h = self._shard_heaps[sid]
        ev = heappop(h)
        if h:
            heappush(self._ready, ((h[0][0], h[0][1]), sid))
        return self._exec(ev)

    def run(self, until: float | None = None):
        n0 = self.n_events
        while True:
            key, _sid = self._peek_key()
            if key is None or (until is not None and key[0] > until):
                break
            self.step()
        _L.TOTAL_EVENTS += self.n_events - n0
        return self.now

    @property
    def shard_count(self) -> int:
        return len(self._shard_heaps)


# ===================================================================== #
# Parallel mode: node shards + mesh shard, conservative BSP windows.    #
# ===================================================================== #

@dataclass
class ShardPlan:
    """Everything a worker needs to build its shards (must pickle)."""
    cfg: object                  # TubeConfig
    n_nodes: int
    apps: list                   # Workflow objects
    placements: dict             # app name -> {stage: gpu}
    arrivals: dict               # app name -> [t_arrive_ms, ...]
    seed: int = 0
    chaos: list = field(default_factory=list)   # (t_ms, kind, args)


@dataclass
class _Rec:
    """Lightweight completed/failed request record (picklable)."""
    app: str
    rid: int
    t_arrive: float
    t_done: float
    h2g_ms: float
    g2g_ms: float
    compute_ms: float
    failed: bool = False


def _node_topo(k: int, base=dgx_v100) -> Topology:
    """One cluster node's intra-node topology, globally named (n{k}:...)
    — the shard's private simulation world.  No mesh edges: every
    cross-node byte goes through the boundary shard."""
    s = base()
    t = Topology(f"n{k}:{s.name}")
    for (a, b), bw in s.edges.items():
        t.edges[(f"n{k}:{a}", f"n{k}:{b}")] = bw
    t.gpus = [f"n{k}:{g}" for g in s.gpus]
    t.version += 1
    return t


def _mesh_topo(n_nodes: int) -> Topology:
    t = Topology(f"mesh-{n_nodes}")
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            t.add(f"n{i}:host", f"n{j}:host", NET)
    return t


def _home_node(w, placements: dict) -> str:
    """A request's home shard: the node of its first gpu stage."""
    for s in w.stages:
        if s.kind == "gpu":
            return node_of(placements[w.name][s.name])
    return "n0"


def _shadow_rid(rid: int) -> int:
    return rid + _SHADOW_BASE


class NodeShard:
    """One node's private simulation: tube + executor over the node's
    own topology.  Doubles as the executor's ``boundary`` collaborator —
    stages placed off-node arrive here and leave as staged handoffs."""

    def __init__(self, sid: str, plan: ShardPlan):
        from repro_torch.core.api import TubeConfig  # noqa: F401  (unpickled cfg)
        from repro_torch.serving.executor import RequestState, WorkflowEngine
        self.sid = sid
        self.idx = int(sid[1:])
        self.host = f"{sid}:host"
        self.plan = plan
        self.rng = random.Random((plan.seed << 16) ^ (self.idx + 1))
        self._RequestState = RequestState
        topo = _node_topo(self.idx)
        self.eng = WorkflowEngine(topo, plan.cfg,
                                  placements=dict(plan.placements),
                                  boundary=self, local_nodes={sid})
        self.eng._rid = itertools.count(self.idx * _RID_STRIDE)
        self.eng.register_apps(plan.apps)
        self.outbox: list = []
        self._seq = itertools.count()
        self._shadow: dict = {}       # (origin, home_rid) -> RequestState
        self._reported: set = set()   # rids already surfaced to driver
        self._rid_app: dict[int, str] = {}
        self.dead = False
        # home apps submit their full arrival trace up front — arrivals
        # are heap events, consumed as windows advance
        for w in plan.apps:
            if _home_node(w, plan.placements) != sid:
                continue
            for t in plan.arrivals.get(w.name, ()):
                self._rid_app[self.eng.submit_workflow(w, t)] = w.name
        # shard-owned fault timers
        for (t, kind, args) in plan.chaos:
            if self._owns_fault(kind, args):
                self.eng.tube.sim.call_at(
                    t, lambda sim, k=kind, a=args: self._fire_fault(k, a))

    def _owns_fault(self, kind: str, args) -> bool:
        if kind == "crash_node":
            return args[0] == self.sid
        tgt = args[0]
        return owning_shard(tgt) == self.sid

    def _fire_fault(self, kind: str, args):
        getattr(self.eng.tube, kind)(*args)
        if kind == "crash_node":
            self.dead = True

    # -------------------------------------- executor boundary protocol --
    def _sync_state(self, rs) -> dict:
        """Set snapshots + scalar deltas accumulated since last sync."""
        base = getattr(rs, "_sync_base", (0.0, 0.0, 0.0))
        state = {
            "done": set(rs.done_stages), "stored": set(rs.stored_stages),
            "fetched": set(rs.fetched_stages),
            "data_ids": dict(rs.data_ids),
            "h2g_ms": rs.h2g_ms - base[0], "g2g_ms": rs.g2g_ms - base[1],
            "compute_ms": rs.compute_ms - base[2],
        }
        rs._sync_base = (rs.h2g_ms, rs.g2g_ms, rs.compute_ms)
        return state

    def dispatch(self, eng, w, rs, s):
        """Hand stage ``s`` to its owning shard: export the dep bytes
        this shard holds to its own host (real PCIe reads), then emit
        one boundary crossing whose mesh legs the driver hands to the
        mesh shard.  Called once per local producer store — each sync
        carries that producer's bytes; the byte export is deduped per
        (stage, dep) so a re-gate sync is control-only."""
        sim = eng.tube.sim
        origin = rs.origin or self.sid
        home_rid = rs.home_rid if rs.origin else rs.rid
        if s.kind == "gpu":
            target = node_of(eng._gpu_of(w, s))
        else:
            target = rs.origin          # cpu stages run on the home shard
        exported = getattr(rs, "_exported", None)
        if exported is None:
            exported = rs._exported = set()
        state = self._sync_state(rs)
        state["started"] = set(rs.started_stages)
        inputs = []
        if s.name in w.input_mb and (s.name, ":in") not in exported:
            exported.add((s.name, ":in"))
            inputs.append((w.input_mb[s.name],))
        payload = {
            "kind": "stage", "app": w.name, "origin": origin,
            "rid": home_rid, "stage": s.name, "state": state,
            "snap": {"t_arrive": rs.t_arrive, "slo_ms": rs.slo_ms},
            "inputs": inputs,
        }
        items = []                      # (did, mb) crossing the mesh
        legs = {"n": 0, "t": sim.now}
        msg = [next(self._seq), self.sid, target, items, payload]

        def leg_done(t):
            legs["t"] = max(legs["t"], t)
            legs["n"] -= 1
            if legs["n"] == 0:
                # the export IS this consumer's read of its local deps:
                # release them through the engine's own all-consumers
                # guard (frees the producer GPU copy once every local
                # and exported reader is done)
                eng._consume_fetched(w, rs, s)
                msg.append(legs["t"])
                self.outbox.append(tuple(msg))

        for dep, mb in s.deps:
            did = rs.data_ids.get(dep)
            if did is None or (s.name, dep) in exported:
                continue                # not produced yet / already sent
            home_dev = eng.tube._home.get(did)
            if home_dev is None:
                continue                # bytes live on another shard
            exported.add((s.name, dep))
            items.append((did, mb))
            if is_device(home_dev):
                legs["n"] += 1
                eng.tube.put(f"x{home_rid}:{dep}", home_dev, mb, sim.now,
                             slo_ms=rs.slo_ms,
                             on_done=lambda sim2, tr: leg_done(sim2.now))
        if legs["n"] == 0:
            if items:
                eng._consume_fetched(w, rs, s)
            msg.append(sim.now)
            self.outbox.append(tuple(msg))

    def complete(self, eng, rs):
        """A shadow request finished (or failed) here: relay home."""
        state = self._sync_state(rs)
        self.outbox.append((next(self._seq), self.sid, rs.origin, [], {
            "kind": "complete", "rid": rs.home_rid,
            "t_done": rs.t_done, "failed": rs.failed, "state": state,
        }, eng.tube.sim.now))

    # ------------------------------------------------- driver protocol --
    def _apply(self, payload, items, t_apply):
        eng = self.eng
        if payload["kind"] == "complete":
            rs = eng.requests.get(payload["rid"])
            if rs is not None:
                eng.accept_complete(rs, payload["t_done"],
                                    payload["state"], payload["failed"])
            return
        w = eng.apps[payload["app"]]
        origin = payload["origin"]
        if origin == self.sid:          # returning to the home request
            rs = eng.requests[payload["rid"]]
            rid = payload["rid"]
        else:                           # shadow of a remote request
            key = (origin, payload["rid"])
            rs = self._shadow.get(key)
            rid = _shadow_rid(payload["rid"])
            if rs is None:
                snap = payload["snap"]
                rs = self._RequestState(rid, snap["t_arrive"],
                                        origin=origin,
                                        home_rid=payload["rid"])
                rs.slo_ms = snap["slo_ms"]
                rs.started_stages |= payload["state"]["started"]
                rs._sync_base = (0.0, 0.0, 0.0)
                self._shadow[key] = rs
                eng.requests[rid] = rs
        for (did, mb, t_avail, segs) in items:
            eng.tube.adopt_host_object(f"x{rid}", did, mb, self.host,
                                       min(t_avail, t_apply),
                                       avail_segs=segs)
        for (mb,) in payload["inputs"]:
            eng.tube.store(f"r{rid}", f"r{rid}:in:{payload['stage']}",
                           mb, self.host, t_apply)
        eng.accept_stage(w, rs, payload["stage"], payload["state"])

    def advance(self, t_lo: float, t_hi: float, inbox: list):
        """Apply one window's inbox at its start, simulate to ``t_hi``,
        return (outbox, next event time, fresh completion records)."""
        sim = self.eng.tube.sim
        if not self.dead:
            for (payload, items, t_send) in inbox:
                t_apply = max(t_send, t_lo, sim.now)
                sim.call_at(t_apply,
                            lambda s, p=payload, it=items, t=t_apply:
                            self._apply(p, it, t))
        sim.run(until=t_hi)
        out, self.outbox = self.outbox, []
        recs = []
        for rs in self.eng.completed + self.eng.failed:
            if rs.rid in self._reported or rs.origin:
                continue
            self._reported.add(rs.rid)
            recs.append(_Rec(self._rid_app.get(rs.rid, ""), rs.rid,
                             rs.t_arrive, rs.t_done, rs.h2g_ms, rs.g2g_ms,
                             rs.compute_ms, rs.failed))
        nxt = sim._events[0][0] if sim._events else float("inf")
        return out, nxt, recs, self.dead, sim.n_events


class MeshShard:
    """The boundary shard: owns every host-mesh link and simulates the
    host->host legs of all boundary crossings under shared contention."""

    def __init__(self, n_nodes: int, chunk_mb: float = 2.0):
        self.sim = LinkSim(_mesh_topo(n_nodes), policy="drr")
        self.chunk_mb = chunk_mb
        self.inflight = 0
        self._ready: list = []          # completed crossings

    def kill_host(self, sid: str, n_nodes: int):
        host = f"{sid}:host"
        for j in range(n_nodes):
            other = f"n{j}:host"
            if other != host:
                self.sim.kill_link(host, other, "node crash")
                self.sim.kill_link(other, host, "node crash")

    def advance(self, t_hi: float, requests: list):
        """Inject this window's crossings, run to ``t_hi``, and return
        crossings whose every mesh leg completed."""
        for (seq, src, dst, items, payload, t_ready) in requests:
            if not items:               # control-only crossing
                self._ready.append((t_ready, src, seq, dst, [], payload))
                continue
            done = {"n": len(items), "t": t_ready,
                    "out": [None] * len(items)}
            src_h, dst_h = f"{src}:host", f"{dst}:host"
            for i, (did, mb) in enumerate(items):
                self.inflight += 1

                def landed(sim, tr, i=i, did=did, mb=mb, done=done,
                           seq=seq, src=src, dst=dst, payload=payload):
                    self.inflight -= 1
                    t_done = sim.now
                    n = max(1, int(mb / self.chunk_mb + 0.999999))
                    iv = self.chunk_mb / NET
                    t0 = t_done - (n - 1) * iv
                    segs = [(t0, iv, n)] if t0 > tr.t_submit else None
                    done["out"][i] = (did, mb, t_done, segs)
                    done["t"] = max(done["t"], t_done)
                    done["n"] -= 1
                    if done["n"] == 0:
                        self._ready.append((done["t"], src, seq, dst,
                                            done["out"], payload))

                self.sim.submit(f"x{src}.{seq}.{i}",
                                [((src_h, dst_h), 1.0)], mb,
                                t=t_ready, on_done=landed)
        self.sim.run(until=t_hi)
        out, self._ready = self._ready, []
        nxt = self.sim._events[0][0] if self.sim._events else float("inf")
        return out, nxt


# ===================================================================== #
# Driver                                                                #
# ===================================================================== #

def _worker_main(conn, plan_bytes: bytes, shard_ids: list):
    """Worker process: build the assigned node shards, then serve
    (t_lo, t_hi, inboxes) rounds until told to stop."""
    plan = pickle.loads(plan_bytes)
    shards = {sid: NodeShard(sid, plan) for sid in shard_ids}
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            conn.close()
            return
        if msg[0] == "stats":
            conn.send(("stats", {sid: sh.eng.tube.sim.n_events
                                 for sid, sh in shards.items()}))
            continue
        _, t_lo, t_hi, inboxes = msg
        # only the shards the driver listed are touched this round — a
        # shard with no inbox and no event before t_hi cannot act, and
        # skipping it is what makes sparse windows cheap at fleet size
        reply = {sid: shards[sid].advance(t_lo, t_hi, inbox)
                 for sid, inbox in inboxes.items()}
        conn.send(("ok", reply))


@dataclass
class ShardResult:
    completed: list
    failed: list
    n_events: int
    wall_s: float
    rounds: int = 0
    lookahead_ms: float = 0.0
    engine: object = None      # single-process mode: the real engine


class ShardedTube:
    """Driver for both sharded execution modes (module docstring)."""

    def __init__(self, plan: ShardPlan, workers: int = 0,
                 sync_timeout_s: float | None = None):
        self.plan = plan
        self.workers = workers
        self.sync_timeout_s = sync_timeout_s if sync_timeout_s is not None \
            else float(os.environ.get("SHARD_SYNC_TIMEOUT_S", "300"))

    # ------------------------------------------------ single-process --
    def _run_single(self) -> ShardResult:
        from repro_torch.serving.executor import WorkflowEngine
        plan = self.plan
        t0 = time.time()
        topo = cluster(plan.n_nodes, base=dgx_v100)
        sim = ShardedLinkSim(
            topo, policy="drr" if plan.cfg.slo_sched else "fifo",
            bg_every=plan.cfg.bg_guard)
        eng = WorkflowEngine(topo, plan.cfg,
                             placements=dict(plan.placements), sim=sim)
        for (t, kind, args) in plan.chaos:
            sim.call_at(t, lambda s, k=kind, a=args:
                        getattr(eng.tube, k)(*a))
        for w in plan.apps:
            for t in plan.arrivals.get(w.name, ()):
                eng.submit_workflow(w, t)
        eng.run()
        return ShardResult(eng.completed, eng.failed, sim.n_events,
                           time.time() - t0,
                           lookahead_ms=lookahead_ms(topo), engine=eng)

    # ----------------------------------------------------- parallel --
    def _run_parallel(self) -> ShardResult:
        import multiprocessing as mp
        plan = self.plan
        t0 = time.time()
        L = lookahead_ms(_mesh_topo(2))
        sids = [f"n{k}" for k in range(plan.n_nodes)]
        mesh = MeshShard(plan.n_nodes)
        for (t, kind, args) in plan.chaos:
            if kind == "crash_node":
                mesh.sim.call_at(t, lambda s, a=args:
                                 mesh.kill_host(a[0], plan.n_nodes))
        plan_bytes = pickle.dumps(plan)
        ctx = mp.get_context("fork")
        conns, procs = [], []
        n_workers = max(1, self.workers)
        assign = {w: sids[w::n_workers] for w in range(n_workers)}
        for w in range(n_workers):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(child, plan_bytes, assign[w]),
                            daemon=True)
            p.start()
            child.close()
            conns.append(parent)
            procs.append(p)
        completed, failed = [], []
        pending: dict[str, list] = {}      # sid -> next round's inbox
        n_events = 0
        dead: set = set()
        next_t = {sid: 0.0 for sid in sids}
        t_lo, rounds = 0.0, 0
        submitted = sum(len(v) for v in plan.arrivals.values())
        try:
            while True:
                rounds += 1
                lo = min(next_t.values(), default=float("inf"))
                if not pending and mesh.inflight == 0 \
                        and not mesh.sim._events and lo == float("inf"):
                    break
                t_hi = t_lo + L
                if not pending and mesh.inflight == 0 and lo > t_hi \
                        and lo < float("inf"):
                    t_hi = lo + L                       # idle-gap jump
                inboxes, pending = pending, {}
                for w in range(n_workers):
                    conns[w].send(("round", t_lo, t_hi,
                                   {sid: inboxes.get(sid, [])
                                    for sid in assign[w]
                                    if sid in inboxes
                                    or next_t.get(sid, 0.0) <= t_hi}))
                xfers = []
                for w in range(n_workers):
                    if not conns[w].poll(self.sync_timeout_s):
                        raise RuntimeError(
                            f"boundary sync deadlock: worker {w} gave no "
                            f"reply within {self.sync_timeout_s:.0f}s "
                            f"(round {rounds}, window {t_lo:.1f}ms)")
                    _, reply = conns[w].recv()
                    for sid, (out, nxt, recs, is_dead, _nev) in \
                            sorted(reply.items()):
                        next_t[sid] = nxt
                        if is_dead and sid not in dead:
                            dead.add(sid)
                            next_t[sid] = float("inf")
                        for r in recs:
                            (failed if r.failed else completed).append(r)
                        xfers.extend(out)
                # deterministic merge: send-time, then shard, then seq
                xfers.sort(key=lambda m: (m[5], m[1], m[0]))
                deliveries, mesh_next = mesh.advance(t_hi, xfers)
                deliveries.sort(key=lambda d: (d[0], d[1], d[2]))
                for (t_send, _src, _seq, dst, items, payload) in deliveries:
                    if dst in dead:
                        continue
                    pending.setdefault(dst, []).append(
                        (payload, items, t_send))
                if mesh_next < float("inf"):
                    next_t[MESH] = mesh_next
                else:
                    next_t.pop(MESH, None)
                t_lo = t_hi
            # gather per-shard event totals
            for w in range(n_workers):
                conns[w].send(("stats",))
            for w in range(n_workers):
                _, per_shard = conns[w].recv()
                n_events += sum(per_shard.values())
            n_events += mesh.sim.n_events
        finally:
            for w in range(n_workers):
                try:
                    conns[w].send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
        # requests stranded by a crashed shard count as failed
        lost = submitted - len(completed) - len(failed)
        for k in range(lost):
            failed.append(_Rec("", -1 - k, 0.0, -1.0, 0, 0, 0, True))
        _L.TOTAL_EVENTS += n_events
        return ShardResult(completed, failed, n_events,
                           time.time() - t0, rounds=rounds,
                           lookahead_ms=L)

    def run(self) -> ShardResult:
        if self.workers <= 0:
            return self._run_single()
        return self._run_parallel()
