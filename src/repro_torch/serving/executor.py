"""Workflow executor: the serverless platform driving FaaSTube.

Event-driven over the LinkSim clock.  Each request walks its workflow DAG:
host inputs are fetched host->gFunc, inter-stage tensors move gFunc->gFunc
through the tube, outputs that the app returns go gFunc->host.  GPUs are
temporally shared (one running function at a time, FIFO queue); data-
passing overlaps other requests' compute — exactly the paper's execution
model.  Latency split (h2g / g2g / compute) is tracked per request for the
Fig. 3 / Fig. 12 breakdowns.

With ``TubeConfig.overlap=True`` a stage that opts in (``Stage.partial``)
additionally overlaps its OWN compute with its residual input transfer:
``_drain_overlap`` starts the kernel on the first landed trigger batch
(``consume(partial=True)`` → PARTIAL residency) and advances a pipelined
compute clock on every progress report — the TensorRT batched-pipelining
cost model.  ``overlap=False`` (the default) keeps the all-deps-COMPLETE
gate and an event stream byte-identical to pre-overlap builds.

Lineage recovery (fault model)
------------------------------
The executor registers a crash listener with the tube.  On a node crash
it remaps dead GPUs onto sorted survivors (deterministically) and moves
their queues; invocations running on the dead node are re-triggered on
the remapped GPU.  A fetch that fails terminally (ObjectLost /
TransferFailed after the engine's retry ladder) walks the request's
lineage: workflow INPUTS are simply re-published (they come from outside
the tube), a lost INTERMEDIATE resets its producer stage and re-executes
it — recursively, because the producer's own consumed inputs surface as
further fetch errors.  Re-triggering is idempotent (``started_stages``
gates enqueueing) and budget-capped per stage; an unrecoverable request
is marked failed and its GPU slot released so the fleet keeps serving.
With ``recover=False`` (the no-retry contrast arm) any terminal error
fails the request immediately.
"""
from __future__ import annotations

import itertools
from collections import defaultdict, deque
from dataclasses import dataclass, field

from repro_torch.core.api import FaaSTube, TubeConfig
from repro_torch.core.transfer import host_of, is_device
from repro_torch.core.topology import Topology
from repro_torch.serving.workflow import Workflow, isolated_compute_ms, place


@dataclass
class RequestState:
    rid: int
    t_arrive: float
    #: cross-shard execution (core/shard.py): non-empty on a SHADOW
    #: request — the shard id that owns the real request — with
    #: ``home_rid`` the rid it has there.  Empty on ordinary requests.
    origin: str = ""
    home_rid: int = -1
    done_stages: set = field(default_factory=set)
    started_stages: set = field(default_factory=set)
    stored_stages: set = field(default_factory=set)
    fetched_stages: set = field(default_factory=set)
    data_ids: dict = field(default_factory=dict)      # stage -> data_id
    t_done: float = -1.0
    h2g_ms: float = 0.0
    g2g_ms: float = 0.0
    compute_ms: float = 0.0
    slo_ms: float = 1e9
    failed: bool = False
    recoveries: dict = field(default_factory=dict)   # stage -> retries


class _WorkflowMeta:
    """Pre-resolved DAG lookups for one workflow, shared by all requests.

    The executor walks the DAG once per stage per request; resolving
    consumers/sinks by scanning `w.stages` each time is O(stages^2) per
    request and dominates at fleet scale (hundreds of concurrent
    workflows), so the maps are built once per workflow object.
    """
    __slots__ = ("stage", "consumers", "out_mb", "downstream", "sinks")

    def __init__(self, w: Workflow):
        self.stage = {s.name: s for s in w.stages}
        self.consumers = {s.name: [t.name for t in w.stages
                                   if any(d == s.name for d, _ in t.deps)]
                          for s in w.stages}
        self.out_mb = {s.name: max((mb for t in w.stages for d, mb in t.deps
                                    if d == s.name), default=0.0)
                       for s in w.stages}
        self.downstream = {s.name: [t for t in w.stages if t.deps and
                                    s.name in [d for d, _ in t.deps]]
                           for s in w.stages}
        self.sinks = [t for t in w.stages if not self.consumers[t.name]]


STAGE_RECOVERY_BUDGET = 5     # re-executions per (request, stage)


class WorkflowEngine:
    def __init__(self, topo: Topology, cfg: TubeConfig,
                 placements: dict[str, dict] | None = None, *,
                 recover: bool = True, sim=None, boundary=None,
                 local_nodes=None):
        self.tube = FaaSTube(topo, cfg, sim=sim)
        self.topo = topo
        self.cfg = cfg
        self.placements = placements or {}
        # cross-shard execution (core/shard.py): `boundary` receives
        # stages placed outside `local_nodes` instead of _try_stage; both
        # None on an ordinary engine, which keeps every hook below on the
        # single-attribute-check fast path
        self.boundary = boundary
        self.local_nodes = frozenset(local_nodes) if local_nodes else None
        self.apps: dict[str, Workflow] = {}      # name -> workflow (shard
        #                                          mode: remote triggers
        #                                          resolve apps by name)
        self.gpu_busy: dict[str, bool] = defaultdict(bool)
        self.gpu_queue: dict[str, deque] = defaultdict(deque)
        self.requests: dict[int, RequestState] = {}
        self._rid = itertools.count()
        self.completed: list[RequestState] = []
        self.failed: list[RequestState] = []
        self._meta: dict[int, tuple] = {}   # id(w) -> (_WorkflowMeta, w)
        # lineage recovery (module docstring): dead GPUs remap onto
        # survivors; recover=False is the no-retry contrast arm
        self.recover = recover
        self.dead_gpus: set[str] = set()
        self._remap: dict[str, str] = {}
        self.recovered_stages = 0
        self.tube.crash_listeners.append(self._on_node_crash)

    def _wmeta(self, w: Workflow) -> _WorkflowMeta:
        # keyed by id(w) WITH a strong reference to w in the value: if the
        # dict didn't keep w alive, a GC'd workflow's recycled id could
        # alias another workflow's metadata
        hit = self._meta.get(id(w))
        if hit is None or hit[1] is not w:
            hit = self._meta[id(w)] = (_WorkflowMeta(w), w)
        return hit[0]

    # ------------------------------------------------------------ public --
    def submit_workflow(self, w: Workflow, t_arrive: float,
                        slo_factor: float = 0.0):
        if w.name not in self.placements:
            occupied = {}
            for pl in self.placements.values():
                occupied.update(pl)
            self.placements[w.name] = place(w, self.topo, occupied=occupied)
        rid = next(self._rid)
        rs = RequestState(rid, t_arrive)
        if slo_factor:
            rs.slo_ms = slo_factor * isolated_compute_ms(w)
        self.requests[rid] = rs
        self.tube.sim.call_at(t_arrive, lambda sim: self._start(w, rs))
        return rid

    def run(self):
        self.tube.sim.run()
        return self.completed

    # -------------------------------------------- cross-shard execution --
    # Entry points driven by core/shard.py's boundary protocol.  An
    # ordinary engine never reaches them.
    def register_apps(self, apps):
        for w in apps:
            self.apps[w.name] = w

    def accept_stage(self, w: Workflow, rs: RequestState, stage_name: str,
                     state: dict):
        """Run one handed-off stage locally.  ``rs`` is either a shadow
        request (created by the boundary client) or — when a remote
        stage's successor returns to its home shard — the real one.
        ``state`` carries set-unions and scalar DELTAS accumulated on
        the sending shard since its last sync."""
        rs.done_stages |= state["done"]
        rs.stored_stages |= state["stored"]
        rs.fetched_stages |= state["fetched"]
        rs.data_ids.update(state["data_ids"])
        rs.h2g_ms += state["h2g_ms"]
        rs.g2g_ms += state["g2g_ms"]
        rs.compute_ms += state["compute_ms"]
        s = self._wmeta(w).stage[stage_name]
        rs.started_stages.discard(s.name)
        # gate on the MERGED view: a fan-in stage syncs once per remote
        # producer, and only the final merge sees every dep stored
        if all(d in rs.stored_stages for d, _ in s.deps):
            self._dispatch_or_try(w, rs, s)

    def accept_complete(self, rs: RequestState, t_done: float,
                        state: dict, failed: bool):
        """A shadow of one of our requests finished (or failed) on its
        executing shard: merge its deltas and record the completion."""
        rs.h2g_ms += state["h2g_ms"]
        rs.g2g_ms += state["g2g_ms"]
        rs.compute_ms += state["compute_ms"]
        rs.done_stages |= state["done"]
        if failed:
            self._fail_request(rs)
            return
        if rs.t_done >= 0:
            return
        rs.t_done = t_done
        self.completed.append(rs)

    # ----------------------------------------------------------- engine ---
    def _remote(self, w: Workflow, rs: RequestState, s) -> bool:
        """True when stage s must execute on another shard.  GPU stages
        belong to their placement's node; cpu stages (and completion)
        belong to the request's origin shard."""
        if self.boundary is None:
            return False
        if s.kind == "gpu":
            ln = self.local_nodes
            return ln is not None and \
                self._gpu_of(w, s).split(":")[0] not in ln
        return bool(rs.origin)

    def _dispatch_or_try(self, w: Workflow, rs: RequestState, s):
        if self._remote(w, rs, s):
            # no started-dedup here: a fan-in stage receives one sync per
            # producer (each carrying that producer's bytes), and the
            # OWNING shard gates on its merged view in accept_stage; the
            # boundary client dedups byte exports per (stage, dep)
            self.boundary.dispatch(self, w, rs, s)
        else:
            self._try_stage(w, rs, s)

    def _start(self, w: Workflow, rs: RequestState):
        sim = self.tube.sim
        # publish host inputs on the host of the consuming stage's node
        # (cluster topologies have per-node hosts); inputs of a REMOTE
        # stage are published by the owning shard at handoff
        meta = self._wmeta(w)
        for stage, mb in w.input_mb.items():
            st = meta.stage[stage]
            if self._remote(w, rs, st):
                continue
            did = f"r{rs.rid}:in:{stage}"
            host = host_of(self._gpu_of(w, st)) if st.kind == "gpu" else "host"
            self.tube.store(f"r{rs.rid}", did, mb, host, sim.now)
        for s in w.stages:
            if not s.deps and s.name not in w.input_mb and s.kind == "cpu":
                # source cpu stage (decode): runs immediately on host
                self._run_stage(w, rs, s)
        for s in w.stages:
            if s.kind == "gpu" and not s.deps:
                self._dispatch_or_try(w, rs, s)

    def _gpu_of(self, w: Workflow, stage) -> str:
        g = self.placements[w.name][stage.name]
        return self._remap.get(g, g)

    # ------------------------------------------------------- fault model --
    def _on_node_crash(self, node: str, t: float):
        """Crash listener (fires before the tube invalidates the node's
        objects): remap dead GPUs deterministically onto sorted
        survivors, move their queues, and resume draining."""
        pre = node + ":"
        dead = sorted(g for g in self.topo.gpus
                      if g.startswith(pre) and g not in self.dead_gpus)
        if not dead:
            return
        self.dead_gpus.update(dead)
        survivors = sorted(g for g in self.topo.gpus
                           if g not in self.dead_gpus)
        if not survivors:
            return
        for i, g in enumerate(dead):
            self._remap[g] = survivors[i % len(survivors)]
        for k, v in list(self._remap.items()):
            while v in self.dead_gpus:          # chase earlier remaps
                v = self._remap[v]
            self._remap[k] = v
        for g in dead:
            self.gpu_busy.pop(g, None)
            for item in self.gpu_queue.pop(g, ()):
                self.gpu_queue[self._remap[g]].append(item)
        for g in sorted({self._remap[g] for g in dead}):
            self._drain(g)

    def _budget_ok(self, rs: RequestState, s) -> bool:
        """Charge one recovery of stage s against the request's budget."""
        if not self.recover or rs.failed or rs.t_done >= 0:
            return False
        n = rs.recoveries.get(s.name, 0)
        if n >= STAGE_RECOVERY_BUDGET:
            return False
        rs.recoveries[s.name] = n + 1
        return True

    def _fail_request(self, rs: RequestState):
        if rs.failed or rs.t_done >= 0:
            return
        rs.failed = True
        if rs.origin:
            self.boundary.complete(self, rs)     # relay to home shard
            return
        self.failed.append(rs)

    def _fetch_failed(self, w: Workflow, rs: RequestState, s, did: str,
                      err, held: str):
        """Terminal input-fetch failure for stage s.  Release the GPU
        slot the invocation holds (a parked stage must not deadlock its
        GPU), then walk the lineage."""
        if held and held not in self.dead_gpus and self.gpu_busy.get(held):
            self.gpu_busy[held] = False
            self._drain(held)
        if not self._budget_ok(rs, s):
            self._fail_request(rs)
            return
        rs.started_stages.discard(s.name)
        rs.fetched_stages.discard(s.name)
        self._recover(w, rs, s, did)

    def _recover(self, w: Workflow, rs: RequestState, s, did: str):
        """Lineage recovery for one lost data id feeding stage s.

        Inputs are re-published (they originate outside the tube); an
        intermediate still in the index means the TRANSFER failed, not
        the data — plain retry; otherwise the producer stage is reset
        and re-executed.  Stage s itself re-triggers through the normal
        ``stored`` -> downstream machinery once the producer's output
        store completes."""
        sim = self.tube.sim
        meta = self._wmeta(w)
        rid = rs.rid
        if did.startswith(f"r{rid}:in:"):
            stage = did.split(":", 2)[2]
            st = meta.stage[stage]
            host = host_of(self._gpu_of(w, st)) if st.kind == "gpu" \
                else "host"
            self.tube.store(f"r{rid}", did, w.input_mb[stage], host,
                            sim.now)
            self._try_stage(w, rs, s)
            return
        if did in self.tube.index.global_table:
            self._try_stage(w, rs, s)            # data intact: plain retry
            return
        prod = did[len(f"r{rid}:"):]
        p = meta.stage.get(prod)
        if p is None:
            self._fail_request(rs)
            return
        if prod in rs.started_stages and prod not in rs.done_stages:
            return     # re-execution already in flight; stored() re-triggers
        self.recovered_stages += 1
        for coll in (rs.done_stages, rs.started_stages,
                     rs.stored_stages, rs.fetched_stages):
            coll.discard(prod)
        self._try_stage(w, rs, p)

    def _try_stage(self, w: Workflow, rs: RequestState, s):
        """Enqueue stage s on its GPU's request queue (temporal sharing).

        Inputs are fetched when the invocation reaches the queue front —
        the paper's execution model (§7.2): intermediates DWELL in the
        store while upstream producers outpace downstream consumers,
        which is what makes queue-aware migration matter.

        Idempotent per stage: a fan-in stage's producers each report
        store completion independently, and more than one of those
        callbacks can observe all deps done.
        """
        if s.name in rs.started_stages:
            return
        rs.started_stages.add(s.name)
        if s.kind == "cpu":
            def run_cpu():
                self._consume_fetched(w, rs, s)
                self._run_stage(w, rs, s)
            self._fetch_then(w, rs, s, run_cpu)
            return
        gpu = self._gpu_of(w, s)
        self.gpu_queue[gpu].append((w, rs, s))
        self._drain(gpu)

    def _drain(self, gpu: str):
        if self.gpu_busy[gpu] or not self.gpu_queue[gpu]:
            return
        self.gpu_busy[gpu] = True
        w, rs, s = self.gpu_queue[gpu].popleft()
        if self.cfg.overlap and s.partial \
                and (s.deps or s.name in w.input_mb):
            self._drain_overlap(gpu, w, rs, s)
            return

        def compute():
            sim = self.tube.sim
            # destructive read: inputs are consumed when the invocation
            # reads them, so spill/prefetch overlaps THIS compute (paper
            # Fig. 10b) instead of stalling the next consumer
            self._consume_fetched(w, rs, s)

            def finished(sim2):
                if gpu in self.dead_gpus:
                    # crashed mid-compute: the invocation died with the
                    # node.  Re-trigger on the remapped GPU — its
                    # consumed inputs surface as fetch errors and walk
                    # the lineage recovery.
                    if self._budget_ok(rs, s):
                        rs.started_stages.discard(s.name)
                        rs.fetched_stages.discard(s.name)
                        self._try_stage(w, rs, s)
                    else:
                        self._fail_request(rs)
                    return
                self.gpu_busy[gpu] = False
                self._finish_stage(w, rs, s)
                self._drain(gpu)
            sim.call_at(sim.now + s.compute_ms, finished)
        self._fetch_then(w, rs, s, compute, held=gpu)

    def _consume_fetched(self, w: Workflow, rs: RequestState, s):
        sim = self.tube.sim
        meta = self._wmeta(w)
        rs.fetched_stages.add(s.name)
        for dep, _mb in s.deps:
            consumers = meta.consumers[dep]
            if all(c in rs.fetched_stages for c in consumers):
                did = rs.data_ids.get(dep)
                # release from wherever the bytes actually live: on a
                # shard that reloaded a handed-off dep, that is the local
                # GPU, not the producer's placement
                dev = self.tube._home.get(did) if did else None
                if dev is not None and is_device(dev):
                    self.tube.consume(did, dev, sim.now)

    def _consume_partial(self, w: Workflow, rs: RequestState, s):
        """Overlap twin of ``_consume_fetched``: runs at the stage's
        FIRST landed trigger batch, before its readers finish.  The same
        all-consumers guard applies; ``partial=True`` flips the dep to
        PARTIAL residency (unspillable, release deferred to the last
        in-flight reader) instead of releasing it outright."""
        sim = self.tube.sim
        meta = self._wmeta(w)
        rs.fetched_stages.add(s.name)
        for dep, _mb in s.deps:
            consumers = meta.consumers[dep]
            if all(c in rs.fetched_stages for c in consumers):
                did = rs.data_ids.get(dep)
                dev = self.tube._home.get(did) if did else None
                if dev is not None and is_device(dev):
                    self.tube.consume(did, dev, sim.now, partial=True)

    def _drain_overlap(self, gpu: str, w: Workflow, rs: RequestState, s):
        """Overlap-aware stage execution (``TubeConfig.overlap``).

        Compute starts when the first trigger batch of input lands and
        pipelines against the residual transfer: every progress report
        of ``delta`` landed MB extends a pipelined compute clock

            c = max(c, t) + (delta / total_in) * compute_ms

        — the batched-pipelining recurrence: a batch is processed once
        it has both landed AND the previous batch's compute retired, so
        a transfer-bound stage finishes ~one batch-compute after its
        last byte while a compute-bound stage hides the transfer tail
        entirely.  Total compute charged is exactly ``compute_ms``.
        Inputs are partial-consumed at first landing; terminal fetch
        failures poison the group and walk the same lineage recovery as
        the serial path (the partial consume surfaces as a re-fetch of
        a PARTIAL or re-produced object)."""
        sim = self.tube.sim
        needed = []
        if s.name in w.input_mb:
            needed.append((f"r{rs.rid}:in:{s.name}", "h2g",
                           w.input_mb[s.name]))
        for dep, mb in s.deps:
            needed.append((rs.data_ids[dep], "g2g", mb))
        total_in = sum(mb for _, _, mb in needed)
        landed = {did: 0.0 for did, _, _ in needed}
        st = {"c": 0.0, "sum": 0.0, "started": False,
              "left": len(needed), "dead": False}
        t0 = sim.now

        def advance(t):
            cur = sum(landed.values())
            delta = cur - st["sum"]
            if delta <= 1e-12:
                return
            st["sum"] = cur
            if not st["started"]:
                st["started"] = True
                st["c"] = t
                self._consume_partial(w, rs, s)
            st["c"] = max(st["c"], t) + (delta / total_in) * s.compute_ms

        def finished(sim2):
            if gpu in self.dead_gpus:
                # crashed mid-pipeline: same re-trigger as the serial
                # path — consumed inputs surface as fetch errors and
                # walk the lineage recovery on the remapped GPU
                if self._budget_ok(rs, s):
                    rs.started_stages.discard(s.name)
                    rs.fetched_stages.discard(s.name)
                    self._try_stage(w, rs, s)
                else:
                    self._fail_request(rs)
                return
            self.gpu_busy[gpu] = False
            self._finish_stage(w, rs, s)
            self._drain(gpu)

        for did, kind, mb in needed:
            def on_progress(sim2, h, did=did, mb=mb):
                if st["dead"]:
                    return
                if h.done_mb > landed[did]:
                    landed[did] = min(h.done_mb, mb)
                    advance(sim2.now)

            def on_ready(sim2, t, did=did, kind=kind, mb=mb):
                if st["dead"]:
                    return
                dt = t - t0
                if kind == "h2g":
                    rs.h2g_ms = max(rs.h2g_ms, dt)
                else:
                    rs.g2g_ms = max(rs.g2g_ms, dt)
                landed[did] = mb
                advance(t)
                st["left"] -= 1
                if st["left"] == 0:
                    sim2.call_at(max(st["c"], t), finished)

            def on_error(sim2, err, did=did):
                if st["dead"]:
                    return
                st["dead"] = True
                self._fetch_failed(w, rs, s, did, err, gpu)
            self.tube.fetch(f"r{rs.rid}:{s.name}", did, gpu, sim.now,
                            slo_ms=rs.slo_ms, infer_ms=s.compute_ms,
                            on_ready=on_ready, on_error=on_error,
                            on_progress=on_progress)

    def _fetch_then(self, w: Workflow, rs: RequestState, s, then,
                    held: str = ""):
        """Fetch all of stage s's inputs, then call `then()`.

        One terminal fetch failure poisons the whole group (``dead``):
        sibling fetches that still land must not start the compute —
        the stage re-triggers through recovery with a fresh group."""
        sim = self.tube.sim
        gpu = self._gpu_of(w, s) if s.kind == "gpu" else "host"
        needed = []
        if s.name in w.input_mb:
            needed.append((f"r{rs.rid}:in:{s.name}", "h2g"))
        for dep, mb in s.deps:
            needed.append((rs.data_ids[dep], "g2g"))
        if not needed:
            then()
            return
        pending = {"n": len(needed), "dead": False}
        t_fetch_start = sim.now

        for did, kind in needed:
            def on_ready(sim2, t, kind=kind, t0=t_fetch_start):
                if pending["dead"]:
                    return
                dt = t - t0
                if kind == "h2g":
                    rs.h2g_ms = max(rs.h2g_ms, dt)
                else:
                    rs.g2g_ms = max(rs.g2g_ms, dt)
                pending["n"] -= 1
                if pending["n"] == 0:
                    then()

            def on_error(sim2, err, did=did):
                if pending["dead"]:
                    return
                pending["dead"] = True
                self._fetch_failed(w, rs, s, did, err, held)
            self.tube.fetch(f"r{rs.rid}:{s.name}", did, gpu, sim.now,
                            slo_ms=rs.slo_ms, infer_ms=s.compute_ms,
                            on_ready=on_ready, on_error=on_error)

    def _run_stage(self, w: Workflow, rs: RequestState, s):
        sim = self.tube.sim
        sim.call_at(sim.now + s.compute_ms,
                    lambda sim2: self._finish_stage(w, rs, s))

    def _finish_stage(self, w: Workflow, rs: RequestState, s):
        sim = self.tube.sim
        meta = self._wmeta(w)
        rs.compute_ms += s.compute_ms
        rs.done_stages.add(s.name)
        out_mb = meta.out_mb[s.name]

        # trigger downstream stages once every dep's output store has
        # COMPLETED (stored_stages, not done_stages): the alloc cost
        # sits on this path when there is no pool, and under memory
        # pressure a store's ready time is completion-driven (it waits
        # for victim spills) — a consumer must not start against a
        # producer output whose capacity-deferred allocation never landed
        def stored(sim2, t):
            rs.stored_stages.add(s.name)
            for tg in meta.downstream[s.name]:
                if tg.name in rs.done_stages:
                    continue
                if self._remote(w, rs, tg):
                    # per-producer sync: ship this producer's bytes now;
                    # the owning shard re-gates on its merged view
                    self._dispatch_or_try(w, rs, tg)
                elif all(d in rs.stored_stages for d, _ in tg.deps):
                    self._dispatch_or_try(w, rs, tg)

        if out_mb and s.kind == "gpu":
            did = f"r{rs.rid}:{s.name}"
            rs.data_ids[s.name] = did
            self.tube.store(f"r{rs.rid}", did, out_mb,
                            self._gpu_of(w, s), sim.now,
                            consumer_pos=rs.rid, on_ready=stored)
        elif out_mb:
            did = f"r{rs.rid}:{s.name}"
            rs.data_ids[s.name] = did
            self.tube.store(f"r{rs.rid}", did, out_mb, "host",
                            sim.now, on_ready=stored)
        else:
            stored(sim, sim.now)

        # workflow finished?
        if all(t.name in rs.done_stages for t in meta.sinks):
            ret_mb = w.output_mb.get(s.name, 0.0)
            if ret_mb and s.kind == "gpu":
                def returned(sim2, tr):
                    self._complete(rs)

                def ret_failed(sim2, err):
                    # the return copy died terminally (its node crashed
                    # mid-put): re-execute the sink stage on the
                    # remapped GPU — its consumed inputs walk the
                    # lineage recovery like any other loss
                    if not self._budget_ok(rs, s):
                        self._fail_request(rs)
                        return
                    for coll in (rs.done_stages, rs.started_stages,
                                 rs.stored_stages, rs.fetched_stages):
                        coll.discard(s.name)
                    self._try_stage(w, rs, s)
                gpu = self._gpu_of(w, s)
                # the return copy carries the request's SLO context down
                # so it is foreground-admitted like any fetch (it used to
                # bypass the scheduler and contend at the default weight).
                # Its slack is what remains of the request's exec budget
                # (SLO minus data passing + compute so far, the §9.2
                # no-queueing accounting) — not a fresh full slo_ms.
                rem = rs.slo_ms
                if rs.slo_ms < 1e8:
                    rem = max(rs.slo_ms - rs.h2g_ms - rs.g2g_ms
                              - rs.compute_ms, 1e-3)
                self.tube.put(f"r{rs.rid}:ret", gpu, ret_mb, sim.now,
                              slo_ms=rem, on_done=returned,
                              on_error=ret_failed)
                return
            self._complete(rs)

    def _complete(self, rs: RequestState):
        if rs.t_done >= 0:
            return
        rs.t_done = self.tube.sim.now
        if rs.origin:
            self.boundary.complete(self, rs)     # relay to home shard
            return
        self.completed.append(rs)


def run_closed_loop(topo_fn, cfg: TubeConfig, w: Workflow, *,
                    n_requests: int = 32, interarrival_ms: float = 0.0,
                    slo_factor: float = 0.0):
    """Submit n requests (optionally spaced) and return completed states."""
    eng = WorkflowEngine(topo_fn(), cfg)
    t = 0.0
    for _ in range(n_requests):
        eng.submit_workflow(w, t, slo_factor=slo_factor)
        t += interarrival_ms
    eng.run()
    return eng
