"""Model-swapping serving tier (Torpor/FaaSwap direction): checkpoint
cache + layer-granular pipelined reload + SLO-aware swap policy.

The fleet treats function *data* as tube objects; this module treats
model *weights* the same way.  Each registered checkpoint is ONE tube
object (``ckpt:<model>``) homed at its serving GPU's store, and walks
the same transfer-completion-driven location state machine as any
spilled intermediate (``core/migration.py``):

    HOST --request--> RELOADING --h2g done--> DEVICE --evict--> HOST

with two serving-tier refinements:

* **Weights are immutable**, so swap-OUT never copies: eviction flips
  DEVICE -> SPILLING -> HOST through ``_spill_complete`` with no g2h
  transfer — the pinned-host copy (or the registry master) is already
  authoritative.  What the cache tracks per model is WHICH host copy
  backs the next reload: a slot on the node's circular pinned ring
  (state HOST — reload is a local pinned-PCIe h2g) or only the fleet
  registry host (state EVICTED — reload pays the cold object path
  across the host mesh).  Both reloads are the SAME demand-reload code;
  they differ only in ``item.host``.
* **Reloads are layer-granular.**  A checkpoint registers with its real
  per-layer shard sizes (``profile_from_arch`` walks the PSpec trees in
  ``repro.models``), and the h2g reload streams through the engine's
  cut-through staging with ``on_progress`` trigger-batch events: layer
  *k* starts computing while layer *k+1* is still in flight, so
  first-token latency gates on the first layers landed, not the whole
  checkpoint (``pipelined=False`` is the whole-model contrast arm).

Victim selection reuses the queue-aware machinery: the cache owns a
:class:`~repro.core.migration.Migrator` and, for the SLO-aware policy,
writes each candidate's evictability score (popularity + slack) into
``item.consumer_pos`` before calling ``pick_victims`` — which also
gives mid-reload (RELOADING) and mid-overlap (PARTIAL) checkpoints
their refusal for free.  Queue depth is a hard pin: a model with
waiting requests is never a victim (swapping it out guarantees an
immediate cold re-fault), so a load that cannot free room PARKS at the
cache level and retries as the queues drain — the tube's own spill
machinery never runs behind the cache's back.  ``policy="lru"`` ranks
by ``last_access`` with no pin (the contrast arm); keep-warm registers
every model ``resident=True`` and never evicts.

Serving is one prefill at a time per GPU, FIFO **among ready jobs**: a
job whose model is still swapping in does not head-of-line-block a
resident model's request behind it (the GPU runs whatever has weights
— the reorder that makes swap-stalls observable as queue skew rather
than convoy delay).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core.migration import DEVICE, HOST, RELOADING, SPILLING, Migrator
from repro_torch.core.pinned_buffer import CircularPinnedBuffer
from repro_torch.core.topology import PCIE_PINNED
from repro_torch.core.transfer import host_of, node_of

#: cache-level location of a model whose only copy is the registry
#: master (the node-local pinned copy was demoted); the tube item still
#: reads state HOST — EVICTED is "HOST, but host == the registry"
EVICTED = "evicted"

#: prefill cost per MB of weights touched: ~2 FLOPs/param/token on a
#: 2k-token prompt at ~30% MFU on V100-class silicon works out to
#: ~0.055 ms per MB of bf16 parameters — full-model prefill lands in
#: the same regime as the pinned-PCIe reload, where pipelining the two
#: is worth a large fraction of first-token latency
PREFILL_MS_PER_MB = 0.055

#: EWMA inter-arrival estimate: optimistic-cold init + smoothing factor
IAT_INIT_MS = 120_000.0
IAT_ALPHA = 0.3


# ------------------------------------------------------------- profiles ----

@dataclass(frozen=True)
class ModelProfile:
    """Layer-granular shard description of one servable checkpoint.

    ``layer_mb`` is the per-GPU shard, in stream order: the embedding
    first (needed before any block can run), then every block of
    ``block_pattern``.  ``prefix_mb[k]`` is the bytes that must land
    before layer k may compute.
    """
    name: str
    arch: str
    layer_mb: tuple
    layer_ms: tuple
    prefix_mb: tuple
    tp: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.layer_mb)

    @property
    def total_mb(self) -> float:
        return self.prefix_mb[-1]

    @property
    def total_compute_ms(self) -> float:
        return sum(self.layer_ms)

    @property
    def reload_ms(self) -> float:
        """Pinned-PCIe lower bound for a full swap-in (victim scoring)."""
        return self.total_mb / PCIE_PINNED


def make_profile(name: str, arch: str, layer_mb, *, tp: int = 1,
                 prefill_ms_per_mb: float = PREFILL_MS_PER_MB,
                 ) -> ModelProfile:
    layer_mb = tuple(float(m) for m in layer_mb)
    prefix = [0.0]
    for m in layer_mb:
        prefix.append(prefix[-1] + m)
    return ModelProfile(
        name=name, arch=arch, layer_mb=layer_mb,
        layer_ms=tuple(m * prefill_ms_per_mb for m in layer_mb),
        prefix_mb=tuple(prefix), tp=tp)


def profile_from_arch(arch, *, tp: int = 1, name: str | None = None,
                      prefill_ms_per_mb: float = PREFILL_MS_PER_MB,
                      ) -> ModelProfile:
    """Real per-layer shard sizes from the model stack's PSpec trees.

    ``tp`` is the tensor/expert-parallel degree the checkpoint is
    sharded at — each serving GPU holds (and reloads) 1/tp of every
    layer.  Each leaf's bytes come from its torch dtype; the specs of
    every block kind exist, so every architecture has a profile.
    Imports stay local so the serving tier itself needs no torch
    unless real shapes are requested.
    """
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import param as PM
    from repro_torch.models.blocks import block_pattern, block_specs

    cfg = get_arch(arch) if isinstance(arch, str) else arch

    def tree_mb(tree) -> float:
        return sum(float(np.prod(p.shape)) * p.dtype.itemsize
                   for _, p in PM.tree_leaves_with_paths(tree)) / 1e6

    embed = tree_mb(L.embedding_specs(cfg.padded_vocab, cfg.d_model,
                                      cfg.tie_embeddings))
    per_kind = {k: tree_mb(block_specs(cfg, k))
                for k in set(block_pattern(cfg))}
    layers = [embed / tp] + [per_kind[k] / tp for k in block_pattern(cfg)]
    return make_profile(name or cfg.name, cfg.name, layers, tp=tp,
                        prefill_ms_per_mb=prefill_ms_per_mb)


# ------------------------------------------------------------- entries -----

@dataclass
class _Entry:
    profile: ModelProfile
    gpu: str
    state: str = EVICTED
    item: object = None
    host_slot: bool = False       # node pinned-ring residency held
    dead: bool = False            # serving node crashed
    last_access: float = float("-inf")
    t_prev: float | None = None
    iat_ms: float = IAT_INIT_MS   # EWMA inter-arrival (popularity)
    queue_depth: int = 0          # queued + in-service requests
    loading: bool = False
    load_pending: bool = False    # swap-in waiting for evictable room
    land_t: list | None = None    # per-layer landed time of current load
    next_land: int = 0
    resident_since: float = 0.0
    mb_ms: float = 0.0            # DEVICE-residency integral (keep-warm cost)

    @property
    def data_id(self) -> str:
        return f"ckpt:{self.profile.name}"


class _Job:
    __slots__ = ("entry", "t_arrive", "cold", "k", "c", "finish_t",
                 "failed", "on_first_token")

    def __init__(self, entry: _Entry, t: float, cold: bool,
                 on_first_token=None):
        self.entry = entry
        self.t_arrive = t
        self.cold = cold
        self.k = 0                   # next layer to compute
        self.c = None                # pipelined compute clock
        self.finish_t = None
        self.failed = False
        self.on_first_token = on_first_token


# ------------------------------------------------------------ the cache ----

class ModelCache:
    """Checkpoint cache + request path of the model-swapping tier.

    One instance serves a fleet: models are registered onto serving
    GPUs, requests queue per GPU (one prefill at a time, FIFO among
    ready jobs), and every weight movement executes through the tube's
    TransferEngine.
    """

    def __init__(self, tube, *, policy: str = "slo", pipelined: bool = True,
                 host_cache_mb: float = 16384.0,
                 registry_host=None):
        assert policy in ("slo", "lru")
        self.tube = tube
        self.sim = tube.sim
        self.policy = policy
        self.pipelined = pipelined
        # the queue-aware victim machinery, reused: "slo" ranks by the
        # consumer_pos scores _score() writes, "lru" by last_access
        self.migrator = Migrator("lru" if policy == "lru" else "queue")
        # per-node pinned checkpoint ring: host-cache residency budget
        # (same occupancy accounting as the staging ring, keyed by host)
        self.host_ring = CircularPinnedBuffer(
            size_mb=host_cache_mb, policy="circular", warmed=True)
        # the fleet checkpoint registry: one host (str) or, for a
        # distributed object store, a callable mapping model name ->
        # the host holding that checkpoint's master shard
        self.registry_host = registry_host or host_of(min(tube.topo.gpus))
        self.entries: dict[str, _Entry] = {}
        self._q: dict[str, deque] = {}
        self._serving: dict[str, _Job | None] = {}
        self.ttft: list[tuple] = []   # (t_arrive, ttft_ms, cold)
        self.stats = {
            "requests": 0, "warm": 0, "cold": 0, "loads": 0,
            "host_hits": 0, "cold_misses": 0, "evictions": 0,
            "evicted_with_queue": 0, "host_demotions": 0,
            "load_failures": 0, "failed_requests": 0,
        }
        tube.crash_listeners.append(self._on_crash)

    # ------------------------------------------------------ registration --
    def _registry_for(self, e) -> str:
        r = self.registry_host
        return r(e.profile.name) if callable(r) else r

    def register(self, profile: ModelProfile, gpu: str, now: float, *,
                 prestage: bool = True, resident: bool = False) -> _Entry:
        """Publish a checkpoint for serving from ``gpu``.

        ``prestage=True`` claims a slot on the node's pinned ring when
        one is free (deploy-time host caching, popularity order is the
        caller's choice); otherwise the model starts registry-backed.
        ``resident=True`` is the keep-warm arm: weights loaded at
        deploy time and never evicted.
        """
        p = profile
        e = _Entry(profile=p, gpu=gpu)
        self.entries[p.name] = e
        if resident:
            self.tube.store(p.name, e.data_id, p.total_mb, gpu, now)
            e.item = self.tube.items[gpu][e.data_id]
            e.state = DEVICE
            e.resident_since = now
            return e
        host = host_of(gpu)
        if prestage and self.host_ring.try_reserve(p.total_mb, key=host):
            e.host_slot = True
            e.state = HOST
        else:
            host = self._registry_for(e)
            e.state = EVICTED
        e.item = self.tube.adopt_host_object(
            p.name, e.data_id, p.total_mb, host, now, home=gpu)
        return e

    # ---------------------------------------------------------- requests --
    def request(self, name: str, now: float, *, on_first_token=None) -> _Job:
        """One inference request: swap the model in if needed, queue its
        prefill on the serving GPU, fire ``on_first_token(sim, t)`` when
        the last layer's compute retires."""
        e = self.entries[name]
        self.stats["requests"] += 1
        if e.t_prev is not None:
            e.iat_ms = IAT_ALPHA * (now - e.t_prev) \
                + (1.0 - IAT_ALPHA) * e.iat_ms
        e.t_prev = now
        e.last_access = now
        if e.item is not None:
            e.item.last_access = now
        job = _Job(e, now, e.state != DEVICE, on_first_token)
        if e.dead or node_of(e.gpu) in self.tube.dead_nodes:
            self.stats["failed_requests"] += 1
            job.failed = True
            return job
        e.queue_depth += 1
        if job.cold:
            self.stats["cold"] += 1
            self._ensure_loading(e, now)
        else:
            self.stats["warm"] += 1
        self._q.setdefault(e.gpu, deque()).append(job)
        self._advance(e.gpu)
        return job

    # ------------------------------------------------------------- loads --
    def _ensure_loading(self, e: _Entry, now: float):
        """Start the model's swap-in unless one is already in flight.

        Room is made FIRST (so the tube's ``_reserve`` always grants
        immediately and its own spill machinery never runs on
        checkpoint items); when the swap policy refuses every victim —
        all residents queued or in service — the load parks and
        ``_kick`` retries it as requests retire."""
        if e.loading or e.state == DEVICE or e.dead:
            return
        p = e.profile
        tube = self.tube
        if e.item is None or e.data_id not in tube.index.global_table:
            # poisoned by a fault while away: the registry master is
            # immortal — re-adopt from it and take the cold path
            e.item = tube.adopt_host_object(
                p.name, e.data_id, p.total_mb, self._registry_for(e), now,
                home=e.gpu)
            e.state = EVICTED
        need = tube._held_mb(e.gpu) + tube._mb_needed(p.total_mb) \
            - tube.cfg.store_cap_mb
        if need > 0:
            need -= self._free_mb(e.gpu, need, now, incoming=e)
        if need > 1e-9:
            e.load_pending = True
            return
        e.load_pending = False
        if e.state == HOST:
            self.stats["host_hits"] += 1
        else:
            self.stats["cold_misses"] += 1
        self.stats["loads"] += 1
        e.loading = True
        e.land_t = [None] * p.n_layers
        e.next_land = 0

        def prog(sim, h, e=e, p=p):
            done = h.done_mb + 1e-9
            k = e.next_land
            moved = False
            while k < p.n_layers and p.prefix_mb[k + 1] <= done:
                e.land_t[k] = sim.now
                k += 1
                moved = True
            e.next_land = k
            if moved:
                self._advance(e.gpu)

        def ready(sim, t, e=e, p=p):
            e.loading = False
            for k in range(p.n_layers):
                if e.land_t[k] is None:
                    e.land_t[k] = t
            e.next_land = p.n_layers
            e.state = DEVICE
            e.resident_since = t
            if not e.host_slot:
                # the checkpoint just streamed through this node's
                # staging: keep the bytes pinned when the ring has room
                self._admit_host(e, t)
            self._kick(e.gpu)
            self._advance(e.gpu)

        def err(sim, ex, e=e):
            self._load_failed(e, sim)

        tube.fetch(p.name, e.data_id, e.gpu, now,
                   on_ready=ready, on_error=err,
                   on_progress=prog if self.pipelined else None)
        if e.state != DEVICE:
            e.state = RELOADING

    def _kick(self, gpu: str):
        """Retry parked swap-ins (room frees only through cache-driven
        evictions, so every retire/ready re-runs the pending loads)."""
        now = self.sim.now
        for e in self.entries.values():
            if e.gpu == gpu and e.load_pending:
                e.load_pending = False
                self._ensure_loading(e, now)

    def _load_failed(self, e: _Entry, sim):
        e.loading = False
        e.land_t = None
        self.stats["load_failures"] += 1
        if e.data_id not in self.tube.index.global_table:
            # lost wholesale (node crash / host loss): drop the poisoned
            # item; the next request re-adopts from the registry
            e.item = None
            if e.host_slot:
                self.host_ring.release(e.profile.total_mb, sim,
                                       key=host_of(e.gpu))
                e.host_slot = False
            e.state = EVICTED
        else:
            # h2g failed but the source copy is intact (the machinery
            # already flipped the item back to HOST)
            e.state = HOST if e.host_slot else EVICTED
        if node_of(e.gpu) in self.tube.dead_nodes:
            e.dead = True
        self._fail_jobs(e, sim.now)

    # ------------------------------------------------------- compute loop --
    def _advance(self, gpu: str):
        """Admit the first READY queued job when the GPU is idle, then
        drive the in-service job's pipelined prefill clock: layer k
        costs ``layer_ms[k]`` and may start once its weights landed —
        ``c = max(c, t_landed[k]) + layer_ms[k]`` — so compute overlaps
        the residual transfer exactly like a partial-input stage."""
        job = self._serving.get(gpu)
        if job is not None:
            if job.finish_t is None:
                self._run(gpu, job)
            return
        q = self._q.get(gpu)
        if not q:
            return
        for i, j in enumerate(q):
            e = j.entry
            if e.state not in (DEVICE, RELOADING) and not e.loading \
                    and not e.load_pending and not e.dead:
                # evicted (or demoted) while queued: this request goes
                # cold again — the pathology queue-aware scoring exists
                # to avoid
                if not j.cold:
                    j.cold = True
                    self.stats["cold"] += 1
                self._ensure_loading(e, self.sim.now)
            if e.state == DEVICE or (e.state == RELOADING
                                     and e.land_t is not None
                                     and e.land_t[j.k] is not None):
                del q[i]
                self._serving[gpu] = j
                # a request() issued with ``now`` ahead of the sim clock
                # must not start computing before it arrived
                j.c = max(self.sim.now, j.t_arrive)
                self._run(gpu, j)
                return

    def _run(self, gpu: str, job: _Job):
        e = job.entry
        p = e.profile
        while job.k < p.n_layers:
            lt = e.land_t
            if lt is not None:
                if lt[job.k] is None:
                    return            # wait for the next trigger batch
                tk = lt[job.k]
            else:
                tk = job.c            # keep-warm resident: no gate
            job.c = max(job.c, tk) + p.layer_ms[job.k]
            job.k += 1
        job.finish_t = job.c
        self.sim.call_at(job.c,
                         lambda sim, j=job, g=gpu: self._retire(g, j))

    def _retire(self, gpu: str, job: _Job):
        if self._serving.get(gpu) is not job or job.failed:
            return                    # failed over while in flight
        self._serving[gpu] = None
        e = job.entry
        e.queue_depth = max(0, e.queue_depth - 1)
        self.ttft.append((job.t_arrive, job.finish_t - job.t_arrive,
                          job.cold))
        if job.on_first_token is not None:
            job.on_first_token(self.sim, job.finish_t)
        self._kick(gpu)
        self._advance(gpu)

    def _fail_jobs(self, e: _Entry, now: float):
        srv = self._serving.get(e.gpu)
        if srv is not None and srv.entry is e:
            srv.failed = True
            self._serving[e.gpu] = None
            e.queue_depth = max(0, e.queue_depth - 1)
            self.stats["failed_requests"] += 1
        q = self._q.get(e.gpu)
        if q:
            keep = deque()
            for job in q:
                if job.entry is e:
                    job.failed = True
                    e.queue_depth = max(0, e.queue_depth - 1)
                    self.stats["failed_requests"] += 1
                else:
                    keep.append(job)
            self._q[e.gpu] = keep
        self._advance(e.gpu)

    # ---------------------------------------------------- swap policy -----
    def _score(self, e: _Entry) -> float:
        """Evictability among idle models: higher = better victim.
        Slack is how much idle time the swap can hide in — the EWMA
        inter-arrival (popularity) minus the reload cost the next
        request would re-pay."""
        return e.iat_ms - e.profile.reload_ms

    def _free_mb(self, gpu: str, need: float, now: float, *,
                 incoming: _Entry) -> float:
        """Swap models out until ``need`` MB is freed (best effort —
        returns the MB actually freed).  Victims come from
        ``Migrator.pick_victims`` over the GPU's settled DEVICE-state
        checkpoint items: RELOADING and PARTIAL items are refused by the
        machinery itself, the in-service model is always excluded, and
        the SLO policy additionally hard-pins any model with queued
        requests (evicting it guarantees an immediate cold re-fault)."""
        srv = self._serving.get(gpu)
        serving = srv.entry if srv is not None else None
        cands = []
        for en in self.entries.values():
            if en.gpu != gpu or en is incoming or en is serving:
                continue
            if en.state != DEVICE or en.item is None or not en.item.held:
                continue
            if self.policy == "slo":
                if en.queue_depth > 0:
                    continue
                en.item.consumer_pos = self._score(en)
            cands.append(en.item)
        freed = 0.0
        for v in self.migrator.pick_victims(cands, need):
            en = self.entries[v.data_id[len("ckpt:"):]]
            self._evict(en, now)
            freed += self.tube._mb_needed(en.profile.total_mb)
        return freed

    def _evict(self, e: _Entry, now: float):
        """DEVICE -> SPILLING -> HOST with no g2h copy: weights are
        read-only, so the pinned-host slot (or the registry master) is
        already the authoritative swap-out target — the state machine's
        completion step runs immediately."""
        item = e.item
        e.mb_ms += e.profile.total_mb * (now - e.resident_since)
        self.stats["evictions"] += 1
        if e.queue_depth > 0:
            self.stats["evicted_with_queue"] += 1
        item.set_state(SPILLING)
        item.host = host_of(e.gpu) if e.host_slot else self._registry_for(e)
        self.tube._spill_complete(item, e.gpu, now)
        e.state = HOST if e.host_slot else EVICTED

    # ------------------------------------------------- host-cache policy --
    def _admit_host(self, e: _Entry, now: float):
        """Claim a pinned-ring slot for a model that just swapped in,
        demoting idle HOST-state residents (LRU) to registry-backed when
        the ring is full.  Going slotless is allowed: evictions then
        fall back to the cold object path."""
        key = host_of(e.gpu)
        mb = e.profile.total_mb
        if self.host_ring.try_reserve(mb, key=key):
            e.host_slot = True
            return
        idle = sorted((en for en in self.entries.values()
                       if en.host_slot and en.state == HOST
                       and host_of(en.gpu) == key),
                      key=lambda en: en.last_access)
        for v in idle:
            self._demote(v, now)
            if self.host_ring.try_reserve(mb, key=key):
                e.host_slot = True
                return

    def _demote(self, v: _Entry, now: float):
        """HOST -> EVICTED: release the pinned slot; the item's backing
        copy becomes the registry master (reloads go cold-path)."""
        self.host_ring.release(v.profile.total_mb, self.sim,
                               key=host_of(v.gpu))
        v.host_slot = False
        self.stats["host_demotions"] += 1
        if v.state == HOST and v.item is not None:
            reg = self._registry_for(v)
            v.item.host = reg
            rec = self.tube.index.global_table.get(v.data_id)
            if rec is not None:
                self.tube.index.relocate(rec, reg, "host")
            v.state = EVICTED

    # ------------------------------------------------------------ faults --
    def _on_crash(self, node: str, t: float):
        """Crash listener (fires before the tube invalidates the node's
        stores): fail queued work and mark the node's models dead.
        In-flight reloads are poisoned by the machinery itself — their
        ``on_error`` lands in ``_load_failed``."""
        for e in self.entries.values():
            if node_of(e.gpu) != node:
                continue
            e.dead = True
            e.load_pending = False
            if e.state == DEVICE:
                e.mb_ms += e.profile.total_mb * (t - e.resident_since)
                e.state = EVICTED
            self._fail_jobs(e, t)

    # ----------------------------------------------------------- metrics --
    def gpu_mb_s(self, now: float) -> float:
        """Integral of DEVICE-resident checkpoint MB over time, in
        MB*seconds of simulated time — the keep-warm cost metric."""
        total = 0.0
        for e in self.entries.values():
            if e.state == DEVICE:
                e.mb_ms += e.profile.total_mb * (now - e.resident_since)
                e.resident_since = now
            total += e.mb_ms
        return total / 1000.0
