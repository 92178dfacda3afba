"""Real PyTorch data plane: execute TransferPlans by moving actual bytes.

The simulator decides *when* a transfer completes; this backend makes
the same plan move *real* bytes on the card.  Objects live as 2 MB slab
rows inside a real ``ElasticPool``-backed slab store per endpoint
(``track_slabs`` mode hands out concrete row indices into one uint8
``(n, SLAB_BYTES)`` tensor per endpoint): device stores in device
memory, host stores and the staging rings in page-locked host memory
(``pin_memory=True``, i.e. ``cudaHostAlloc``).  Every device-side read
and write — ``put`` included — goes through the hand-written CUDA
gather/scatter kernels (``kernels/chunked_copy``); host-side row copies
are plain tensor copies.

Every ``gpuN`` endpoint of the simulated topology maps to the backend's
one device (``cuda:0`` by default), as the JAX reference maps them onto
its single jax device: a g2g hop is therefore a copy within one device.
``TorchBackend(device="cpu")`` runs the same walks on CPU tensors through
the kernels' plain versions — that is how the tests hold it against the
reference.

The two staging modes differ observably, exactly like the simulator:

``cut_through``
    batch-granular handoff — each trigger batch walks ALL hops before
    the next batch enters, intermediate hosts hold only ring windows
    (``peak_staging_mb`` ≤ one window), and the hop trace interleaves
    ``b0:g2h b0:net b0:h2g b1:g2h ...``.

``store_forward``
    full materialization per hop — hop k+1 starts only after hop k has
    landed the ENTIRE object in an intermediate host store
    (``peak_staging_mb`` == the object size), trace ``h0:b0 h0:b1 ...
    h1:b0 ...``.

Ordering.  Kernels and copies all go on the device's current stream, so
device-side steps are ordered among themselves.  The host waits (a CUDA
event) wherever it touches bytes a copy is still moving: after every
device-to-host copy before the host reads the window, and at every
trigger-batch boundary, before the next batch rewrites a ring window
that an upload reads.  A batch uploads in place when its host rows are
one run, and a window is written only when a batch breaks a run or the
hop before it staged the batch.  In-place uploads are not waited for
one by one: a stretch of them is one ``host_to_pool`` pipeline, which
queues batch k+1's upload and scatter before it waits on batch k and
returns (or raises) only once its queue has drained.  That is safe
because nothing writes a store's rows while a walk reads them, so the
rows hold still until the pipeline's last wait, and because the
uploads' device temporaries are freed in stream order on the one
stream, so none is reused before the scatter that reads it has run.
Progress events carry REAL landed bytes: one event per trigger batch
whose bytes are resident at the plan destination.  Execution is
synchronous wall-clock work at submit time and never touches the
LinkSim event stream.
"""
from __future__ import annotations

import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.elastic_pool import BLOCK_MB, SLAB_BYTES, ElasticPool
from repro_torch.errors import PoolCapacityError
from repro_torch.core.linksim import BATCH_CHUNKS
from repro_torch.core.transfer import TransferPlan, host_of, is_device
from repro_torch.kernels.chunked_copy.ops import gather, scatter
from repro_torch.kernels.chunked_copy.pipeline import (
    host_to_pool,
    pool_to_host,
    record,
    wait,
)
from repro_torch.spans import span

MB = 2 ** 20
#: synth_payload's parallel draw: threads, and the 64-bit words a thread
#: draws at a time (32 MiB; no thread is given fewer)
_SYNTH_THREADS = min(8, os.cpu_count() or 1)
_SYNTH_SLICE_WORDS = 1 << 22


def synth_payload(data_id: str, nbytes: int) -> np.ndarray:
    """Deterministic payload bytes for an object id — the oracle both
    the backend and the conformance tests regenerate independently.

    The bytes are ``default_rng(crc32(id)).integers(0, 256, nbytes,
    uint8)``, as the JAX package draws them.  For a full-range uint8
    draw numpy takes one 32-bit output per four bytes, low byte first,
    and PCG64 splits each 64-bit output low half first, so the same
    bytes are the generator's raw 64-bit stream read as little-endian
    bytes.  That stream is drawn in parallel: slice k is a fresh
    generator advanced to the slice's first word (a checkpoint is
    gigabytes; one thread draws well under 1 GB/s)."""
    seed = zlib.crc32(data_id.encode())
    words = -(-nbytes // 8)
    out = np.empty(words * 8, np.uint8)
    w = out.view("<u8")
    parts = min(_SYNTH_THREADS, max(1, words // _SYNTH_SLICE_WORDS))
    step = -(-words // parts)

    def fill(k: int):
        lo, hi = k * step, min(words, (k + 1) * step)
        gen = np.random.PCG64(seed)
        gen.advance(lo)
        for s in range(lo, hi, _SYNTH_SLICE_WORDS):   # bounded temporaries
            e = min(hi, s + _SYNTH_SLICE_WORDS)
            w[s:e] = gen.random_raw(e - s)

    if parts == 1:
        fill(0)
    else:
        with ThreadPoolExecutor(parts) as ex:
            list(ex.map(fill, range(parts)))
    return out[:nbytes]


def nbytes_of(size_mb: float) -> int:
    return max(1, int(round(size_mb * MB)))


@dataclass
class _Obj:
    data_id: str
    nbytes: int
    buf_id: int
    rows: tuple            # slab row indices, payload order


def _run(rows) -> slice | None:
    """``rows`` as a slice when they are one ascending run — fresh
    allocations hand out sequential slab rows, so this is the common
    case and a view replaces an indexed copy."""
    r0, n = rows[0], len(rows)
    if all(rows[i] == r0 + i for i in range(1, n)):
        return slice(r0, r0 + n)
    return None


def _index(rows) -> torch.Tensor:
    return torch.as_tensor(list(rows), dtype=torch.long)


def _host_get(pool: torch.Tensor, rows) -> torch.Tensor:
    """``pool[rows]`` of a host store: a view for a run, else a copy."""
    run = _run(rows)
    return pool[run] if run is not None else pool[_index(rows)]


def _host_put(pool: torch.Tensor, rows, src: torch.Tensor):
    """``pool[rows] = src`` for a host store."""
    run = _run(rows)
    if run is not None:
        pool[run].copy_(src)
    else:
        pool[_index(rows)] = src


def _chunk_rows(payload: np.ndarray, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Flat bytes as (rows, SLAB_BYTES), the tail zero-padded: written
    into ``out`` when given, else a view when the bytes fill whole rows,
    else one copy."""
    rows = -(-payload.nbytes // SLAB_BYTES)
    src = torch.from_numpy(payload)
    if out is None:
        if payload.nbytes == rows * SLAB_BYTES:
            return src.view(rows, SLAB_BYTES)
        out = torch.empty((rows, SLAB_BYTES), dtype=torch.uint8)
    flat = out.view(-1)
    flat[:payload.nbytes].copy_(src)
    flat[payload.nbytes:].zero_()
    return out


class SlabStore:
    """One endpoint's slab store: a uint8 ``(n, SLAB_BYTES)`` tensor
    whose rows are handed out by a ``track_slabs`` ElasticPool.

    ``device=True`` marks a device endpoint (its rows move through the
    gather/scatter kernels); ``place`` is where the tensor lives (the
    backend's device for device endpoints, the CPU for hosts) and
    ``pin`` page-locks a host store."""

    #: initial physical pool: stores start small and double on demand up
    #: to their capacity instead of paying the worst case up front
    START_MB = 64.0

    def __init__(self, name: str, capacity_mb: float, *,
                 device: bool = True, place="cpu", pin: bool = False):
        self.name = name
        self.device = device
        self.place = torch.device(place)
        self.pin = pin
        self.capacity_mb = capacity_mb
        start = min(self.START_MB, capacity_mb)
        self.pool = ElasticPool(name, capacity_mb=start,
                                elastic=False, track_slabs=True)
        self.slabs = self._zeros(self.pool.n_slabs)
        self.objects: dict[str, _Obj] = {}
        #: wall seconds spent growing the slab tensor (page-locked host
        #: stores pay real cudaHostAlloc time here)
        self.grow_s = 0.0

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n, SLAB_BYTES), dtype=torch.uint8,
                           device=self.place, pin_memory=self.pin)

    def __contains__(self, data_id: str) -> bool:
        return data_id in self.objects

    def _grow_for(self, size_mb: float) -> bool:
        """Double the physical pool (at least enough for size_mb, at
        most capacity_mb) and replace the slab tensor with a larger copy.
        False when already at capacity — the caller's PoolCapacityError
        stands.  Callers re-read ``slabs`` after any ``alloc``."""
        need = self.pool.used_mb + size_mb + BLOCK_MB
        new_cap = min(max(2 * self.pool.capacity_mb, need),
                      self.capacity_mb)
        if new_cap <= self.pool.capacity_mb:
            return False
        t0 = time.perf_counter()
        self.pool.grow(new_cap)
        if self.pin:
            # no copy in flight may still read or fill the old pages
            torch.cuda.synchronize()
        grown = self._zeros(self.pool.n_slabs)
        # device stores: stream-ordered after every queued kernel
        grown[:self.slabs.shape[0]].copy_(self.slabs)
        self.slabs = grown
        self.grow_s += time.perf_counter() - t0
        return True

    def alloc(self, data_id: str, nbytes: int) -> _Obj:
        """Allocate rows for an incoming object (no bytes moved yet)."""
        assert data_id not in self.objects, (self.name, data_id)
        size_mb = nbytes / MB
        while True:
            try:
                buf_id, _ = self.pool.alloc(data_id, size_mb, 0.0)
                break
            except PoolCapacityError:
                if not self._grow_for(size_mb):
                    raise
        obj = _Obj(data_id, nbytes, buf_id, self.pool.bufs[buf_id].slabs)
        self.objects[data_id] = obj
        return obj

    def put(self, data_id: str, payload: np.ndarray) -> _Obj:
        """Materialize host bytes into the store (the write path)."""
        payload = np.ascontiguousarray(payload, dtype=np.uint8).ravel()
        obj = self.alloc(data_id, payload.nbytes)
        run = _run(obj.rows)
        if not self.device and run is not None:
            # one run of host rows: the bytes land in place, no staging
            _chunk_rows(payload, self.slabs[run])
            return obj
        chunks = _chunk_rows(payload)
        if self.device:
            scatter(self.slabs, chunks.to(self.place), obj.rows)
            wait(record(self.slabs))
        else:
            _host_put(self.slabs, obj.rows, chunks)
        return obj

    def read(self, data_id: str) -> np.ndarray:
        """Materialize an object back to host bytes (verification path,
        not the data plane)."""
        obj = self.objects[data_id]
        if self.device:
            out = torch.empty((len(obj.rows), SLAB_BYTES), dtype=torch.uint8,
                              pin_memory=self.place.type == "cuda")
            pool_to_host(self.slabs, obj.rows, out, batch=len(obj.rows))
        else:
            out = _host_get(self.slabs, obj.rows)
        return out.numpy().reshape(-1)[:obj.nbytes].copy()

    def drop(self, data_id: str):
        obj = self.objects.pop(data_id, None)
        if obj is not None:
            self.pool.free(obj.buf_id, 0.0)

    @property
    def used_mb(self) -> float:
        return self.pool.used_mb


def _side(at, rows):
    """One side of a row copy as (tensor, rows, on the device): a
    store's rows, or all of a ring window (a host tensor)."""
    if isinstance(at, SlabStore):
        return at.slabs, rows, at.device
    return at, range(len(at)), False


class HostRing:
    """Preallocated page-locked staging ring mirroring
    CircularPinnedBuffer: ``size_mb`` of warm chunk slots per staging
    host.  A staged transfer reserves ONE trigger-batch window
    (``min(transfer, batch_mb)``) for its lifetime and lands every batch
    in that same window — bounded occupancy is the point.  Pinning the
    ring once is the paper's §6.1 pre-pinned circular buffer, against a
    ``cudaHostAlloc`` per transfer.

    The window is reserved for every staged hop, but it is written only
    when a batch breaks a run or the hop before it staged the batch: a
    batch whose host rows are one run uploads from the store in place
    (its rows hold still until ``host_to_pool`` returns), so the window
    of a plan whose one hop is an upload from such rows stays
    unwritten."""

    def __init__(self, host: str, size_mb: float = 40.0,
                 chunk_mb: float = BLOCK_MB, *, pin: bool = False):
        self.host = host
        self.size_mb = size_mb
        self.slots = max(1, int(size_mb // chunk_mb))
        self.buf = torch.zeros((self.slots, SLAB_BYTES), dtype=torch.uint8,
                               pin_memory=pin)
        self.in_flight_mb = 0.0
        self.peak_mb = 0.0
        self.stalls = 0
        self._used = [False] * self.slots

    def acquire(self, win_chunks: int) -> tuple[int, int]:
        """Reserve a contiguous run of warm slots (contiguity keeps the
        window a VIEW of the ring, so batches really land in the
        preallocated pages).  Returns (start, n)."""
        win_chunks = min(win_chunks, self.slots)
        for start in range(self.slots - win_chunks + 1):
            if not any(self._used[start:start + win_chunks]):
                for i in range(start, start + win_chunks):
                    self._used[i] = True
                self.in_flight_mb += win_chunks * BLOCK_MB
                self.peak_mb = max(self.peak_mb, self.in_flight_mb)
                return start, win_chunks
        # a real executor would queue here; the synchronous hop walk
        # holds at most one window per ring, so a miss marks a
        # mis-sized ring rather than a deadlock
        self.stalls += 1
        self.in_flight_mb += win_chunks * BLOCK_MB
        self.peak_mb = max(self.peak_mb, self.in_flight_mb)
        return 0, win_chunks

    def release(self, win: tuple[int, int]):
        start, n = win
        for i in range(start, min(start + n, self.slots)):
            self._used[i] = False
        self.in_flight_mb -= n * BLOCK_MB

    def window(self, win: tuple[int, int], n: int) -> torch.Tensor:
        """A view of the first n chunk rows of a reserved window (every
        batch reuses the same warm slots — bounded occupancy)."""
        start, cap = win
        assert n <= cap, (n, cap)
        return self.buf[start:start + n]


@dataclass
class ExecReport:
    """What one real plan execution did — the observable record the
    conformance suite and the smoke run read."""
    kind: str
    func: str
    src: str
    dst: str
    size_mb: float
    staging: str
    n_chunks: int
    n_batches: int
    stripes: int
    wall_ms: float = 0.0
    peak_staging_mb: float = 0.0
    #: (landed_mb_at_destination, wall_ms_since_start) per trigger batch
    events: list = field(default_factory=list)
    #: per-batch per-hop steps, in execution order
    hop_trace: list = field(default_factory=list)
    #: trigger batches whose upload read the source host store's rows in
    #: place, with no copy into a ring window
    direct_batches: int = 0
    #: direct batches whose upload was queued while an earlier batch of
    #: the same walk was still unconfirmed
    overlapped_batches: int = 0


class TorchBackend:
    """Executes TransferPlans with real bytes.  One instance owns every
    endpoint's slab store and every host's staging ring; stores are
    created lazily so a fleet topology only pays for endpoints that
    actually move data.  Capacity here is physical (bytes must land
    somewhere) — admission/spill POLICY stays with the simulator's own
    ElasticPools.

    ``device`` defaults to ``cuda`` (index 0) and raises RuntimeError
    when CUDA is not available; ``device="cpu"`` runs every walk on CPU
    tensors through the kernels' plain versions."""

    def __init__(self, *, store_mb: float = 256.0, host_mb: float = 1024.0,
                 ring_mb: float = 40.0, batch_chunks: int = BATCH_CHUNKS,
                 device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: CUDA is not available (pass "
                    "device='cpu' to run the plain versions on the CPU)")
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        elif dev.type != "cpu":
            raise ValueError(f"TorchBackend: unsupported device {dev}")
        self.device = dev
        self.pin = dev.type == "cuda"
        self.store_mb = store_mb
        self.host_mb = host_mb
        self.ring_mb = ring_mb
        self.batch_chunks = batch_chunks
        self.stores: dict[str, SlabStore] = {}
        self.rings: dict[str, HostRing] = {}
        self.reports: list[ExecReport] = []

    # ------------------------------------------------------------ stores --
    def store_for(self, endpoint: str) -> SlabStore:
        st = self.stores.get(endpoint)
        if st is None:
            dev = is_device(endpoint)
            st = SlabStore(endpoint,
                           self.store_mb if dev else self.host_mb,
                           device=dev, place=self.device if dev else "cpu",
                           pin=self.pin and not dev)
            self.stores[endpoint] = st
        return st

    def ring_for(self, host: str) -> HostRing:
        r = self.rings.get(host)
        if r is None:
            r = HostRing(host, self.ring_mb, pin=self.pin)
            self.rings[host] = r
        return r

    def reserve(self, endpoint: str, size_mb: float) -> float:
        """Grow an endpoint's store now to hold at least ``size_mb`` (at
        most its capacity), so that no later transfer pays the growth
        inside its wall time.  Returns the seconds the growth took."""
        st = self.store_for(endpoint)
        before = st.grow_s
        if st.pool.capacity_mb < size_mb:
            st._grow_for(size_mb - st.pool.used_mb - BLOCK_MB)
        return st.grow_s - before

    def put_object(self, data_id: str, endpoint: str,
                   payload: np.ndarray | None = None,
                   size_mb: float | None = None):
        """Register real bytes at an endpoint.  Without an explicit
        payload the deterministic synthetic one is materialized (the
        facade stores declared-size objects, not user tensors)."""
        if payload is None:
            payload = synth_payload(data_id, nbytes_of(size_mb))
        st = self.store_for(endpoint)
        if data_id in st:
            st.drop(data_id)
        return st.put(data_id, payload)

    def read_object(self, data_id: str, endpoint: str) -> np.ndarray:
        return self.store_for(endpoint).read(data_id)

    def drop_object(self, data_id: str, endpoint: str | None = None):
        stores = ([self.stores[endpoint]] if endpoint in self.stores
                  else self.stores.values()) if endpoint else \
            self.stores.values()
        for st in list(stores):
            st.drop(data_id)

    def where(self, data_id: str) -> list[str]:
        return sorted(n for n, st in self.stores.items() if data_id in st)

    # ----------------------------------------------------------- execute --
    def execute(self, plan: TransferPlan, *, on_progress=None
                ) -> ExecReport | None:
        """Move a plan's real bytes src -> dst, synchronously.

        Returns the ExecReport (also appended to ``self.reports``), or
        None for plans with no object identity / no hops — those move
        nothing real.  The source object is synthesized on demand so
        every identified plan can execute."""
        if not getattr(plan, "data_id", "") or plan.local:
            return None
        src_st = self.store_for(plan.src)
        if plan.data_id not in src_st:
            self.put_object(plan.data_id, plan.src, size_mb=plan.size_mb)
        obj = src_st.objects[plan.data_id]
        n_chunks = len(obj.rows)
        batch = self.batch_chunks
        n_batches = -(-n_chunks // batch)
        stripes = 2 if any(h.multipath for h in plan.hops) \
            and n_chunks > 1 else 1
        rep = ExecReport(plan.kind, plan.func, plan.src, plan.dst,
                         plan.size_mb, plan.staging, n_chunks, n_batches,
                         stripes)
        t0 = time.perf_counter()

        def landed(nrows: int, tag: str):
            mb = min(nrows * BLOCK_MB, plan.size_mb)
            rep.events.append(
                (mb, (time.perf_counter() - t0) * 1e3))
            if on_progress is not None:
                on_progress(mb)
            rep.hop_trace.append(tag)

        with span("ft:backend.execute"):
            if plan.staging == "store_forward" and len(plan.hops) > 1:
                self._store_forward(plan, obj, rep, landed)
            else:
                self._cut_through(plan, obj, rep, landed)
        rep.wall_ms = (time.perf_counter() - t0) * 1e3
        self.reports.append(rep)
        return rep

    # one trigger batch's row range
    def _batches(self, n: int):
        for s in range(0, n, self.batch_chunks):
            yield s, min(s + self.batch_chunks, n)

    @staticmethod
    def _fresh_rows(st: SlabStore, data_id: str, nbytes: int) -> tuple:
        """Rows for an object landing at ``st`` (a fresh copy; replaces a
        stale same-id copy so re-fetch after update stays coherent)."""
        if data_id in st:
            st.drop(data_id)
        return st.alloc(data_id, nbytes).rows

    # ---------------------------------------------------------- copy step -
    def _copy(self, src, src_rows, dst, dst_rows, *, batch: int = 0,
              on_batch=None):
        """Move one batch of rows, ``src_rows`` of ``src`` to ``dst_rows``
        of ``dst``.  A side is a :class:`SlabStore` with its rows, or a
        ring window (a host tensor) with rows ``None``: all of the
        window, which is one run.  Where the sides live, and whether the
        host rows are one run, choose the primitive:

        * device -> device: ``gather``, then ``scatter`` (the caller puts
          both row lists in stripe order);
        * device -> host: ``pool_to_host`` straight into the host rows
          when they are one run, else into one page-locked temporary
          that is then put into them;
        * host -> device: ``host_to_pool`` from the host rows in place
          when they are one run, else from a copy of them; ``batch``
          rows a pipeline batch (all of them by default) and
          ``on_batch`` its callback;
        * host -> host: a copy, under ``ft:backend.stage`` when it fills
          a ring window.

        Copies between the host and the device have landed when it
        returns; a device-to-device copy is queued on the stream."""
        (sp, sr, s_dev), (dp, dr, d_dev) = (_side(src, src_rows),
                                            _side(dst, dst_rows))
        if s_dev and d_dev:
            scatter(dp, gather(sp, sr), dr)
        elif s_dev:
            run = _run(dr)
            out = dp[run] if run is not None else torch.empty(
                (len(dr), SLAB_BYTES), dtype=torch.uint8, pin_memory=self.pin)
            pool_to_host(sp, sr, out, batch=len(dr))
            if run is None:
                _host_put(dp, dr, out)
        elif d_dev:
            host_to_pool(_host_get(sp, sr), dp, dr, batch=batch or len(dr),
                         on_batch=on_batch)
        else:
            with nullcontext() if isinstance(dst, SlabStore) else \
                    span("ft:backend.stage"):
                _host_put(dp, dr, _host_get(sp, sr))

    # --------------------------------------------------- cut-through walk -
    def _cut_through(self, plan: TransferPlan, obj: _Obj, rep: ExecReport,
                     landed):
        """Batch-granular handoff: each trigger batch walks the whole
        hop chain before the next enters; intermediate hosts hold only
        one ring window.

        A batch uploads in place when its host rows are one run, and a
        window is written only when a batch breaks a run or the hop
        before it staged the batch.  So a plan whose one hop is an h2g
        uploads each batch whose rows are one run straight from the
        source store (``ExecReport.direct_batches``), and walks each
        stretch of such batches as one ``host_to_pool`` pipeline
        (:meth:`_upload_in_place`): batch k+1's upload and scatter are
        queued before the host waits on batch k
        (``ExecReport.overlapped_batches``), and batch k is marked
        landed once that wait returns.  The queue is safe because a
        store's rows hold still until the pipeline's last wait (nothing
        writes a store's rows while a walk reads them), and the uploads'
        device temporaries are freed in stream order on the one stream.
        A batch that breaks a run is staged through the source host's
        window (``ft:backend.stage``) and waited for alone; it starts
        after the stretch before it has drained, since ``host_to_pool``
        returns (or raises) only with nothing queued.  Every other hop
        lands the batch in the window of the host it ends on, when that
        host has one, and in the destination store's rows when it ends
        at the plan's destination.  The windows are reserved either way,
        so the report's staging, hops and events do not depend on which
        batches were staged or queued."""
        src_st = self.store_for(plan.src)
        dst_st = self.store_for(plan.dst)
        dst_rows = self._fresh_rows(dst_st, plan.data_id, obj.nbytes)
        hops = plan.hops
        # the host of each staged hop: an upload's source, else its end
        staged = [h.src if h.kind == "h2g" else h.dst
                  for h in hops if h.staged]
        # one trigger-batch window per staging host, held for the whole
        # transfer — CircularPinnedBuffer's window_mb reservation
        win_chunks = min(self.batch_chunks, len(obj.rows))
        wins = {hk: self.ring_for(hk).acquire(win_chunks)
                for hk in dict.fromkeys(staged)}
        rep.peak_staging_mb = max(
            (self.rings[hk].in_flight_mb for hk in wins), default=0.0)
        batches = list(self._batches(len(obj.rows)))
        upload = [h.kind for h in hops] == ["h2g"]
        try:
            bi = 0
            while bi < len(batches):
                m = self._in_place_stretch(obj.rows, batches, bi) \
                    if upload else 0
                if m:
                    self._upload_in_place(src_st, dst_st, obj.rows, dst_rows,
                                          batches, bi, m, rep, landed)
                    bi += m
                    continue
                s, e = batches[bi]
                rows, drows = obj.rows[s:e], dst_rows[s:e]
                at = (src_st, rows)     # where the batch sits now
                for h in hops:
                    if h.kind == "g2g":
                        # device->device within the one card, striped
                        # across the multipath set chunk-by-chunk
                        # (round-robin — same bytes, observable stripe
                        # interleave)
                        order = self._stripe_order(e - s, rep.stripes)
                        self._copy(src_st, np.asarray(rows, np.int32)[order],
                                   dst_st, np.asarray(drows, np.int32)[order])
                    else:
                        # the window this hop lands the batch in: the
                        # one at its end, or, for an upload of a batch
                        # still in the source rows, the source host's
                        hk = h.src if h.kind == "h2g" and at[0] is src_st \
                            else h.dst
                        if hk in wins:
                            win = self.rings[hk].window(wins[hk], e - s)
                            self._copy(*at, win, None)
                            at = (win, None)
                        if h.dst == plan.dst:
                            self._copy(*at, dst_st, drows)
                    rep.hop_trace.append(f"b{bi}:{h.kind}")
                # boundary sync: the batch is REALLY at the destination
                if dst_st.device:
                    wait(record(dst_st.slabs))
                landed(e, f"b{bi}:landed")
                bi += 1
        finally:
            for hk, slots in wins.items():
                self.rings[hk].release(slots)

    @staticmethod
    def _in_place_stretch(rows, batches, b0: int) -> int:
        """How many batches from ``b0`` on have their rows in one run of
        the source store, and so upload in place as one pipeline; 0 when
        batch ``b0``'s own rows are not one run."""
        s0, e0 = batches[b0]
        end = s0 + 1                    # rows[s0:end] are one run
        while end < len(rows) and rows[end] == rows[end - 1] + 1:
            end += 1
        m = 0
        while b0 + m < len(batches) and batches[b0 + m][1] <= end:
            m += 1
        return m

    def _upload_in_place(self, src_st, dst_st, rows, dst_rows, batches,
                         b0: int, m: int, rep: ExecReport, landed):
        """Upload batches ``b0 .. b0 + m - 1``, one run of host rows,
        straight from the store as one ``host_to_pool`` pipeline, and
        mark each landed when its wait returns: its ``h2g`` tag, then
        its ``landed`` event, as the per-batch walk does.  The event
        after a batch's scatter already means its bytes are on the card,
        so no second wait."""
        s0, e0 = batches[b0][0], batches[b0 + m - 1][1]
        k = iter(range(b0, b0 + m))

        def on_batch(nrows: int):
            bi = next(k)
            rep.hop_trace.append(f"b{bi}:h2g")
            landed(s0 + nrows, f"b{bi}:landed")

        rep.direct_batches += m
        rep.overlapped_batches += m - 1
        self._copy(src_st, rows[s0:e0], dst_st, dst_rows[s0:e0],
                   batch=batches[b0][1] - batches[b0][0], on_batch=on_batch)

    def _stripe_order(self, n: int, stripes: int) -> np.ndarray:
        if stripes <= 1:
            return np.arange(n)
        # round-robin chunk assignment across the stripe set, then
        # stripe-major order — the interleave a striped submission lands
        return np.argsort(np.arange(n) % stripes, kind="stable")

    # ------------------------------------------------- store-forward walk -
    def _store_forward(self, plan: TransferPlan, obj: _Obj,
                       rep: ExecReport, landed):
        """Full materialization per hop: hop k lands the WHOLE object at
        an intermediate host store before hop k+1 starts."""
        n = len(obj.rows)
        cur_ep, cur_rows = plan.src, obj.rows
        inter: list[str] = []
        for hi, h in enumerate(plan.hops):
            final = hi + 1 == len(plan.hops)
            dst_ep = plan.dst if final else \
                (h.dst if not is_device(h.dst) else host_of(h.dst))
            src_st = self.store_for(cur_ep)
            dst_st = self.store_for(dst_ep)
            nxt_rows = self._fresh_rows(dst_st, plan.data_id, obj.nbytes)
            if not final:
                inter.append(dst_ep)
            for bi, (s, e) in enumerate(self._batches(n)):
                self._copy(src_st, cur_rows[s:e], dst_st, nxt_rows[s:e])
                if final:
                    if dst_st.device:
                        wait(record(dst_st.slabs))
                    landed(e, f"h{hi}:b{bi}")
                else:
                    rep.hop_trace.append(f"h{hi}:b{bi}")
            if dst_st.device:
                wait(record(dst_st.slabs))
            # the whole object now sits at this hop's landing store
            rep.peak_staging_mb = max(
                rep.peak_staging_mb,
                sum(self.stores[ep].objects[plan.data_id].nbytes / MB
                    for ep in inter if plan.data_id in self.stores[ep]))
            cur_ep, cur_rows = dst_ep, nxt_rows
        for ep in inter:            # intermediates drain after landing
            if ep not in (plan.src, plan.dst):
                self.stores[ep].drop(plan.data_id)


def load_reference_state(backend: TorchBackend, snapshot: dict):
    """Carry slab stores across from another backend.

    ``snapshot`` is plain Python and numpy: ``{endpoint: {"slabs": (n,
    SLAB_BYTES) uint8 array, "objects": {data_id: (nbytes, rows)}}}``.
    Each endpoint's allocations are replayed in row order on a fresh
    store, so the copied allocator hands out the same rows; the bytes
    are then copied in (through the scatter kernel for device stores).
    Raises ValueError when a store is not empty or the allocator cannot
    reproduce a row map (a fragmented pool, for example)."""
    for ep, state in snapshot.items():
        slabs = np.asarray(state["slabs"], np.uint8)
        st = backend.store_for(ep)
        if st.objects:
            raise ValueError(f"{ep}: store already holds objects")
        objs = sorted(state["objects"].items(),
                      key=lambda kv: min(kv[1][1]))
        for data_id, (nbytes, rows) in objs:
            rows = tuple(int(r) for r in rows)
            got = st.alloc(data_id, nbytes).rows
            if tuple(got) != rows:
                st.drop(data_id)
                raise ValueError(f"{ep}: cannot reproduce rows of "
                                 f"{data_id!r}: allocator gave {got}, "
                                 f"snapshot has {rows}")
            chunk = torch.from_numpy(np.ascontiguousarray(slabs[list(rows)]))
            if st.device:
                scatter(st.slabs, chunk.to(st.place), rows)
            else:
                _host_put(st.slabs, rows, chunk)
        if st.device:
            wait(record(st.slabs))
