"""Auto-scaling GPU/HBM memory pool (paper §7.1).

Tracks, per producing function, the 99th-percentile request interval
(R_window), intermediate-data size (R_size) and concurrency / accumulation
degree (R_con); after each execution it reserves R_size * R_con for
R_window; blocks beyond  sum(active reservations) + min_pool  are released
back to the device.  Allocation from cached blocks is free; growing the
pool pays the device-allocation cost (linksim.alloc_ms).

Units MB; block granularity 2 MB (matches the transfer chunk size and
GMlake's unified chunk).  This same allocator manages the JAX-side tensor
arenas (serving/kvcache.py) — here it is driven by the link simulator for
the paper's benchmarks.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

from repro_torch.core.linksim import alloc_ms
# moved to the shared taxonomy (repro.errors); re-exported here for
# existing imports
from repro_torch.errors import PoolCapacityError  # noqa: F401

BLOCK_MB = 2.0
#: bytes per block/slab — the 2 MB transfer chunk IS the pool block, so
#: the jax backend's slab arrays are rows of exactly this many uint8s
SLAB_BYTES = int(BLOCK_MB * 2 ** 20)


def blocks_for(size_mb: float) -> int:
    return max(1, int(-(-size_mb // BLOCK_MB)))


def _p99(values) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


@dataclass
class _FuncStats:
    arrivals: deque = field(default_factory=lambda: deque(maxlen=64))
    sizes: deque = field(default_factory=lambda: deque(maxlen=64))
    live: int = 0                      # currently-live outputs (accumulation)
    live_hist: deque = field(default_factory=lambda: deque(maxlen=64))
    last_exec: float = -1.0

    @property
    def r_window(self) -> float:
        iv = [b - a for a, b in zip(self.arrivals, list(self.arrivals)[1:])]
        return _p99(iv)

    @property
    def r_size(self) -> float:
        return _p99(self.sizes)

    @property
    def r_con(self) -> float:
        return max(_p99(self.live_hist), 1.0)


@dataclass
class Buf:
    buf_id: int
    func: str
    size_mb: float
    blocks: int
    t_alloc: float
    last_access: float
    #: concrete slab rows backing this buffer (track_slabs pools only)
    slabs: tuple = ()


class ElasticPool:
    def __init__(self, device: str, *, capacity_mb: float = 1024.0,
                 min_pool_mb: float = 300.0, elastic: bool = True,
                 track_slabs: bool = False):
        self.device = device
        self.capacity_mb = capacity_mb
        self.min_pool_mb = min_pool_mb
        self.elastic = elastic
        self.cached_blocks = 0          # free blocks kept warm
        self.used_blocks = 0
        self.bufs: dict[int, Buf] = {}
        self.stats: dict[str, _FuncStats] = defaultdict(_FuncStats)
        self._next = 0
        self.timeline: list[tuple[float, float]] = []   # (t, pool MB)
        self.peak_used_mb = 0.0         # high-water mark of live blocks
        # slab-identity mode (the jax backend): the pool hands out
        # concrete row indices into a preallocated (n_slabs, SLAB_BYTES)
        # array, so a Buf names the physical 2 MB rows its bytes live in
        self.track_slabs = track_slabs
        self.n_slabs = int(capacity_mb // BLOCK_MB) if track_slabs else 0
        self._free_slabs: list[int] = list(range(self.n_slabs - 1, -1, -1))

    # ------------------------------------------------------------ sizes ---
    @property
    def pool_mb(self) -> float:
        return (self.used_blocks + self.cached_blocks) * BLOCK_MB

    @property
    def used_mb(self) -> float:
        return self.used_blocks * BLOCK_MB

    @property
    def headroom_mb(self) -> float:
        """Capacity left before alloc() would raise PoolCapacityError —
        what the store facade may hand to background prefetch reloads."""
        return self.capacity_mb - self.used_mb

    def _record(self, t):
        self.timeline.append((t, self.pool_mb))

    def grow(self, new_capacity_mb: float):
        """Raise capacity_mb (never shrinks).  In track_slabs mode the
        new physical rows join the free list BEHIND the existing ones,
        so warm slabs keep being reused first."""
        if new_capacity_mb <= self.capacity_mb:
            return
        self.capacity_mb = new_capacity_mb
        if self.track_slabs:
            new_n = int(new_capacity_mb // BLOCK_MB)
            self._free_slabs[:0] = range(new_n - 1, self.n_slabs - 1, -1)
            self.n_slabs = new_n

    # ------------------------------------------------------------- alloc --
    def fits(self, size_mb: float) -> bool:
        """Would an allocation of size_mb stay within capacity_mb?"""
        return (self.used_blocks + blocks_for(size_mb)) * BLOCK_MB \
            <= self.capacity_mb

    def alloc(self, func: str, size_mb: float, now: float, *,
              force: bool = False) -> tuple[int, float]:
        """Returns (buf_id, cost_ms).

        Raises PoolCapacityError when the blocks would exceed
        capacity_mb — callers must spill victims first and retry on
        completion.  force=True bypasses the check (single items larger
        than the whole store).
        """
        if not force and not self.fits(size_mb):
            raise PoolCapacityError(
                f"{self.device}: alloc {size_mb:.0f} MB would exceed "
                f"capacity {self.capacity_mb:.0f} MB "
                f"(used {self.used_mb:.0f} MB)",
                device=self.device, need_mb=size_mb, cause="capacity")
        st = self.stats[func]
        st.arrivals.append(now)
        st.sizes.append(size_mb)
        st.live += 1
        st.live_hist.append(st.live)
        st.last_exec = now

        blocks = blocks_for(size_mb)
        slabs: tuple = ()
        if self.track_slabs:
            # physical rows cannot be forced into existence: even a
            # force=True alloc needs real slabs to land bytes in
            if len(self._free_slabs) < blocks:
                raise PoolCapacityError(
                    f"{self.device}: no free slabs for {size_mb:.0f} MB "
                    f"({len(self._free_slabs)}/{self.n_slabs} free)",
                    device=self.device, need_mb=size_mb, cause="capacity")
            slabs = tuple(self._free_slabs.pop() for _ in range(blocks))
        cost = 0.0
        if self.cached_blocks >= blocks:
            self.cached_blocks -= blocks
        else:
            grow = blocks - self.cached_blocks
            self.cached_blocks = 0
            cost = alloc_ms(grow * BLOCK_MB)
        self.used_blocks += blocks
        if self.used_mb > self.peak_used_mb:
            self.peak_used_mb = self.used_mb
        self._next += 1
        self.bufs[self._next] = Buf(self._next, func, size_mb, blocks, now,
                                    now, slabs)
        self._record(now)
        return self._next, cost

    def free(self, buf_id: int, now: float):
        """Release a buffer back to the cache.  Idempotent: freeing an
        unknown / already-freed buf_id is a no-op (the spill-completion
        and consume paths may race on the same buffer)."""
        buf = self.bufs.pop(buf_id, None)
        if buf is None:
            return
        self.used_blocks -= buf.blocks
        self.cached_blocks += buf.blocks
        if buf.slabs:
            self._free_slabs.extend(reversed(buf.slabs))
        st = self.stats[buf.func]
        st.live = max(0, st.live - 1)
        if self.elastic:
            self.gc(now)
        self._record(now)

    # ------------------------------------------------------------- gc -----
    def target_cache_mb(self, now: float) -> float:
        """sum_f Data_size(f) * 1{now within f's reservation window}."""
        total = 0.0
        for f, st in self.stats.items():
            if st.last_exec < 0:
                continue
            if now - st.last_exec <= st.r_window:
                total += st.r_size * st.r_con
        return max(total, self.min_pool_mb)

    def gc(self, now: float):
        """Release cached blocks beyond the live reservations."""
        target_blocks = int(self.target_cache_mb(now) // BLOCK_MB)
        excess = self.cached_blocks - max(target_blocks - self.used_blocks, 0)
        if excess > 0:
            self.cached_blocks -= excess
        self._record(now)
