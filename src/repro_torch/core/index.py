"""Two-tier data index (paper §5.2): per-node local tables + one global
table.  Functions query their local table first (shared-memory pipe,
~2 us); a miss escalates to the global node (RPC, ~50 us).  Local tables
sync to the global table on every publish (write-through, async).

A record's ``location`` ("device" | "host" | "partial") follows the
store's location state machine and flips via `relocate` only when the
migration transfer *completes* — while a spill's g2h copy is in flight
the record still points at the device (the HBM copy is the valid one),
and a reload flips it back to the destination device only when the h2g
copy lands.  "partial" is the overlap contract's PARTIAL residency: a
consumer has partial-consumed the object and is computing on the landed
prefix while reader transfers are still draining — the bytes are live
mid-DMA, so the record stays published (and the item unspillable) until
the facade's deferred release drops it.  Local tables share the record
object with the global table, so a relocate is visible everywhere
without an extra RPC (write-through semantics).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

LOCAL_LOOKUP_MS = 0.002
GLOBAL_LOOKUP_MS = 0.05


@dataclass
class DataRecord:
    data_id: str
    node: str
    device: str          # "gpu3" | "host" | "chip4_7"
    size_mb: float
    location: str        # "device" | "host" | "partial"
    buf_id: int = -1


class DataIndex:
    def __init__(self):
        self.local: dict[str, dict[str, DataRecord]] = {}
        self.global_table: dict[str, DataRecord] = {}
        self._uid = itertools.count()
        self.local_hits = 0
        self.global_hits = 0

    def unique_id(self, prefix: str = "d") -> str:
        return f"{prefix}{next(self._uid)}"

    def publish(self, rec: DataRecord):
        self.local.setdefault(rec.node, {})[rec.data_id] = rec
        self.global_table[rec.data_id] = rec      # write-through sync

    def lookup(self, node: str, data_id: str) -> tuple[DataRecord, float]:
        """Returns (record, lookup_latency_ms)."""
        rec = self.local.get(node, {}).get(data_id)
        if rec is not None:
            self.local_hits += 1
            return rec, LOCAL_LOOKUP_MS
        rec = self.global_table.get(data_id)
        if rec is None:
            raise KeyError(data_id)
        self.global_hits += 1
        # cache into the local table for next time
        self.local.setdefault(node, {})[data_id] = rec
        return rec, GLOBAL_LOOKUP_MS

    def relocate(self, rec: DataRecord, device: str, location: str):
        """Flip a record's physical location on transfer completion
        (spill landed -> its host; reload landed -> the destination
        device) and publish it into the new node's local table."""
        rec.device = device
        rec.location = location
        rec.node = device.split(":")[0] if ":" in device else ""
        self.local.setdefault(rec.node, {})[rec.data_id] = rec

    def drop(self, data_id: str):
        self.global_table.pop(data_id, None)
        for tbl in self.local.values():
            tbl.pop(data_id, None)
