"""Circular pinned staging buffer (paper §6.1, Fig. 5b) — bounded.

Pinned host memory doubles-to-quadruples PCIe bandwidth (3 -> 12 GB/s) but
allocation costs ~0.7 ms/MB.  Three policies:

  none         — transfer unpinned (3 GB/s, no pin cost)
  per_transfer — pin a fresh region per transfer (12 GB/s, 0.7 ms/MB every
                 time) — what naive systems and short-lived functions do
  circular     — one fixed ring of pinned chunks shared by all functions,
                 reused batch after batch: the ring is pinned ONCE (the
                 first acquire charges the one-time ``size_mb`` pin cost;
                 construct with ``warmed=True`` to model a daemon that
                 pre-pinned it off the critical path), then free forever
                 (FaaSTube)

Occupancy accounting (circular only)
------------------------------------
``size_mb`` is a real bound: it is the ring's in-flight staging
occupancy, not a label.  Each staged transfer reserves a *window* of
ring space (one trigger batch — in steady cut-through flow the ring
drains as fast as it fills, so a transfer never holds more than one
batch of chunks in pinned memory) before its first chunk may move, and
releases it when the transfer completes.  When the ring is full, new
staged transfers queue behind the next release — the back-pressure the
TransferEngine's cut-through staging rides on.  A window larger than
the whole ring is admitted only on an empty ring (progress guarantee:
the transfer cycles through every slot).

The §7 isolation contract extends to the ring: a BACKGROUND (migration)
reservation may hold at most half the ring, and when space frees up
waiting FOREGROUND transfers are granted before any waiting background
one — otherwise a handful of slow residual-bandwidth spills would pin
every window and SLO-admitted fetches would queue behind them (a
staging-level priority inversion the per-link chunk priority cannot
see).

On cluster topologies every node's host pins its OWN ring, so occupancy
is tracked per staging host (the ``key`` parameter — the engine passes
the plan's staging-host name): node 7's staging pressure never
back-pressures node 3.  ``stalls`` counts ring waits across all hosts;
``peak_in_flight_mb`` is the busiest single ring's peak.

`none` and `per_transfer` transfers do not touch the shared ring, so
they are never occupancy-bounded.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

#: canonical traffic-class constants (this is the lowest-level module
#: that needs them; pcie_scheduler re-exports, linksim imports for its
#: stage defaults — no import cycles)
FOREGROUND = "fg"
BACKGROUND = "bg"


@dataclass
class CircularPinnedBuffer:
    size_mb: float = 64.0             # ring capacity PER staging host
    policy: str = "circular"          # none | per_transfer | circular
    warmed: bool = False              # True: daemon pre-pinned the ring
    peak_in_flight_mb: float = 0.0    # busiest single ring's peak
    stalls: int = 0                   # transfers that had to wait for room
    # per-host occupancy state (circular policy only)
    _in_flight: dict = field(default_factory=dict, repr=False)
    _bg_in_flight: dict = field(default_factory=dict, repr=False)
    _waiters: dict = field(default_factory=dict, repr=False)
    _bg_waiters: dict = field(default_factory=dict, repr=False)

    @property
    def in_flight_mb(self) -> float:
        """Aggregate staged bytes in flight across every host ring."""
        return sum(self._in_flight.values())

    # ------------------------------------------------------- pin policy ---
    def acquire(self, transfer_mb: float) -> tuple[float, bool]:
        """Returns (pin_cost_mb_to_charge, pinned_bandwidth_available)."""
        if self.policy == "none":
            return 0.0, False
        if self.policy == "per_transfer":
            return transfer_mb, True
        # circular: the first use pins the whole ring once, then free
        # forever (a pre-warmed ring never charges — the daemon paid at
        # startup, off any request's critical path)
        if not self.warmed:
            self.warmed = True
            return self.size_mb, True
        return 0.0, True

    # ------------------------------------------------------- occupancy ----
    def window_mb(self, transfer_mb: float, batch_mb: float) -> float:
        """Ring space one staged transfer occupies while in flight."""
        return min(transfer_mb, batch_mb)

    def try_reserve(self, mb: float, cls: str = FOREGROUND,
                    key: str = "host") -> bool:
        """Claim space on ``key``'s ring now, or False when it is full.
        An empty ring always admits a foreground window (a window wider
        than ``size_mb`` cycles through the slots instead of
        deadlocking); background is additionally capped at half the
        ring, so migration can never pin every staging slot."""
        if self.policy != "circular" or mb <= 0:
            return True
        have = self._in_flight.get(key, 0.0)
        bg_have = self._bg_in_flight.get(key, 0.0)
        if cls == BACKGROUND and bg_have > 0 \
                and bg_have + mb > 0.5 * self.size_mb + 1e-9:
            return False
        if have > 0 and have + mb > self.size_mb + 1e-9:
            return False
        self._in_flight[key] = have + mb
        if cls == BACKGROUND:
            self._bg_in_flight[key] = bg_have + mb
        if have + mb > self.peak_in_flight_mb:
            self.peak_in_flight_mb = have + mb
        return True

    def wait(self, mb: float, launch, cls: str = FOREGROUND,
             key: str = "host"):
        """Queue ``launch(t_grant)`` until `mb` of ``key``'s ring frees
        up — FIFO within a class, foreground before background."""
        self.stalls += 1
        qs = self._bg_waiters if cls == BACKGROUND else self._waiters
        qs.setdefault(key, deque()).append((mb, launch))

    def reserve_or_wait(self, mb: float, launch, cls: str = FOREGROUND,
                        key: str = "host") -> bool:
        """Reserve now (True) or park ``launch`` (False) — the entry
        point for NEW staged transfers.  Unlike raw `try_reserve`, a
        newcomer may not jump transfers already parked on ``key``'s
        ring: a foreground reservation queues behind existing foreground
        waiters (FIFO), and a background one behind ANY waiter — without
        this, a small-window (or background) transfer submitted while
        the ring is full would overtake a parked SLO-admitted fetch."""
        if self.policy == "circular" and mb > 0:
            fg_waiting = self._waiters.get(key)
            if fg_waiting or (cls == BACKGROUND
                              and self._bg_waiters.get(key)):
                self.wait(mb, launch, cls, key)
                return False
        if self.try_reserve(mb, cls, key):
            return True
        self.wait(mb, launch, cls, key)
        return False

    def release(self, mb: float, sim, cls: str = FOREGROUND,
                key: str = "host"):
        """Return a reservation; grant waiting transfers (fg first)."""
        if self.policy != "circular" or mb <= 0:
            return
        self._in_flight[key] = max(0.0, self._in_flight.get(key, 0.0) - mb)
        if cls == BACKGROUND:
            self._bg_in_flight[key] = max(
                0.0, self._bg_in_flight.get(key, 0.0) - mb)
        fg = self._waiters.get(key)
        while fg and self.try_reserve(fg[0][0], key=key):
            _mb, launch = fg.popleft()
            launch(sim.now)
        bg = self._bg_waiters.get(key)
        while not fg and bg and self.try_reserve(bg[0][0], BACKGROUND, key):
            _mb, launch = bg.popleft()
            launch(sim.now)
