"""Seeded, deterministic fault injection for the tube (chaos harness).

A :class:`FaultSchedule` is a sorted list of :class:`Fault` records —
what breaks, where, and when.  :class:`FaultInjector` arms a schedule on
a :class:`~repro.core.api.FaaSTube`: each fault becomes one simulator
timer that dispatches to the facade's fault entry points
(``fail_link`` / ``brownout`` / ``crash_node`` / ``lose_host``), so the
whole failure trace rides the same event heap as the workload and a
given ``(workload, schedule)`` pair replays byte-identically.

Determinism guarantee: ``FaultSchedule.generate`` draws from
``random.Random(seed)`` over *sorted* topology collections (canonical
undirected edge pairs, sorted node/host names), so the schedule — and
with it every downstream event — is independent of ``PYTHONHASHSEED``
and process history.  An EMPTY schedule arms nothing: the injector adds
zero simulator events and the run is bit-identical to a fault-free one.

Fault kinds
-----------
``link``      permanent link death: in-flight coalesced service is
              truncated at the failure epoch, the edge leaves the
              routing graph, victims re-plan through PathFinder.
``brownout``  bandwidth degradation to ``factor`` of nominal for
              ``duration_ms`` (0 = permanent), then restoration.
``node``      whole-node crash: every link severed, every object stored
              on the node lost (lineage recovery re-executes producers).
``host``      staging-host memory loss: transfers staged through the
              host's pinned ring fail (and re-plan; the ring itself
              recovers), spilled objects on that host are gone.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from repro_torch.core.topology import Topology
from repro_torch.core.transfer import RecoveryPolicy, node_of

FAULT_KINDS = ("link", "brownout", "node", "host")


@dataclass(frozen=True)
class Fault:
    t_ms: float
    kind: str                 # one of FAULT_KINDS
    a: str = ""               # link endpoints (link / brownout)
    b: str = ""
    node: str = ""            # crashed node ("n3") or lost host ("n3:host")
    factor: float = 0.5       # brownout bandwidth multiplier
    duration_ms: float = 0.0  # brownout hold time (0 = permanent)

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind


@dataclass
class FaultSchedule:
    faults: list = field(default_factory=list)

    def __post_init__(self):
        # total order: time, then a PYTHONHASHSEED-free tiebreak
        self.faults = sorted(
            self.faults,
            key=lambda f: (f.t_ms, f.kind, f.a, f.b, f.node))

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)

    def by_kind(self) -> dict:
        out = {k: 0 for k in FAULT_KINDS}
        for f in self.faults:
            out[f.kind] += 1
        return out

    @classmethod
    def generate(cls, topo: Topology, *, seed: int, horizon_ms: float,
                 n_link: int = 0, n_brownout: int = 0, n_node: int = 0,
                 n_host: int = 0) -> "FaultSchedule":
        """Draw a schedule over the topology's links/nodes/hosts.

        Node crashes are sampled WITHOUT replacement (crashing the same
        node twice is a no-op); link faults avoid the inter-host mesh so
        a small schedule cannot partition the fleet outright — node
        crashes are the partition-grade faults.
        """
        rng = random.Random(seed)
        pairs = sorted({tuple(sorted(e)) for e in topo.edges})
        intra = [p for p in pairs
                 if not (p[0].endswith("host") and p[1].endswith("host"))]
        nodes = sorted({node_of(g) for g in topo.gpus if node_of(g)})
        hosts = sorted({n for p in pairs for n in p
                        if n.split(":")[-1] == "host"})
        faults = []
        for _ in range(n_link):
            a, b = rng.choice(intra or pairs)
            faults.append(Fault(rng.uniform(0.0, horizon_ms), "link", a, b))
        for _ in range(n_brownout):
            a, b = rng.choice(pairs)
            faults.append(Fault(
                rng.uniform(0.0, horizon_ms), "brownout", a, b,
                factor=rng.uniform(0.05, 0.5),
                duration_ms=rng.uniform(0.05 * horizon_ms,
                                        0.25 * horizon_ms)))
        for n in rng.sample(nodes, min(n_node, len(nodes))):
            faults.append(Fault(rng.uniform(0.2 * horizon_ms, horizon_ms),
                                "node", node=n))
        for _ in range(n_host):
            if not hosts:
                break
            faults.append(Fault(rng.uniform(0.0, horizon_ms), "host",
                                node=rng.choice(hosts)))
        return cls(faults)


class FaultInjector:
    """Arm a schedule on a tube and (optionally) its recovery policy.

    ``recovery=None`` leaves the engine's retry ladder disarmed — the
    no-retry contrast arm: faults fire, transfers fail once, errors
    surface straight to the callers.
    """

    def __init__(self, tube, schedule: FaultSchedule, *,
                 recovery: RecoveryPolicy | None = None):
        self.tube = tube
        self.schedule = schedule
        self.fired = {k: 0 for k in FAULT_KINDS}
        self.fired["skipped"] = 0
        if recovery is not None:
            tube.engine.recovery = recovery

    def arm(self):
        """One simulator timer per fault.  An empty schedule arms
        nothing — zero events, bit-identical to a fault-free run."""
        for f in self.schedule:
            self.tube.sim.call_at(f.t_ms,
                                  lambda sim, f=f: self._fire(f))
        return self

    def _fire(self, f: Fault):
        tube = self.tube
        if f.kind == "link":
            if tube.topo.bw(f.a, f.b) <= 0.0:
                self.fired["skipped"] += 1   # already dead (prior fault)
                return
            tube.fail_link(f.a, f.b)
        elif f.kind == "brownout":
            if tube.topo.bw(f.a, f.b) <= 0.0:
                self.fired["skipped"] += 1
                return
            tube.brownout(f.a, f.b, f.factor, f.duration_ms)
        elif f.kind == "node":
            if f.node in tube.dead_nodes:
                self.fired["skipped"] += 1
                return
            tube.crash_node(f.node)
        elif f.kind == "host":
            if node_of(f.node) in tube.dead_nodes:
                self.fired["skipped"] += 1
                return
            tube.lose_host(f.node)
        self.fired[f.kind] += 1
