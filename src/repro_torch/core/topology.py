"""Connection topologies of accelerator servers (paper Fig. 4) + TPU torus.

A Topology is a graph: nodes are device names ("gpu0".."gpu7", "host",
"pcie0".."pcie3", or "chip_x_y"), edges carry bandwidth in GB/s.  All graphs
are *capacitated*: the pathfinder and link simulator treat bandwidth as a
consumable resource.

Bandwidth constants (paper §2-3): NVLink 24 GB/s per link (double links
48 GB/s), PCIe 3.0 pinned 12 GB/s / unpinned 3 GB/s, P2P-over-PCIe 7.9 GB/s,
NVSwitch ~250 GB/s per GPU pair (uniform), TPU v5e ICI ~50 GB/s per link,
inter-node network 12.5 GB/s (100 Gbe).
"""
from __future__ import annotations

from dataclasses import dataclass, field

NVLINK_1X = 24.0
NVLINK_2X = 48.0
NVSWITCH = 250.0
PCIE_PINNED = 12.0
PCIE_UNPINNED = 3.0
PCIE_P2P = 7.9
ICI = 50.0
NET = 12.5
DCN = 25.0          # pod-to-pod


@dataclass
class Topology:
    name: str
    edges: dict[tuple[str, str], float] = field(default_factory=dict)
    gpus: list[str] = field(default_factory=list)
    # version bumps on every mutation; consumers (LinkSim's bandwidth cache,
    # PathFinder's route cache, the adjacency cache below) key on it
    version: int = 0
    _adj: dict = field(default=None, repr=False, compare=False)
    _adj_version: int = field(default=-1, repr=False, compare=False)

    def add(self, a: str, b: str, bw: float):
        self.edges[(a, b)] = bw
        self.edges[(b, a)] = bw
        self.version += 1

    def remove(self, a: str, b: str, *, directed: bool = False):
        """Remove the edge a-b.  Symmetric by default — `add` always
        inserts both directions, so a default removal can never leave a
        half-removed edge behind (the old fail_link hazard).  Pass
        directed=True for deliberate one-way surgery."""
        hit = self.edges.pop((a, b), None) is not None
        if not directed:
            hit = (self.edges.pop((b, a), None) is not None) or hit
        if hit:
            self.version += 1

    def set_bw(self, a: str, b: str, bw: float):
        """Rescale an existing edge in place (bandwidth brownouts).
        Symmetric, no-op on absent edges; bumps `version` so the LinkSim
        bandwidth cache and PathFinder routes invalidate."""
        hit = False
        for k in ((a, b), (b, a)):
            if k in self.edges:
                self.edges[k] = bw
                hit = True
        if hit:
            self.version += 1

    def bw(self, a: str, b: str) -> float:
        return self.edges.get((a, b), 0.0)

    def neighbors(self, a: str):
        if self._adj_version != self.version:
            adj: dict[str, list[str]] = {}
            for (x, b) in self.edges:
                adj.setdefault(x, []).append(b)
            self._adj = adj
            self._adj_version = self.version
        return self._adj.get(a, ())

    def gpu_pairs(self):
        out = []
        for i, a in enumerate(self.gpus):
            for b in self.gpus[i + 1:]:
                out.append((a, b))
        return out


def dgx_v100(name: str = "dgx-v100") -> Topology:
    """8xV100, hard-wired hybrid-cube-mesh NVLink (paper Fig. 4b).

    Two quads {0..3} {4..7}; in-quad fully connected (ring edges double),
    aligned cross-quad pairs double-linked; 12/28 pairs have no direct
    NVLink (43%), 8/28 single-link (29%) — matching the paper's Fig. 6a
    distribution (42% / 28%).  Each GPU uses exactly 6 NVLinks.
    """
    t = Topology(name, gpus=[f"gpu{i}" for i in range(8)])
    for q in (0, 4):
        t.add(f"gpu{q}", f"gpu{q+1}", NVLINK_2X)
        t.add(f"gpu{q+2}", f"gpu{q+3}", NVLINK_2X)
        t.add(f"gpu{q}", f"gpu{q+2}", NVLINK_1X)
        t.add(f"gpu{q}", f"gpu{q+3}", NVLINK_1X)
        t.add(f"gpu{q+1}", f"gpu{q+2}", NVLINK_1X)
        t.add(f"gpu{q+1}", f"gpu{q+3}", NVLINK_1X)
    for i in range(4):
        t.add(f"gpu{i}", f"gpu{i+4}", NVLINK_2X)
    _add_pcie(t, n_switches=4)
    return t


def dgx_a100(name: str = "dgx-a100") -> Topology:
    """8xA100, NVSwitch: uniform high-bandwidth all-to-all (Fig. 4c)."""
    t = Topology(name, gpus=[f"gpu{i}" for i in range(8)])
    for a, b in [(i, j) for i in range(8) for j in range(i + 1, 8)]:
        t.add(f"gpu{a}", f"gpu{b}", NVSWITCH)
    _add_pcie(t, n_switches=4)
    return t


def a10_server(name: str = "4xa10") -> Topology:
    """4xA10: no NVLink; one PCIe link per GPU; P2P crosses the root
    complex BETWEEN switches (7.9 GB/s), so every byte into gpu_i still
    funnels through the single pcie_i-gpu_i link — parallel loading via
    neighbor GPUs is physically impossible (paper §9.3: DeepPlan+ ==
    INFless+ on this box)."""
    t = Topology(name, gpus=[f"gpu{i}" for i in range(4)])
    for i in range(4):
        t.add(f"gpu{i}", f"pcie{i}", PCIE_PINNED)
        t.add(f"pcie{i}", "host", PCIE_PINNED)
    for i in range(4):
        for j in range(i + 1, 4):
            t.add(f"pcie{i}", f"pcie{j}", PCIE_P2P)
    return t


def _add_pcie(t: Topology, n_switches: int):
    """4 PCIe switches, 2 GPUs each, parallel host links (paper Fig. 4a)."""
    per = len(t.gpus) // n_switches
    for s in range(n_switches):
        t.add(f"pcie{s}", "host", PCIE_PINNED)
        for k in range(per):
            t.add(t.gpus[s * per + k], f"pcie{s}", PCIE_PINNED)


def tpu_torus(nx: int = 16, ny: int = 16, name: str = "tpu-v5e-pod",
              hosts: bool = True) -> Topology:
    """TPU v5e pod: 2-D torus of chips, ICI links, 4 chips per host PCIe.

    The TPU analogue of the paper's server graph: uniform per-link bandwidth
    but *hop count* and *port contention* make multi-path routing matter —
    a chip has only 4 ICI ports, and a naive P2P reshard saturates one
    dimension-ordered route while the orthogonal route idles.
    """
    t = Topology(name, gpus=[f"chip{x}_{y}" for x in range(nx) for y in range(ny)])
    for x in range(nx):
        for y in range(ny):
            t.add(f"chip{x}_{y}", f"chip{(x+1) % nx}_{y}", ICI)
            t.add(f"chip{x}_{y}", f"chip{x}_{(y+1) % ny}", ICI)
    if hosts:
        # v5e: 4 chips per host, PCIe to host memory
        h = 0
        for x in range(nx):
            for y in range(0, ny, 4):
                for k in range(4):
                    t.add(f"chip{x}_{y+k}", f"host{h}", PCIE_PINNED)
                h += 1
    return t


def cluster(n_nodes: int = 4, base=dgx_v100) -> Topology:
    """Multi-node cluster: n copies of a server joined by the network."""
    t = Topology(f"{n_nodes}x{base().name}")
    for n in range(n_nodes):
        s = base()
        for (a, b), bw in s.edges.items():
            t.edges[(f"n{n}:{a}", f"n{n}:{b}")] = bw
        t.gpus += [f"n{n}:{g}" for g in s.gpus]
    for n in range(n_nodes):
        for m in range(n + 1, n_nodes):
            t.add(f"n{n}:host", f"n{m}:host", NET)
    return t


def make_topology(kind: str) -> Topology:
    return {
        "dgx-v100": dgx_v100,
        "dgx-a100": dgx_a100,
        "4xa10": a10_server,
        "tpu": tpu_torus,
        "cluster": cluster,
    }[kind]()
