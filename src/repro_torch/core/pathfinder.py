"""Contention-aware parallel path selection (paper Algorithm 1).

Treats the server as a network: a live bandwidth matrix BW tracks residual
capacity per directed edge; path search returns multiple parallel paths for
one point-to-point transfer, preferring *free* paths (no other function on
any edge), then balancing onto busy paths when the endpoints still have
spare ingress/egress bandwidth.

Used three ways:
  * NVLink scheduling on GPU servers (paper §6.2),
  * ICI multi-path routing on the TPU torus (our adaptation),
  * link-failure rerouting (fault tolerance: dead link -> edge removed).

Route cache
-----------
`_next_shortest_path` is memoized on `(src, dst, free_only)` behind two
generation counters, so repeated queries against an unchanged graph are a
dict hit instead of a Dijkstra run:

  * the *residual* generation bumps on every `_allocate` /
    `_release_alloc` / `fail_link` — any mutation of the live bandwidth
    matrix invalidates residual-aware routes;
  * pure-topology routes (``ignore_load=True`` — the saturated-graph
    fallback, where the link simulator arbitrates sharing chunk by chunk)
    are invalidated only by `Topology.version` changes (`fail_link`,
    edge insertion), which makes the fallback O(1) for the host-staged
    baselines that take it on every transfer.

Queries with ``avoid_edges`` (the rebalancer's what-if probes) bypass the
cache entirely.

Cluster scaling
---------------
On multi-node cluster topologies (`cluster()` — node-qualified names
like ``n3:gpu0``, inter-node edges ONLY between per-node hosts) the
search is hierarchical, which is what makes fleet-scale traces feasible:

  * an intra-node query explores only that node's subgraph — a path
    between two ``nK:`` devices can never leave the node, because the
    node's single gateway is its host and re-entering would revisit it;
  * a cross-node query composes ``src -> nS:host``, the direct
    ``nS:host -> nD:host`` mesh edge (the host mesh is a clique, so any
    minimal-hop path crosses exactly once), and ``nD:host -> dst`` —
    two node-local searches instead of a cluster-wide one.  When the
    composition fails (mesh edge saturated or removed) the query falls
    back to the cluster-wide Dijkstra, which can still route around via
    other hosts;
  * the residual generation is tracked PER NODE: an allocation on node
    3 no longer invalidates node 5's cached routes, and the pristine
    `select_paths` memo replays whenever the involved node — not the
    whole cluster — has no live allocations.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass

from repro_torch.core.topology import Topology


@dataclass
class PathAlloc:
    func: str
    path: tuple[str, ...]
    bw: float


class PathFinder:
    def __init__(self, topo: Topology, *, transit: str = "gpu"):
        """transit: node-name prefix allowed as intermediate hop."""
        self.topo = topo
        self.transit = transit
        self.residual: dict[tuple[str, str], float] = dict(topo.edges)
        # per-edge user "sets" are insertion-ordered dicts: the
        # rebalancer iterates them, and salted set order would make
        # path selection (and with it every banded event count)
        # nondeterministic across processes
        self.users: dict[tuple[str, str], dict[str, None]] = \
            defaultdict(dict)
        self.allocs: dict[str, list[PathAlloc]] = defaultdict(list)
        self._gen = 0                 # residual-matrix generation
        self._n_live = 0              # live PathAllocs (0 == pristine graph)
        # per-node-scope residual generation / live-alloc count ("" is
        # the scope of unqualified names, e.g. single-server graphs)
        self._gen_s: dict[str, int] = {}
        self._n_live_s: dict[str, int] = {}
        self._res_cache: dict = {}    # (src,dst,free_only) -> (gen, tv, p, bw)
        self._topo_cache: dict = {}   # (src,dst) -> (topo_version, path, bw)
        self._stripe_cache: dict = {}  # (src,dst,k) -> (tv, [(path, bw)])
        self._sp_cache: dict = {}     # pristine-graph select_paths results
        self._transit_ok: dict = {}   # node -> allowed as intermediate hop
        self._transit_prefixes = tuple(self.transit.split(","))
        self._adj_cache: dict = {}    # (node, scope) -> transit neighbors
        self._adj_version = -1
        self._spaths_cache: dict = {}  # (src,dst,scope) -> simple paths
        self._spaths_version = -1
        #: True once fail_link has performed surgery — only then can a
        #: node subgraph be disconnected and a scoped miss need the
        #: cluster-wide re-check
        self._failed_links = False

    # ------------------------------------------------------------- util ---
    def _edge_ok(self, a, b, *, free_only: bool,
                 ignore_load: bool = False) -> bool:
        if ignore_load:
            return self.topo.bw(a, b) > 0.0
        r = self.residual.get((a, b), 0.0)
        if r <= 1e-9:
            return False
        if free_only and self.users[(a, b)]:
            return False
        return True

    def _is_transit(self, node: str) -> bool:
        ok = self._transit_ok.get(node)
        if ok is None:
            # transit check on the node-local name ("n3:pcie0" -> "pcie0")
            local = node.split(":")[-1]
            ok = local.startswith(self._transit_prefixes)
            self._transit_ok[node] = ok
        return ok

    @staticmethod
    def _scope_of(node: str) -> str:
        """Cluster-node scope of a device name ("n3:gpu0" -> "n3")."""
        i = node.find(":")
        return node[:i] if i > 0 else ""

    def _touch_scopes(self, path, delta_live: int = 0):
        """Bump the residual generation of every node scope a path
        touches (and the live-alloc counters when delta_live != 0)."""
        self._gen += 1
        seen = None
        for n in path:
            s = self._scope_of(n)
            if seen is None:
                seen = {s}
            elif s in seen:
                continue
            else:
                seen.add(s)
            self._gen_s[s] = self._gen
            if delta_live:
                self._n_live_s[s] = self._n_live_s.get(s, 0) + delta_live

    def route(self, src: str, dst: str):
        """Topology-shortest route ignoring load (cached fallback)."""
        return self._next_shortest_path(src, dst, free_only=False,
                                        ignore_load=True)

    # ------------------------------------------------------- public API ---
    def shortest_residual_path(self, src: str, dst: str, *,
                               free_only: bool = False,
                               avoid_edges=frozenset()):
        """Shortest path on the LIVE residual bandwidth matrix:
        ``(path, bottleneck_bw)``, or ``(None, 0.0)`` when the residual
        graph is exhausted between the endpoints.

        This is the public query the transfer engine stitches multi-hop
        cut-through paths from (and what `benchmarks/tpu_multipath.py`
        uses for its single-path arm) — callers never reach into the
        memoized `_next_shortest_path` internals.
        """
        return self._next_shortest_path(src, dst, free_only=free_only,
                                        avoid_edges=avoid_edges)

    def striped_paths(self, src: str, dst: str, max_paths: int = 4
                      ) -> list[tuple[tuple[str, ...], float]]:
        """Edge-disjoint topology stripe set ``[(path, bw), ...]`` for a
        SATURATED residual graph: up to ``max_paths`` shortest routes on
        the raw topology, each avoiding the edges of the earlier ones.

        When `select_paths` can allocate nothing (every relevant edge's
        residual is claimed by live transfers), striping chunks across
        several *physical* routes still wins — the link simulator's DRR
        arbitration shares each link chunk by chunk, so an extra disjoint
        route is extra aggregate bandwidth even at zero free capacity.
        Stripe routes are capped at ONE hop beyond the shortest (the
        direct NVLink plus its 2-hop parallel detours — paper Fig. 7's
        stripe shape): a longer detour through contended links makes its
        stripe the straggler that delays the whole transfer (completion
        is the max over stripes).  No allocation is made.  Pure function
        of the topology, memoized on `Topology.version`.
        """
        key = (src, dst, max_paths)
        hit = self._stripe_cache.get(key)
        if hit is not None and hit[0] == self.topo.version:
            return hit[1]
        out: list[tuple[tuple[str, ...], float]] = []
        avoid: set[tuple[str, str]] = set()
        min_hops = None
        while len(out) < max_paths:
            p, bw = self._next_shortest_path(
                src, dst, free_only=False, ignore_load=True,
                avoid_edges=frozenset(avoid))
            if p is None:
                break
            if min_hops is None:
                min_hops = len(p)
            elif len(p) > min_hops + 1:
                break
            out.append((tuple(p), bw))
            avoid.update(zip(p, p[1:]))
        self._stripe_cache[key] = (self.topo.version, out)
        return out

    def _next_shortest_path(self, src, dst, *, free_only: bool,
                            avoid_edges=frozenset(),
                            ignore_load: bool = False):
        """Dijkstra on hop count then max bottleneck bw, memoized.

        ignore_load=True routes on the raw topology (saturated graph
        fallback: the link simulator arbitrates sharing chunk by chunk).

        Cluster queries are hierarchical: intra-node searches are scoped
        to the node's subgraph; cross-node queries compose two scoped
        searches around the direct host-mesh edge and fall back to the
        cluster-wide search only when the composition fails.
        """
        ns, nd = self._scope_of(src), self._scope_of(dst)
        if avoid_edges:
            return self._dijkstra(src, dst, free_only=free_only,
                                  avoid_edges=avoid_edges,
                                  ignore_load=ignore_load,
                                  scope=ns if ns and ns == nd else None)
        if ns and nd and ns != nd:
            r = self._compose_cross(src, dst, ns, nd, free_only=free_only,
                                    ignore_load=ignore_load)
            if r is not None:
                return r
            # mesh edge unusable: cluster-wide search can still route
            # around via other hosts
        tv = self.topo.version
        scope = ns if ns and ns == nd else None
        if ignore_load:
            hit = self._topo_cache.get((src, dst))
            if hit is not None and hit[0] == tv:
                return hit[1], hit[2]
            path, bw = self._dijkstra(src, dst, free_only=free_only,
                                      ignore_load=True, scope=scope)
            if path is None and scope is not None and self._failed_links:
                path, bw = self._dijkstra(src, dst, free_only=free_only,
                                          ignore_load=True)
            self._topo_cache[(src, dst)] = (tv, path, bw)
            return path, bw
        key = (src, dst, free_only)
        gen = self._gen_s.get(scope, 0) if scope is not None else self._gen
        hit = self._res_cache.get(key)
        if hit is not None and hit[0] == gen and hit[1] == tv:
            return hit[2], hit[3]
        path, bw = self._dijkstra(src, dst, free_only=free_only, scope=scope)
        if path is None and scope is not None and self._failed_links:
            # a node subgraph is only disconnected after fail_link
            # surgery — re-check against the whole graph before giving up
            path, bw = self._dijkstra(src, dst, free_only=free_only)
            if path is not None:
                return path, bw     # out-of-scope route: do not cache
        self._res_cache[key] = (gen, tv, path, bw)
        return path, bw

    def _compose_cross(self, src, dst, ns, nd, *, free_only: bool,
                       ignore_load: bool):
        """Cross-node route as src -> nS:host -> nD:host -> dst.

        Exact on cluster() graphs: hosts are the only inter-node
        gateways and the host mesh is a clique, so every minimal-hop
        cross-node path decomposes this way, and hop count / bottleneck
        optimize independently per piece.  Returns None when any piece
        is unavailable (caller falls back to the cluster-wide search).
        """
        hs, hd = f"{ns}:host", f"{nd}:host"
        e = (hs, hd)
        if ignore_load:
            mbw = self.topo.bw(*e)
        else:
            mbw = self.residual.get(e, 0.0)
            if free_only and self.users.get(e):
                mbw = 0.0
        if mbw <= 1e-9:
            return None
        if src == hs:
            p1, b1 = (hs,), float("inf")
        else:
            p1, b1 = self._next_shortest_path(src, hs, free_only=free_only,
                                              ignore_load=ignore_load)
            if p1 is None:
                return None
        if dst == hd:
            p2, b2 = (hd,), float("inf")
        else:
            p2, b2 = self._next_shortest_path(hd, dst, free_only=free_only,
                                              ignore_load=ignore_load)
            if p2 is None:
                return None
        return tuple(p1) + tuple(p2), min(b1, mbw, b2)

    def _transit_adj(self, node, scope=None):
        """Transit-allowed neighbors of node (optionally restricted to a
        cluster-node scope), cached on topo.version."""
        if self._adj_version != self.topo.version:
            self._adj_cache.clear()
            self._adj_version = self.topo.version
        key = (node, scope)
        lst = self._adj_cache.get(key)
        if lst is None:
            lst = [nb for nb in self.topo.neighbors(node)
                   if self._is_transit(nb)]
            if scope is not None:
                pre = scope + ":"
                lst = [nb for nb in lst if nb.startswith(pre)]
            self._adj_cache[key] = lst
        return lst

    def _scoped_mids(self, src, dst, scope):
        """Midpoints of every 2-hop transit path src -> mid -> dst in
        one node scope, cached on `Topology.version`.  Covers both
        transit and device endpoints: the heap search steps onto a
        non-transit dst exactly when the (mid, dst) edge exists, which
        is the same membership test."""
        if self._spaths_version != self.topo.version:
            self._spaths_cache.clear()
            self._spaths_version = self.topo.version
        key = (src, dst, scope)
        mids = self._spaths_cache.get(key)
        if mids is None:
            edges = self.topo.edges
            mids = tuple(m for m in self._transit_adj(src, scope)
                         if m != dst and (m, dst) in edges)
            self._spaths_cache[key] = mids
        return mids

    def _scoped_query(self, src, dst, scope, free_only, avoid_edges,
                      ignore_load):
        """Closed-form answer for the minimal-hop intra-node queries
        that dominate fleet traffic, bypassing the heap search:

          * a usable direct edge is the unique 1-hop path, which beats
            every >=2-hop candidate on the (hops, -bw) pop order;
          * otherwise, if ANY 2-hop path passes the residual/free/avoid
            filters, the search's answer is exactly the usable 2-hop
            candidate minimizing (-bottleneck, path) — every 1-hop heap
            entry pops before the first 2-hop entry, so all 2-hop dst
            entries are on the heap by then and longer paths never win.

        Returns ``NotImplemented`` when no minimal-hop candidate is
        usable (the search may route around through 3+ hops) — the
        caller falls through to the real Dijkstra."""
        if src == dst:
            return (src,), 1e18       # the search's immediate first pop
        edges = self.topo.edges
        residual = self.residual
        users = self.users
        e = (src, dst)
        if edges.get(e, 0.0) > 0.0 and e not in avoid_edges:
            if ignore_load:
                return (src, dst), edges[e]
            bw = residual.get(e, 0.0)
            if bw > 1e-9 and not (free_only and users.get(e)):
                return (src, dst), bw
        best = None
        for m in self._scoped_mids(src, dst, scope):
            bw = 1e18
            for pe in ((src, m), (m, dst)):
                if pe in avoid_edges:
                    bw = 0.0
                    break
                if ignore_load:
                    w = edges.get(pe, 0.0)
                    if w <= 0.0:
                        bw = 0.0
                        break
                else:
                    w = residual.get(pe, 0.0)
                    if w <= 1e-9 or (free_only and users.get(pe)):
                        bw = 0.0
                        break
                if w < bw:
                    bw = w
            if bw > 0.0:
                k = (-bw, (src, m, dst))
                if best is None or k < best:
                    best = k
        if best is None:
            return NotImplemented
        return best[1], -best[0]

    def _dijkstra(self, src, dst, *, free_only: bool,
                  avoid_edges=frozenset(), ignore_load: bool = False,
                  scope=None):
        if scope is not None:
            r = self._scoped_query(src, dst, scope, free_only,
                                   avoid_edges, ignore_load)
            if r is not NotImplemented:
                return r
        heap = [(0, -1e18, src, (src,))]
        seen = {}
        edges = self.topo.edges
        residual = self.residual
        users = self.users
        dst_needs_extra = not self._is_transit(dst)
        heappush, heappop = heapq.heappush, heapq.heappop
        while heap:
            hops, negbw, node, path = heappop(heap)
            if node == dst:
                return path, -negbw
            sk = seen.get(node)
            if sk is not None and sk <= (hops, negbw):
                continue
            seen[node] = (hops, negbw)
            nbrs = self._transit_adj(node, scope)
            if dst_needs_extra and (node, dst) in edges:
                nbrs = nbrs + [dst]
            cap = -negbw
            for nb in nbrs:
                if nb in path:
                    continue
                e = (node, nb)
                if e in avoid_edges:
                    continue
                if ignore_load:
                    bw = edges.get(e, 0.0)
                    if bw <= 0.0:
                        continue
                else:
                    bw = residual.get(e, 0.0)
                    if bw <= 1e-9:
                        continue
                    if free_only and users.get(e):
                        continue
                if bw > cap:
                    bw = cap
                heappush(heap, (hops + 1, -bw, nb, path + (nb,)))
        return None, 0.0

    def _egress(self, g) -> float:
        """Spare bandwidth out of g — callers only threshold it against
        1e-9, so the sum short-circuits once it is unambiguously
        positive (a cluster host has ~N mesh edges; summing them all per
        select_paths probe was a top fleet hotspot).  Residual dust from
        alloc/release float error is bounded far below 1e-3, so an early
        exit can never flip the threshold comparison."""
        s = 0.0
        rget = self.residual.get
        for nb in self.topo.neighbors(g):
            s += rget((g, nb), 0.0)
            if s > 1e-3:
                break
        return s

    def _ingress(self, g) -> float:
        s = 0.0
        rget = self.residual.get
        for nb in self.topo.neighbors(g):
            s += rget((nb, g), 0.0)
            if s > 1e-3:
                break
        return s

    # -------------------------------------------------------- Algorithm 1 -
    def select_paths(self, func: str, src: str, dst: str,
                     max_paths: int = 8) -> list[PathAlloc]:
        """Contention-aware parallel transfer paths for func: src -> dst.

        On a pristine graph (no live allocations) the outcome is a pure
        function of (src, dst, max_paths, topology), so the search result
        is memoized and replayed through `_allocate` — the common case
        when transfers do not overlap.  On cluster topologies pristine
        is judged PER NODE: an intra-node selection replays whenever its
        own node has no live allocations, regardless of traffic
        elsewhere in the fleet.
        """
        ns, nd = self._scope_of(src), self._scope_of(dst)
        if ns and ns == nd:
            pristine = self._n_live_s.get(ns, 0) == 0
        else:
            pristine = self._n_live == 0
        if pristine:
            hit = self._sp_cache.get((src, dst, max_paths))
            if hit is not None and hit[0] == self.topo.version:
                paths = []
                for p, bw in hit[1]:
                    self._allocate(func, p, bw, paths)
                return paths
            paths = self._select_paths_uncached(func, src, dst, max_paths)
            self._sp_cache[(src, dst, max_paths)] = (
                self.topo.version, [(p.path, p.bw) for p in paths])
            return paths
        return self._select_paths_uncached(func, src, dst, max_paths)

    def _select_paths_uncached(self, func, src, dst, max_paths):
        paths: list[PathAlloc] = []
        # Phase 1: free paths (no contention with other functions)
        while len(paths) < max_paths:
            path, bw = self._next_shortest_path(src, dst, free_only=True)
            if path is None:
                break
            self._allocate(func, path, bw, paths)
            if self._egress(src) <= 1e-9 or self._ingress(dst) <= 1e-9:
                break
        # Phase 2: busy paths, when endpoints still have spare bandwidth
        if self._egress(src) > 1e-9 and self._ingress(dst) > 1e-9:
            while len(paths) < max_paths:
                path, bw = self._next_shortest_path(src, dst, free_only=False)
                if path is None:
                    break
                # bandwidth balancing: try to migrate the busiest co-user to
                # an alternative free path before sharing
                self._rebalance_users(path)
                bw = min(self.residual[(a, b)]
                         for a, b in zip(path, path[1:]))
                if bw <= 1e-9:
                    break
                self._allocate(func, path, bw, paths)
                if self._egress(src) <= 1e-9 or self._ingress(dst) <= 1e-9:
                    break
        return paths

    def _rebalance_users(self, path):
        edges = list(zip(path, path[1:]))
        for e in edges:
            for other in list(self.users[e]):
                allocs = [a for a in self.allocs[other] if e in
                          zip(a.path, a.path[1:])]
                for a in allocs:
                    alt, altbw = self._next_shortest_path(
                        a.path[0], a.path[-1], free_only=True,
                        avoid_edges=frozenset(edges))
                    if alt is not None and altbw >= a.bw:
                        self._release_alloc(other, a)
                        self._allocate(other, alt, a.bw, self.allocs[other])

    def _allocate(self, func, path, bw, out_list):
        bw = min(bw, *(self.residual[(a, b)] for a, b in zip(path, path[1:])))
        alloc = PathAlloc(func, tuple(path), bw)
        for a, b in zip(path, path[1:]):
            self.residual[(a, b)] -= bw
            self.users[(a, b)][func] = None
        self._touch_scopes(path, delta_live=1)
        self._n_live += 1
        if out_list is not self.allocs[func]:
            self.allocs[func].append(alloc)
        out_list.append(alloc)
        return alloc

    def _release_alloc(self, func, alloc: PathAlloc):
        for a, b in zip(alloc.path, alloc.path[1:]):
            # an edge may have been removed by fail_link while the
            # allocation was live — nothing to give back then
            if (a, b) in self.residual:
                self.residual[(a, b)] += alloc.bw
            self.users[(a, b)].pop(func, None)
        self._touch_scopes(alloc.path, delta_live=-1)
        self._n_live -= 1
        if alloc in self.allocs[func]:
            self.allocs[func].remove(alloc)

    def release(self, func: str):
        for alloc in list(self.allocs[func]):
            self._release_alloc(func, alloc)
        self.allocs.pop(func, None)

    def retime_link(self, a: str, b: str, delta: float):
        """Bandwidth brownout/restore: shift the residual capacity of a
        live edge by ``delta`` (the topology edge itself is rescaled by
        ``Topology.set_bw`` via the link simulator).  Clamped at zero —
        an edge allocated beyond its browned-out capacity simply has no
        residual until its flows complete."""
        for e in ((a, b), (b, a)):
            if e in self.residual:
                self.residual[e] = max(0.0, self.residual[e] + delta)
        self._touch_scopes((a, b))

    def fail_link(self, a: str, b: str):
        """Fault tolerance: remove a dead link from the graph.

        Bumps both the residual generation and `Topology.version`, so
        every cached route (residual-aware AND pure-topology) that might
        cross the dead edge is invalidated.
        """
        self.topo.remove(a, b)          # symmetric: both directions go
        for e in ((a, b), (b, a)):
            self.residual.pop(e, None)
            self.users.pop(e, None)
        self._touch_scopes((a, b))
        self._failed_links = True
