"""Multi-path chunked resharding over the device mesh — the lowering of
FaaSTube's topology-aware P2P transfer scheduling (paper §6.2), PyTorch
port of ``src/repro/distributed/resharding.py``.

A point-to-point shard movement along one mesh axis uses only that
axis's ring links; the orthogonal axis's links idle.  Single-path
send/recv has the same blind spot the paper attacks on NVLink.
``multipath_permute`` splits the tensor into a direct part (1 hop on the
primary ring) and a detour part (detour+1 -> primary -> detour-1, three
hops on otherwise-idle links), doubling the usable link count for large
handoffs (e.g. the prefill->decode KV cache move).  The split ratio is
bandwidth-proportional, mirroring the chunk striping in core/transfer
scheduling: with equal links the detour path carries 1/3 of the bytes
for ~2x total throughput at equal finish time (direct: x/2 over 1 link-hop
vs detour: x/3 over 3 sequential hops — tune via ``detour_frac``).

Each function takes the rank's local shard of ``x`` along ``axis`` (the
dim sharded over the primary axis) and returns the rank's new shard.
A ring hop is one ``dist.batch_isend_irecv`` over
``mesh.get_group(axis)``; a ring of one member is the identity, as
``ppermute`` is there.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import costs
from repro_torch.distributed.mesh import (
    axis_sizes, coordinate, entry_axes, gather_dim, local_chunk)


def _ring(vals: torch.Tensor, mesh, ax_name: str, s: int) -> torch.Tensor:
    """Every member of the ``ax_name`` ring sends ``vals`` to the member
    ``s`` places on and receives from the one ``s`` places back."""
    g = mesh.get_group(ax_name)
    ranks = dist.get_process_group_ranks(g)
    n = len(ranks)
    if n == 1:
        return vals
    at = mesh.mesh_dim_names.index(ax_name)
    by_pos = {coordinate(mesh, r)[at]: r for r in ranks}
    me = coordinate(mesh)[at]
    vals = vals.contiguous()
    got = torch.empty_like(vals)
    ops = [dist.P2POp(dist.isend, vals, by_pos[(me + s) % n], group=g),
           dist.P2POp(dist.irecv, got, by_pos[(me - s) % n], group=g)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    costs.collective("collective-permute", got)
    return got


def multipath_permute(xb, mesh, *, shift: int = 1, primary: str = "model",
                      detour: str = "data", axis: int = 0,
                      detour_frac: float = 0.25):
    """Rotate shards by ``shift`` along the primary mesh axis, splitting
    traffic between the direct ring and a detour through the orthogonal
    ring.

    ``xb`` is this rank's shard of x, which is sharded over ``primary``
    on dim ``axis``.  Returns the rank's shard of the rotated x (shard i
    receives shard i-shift's data).
    """
    n_d = axis_sizes(mesh)[detour]
    split = max(1, min(xb.shape[axis] - 1,
                       int(round(xb.shape[axis] * (1 - detour_frac)))))
    direct = xb.narrow(axis, 0, split)
    via = xb.narrow(axis, split, xb.shape[axis] - split)

    direct = _ring(direct, mesh, primary, shift)    # 1 hop, primary ring
    if n_d > 1:
        via = _ring(via, mesh, detour, 1)           # step aside
        via = _ring(via, mesh, primary, shift)      # cross on idle row
        via = _ring(via, mesh, detour, -1)          # step back
    else:
        via = _ring(via, mesh, primary, shift)
    return torch.cat([direct, via], dim=axis)


def single_path_permute(xb, mesh, *, shift: int = 1, primary: str = "model",
                        axis: int = 0):
    """Baseline: the whole shard over the primary ring only."""
    del axis                    # the shard moves whole
    return _ring(xb, mesh, primary, shift)


def _all_to_all(x, mesh, axis: str, src_dim: int, dst_dim: int):
    """One ``all_to_all`` over ``axis``: ``x`` is split over ``axis`` on
    ``src_dim`` and whole on ``dst_dim``; the result is whole on
    ``src_dim`` and split on ``dst_dim``.  The member at place p on the
    axis sends its chunk i of ``dst_dim`` to the member at place i and
    puts what it gets back in place order along ``src_dim``."""
    g = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(g)
    n = len(ranks)
    if x.shape[dst_dim] % n:
        raise ValueError(f"dim {dst_dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    at = mesh.mesh_dim_names.index(axis)
    # group rank order, by coordinate on the axis
    pos = [coordinate(mesh, r)[at] for r in ranks]
    chunks = x.chunk(n, dim=dst_dim)
    send = [chunks[p].contiguous() for p in pos]
    recv = [torch.empty_like(send[0]) for _ in ranks]
    dist.all_to_all(recv, send, group=g)
    costs.collective("all-to-all", recv)
    return torch.cat([recv[i] for i in sorted(range(n), key=pos.__getitem__)],
                     dim=src_dim)


def tube_reshard(x, src_spec, dst_spec, mesh):
    """Layout handoff (e.g. prefill's head-major KV -> decode's
    seq-major): this rank's shard of an array under ``src_spec`` becomes
    its shard of the same array under ``dst_spec``.  The reference leaves
    the move to XLA (a sharding constraint); here it is the one place a
    K/V layout changes hands, and each mesh axis moves by the cheapest
    means its two places allow:

    - on the same dim in both specs: nothing;
    - on a dim of ``src_spec`` only: an all-gather of that dim;
    - on a dim of ``dst_spec`` only (every rank of the axis holds the
      same data): a slice, no collective;
    - from one dim to another (heads over ``model`` -> ``kv_seq`` over
      ``model``): one ``all_to_all`` over the axis.

    A destination dim split over several axes (``kv_seq`` over
    ``(data, model)`` with the batch replicated) is cut major axis
    first, each axis by a slice or an ``all_to_all``, which gives JAX's
    device order (``local_slice``).  A source dim split over several
    axes moves whole or stays; any other pair of specs raises."""
    src = {a: d for d, p in enumerate(src_spec) for a in entry_axes(p)}
    dst = {a: d for d, p in enumerate(dst_spec) for a in entry_axes(p)}
    for d, p in enumerate(src_spec):
        ax = entry_axes(p)
        if not ax or ax == entry_axes(dst_spec[d]):
            continue
        gone = tuple(a for a in ax if a not in dst)
        if gone == ax:
            x = gather_dim(x, mesh, ax, d)
        elif gone or len(ax) > 1:
            raise NotImplementedError(
                f"tube_reshard {src_spec} -> {dst_spec}: dim {d} over {ax}")
    for d, p in enumerate(dst_spec):
        ax = entry_axes(p)
        if not ax or ax == entry_axes(src_spec[d]):
            continue
        for a in ax:                 # major first, as local_slice numbers
            if a not in src:
                x = local_chunk(x, mesh, (a,), d)
            elif src[a] != d and entry_axes(src_spec[src[a]]) == (a,):
                x = _all_to_all(x, mesh, a, src[a], d)
            else:
                raise NotImplementedError(
                    f"tube_reshard {src_spec} -> {dst_spec}: {a} on dim {d}")
    return x
