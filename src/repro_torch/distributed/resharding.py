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

from repro_torch.distributed.mesh import axis_sizes, coordinate


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


def tube_reshard(x, src_spec, dst_spec, mesh):
    """Layout handoff (e.g. prefill's head-major KV -> decode's
    seq-major): this rank's shard of x, sharded over one mesh axis on one
    dim (``src_spec``), becomes its shard of the same x sharded over the
    same axis on another dim (``dst_spec``), by one ``all_to_all`` over
    that axis.  The reference leaves the move to XLA; any other pair of
    specs raises."""
    src = [(d, p) for d, p in enumerate(src_spec) if p is not None]
    dst = [(d, p) for d, p in enumerate(dst_spec) if p is not None]
    if not (len(src) == len(dst) == 1 and isinstance(src[0][1], str)
            and src[0][1] == dst[0][1] and src[0][0] != dst[0][0]):
        raise NotImplementedError(
            f"tube_reshard {src_spec} -> {dst_spec}: only one dim to another "
            "over the same mesh axis is ported (ROADMAP.md §1, weight "
            "sharding)")
    (sd, name), (dd, _) = src[0], dst[0]
    g = mesh.get_group(name)
    ranks = dist.get_process_group_ranks(g)
    n = len(ranks)
    if x.shape[dd] % n:
        raise ValueError(f"dim {dd} of {tuple(x.shape)} does not split {n} "
                         "ways")
    at = mesh.mesh_dim_names.index(name)
    # group rank order, by coordinate on the axis
    pos = [coordinate(mesh, r)[at] for r in ranks]
    chunks = x.chunk(n, dim=dd)
    send = [chunks[p].contiguous() for p in pos]
    recv = [torch.empty_like(send[0]) for _ in ranks]
    dist.all_to_all(recv, send, group=g)
    return torch.cat([recv[i] for i in sorted(range(n), key=pos.__getitem__)],
                     dim=sd)
