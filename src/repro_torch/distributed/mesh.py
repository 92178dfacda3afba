"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
PyTorch port of ``src/repro/distributed/mesh.py``, over a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the
reference's axis names (``data``, ``model``, and ``pod`` when
multi-pod).

Every parameter / activation dim is named by a *logical axis*; a rule table
maps logical axes to mesh axes per (arch, shape).  ``spec_for`` drops mesh
axes that do not divide the dim size (replicate-on-mismatch), so a single
rule table serves every architecture (e.g. grok's 8 experts on a 16-way
model axis fall back to expert-d_ff tensor parallelism).

A spec is a plain tuple, one entry per dim: ``None``, one axis name, or a
tuple of axis names, as a ``PartitionSpec`` holds them.  The rules read
only the mesh's dim names and sizes (``mesh.mesh_dim_names``,
``mesh.shape``), so they run for any object that has those two.

Where JAX places a shard, the port computes it: ``local_slice`` is the
part of a global array that the rank at one mesh coordinate holds, in
JAX's device order (a dim sharded over ``("data", "model")`` splits into
``n_data x n_model`` chunks and chunk ``data_idx * n_model + model_idx``
belongs to that rank; ranks on axes the spec does not name hold copies).
Residency, ZeRO-1 and checkpoint restore all read this one mapping, and
``all_reduce_axes`` / ``gather_full`` are the two collectives that
stand in for what XLA inserts there.

Inside the model, where GSPMD places the collectives of a sharded weight,
the port calls them by hand, as autograd functions over a tuple of mesh
axes: Megatron's pair ``copy_to`` (the identity forward, an all-reduce
backward) and ``reduce_from`` (an all-reduce forward, the identity
backward), FSDP's ``gather_from`` (an all-gather of one dim forward, a
reduce-scatter backward), and ``axis_index``.  A body passes the axes
its weights' specs name, so an axis that ``spec_for`` dropped gets no
collective, and an axis of one member still gets its call.  The
convention they keep: on every rank, autograd gives each tensor the
gradient of the rank's own loss, whole over the model axes and partial
over the data axes; the train step sums over the data axes what
``gather_from`` has not already reduce-scattered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import costs
from repro_torch.configs.base import ArchConfig, ShapeSpec

Rules = dict[str, tuple[str, ...]]
Spec = tuple


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def mesh_axis_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _param_count(cfg: ArchConfig) -> int:
    from repro_torch.models import model as M     # lazy: avoids import cycle
    from repro_torch.models.param import count_params
    return count_params(M.model_specs(cfg))


# Dense models below this size train fastest as pure DP + ZeRO-1 on a
# 256-chip pod: TP-16 either replicates attention outright (36/12/4 heads
# don't divide 16) or trades matmul efficiency for per-layer psums, and
# ZeRO-3 re-gathers weights every microbatch.  The reference's figure for
# this rule was taken on its TPU dry-run and is not the port's.
DP_SMALL_PARAMS = 8e9


def use_small_dense_dp(cfg: ArchConfig, shape: ShapeSpec, mesh) -> bool:
    if not shape.is_training or cfg.n_experts:
        return False
    total = mesh_axis_size(mesh, data_axes(mesh)) * mesh_axis_size(
        mesh, ("model",))
    if shape.global_batch % total:
        return False
    return _param_count(cfg) < DP_SMALL_PARAMS


def make_rules(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Rules:
    """Rule table for one (arch, shape, mesh) cell."""
    da = data_axes(mesh)
    dp = mesh_axis_size(mesh, da)

    rules: Rules = {
        # activations
        "batch": da,
        "seq": (),
        "act_embed": (),
        # weights
        "embed": da if shape.is_training else (),   # FSDP only when training
        "embed_mlp": da if shape.is_training else (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_mlp": (),
        "layers": (),
        "stack": (),
        # attention / recurrent state
        "kv_seq": ("model",),                       # flash-decoding layout
        "state_inner": ("model",),                  # mamba d_inner, mlstm dv
        "head_qk": (),
        "head_v": ("model",),                       # mLSTM C-state v-dim
        # unshardable leftovers
        "conv": (),
        "pos": (),
    }

    # Small dense models: pure data parallelism over EVERY mesh axis with
    # replicated weights (optimizer state sharded via make_opt_rules =
    # ZeRO-1).  No weight gathers, no TP psums, no replicated attention.
    if use_small_dense_dp(cfg, shape, mesh):
        for k in ("embed", "embed_mlp", "heads", "kv_heads", "mlp", "vocab",
                  "state_inner", "head_v", "kv_seq"):
            rules[k] = ()
        rules["batch"] = (*da, "model")
        return rules

    # Experts that do not divide the model axis: replicate experts, TP the
    # expert FFN width instead (grok-1: 8 experts on a 16-way axis).
    if cfg.n_experts and cfg.n_experts % mesh_axis_size(mesh, ("model",)):
        rules["experts"] = ()
        rules["expert_mlp"] = ("model",)

    # Serving big MoE: TP-16 alone cannot hold the experts (jamba 398B,
    # grok 314B, dbrx 132B).  Go 2D: expert FFN width over the data axes
    # as well.  Decode replicates the (tiny, memory-bound) batch and
    # shards the KV sequence everywhere; prefill MUST keep the batch
    # data-sharded (replicating 32k-token prefill activations on every
    # device multiplies their temporaries by the data-parallel width).
    if cfg.n_experts and not shape.is_training:
        rules["expert_mlp"] = da + rules["expert_mlp"]
        if shape.kind == "decode":
            rules["batch"] = ()
            rules["kv_seq"] = (*da, "model")

    # Decode with a batch too small for the data axes: put the data axes on
    # the KV sequence dim instead (long_500k: batch=1 -> 256-way seq shards).
    if shape.kind == "decode" and shape.global_batch % dp != 0:
        rules["batch"] = ()
        rules["kv_seq"] = (*da, "model")
    return rules


def make_opt_rules(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   rules: Rules) -> Rules:
    """Sharding rules for optimizer state.

    Mirrors the param rules except under small-dense DP, where params are
    replicated but the f32 moments would not fit replicated: ZeRO-1 —
    moments sharded over every axis via their embed/vocab dims; the
    update computes each rank's shard and all-gathers the new params.
    """
    if not use_small_dense_dp(cfg, shape, mesh):
        return rules
    out = dict(rules)
    out["embed"] = (*data_axes(mesh), "model")
    out["vocab"] = ("model",)
    out["mlp"] = ("model",)
    return out


def spec_for(
    shape: tuple[int, ...],
    logical: tuple[str | None, ...],
    rules: Rules,
    mesh,
) -> Spec:
    """The spec for a concrete shape, with divisibility fallback."""
    assert len(shape) == len(logical), (shape, logical)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name, ())
        # drop trailing axes until the dim divides (replicate-on-mismatch);
        # also drop axes already used by another dim of this array.
        axes = tuple(a for a in axes if a not in used)
        while axes and dim % mesh_axis_size(mesh, axes) != 0:
            axes = axes[:-1]
        if not axes:
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def entry_axes(part) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh axis a spec names, in the order it names them."""
    return tuple(a for part in spec for a in entry_axes(part))


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the port's ``NamedSharding``.  It unpacks as
    ``(mesh, spec)`` and is a leaf of the port's trees."""
    mesh: Any
    spec: Spec

    def __iter__(self):
        return iter((self.mesh, self.spec))


def sharding_for(
    shape: tuple[int, ...],
    logical: tuple[str | None, ...],
    rules: Rules,
    mesh,
) -> Sharding:
    return Sharding(mesh, spec_for(shape, logical, rules, mesh))


def constrain(x, logical: tuple[str | None, ...], rules: Rules, mesh):
    """The reference's ``with_sharding_constraint``: the identity on the
    rank's local tensor.  The constraints on the model's path name the
    batch, which the train step and the engine have already split by
    rows, and layouts the sharded bodies produce themselves; the one
    constraint that moves data, prefill's K/V onto ``kv_seq``, is
    ``resharding.tube_reshard``."""
    del logical, rules, mesh
    return x


# --------------------------------------------------------- placement ------

def local_slice(shape: tuple[int, ...], spec: Spec, mesh,
                coord) -> tuple[slice, ...]:
    """The slice of a global array of ``shape`` that the rank at mesh
    coordinate ``coord`` (one index per mesh dim) holds under ``spec``,
    in JAX's device order."""
    sizes = axis_sizes(mesh)
    at = dict(zip(mesh.mesh_dim_names, coord))
    out = []
    for dim, part in zip(shape, spec):
        idx, n = 0, 1
        for a in entry_axes(part):
            idx, n = idx * sizes[a] + at[a], n * sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({part})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of every rank's slice under ``spec``."""
    return tuple(d // mesh_axis_size(mesh, entry_axes(part))
                 for d, part in zip(shape, spec))


def _cache(mesh) -> dict:
    """What the collectives derive from a mesh's layout and groups, kept
    on the mesh (neither changes over its life): each rank's coordinate
    and each axes tuple's ``_groups`` plan and ``axis_index``."""
    try:
        return mesh._repro_cache
    except AttributeError:
        mesh._repro_cache = {}
        return mesh._repro_cache


def coordinate(mesh, rank: int | None = None) -> tuple[int, ...]:
    """The mesh coordinate of a global rank (this process's by default)."""
    if rank is None:
        return tuple(mesh.get_coordinate())
    cache = _cache(mesh)
    if "coords" not in cache:
        ids = mesh.mesh.cpu().numpy()
        cache["coords"] = {int(ids[ix]): tuple(int(i) for i in ix)
                           for ix in np.ndindex(ids.shape)}
    try:
        return cache["coords"][rank]
    except KeyError:
        raise ValueError(f"rank {rank} is not on the mesh") from None


def _steps(mesh, axes: tuple[str, ...]):
    """How a collective over ``axes`` runs: [None] for one collective on
    the world group, when the axes are every axis of the mesh with more
    than one member and the mesh spans the world (at world size 1 that is
    a group of one, and the collective is still launched); otherwise one
    collective per axis with more than one member, minor axis first, on
    ``mesh.get_group(axis)``."""
    sizes = axis_sizes(mesh)
    wide = [a for a in axes if sizes[a] > 1]
    mesh_wide = {a for a, n in sizes.items() if n > 1}
    if set(wide) == mesh_wide and mesh.size() == dist.get_world_size():
        return [None]
    return list(reversed(wide))


def all_reduce_axes(t: torch.Tensor, mesh, axes: tuple[str, ...],
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ranks that differ only on ``axes``
    (the reference's ``psum``/``pmax`` over a tuple of axes: ``op=MAX`` is the
    softmax maximum of flash-decoding over a sequence-sharded cache)."""
    for a in _steps(mesh, axes):
        dist.all_reduce(t, op=op,
                        group=None if a is None else mesh.get_group(a))
        costs.collective("all-reduce", t)
    return t


def gather_full(local: torch.Tensor, shape: tuple[int, ...], spec: Spec,
                mesh, out: torch.Tensor | None = None) -> torch.Tensor:
    """The global array of ``shape`` whose slices under ``spec`` the ranks
    hold (``local`` is this rank's), on every rank: all-gathered over the
    spec's axes and reassembled by ``local_slice``.  Written into ``out``
    when given."""
    if out is None:
        out = torch.empty(shape, dtype=local.dtype, device=local.device)
    axes = spec_axes(spec)
    steps = _steps(mesh, axes)
    local = local.contiguous()
    if steps == [None]:
        world = dist.get_world_size()
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        costs.collective("all-gather", parts)
        for r, part in enumerate(parts):
            out[local_slice(shape, spec, mesh, coordinate(mesh, r))] = part
        return out
    # one axis at a time, minor first: a dim split over (a, b) is whole
    # over b after b's gather, then over a
    dims = {a: d for d, part in enumerate(spec) for a in entry_axes(part)}
    cur = local
    for a in steps:
        g = mesh.get_group(a)
        ranks = dist.get_process_group_ranks(g)
        parts = [torch.empty_like(cur) for _ in ranks]
        dist.all_gather(parts, cur, group=g)
        costs.collective("all-gather", parts)
        at = mesh.mesh_dim_names.index(a)
        order = sorted(range(len(ranks)),
                       key=lambda i: coordinate(mesh, ranks[i])[at])
        cur = torch.cat([parts[i] for i in order], dim=dims[a])
    out.copy_(cur)
    return out


# ------------------------------------------- collectives under autograd ---

def _chunk_key(mesh, axes: tuple[str, ...], rank: int) -> int:
    """The index of ``rank``'s chunk of a dim split over ``axes`` (major
    first), as ``local_slice`` numbers them."""
    sizes = axis_sizes(mesh)
    at = dict(zip(mesh.mesh_dim_names, coordinate(mesh, rank)))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + at[a]
    return idx


def _groups(mesh, axes: tuple[str, ...]):
    """``_steps(mesh, axes)`` as (group, ranks in group order, each rank's
    chunk index along the step's axes), minor axis first; made once per
    mesh and axes (``_cache``)."""
    cache = _cache(mesh)
    key = ("groups", axes)
    if key not in cache:
        cache[key] = _plan_groups(mesh, axes)
    return cache[key]


def _plan_groups(mesh, axes: tuple[str, ...]):
    out = []
    for a in _steps(mesh, axes):
        if a is None:
            ranks = list(range(dist.get_world_size()))
            out.append((None, ranks, [_chunk_key(mesh, axes, r)
                                      for r in ranks]))
        else:
            g = mesh.get_group(a)
            ranks = dist.get_process_group_ranks(g)
            out.append((g, ranks, [_chunk_key(mesh, (a,), r)
                                   for r in ranks]))
    return out


def gather_dim(t: torch.Tensor, mesh, axes: tuple[str, ...],
               dim: int) -> torch.Tensor:
    """The tensor whose chunks along ``dim``, split over ``axes`` in
    ``local_slice``'s order, the ranks hold (``t`` is this rank's)."""
    cur = t.contiguous()
    for g, ranks, keys in _groups(mesh, axes):
        parts = [torch.empty_like(cur) for _ in ranks]
        dist.all_gather(parts, cur, group=g)
        costs.collective("all-gather", parts)
        order = sorted(range(len(ranks)), key=keys.__getitem__)
        cur = parts[0] if len(parts) == 1 else torch.cat(
            [parts[i] for i in order], dim=dim)
    return cur


def reduce_scatter_dim(t: torch.Tensor, mesh, axes: tuple[str, ...],
                       dim: int) -> torch.Tensor:
    """``t`` summed over the ranks that differ on ``axes``, and this rank's
    chunk of the sum along ``dim`` (the transpose of ``gather_dim``)."""
    cur = t
    for g, ranks, keys in reversed(_groups(mesh, axes)):
        chunks = cur.chunk(max(keys) + 1, dim=dim)
        out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
        dist.reduce_scatter(out, [chunks[k].contiguous() for k in keys],
                            group=g)
        costs.collective("reduce-scatter", out)
        cur = out
    return cur


def local_chunk(t: torch.Tensor, mesh, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` split over ``axes`` (a
    tensor the ranks of those axes hold alike): the slice ``local_slice``
    gives, taken without a collective (the inverse of ``gather_dim``)."""
    if not axes:
        return t
    n = mesh_axis_size(mesh, axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} "
                         f"ways over {axes}")
    step = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axes) * step, step)


def axis_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's index over ``axes`` (major first): the chunk of a dim
    split over them that it holds (the reference's ``lax.axis_index``)."""
    if not axes:
        return 0
    cache = _cache(mesh)
    key = ("index", axes)
    if key not in cache:
        cache[key] = _chunk_key(mesh, axes, dist.get_rank())
    return cache[key]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g.clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_axes(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.mesh, ctx.axes, ctx.dim), None,
                None, None)


def copy_to(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axes``: a tensor the ranks of
    a model group hold alike, entering work they split among them."""
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The sum over ``axes`` of the ranks' partial ``x``; its gradient
    passes through to each rank's part."""
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def gather_from(x: torch.Tensor, mesh, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
    """``x`` whole along ``dim`` over ``axes`` (an all-gather); its
    gradient is reduce-scattered back to the rank's slice."""
    return _GatherFrom.apply(x, mesh, axes, dim) if axes else x
