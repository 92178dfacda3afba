"""Train step, PyTorch port of ``src/repro/training/train_step.py``:
microbatched gradient accumulation, then AdamW.

Microbatches are interleaved along the batch dim as the reference's
``_split_microbatches`` makes them: microbatch j takes rows j, j + a,
j + 2a, ...  With one microbatch the gradients stay in the parameters'
dtype; with more, each microbatch's gradients are added into f32
buffers and divided by their count, and the loss is the mean over
microbatches.  ``adamw_update`` then writes the parameters and the
optimizer state in place.

On a mesh (``ctx.mesh``) the step runs on every rank: the rank takes its
rows of the global batch (contiguous, in the ``batch`` spec's chunk
order, ``mesh.local_slice``), runs its microbatches on its slices of the
parameters, and averages each gradient leaf in f32 over the data axes
and the axes that split the batch: summed, then divided by their size
(gloo has no average).  A leaf its spec splits over a data axis (FSDP)
arrives summed over that axis already (``mesh.gather_from``'s
reduce-scatter), so only the rest of the axes are all-reduced; the loss
and metrics are averaged likewise.  The reference's loss is a token
mean over the global batch and the shards are equal, so the mean of
rank means is the global mean.  The clip's norm sums each leaf over the
axes its slices split (``optimizer.global_norm``).  With ``shardings``
the optimizer state is ZeRO-1's (``optimizer.zero1_shardings``), for the
small-dense cells, whose parameters are whole on every rank; otherwise
the moments are slices of their parameter's shape and the update runs
on the rank's slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.mesh import (
    all_reduce_axes, coordinate, data_axes, local_slice, mesh_axis_size,
    spec_axes, spec_for, use_small_dense_dp)
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.training.optimizer import OptConfig, adamw_update


def default_accum(shape: ShapeSpec, mesh=None,
                  cfg: ArchConfig | None = None) -> int:
    """One batch row per device per microbatch (when divisible); without
    a mesh the world is one device."""
    if mesh is None:
        return max(1, shape.global_batch)
    dp = mesh_axis_size(mesh, data_axes(mesh))
    if cfg is not None and use_small_dense_dp(cfg, shape, mesh):
        # batch shards over EVERY axis: one row per device, no accum
        dp *= mesh_axis_size(mesh, ("model",))
    if shape.global_batch % dp:
        return 1
    return max(1, shape.global_batch // dp)


def local_rows(ctx, batch):
    """(the rank's rows of every input, the mesh axes that split them)."""
    coord = coordinate(ctx.mesh)
    out, axes = {}, ()
    for k, a in batch.items():
        logical = ("batch",) + (None,) * (a.dim() - 1)
        spec = spec_for(tuple(a.shape), logical, ctx.rules, ctx.mesh)
        out[k] = a[local_slice(tuple(a.shape), spec, ctx.mesh, coord)]
        axes = spec_axes(spec)
    return out, axes


def split_microbatches(batch, accum: int) -> list[dict]:
    """The ``accum`` interleaved microbatches of ``batch``."""
    for name, a in batch.items():
        if a.shape[0] % accum:
            raise ValueError(f"{name}: batch {a.shape[0]} is not a "
                             f"multiple of accum {accum}")
    return [{k: a[j::accum] for k, a in batch.items()}
            for j in range(accum)]


def value_and_grad(cfg: ArchConfig, ctx, params, batch):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (``param.trainable``), in the leaves'
    dtypes and in the tree's structure; a leaf the loss does not read
    gets zeros, as JAX gives it."""
    loss, metrics = M.loss_fn(cfg, ctx, params, batch)
    grads = torch.autograd.grad(loss, PM.tree_leaves(params),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            PM.tree_unflatten(params, grads))


def build_train_step(cfg: ArchConfig, ctx, oc: OptConfig, accum: int,
                     shardings=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``loss``, ``lr`` and ``grad_norm`` in the metrics
    (and ``xent``, ``aux`` with one microbatch, as the reference).
    ``params`` must be ``param.trainable``; it and ``opt_state`` are
    updated in place and returned.  On a mesh, ``batch`` is the global
    batch, ``params`` the rank's slices and ``shardings`` the moments'
    under ZeRO-1."""
    pshd = None
    if ctx.mesh is not None:
        pshd = PM.shardings(M.model_specs(cfg), ctx.rules, ctx.mesh)

    def train_step(params, opt_state, batch):
        axes = None
        if ctx.mesh is not None:
            batch, axes = local_rows(ctx, batch)
        if accum == 1:
            loss, metrics, grads = value_and_grad(cfg, ctx, params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in PM.tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for mb in split_microbatches(batch, accum):
                lmb, _, g = value_and_grad(cfg, ctx, params, mb)
                for a, gl in zip(acc, PM.tree_leaves(g)):
                    a.add_(gl)
                del g
                loss = loss + lmb
            n = torch.tensor(float(accum), device=loss.device)
            grads = PM.tree_unflatten(params, [a.div_(n) for a in acc])
            loss = loss / n
            metrics = {}
        if axes is not None:
            grads, loss, metrics = _mean_over(
                ctx.mesh, tuple(dict.fromkeys(ctx.data_axes + axes)), grads,
                pshd, dict(metrics, loss=loss))
        params, opt_state, om = adamw_update(oc, params, grads, opt_state,
                                             shardings, pshd)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def _mean_over(mesh, axes, grads, shardings, scalars):
    """(grads, loss, other metrics) averaged over the ranks that differ on
    ``axes``: each gradient leaf in f32, one leaf at a time, all-reduced
    over the axes its spec does not split (``gather_from`` summed it over
    the others), then divided by their size; the scalars in one more
    all-reduce."""
    leaves = PM.tree_leaves(grads)
    n = torch.tensor(float(mesh_axis_size(mesh, axes)),
                     device=leaves[0].device)
    out = []
    for g, s in zip(leaves, PM.tree_leaves(shardings)):
        rest = tuple(a for a in axes if a not in spec_axes(s.spec))
        if not rest:
            # in its own dtype: the quotient is rounded once, as it is
            # through f32
            out.append(g.div_(n))
            continue
        gf = g.float() if g.dtype != torch.float32 else g
        all_reduce_axes(gf, mesh, rest)
        gf.div_(n)
        out.append(gf if gf is g else gf.to(g.dtype))
    names = sorted(scalars)
    vec = torch.stack([torch.as_tensor(scalars[k], device=n.device).float()
                       for k in names])
    all_reduce_axes(vec, mesh, axes).div_(n)
    red = dict(zip(names, vec.unbind()))
    return PM.tree_unflatten(grads, out), red.pop("loss"), red
