"""Train step, PyTorch port of ``src/repro/training/train_step.py``:
microbatched gradient accumulation, then AdamW.

Microbatches are interleaved along the batch dim as the reference's
``_split_microbatches`` makes them: microbatch j takes rows j, j + a,
j + 2a, ...  With one microbatch the gradients stay in the parameters'
dtype; with more, each microbatch's gradients are added into f32
buffers and divided by their count, and the loss is the mean over
microbatches.  ``adamw_update`` then writes the parameters and the
optimizer state in place.  On one card the data-parallel world size is
1, so ``default_accum`` takes one batch row per microbatch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.training.optimizer import OptConfig, adamw_update


def default_accum(shape: ShapeSpec, cfg: ArchConfig | None = None) -> int:
    """One batch row per device per microbatch, at world size 1."""
    del cfg                     # the small-dense rule reads the mesh
    return max(1, shape.global_batch)


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


def build_train_step(cfg: ArchConfig, ctx, oc: OptConfig, accum: int):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``loss``, ``lr`` and ``grad_norm`` in the metrics
    (and ``xent``, ``aux`` with one microbatch, as the reference).
    ``params`` must be ``param.trainable``; it and ``opt_state`` are
    updated in place and returned."""

    def train_step(params, opt_state, batch):
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
        params, opt_state, om = adamw_update(oc, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step
