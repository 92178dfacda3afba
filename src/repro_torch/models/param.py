"""Parameter-spec DSL, PyTorch port.

Models declare their parameters as trees (dicts and lists) of ``PSpec``
(shape + logical axes + init), as ``src/repro/models/param.py`` does.
From one spec tree the port derives real tensors (``initialize``) and
the parameter count; ``from_numpy`` carries the JAX package's weights
(and optimizer state) over into a tree of the same structure, and
``trainable`` marks a tree's leaves for autograd.  On a mesh, the
logical axes give each leaf its ``shardings`` and a rank its
``shard_local`` slices (``distributed/mesh.py``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones | s4d_log
    scale: float = 1.0         # stddev multiplier on fan-in-scaled normal
    fan_in: int = 0            # 0 -> shape[-2]; 3D+ weights set it exactly

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(f, tree):
    """Apply ``f`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v) for v in tree)
    return f(tree)


def tree_leaves_with_paths(tree, prefix: str = ""):
    """(path, leaf) pairs in the order ``jax.tree_util`` flattens the same
    tree: dict keys sorted, list items in order; path parts joined by /."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list:
    """The leaves in ``tree_leaves_with_paths`` order."""
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def tree_unflatten(like, leaves):
    """``leaves``, in ``tree_leaves_with_paths`` order, in the structure
    of the tree ``like``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(like)


def stack(tree, n: int, logical: str = "stack"):
    """Prefix every leaf with a stacking dim (layers stored stacked)."""
    return tree_map(
        lambda p: PSpec((n, *p.shape), (logical, *p.logical), p.dtype, p.init,
                        p.scale, p.fan_in),
        tree,
    )


def shardings(tree, rules, mesh):
    """The ``Sharding`` (mesh, spec) of every leaf of a spec tree under
    ``rules``."""
    from repro_torch.distributed.mesh import sharding_for
    return tree_map(lambda p: sharding_for(p.shape, p.logical, rules, mesh),
                    tree)


def shard_local(tree, rules, mesh, coord=None):
    """The slice of every leaf of a spec tree that the rank at mesh
    coordinate ``coord`` (this process's by default) holds under
    ``rules``: a tree of index tuples for ``from_numpy(local=...)``."""
    from repro_torch.distributed.mesh import coordinate, local_slice, spec_for
    coord = coordinate(mesh) if coord is None else tuple(coord)
    return tree_map(lambda p: _Index(local_slice(
        p.shape, spec_for(p.shape, p.logical, rules, mesh), mesh, coord)),
        tree)


@dataclass(frozen=True)
class _Index:
    """One leaf's slice, kept whole by ``tree_map`` (a bare tuple would be
    walked as a subtree)."""
    index: tuple


def abstract(tree):
    """Shape-and-dtype stand-ins for a spec tree: tensors on the ``meta``
    device, which hold no storage (the JAX package's ShapeDtypeStructs)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), tree)


def _leaf_seed(seed: int, name: str) -> int:
    # zlib.crc32 (not hash()): Python string hashing is randomized per
    # process, which would give every run different params.
    return (seed * 0x9E3779B1 + zlib.crc32(name.encode())) % (2 ** 63)


def initialize(tree, seed: int, device="cuda"):
    """Real tensors on ``device``; each normal leaf draws from its own
    ``torch.Generator`` seeded from ``seed`` and the crc32 of the leaf's
    path, as the JAX package folds the path into its key.  Numbers are
    generated on the device itself, so a 2.7 B-parameter model never
    passes through the host.  The CPU and CUDA generators give different
    numbers for one seed: tests that compare devices initialise once and
    copy."""
    device = torch.device(device)

    def make(path, spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "s4d_log":
            n = spec.shape[-1]
            row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=device))
            return row.expand(spec.shape).to(spec.dtype).contiguous()
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, path))
        fan_in = spec.fan_in or (
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        std = spec.scale / np.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(spec.dtype)

    def walk(t, prefix=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{i}/") for i, v in enumerate(t))
        return make(prefix[:-1], t)

    return walk(tree)


def count_params(tree) -> int:
    return sum(int(np.prod(p.shape)) for _, p in tree_leaves_with_paths(tree))


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")     # a C-ordered copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: JAX hands it over as
        # ml_dtypes.bfloat16, which torch cannot read, so pass the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_numpy(tree, device="cuda", local=None):
    """The JAX package's parameter, cache or optimizer-state tree, as
    numpy arrays, into the port's tree of the same structure, shapes and
    dtypes on ``device``: bf16 through its bits, the int8 moments'
    {"q", "scale"} leaves and the 0-d int32 ``step`` as they are.  With
    ``local`` (``shard_local``'s tree), each leaf is cut to the rank's
    slice before it is copied, so a rank builds only its own shards."""
    device = torch.device(device)
    if local is None:
        return tree_map(lambda a: _to_tensor(a).to(device), tree)
    flat = [_to_tensor(np.asarray(a)[ix.index]).to(device) for a, ix in
            zip(tree_leaves(tree), tree_leaves(local))]
    return tree_unflatten(tree, flat)


def trainable(tree):
    """Mark every floating-point leaf of a parameter tree as requiring a
    gradient (in place); returns the tree."""
    return tree_map(lambda t: t.requires_grad_() if t.is_floating_point()
                    else t, tree)
