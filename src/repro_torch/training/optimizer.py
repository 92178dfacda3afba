"""AdamW with LR schedules (cosine, WSD) and optional 8-bit blockwise
moments, PyTorch port of ``src/repro/training/optimizer.py``.

The optimizer state mirrors the parameter tree: m and v as f32 leaves of
the parameter's shape or, in int8 mode, as {"q": int8 codes, "scale":
f32 per-128-block scales} (2.03 bytes a parameter instead of 8),
dequantized and requantized inside the update, plus an int32 ``step``.
``adamw_update`` keeps the reference's arithmetic (f32 math, the result
cast to the parameter's dtype, weight decay on every leaf, bias
correction from step + 1) and writes parameters and moments in place.
MiniCPM's warmup-stable-decay (WSD) schedule is first-class.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import param as PM
from repro_torch.models.param import PSpec, tree_map

_QBLOCK = 128
_QMIN_SIZE = 65_536     # leaves smaller than this stay f32
#: elements of one slice of a leaf's update: the f32 temporaries of a
#: 40-layer stacked leaf stay ~128 MB each instead of several GB
_UPDATE_SLICE = 1 << 25


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | wsd
    stable_frac: float = 0.8       # WSD: fraction of steps at peak LR
    grad_clip: float = 1.0
    state_dtype: str = "f32"       # f32 | int8


def _padded_last(n: int) -> int:
    return -(-n // _QBLOCK) * _QBLOCK


def _f32(value, device) -> torch.Tensor:
    """A 0-d f32 constant on ``device``, where the reference's Python
    float meets an f32 array as a weak type.  A tensor on the operand's
    own device, not a Python scalar: CUDA divides by a CPU scalar as a
    multiplication by its reciprocal."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_blockwise(x):
    """f32 (..., L) -> {"q": int8 (..., Lp), "scale": f32 (..., Lp/128)};
    codes rounded half to even, as ``jnp.round`` does."""
    last = x.shape[-1]
    lp = _padded_last(last)
    xb = F.pad(x, (0, lp - last)).reshape(*x.shape[:-1], lp // _QBLOCK,
                                           _QBLOCK)
    scale = xb.abs().amax(dim=-1) / _f32(127.0, x.device) \
        + _f32(1e-12, x.device)
    q = torch.round(xb / scale[..., None]).to(torch.int8)
    return {"q": q.reshape(*x.shape[:-1], lp), "scale": scale}


def dequantize_blockwise(s, last: int):
    q = s["q"]
    lp = q.shape[-1]
    xb = q.reshape(*q.shape[:-1], lp // _QBLOCK, _QBLOCK).float()
    x = (xb * s["scale"][..., None]).reshape(*q.shape[:-1], lp)
    return x[..., :last]


def _quantized_leaf(p: PSpec) -> bool:
    return math.prod(p.shape) >= _QMIN_SIZE


def _moment_pspec(p: PSpec, state_dtype: str):
    if state_dtype == "int8" and _quantized_leaf(p):
        lp = _padded_last(p.shape[-1])
        return {
            "q": PSpec((*p.shape[:-1], lp), p.logical, torch.int8, "zeros"),
            "scale": PSpec((*p.shape[:-1], lp // _QBLOCK),
                           p.logical, torch.float32, "zeros"),
        }
    return PSpec(p.shape, p.logical, torch.float32, "zeros")


def lr_at(oc: OptConfig, step):
    """The learning rate at ``step`` (int or tensor) as a 0-d f32 tensor,
    computed in f32 on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    c = lambda v: _f32(v, step.device)          # noqa: E731
    warm = torch.minimum(step / c(max(oc.warmup_steps, 1)), c(1.0))
    if oc.schedule == "wsd":
        # warmup -> stable plateau -> 1-sqrt decay (MiniCPM recipe)
        decay_start = oc.stable_frac * oc.total_steps
        frac = torch.clamp(
            (step - c(decay_start)) / c(max(oc.total_steps - decay_start, 1)),
            0.0, 1.0)
        decay = c(1.0) - torch.sqrt(frac)
    else:
        frac = torch.clamp(step / c(oc.total_steps), 0.0, 1.0)
        # the f32 cosine correctly rounded (through f64), as XLA's is;
        # torch's f32 cos is an ulp off at some steps, and 1 + cos cancels
        # toward the end of the schedule, which magnifies it
        cos = torch.cos((c(math.pi) * frac).double()).float()
        decay = c(0.5) * (c(1.0) + cos)
    return c(oc.lr) * warm * decay


def opt_pspecs(param_specs, state_dtype: str = "f32"):
    """PSpec tree for (m, v): f32 or int8-blockwise per OptConfig."""
    mk = lambda p: _moment_pspec(p, state_dtype)    # noqa: E731
    return {"m": tree_map(mk, param_specs), "v": tree_map(mk, param_specs),
            "step": PSpec((), (), torch.int32, "zeros")}


def zero1_shardings(param_specs, state_dtype: str, rules, mesh):
    """The ``Sharding`` of every parameter's moments under the optimizer
    rules (``mesh.make_opt_rules``), one per parameter leaf.  An int8
    moment's codes and scales take the parameter's spec; a shard boundary
    that would split a 128-block of the last axis raises."""
    from repro_torch.distributed.mesh import entry_axes, mesh_axis_size
    shd = PM.shardings(param_specs, rules, mesh)
    if state_dtype != "int8":
        return shd
    for (path, p), (_, s) in zip(PM.tree_leaves_with_paths(param_specs),
                                 PM.tree_leaves_with_paths(shd)):
        if not _quantized_leaf(p) or not p.shape:
            continue
        n = mesh_axis_size(mesh, entry_axes(s.spec[-1]))
        mom = _moment_pspec(p, state_dtype)
        same = all(PM.shardings(mom[k], rules, mesh).spec == s.spec
                   for k in mom)
        if not same or (n > 1 and p.shape[-1] % (_QBLOCK * n)):
            raise ValueError(
                f"{path}: int8 moments split {p.shape[-1]} columns {n} "
                f"ways across 128-blocks ({s.spec})")
    return shd


def init_opt_state(param_specs, state_dtype: str = "f32", device="cuda", *,
                   rules=None, mesh=None):
    """The zero optimizer state for ``param_specs`` on ``device``.  With
    ``rules`` and ``mesh``, only this rank's moment shards: each moment
    leaf's ``local_slice`` under its own spec (the parameter's, under
    ZeRO-1's rules, ``zero1_shardings``; an int8 moment's codes and
    scales may split its last axis otherwise, ``adamw_update``)."""
    if mesh is None:
        return PM.initialize(opt_pspecs(param_specs, state_dtype), 0, device)
    from repro_torch.distributed.mesh import local_shape, spec_for
    mk = tree_map(lambda x: dataclasses.replace(x, shape=local_shape(
        x.shape, spec_for(x.shape, x.logical, rules, mesh), mesh)),
        opt_pspecs(param_specs, state_dtype)["m"])
    return PM.initialize({"m": mk, "v": mk,
                          "step": PSpec((), (), torch.int32, "zeros")},
                         0, device)


def _block_split(p_shd, m_shd, local_last: int):
    """For a parameter slice whose last dim holds ``local_last`` columns,
    with int8 moments (``p_shd`` the parameter's sharding, ``m_shd`` its
    moment's {"q", "scale"} shardings): None where each rank's codes and
    scales are the whole 128-blocks of its own columns; otherwise (mesh,
    the axes that split the parameter's last dim, its codes', its
    scales'), and the update regathers the last dim to quantize whole
    blocks, as the reference's one array does."""
    from repro_torch.distributed.mesh import entry_axes
    axes = [entry_axes(p_shd.spec[-1]), entry_axes(m_shd["q"].spec[-1]),
            entry_axes(m_shd["scale"].spec[-1])]
    if axes[0] == axes[1] == axes[2] and local_last % _QBLOCK == 0:
        return None
    return (p_shd.mesh, *axes)


def _dequantize_split(s, last: int, split):
    """The rank's columns of an int8 moment whose blocks straddle ranks:
    codes and scales gathered over the last dim, dequantized, cut."""
    from repro_torch.distributed.mesh import gather_dim, local_chunk
    mesh, pa, qa, sa = split
    whole = {"q": gather_dim(s["q"], mesh, qa, -1),
             "scale": gather_dim(s["scale"], mesh, sa, -1)}
    return local_chunk(dequantize_blockwise(whole, last), mesh, pa, -1)


def _quantize_split(x, st, split):
    """``x`` (the rank's columns, f32) into the moment ``st`` in place:
    the last dim gathered, quantized in whole blocks, each rank keeping
    its codes and scales."""
    from repro_torch.distributed.mesh import gather_dim, local_chunk
    mesh, pa, qa, sa = split
    qs = quantize_blockwise(gather_dim(x, mesh, pa, -1))
    st["q"].copy_(local_chunk(qs["q"], mesh, qa, -1))
    st["scale"].copy_(local_chunk(qs["scale"], mesh, sa, -1))


def _zip_leaves(p, *trees):
    """(leaf of ``p``, the other trees' entries at its place), in the
    reference's leaf order (dict keys sorted).  An entry may be a whole
    subtree where ``p`` has a leaf: an int8 moment's {"q", "scale"}."""
    if isinstance(p, dict):
        for k in sorted(p):
            yield from _zip_leaves(p[k], *(t[k] for t in trees))
    elif isinstance(p, (list, tuple)):
        for i, x in enumerate(p):
            yield from _zip_leaves(x, *(t[i] for t in trees))
    else:
        yield (p, *trees)


def global_norm(grads, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's sum of squares, in f32.  With ``shardings`` (each leaf's
    ``Sharding``, ``grads`` the rank's slices), a leaf's sum is taken
    over the axes its spec splits (one all-reduce for the leaves that
    split over the same axes); a replicated leaf counts once."""
    sq = [g.float().square().sum() for (g,) in _zip_leaves(grads)]
    if shardings is not None:
        from repro_torch.distributed.mesh import all_reduce_axes, spec_axes
        shd, split = PM.tree_leaves(shardings), {}
        for i, s in enumerate(shd):
            if spec_axes(s.spec):
                split.setdefault(tuple(sorted(spec_axes(s.spec))),
                                 []).append(i)
        for axes, idx in split.items():
            vec = all_reduce_axes(torch.stack([sq[i] for i in idx]),
                                  shd[idx[0]].mesh, axes)
            for i, v in zip(idx, vec.unbind()):
                sq[i] = v
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, in their own dtypes, and the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gn.device) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state, shardings=None,
                 param_shardings=None, moment_shardings=None):
    """One AdamW step.  Writes ``params`` and ``opt_state`` (m, v and the
    step) in place and returns (params, opt_state, metrics).  The
    gradient clip is folded into the update: each leaf's gradient is
    scaled in f32 and rounded back to its own dtype, as the reference's
    ``clip_by_global_norm`` leaves it, before the moments read it.

    With ``shardings`` (``zero1_shardings``: ZeRO-1), the moments are this
    rank's shards and the parameters and gradients whole: the rank
    updates its ``local_slice`` of each parameter from its moment shard,
    then all-gathers the new parameter over the spec's axes.  With
    ``param_shardings`` alone, every leaf is the rank's slice of its
    parameter and updates in place; the norm reads them
    (``global_norm``), and with ``moment_shardings`` (the moments' own
    shardings, ``PM.shardings(opt_pspecs(...)["m"], ...)``) an int8
    moment whose 128-blocks straddle the ranks that split its
    parameter's last dim (``_block_split``) is dequantized and
    requantized whole along that dim, gathered, so its codes and scales
    are the reference's."""
    from repro_torch.distributed.mesh import mesh_axis_size
    gnorm = global_norm(grads, param_shardings)
    dev = gnorm.device
    c = lambda v: _f32(v, dev)          # noqa: E731
    clip = torch.clamp(c(oc.grad_clip) / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    opt_state["step"].add_(1)
    stepf = opt_state["step"].float()
    lr = lr_at(oc, opt_state["step"])
    b1c = c(1.0) - torch.pow(c(oc.b1), stepf)
    b2c = c(1.0) - torch.pow(c(oc.b2), stepf)
    b1, b2, one_b1, one_b2 = c(oc.b1), c(oc.b2), c(1 - oc.b1), c(1 - oc.b2)
    eps, wd = c(oc.eps), c(oc.weight_decay)

    def upd(p, g, m, v, split=None):
        quantized = isinstance(m, dict)
        last = p.shape[-1] if p.dim() else 1
        gf = g.float() * clip
        if g.dtype != torch.float32:
            gf = gf.to(g.dtype).float()
        if split is not None:
            last = p.shape[-1] * mesh_axis_size(split[0], split[1])
            mf = _dequantize_split(m, last, split)
            vf = _dequantize_split(v, last, split)
        else:
            mf = dequantize_blockwise(m, last) if quantized else m
            vf = dequantize_blockwise(v, last) if quantized else v
        mf = mf * b1 + one_b1 * gf
        vf = vf * b2 + one_b2 * gf.square()
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + eps) + wd * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        for st, new in ((m, mf), (v, vf)):
            if split is not None:
                _quantize_split(new, st, split)
            elif quantized:
                qs = quantize_blockwise(new)
                st["q"].copy_(qs["q"])
                st["scale"].copy_(qs["scale"])
            else:
                st.copy_(new)

    def update_leaf(p, g, m, v, split=None):
        if p.numel() == 0:          # a run of no layer (fewer than a unit)
            return
        if p.dim() < 2:
            upd(p, g, m, v, split)
            return
        # elementwise along the leading dim (the int8 blocks run along the
        # last), so slices of it update exactly as the whole leaf would;
        # a contiguous leaf is taken as the rows of its last dim first
        # (views, written in place), so that a leaf stacked (1, 1, ...)
        # slices too
        states = [t for st in (m, v) for t in (
            st.values() if isinstance(st, dict) else [st])]
        if all(t.is_contiguous() for t in (p, g, *states)):
            rows = lambda t: t.view(-1, t.shape[-1])    # noqa: E731
            p, g = rows(p), rows(g)
            m, v = ({k: rows(t) for k, t in st.items()}
                    if isinstance(st, dict) else rows(st) for st in (m, v))
        n = max(1, _UPDATE_SLICE // max(p[0].numel(), 1))
        parts = [t.split(n) for t in (p, g)]
        for st in (m, v):
            parts.append([dict(zip(st, qs)) for qs in
                          zip(*(st[k].split(n) for k in st))]
                         if isinstance(st, dict) else st.split(n))
        for args in zip(*parts):
            upd(*args, split)

    if shardings is None:
        leaves = _zip_leaves(params, grads, opt_state["m"], opt_state["v"])
        if moment_shardings is None:
            for p, g, m, v in leaves:
                update_leaf(p, g, m, v)
        else:
            for (p, g, m, v), (ps, ms) in zip(
                    leaves, _zip_leaves(param_shardings, moment_shardings)):
                split = None
                if isinstance(m, dict) and p.dim():
                    split = _block_split(ps, ms, p.shape[-1])
                update_leaf(p, g, m, v, split)
        return params, opt_state, {"lr": lr, "grad_norm": gnorm}

    from repro_torch.distributed.mesh import (
        coordinate, gather_full, local_slice, spec_axes)
    for p, g, m, v, s in _zip_leaves(params, grads, opt_state["m"],
                                     opt_state["v"], shardings):
        coord = coordinate(s.mesh)
        sl = local_slice(tuple(p.shape), s.spec, s.mesh, coord)
        update_leaf(p[sl], g[sl], m, v)
        if spec_axes(s.spec):
            gather_full(p[sl], tuple(p.shape), s.spec, s.mesh, out=p)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
