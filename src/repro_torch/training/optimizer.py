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
    ``rules`` and ``mesh`` (ZeRO-1), only this rank's moment shards: each
    moment leaf's ``local_slice`` under ``zero1_shardings``."""
    if mesh is None:
        return PM.initialize(opt_pspecs(param_specs, state_dtype), 0, device)
    from repro_torch.distributed.mesh import local_shape
    shd = PM.tree_leaves(zero1_shardings(param_specs, state_dtype, rules,
                                         mesh))

    def cut(p, s):
        return tree_map(lambda x: dataclasses.replace(
            x, shape=local_shape(x.shape, s.spec, mesh)),
            _moment_pspec(p, state_dtype))
    mk = PM.tree_unflatten(param_specs, [
        cut(p, s) for p, s in zip(PM.tree_leaves(param_specs), shd)])
    return PM.initialize({"m": mk, "v": mk,
                          "step": PSpec((), (), torch.int32, "zeros")},
                         0, device)


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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's sum of squares, in f32."""
    sq = [g.float().square().sum() for (g,) in _zip_leaves(grads)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, in their own dtypes, and the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gn.device) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt_state, shardings=None):
    """One AdamW step.  Writes ``params`` and ``opt_state`` (m, v and the
    step) in place and returns (params, opt_state, metrics).  The
    gradient clip is folded into the update: each leaf's gradient is
    scaled in f32 and rounded back to its own dtype, as the reference's
    ``clip_by_global_norm`` leaves it, before the moments read it.

    With ``shardings`` (``zero1_shardings``: ZeRO-1), the moments are this
    rank's shards and the parameters and gradients whole: the rank
    updates its ``local_slice`` of each parameter from its moment shard,
    then all-gathers the new parameter over the spec's axes."""
    gnorm = global_norm(grads)
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

    def upd(p, g, m, v):
        quantized = isinstance(m, dict)
        last = p.shape[-1] if p.dim() else 1
        gf = g.float() * clip
        if g.dtype != torch.float32:
            gf = gf.to(g.dtype).float()
        mf = dequantize_blockwise(m, last) if quantized else m
        vf = dequantize_blockwise(v, last) if quantized else v
        mf = mf * b1 + one_b1 * gf
        vf = vf * b2 + one_b2 * gf.square()
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + eps) + wd * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        for st, new in ((m, mf), (v, vf)):
            if quantized:
                qs = quantize_blockwise(new)
                st["q"].copy_(qs["q"])
                st["scale"].copy_(qs["scale"])
            else:
                st.copy_(new)

    def update_leaf(p, g, m, v):
        if p.dim() < 2:
            upd(p, g, m, v)
            return
        # elementwise along the leading dim (the int8 blocks run along the
        # last), so slices of it update exactly as the whole leaf would
        n = max(1, _UPDATE_SLICE // max(p[0].numel(), 1))
        parts = [t.split(n) for t in (p, g)]
        for st in (m, v):
            parts.append([dict(zip(st, qs)) for qs in
                          zip(*(st[k].split(n) for k in st))]
                         if isinstance(st, dict) else st.split(n))
        for args in zip(*parts):
            upd(*args)

    if shardings is None:
        for p, g, m, v in _zip_leaves(params, grads, opt_state["m"],
                                      opt_state["v"]):
            update_leaf(p, g, m, v)
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
