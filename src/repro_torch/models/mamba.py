"""Mamba (S6 selective SSM) mixer, PyTorch port of
``src/repro/models/mamba.py``.

The JAX package streams the sequence through fixed-size chunks: the
projections and the causal depthwise conv run per chunk, the state
recurrence per step inside it, all under ``lax.scan`` with the chunk
body checkpointed.  The port runs the same chunks and steps as Python
loops; in training the model checkpoints each pattern unit
(``model.apply_stack``), not each chunk.  Decode is the L == 1 case
carrying (conv tail, ssm state).  Dtypes follow the
reference step by step: the projections in x's dtype, ``+ dt_bias``
(f32) before the softplus, the recurrence in f32.

On a mesh (``ctx``), ``d_inner`` splits over the ``state_inner`` axes:
``in_x`` and ``in_z`` are column-parallel, the conv and the scan run on
the rank's channels, ``w_dt``, ``w_B`` and ``w_C`` contract over the
split ``d_inner`` (one ``reduce_from`` of the three partial sums a step,
then ``copy_to`` back into the split channels), ``dt_proj`` is
column-parallel and ``out`` row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import costs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import copy_to, reduce_from
from repro_torch.models.param import PSpec


def mamba_specs(cfg: ArchConfig):
    D, N = cfg.d_model, cfg.d_state
    din = cfg.d_inner
    dtr = max(D // 16, 1)
    return {
        "in_x": PSpec((D, din), ("embed", "state_inner")),
        "in_z": PSpec((D, din), ("embed", "state_inner")),
        "conv_w": PSpec((cfg.d_conv, din), ("conv", "state_inner"), scale=1.0),
        "conv_b": PSpec((din,), ("state_inner",), init="zeros"),
        "w_dt": PSpec((din, dtr), ("state_inner", None)),
        "dt_proj": PSpec((dtr, din), (None, "state_inner")),
        "dt_bias": PSpec((din,), ("state_inner",), torch.float32, "zeros"),
        "w_B": PSpec((din, N), ("state_inner", None)),
        "w_C": PSpec((din, N), ("state_inner", None)),
        "A_log": PSpec((din, N), ("state_inner", None), torch.float32,
                       "s4d_log"),
        "D_skip": PSpec((din,), ("state_inner",), torch.float32, "ones"),
        "out": PSpec((din, D), ("state_inner", "embed")),
    }


def mamba_state_shapes(cfg: ArchConfig, batch: int):
    """Decode-time carried state: (conv tail, ssm state)."""
    din = cfg.d_inner
    return {
        "conv": ((batch, cfg.d_conv - 1, din), cfg.cache_jdtype),
        "ssm": ((batch, din, cfg.d_state), torch.float32),
    }


def _inner_proj(p, x_t, split):
    """``x_t``'s projections to the dt rank, B and C.  Each contracts
    over ``d_inner``: on a split (``(mesh, axes)``) the rank's are partial
    sums, summed over the axes in one all-reduce, whose result feeds the
    split channels again."""
    parts = (x_t @ p["w_dt"], x_t @ p["w_B"], x_t @ p["w_C"])
    if split is None:
        return parts
    mesh, axes = split
    whole = copy_to(reduce_from(torch.cat(parts, dim=-1), mesh, axes),
                    mesh, axes)
    return whole.split([t.shape[-1] for t in parts], dim=-1)


def _chunk_step(p, h, x_t, split=None):
    """One recurrence step.  x_t: (B, din) post-conv activations.  The
    state h (B, din, N) is updated in place (at decode it is the cache's
    slot) and returned; where autograd records the step, a new state is
    returned instead, since the backward reads every step's state."""
    dtr, Bm, Cm = _inner_proj(p, x_t, split)
    dt = F.softplus(dtr @ p["dt_proj"] + p["dt_bias"]).float()     # (B, din)
    Bm = Bm.float()                                                # (B, N)
    Cm = Cm.float()                                                # (B, N)
    A = -torch.exp(p["A_log"].float())                             # (din, N)
    dA = torch.exp(dt[..., None] * A[None])                        # (B, din, N)
    xf = x_t.float()
    dBx = dt[..., None] * Bm[:, None, :] * xf[..., None]
    if torch.is_grad_enabled() and (h.requires_grad or dA.requires_grad
                                    or dBx.requires_grad):
        h = h * dA + dBx
    else:
        h.mul_(dA).add_(dBx)                                       # (B, din, N)
    y = torch.einsum("bdn,bn->bd", h, Cm)                          # (B, din)
    y = y + p["D_skip"] * xf
    return h, y.to(x_t.dtype)


def _conv_chunk(x, tail, w, b):
    """Causal depthwise conv over one chunk; returns (out, new_tail).

    x: (B, Q, din); tail: (B, d_conv-1, din)."""
    K = w.shape[0]
    xp = torch.cat([tail, x], dim=1)                      # (B, Q+K-1, din)
    Q = x.shape[1]
    out = sum(xp[:, j:j + Q] * w[j] for j in range(K)) + b
    return out, xp[:, -(K - 1):]


def mamba_forward(x, p, cfg: ArchConfig, *, chunk: int = 64, state=None,
                  ctx=None):
    """x: (B, L, D) -> (y, final_state).  L must be a multiple of the
    chunk (or at most one chunk), or 1 for decode.  A given ``state``'s
    ssm is updated in place; the conv tail is returned anew.  With a
    ``ctx`` on a mesh, ``p`` holds the rank's slices (module docstring)
    and the state the rank's channels."""
    B, L, D = x.shape
    split = None
    if ctx is not None and ctx.mesh is not None:
        specs = mamba_specs(cfg)
        p = ctx.gathered_tree(p, specs)
        axes = ctx.axes(specs["in_x"], 1)
        if axes:
            split = (ctx.mesh, axes)
            x = copy_to(x, ctx.mesh, axes)
    din = p["in_x"].shape[1]

    if state is None:
        state = {
            "conv": torch.zeros((B, cfg.d_conv - 1, din), dtype=x.dtype,
                                device=x.device),
            "ssm": torch.zeros((B, din, cfg.d_state), dtype=torch.float32,
                               device=x.device),
        }

    if L == 1:  # decode
        xz = x[:, 0] @ p["in_x"]
        z = x[:, 0] @ p["in_z"]
        conv_out, new_tail = _conv_chunk(xz[:, None], state["conv"],
                                         p["conv_w"], p["conv_b"])
        xa = F.silu(conv_out[:, 0])
        h, y = _chunk_step(p, state["ssm"], xa, split)
        out = _out(p, y * F.silu(z), split)
        return out[:, None], {"conv": new_tail, "ssm": h}

    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    h, tail = state["ssm"], state["conv"]
    outs = []
    for x_c in costs.each(x.split(chunk, dim=1)):
        xz = x_c @ p["in_x"]                                  # (B, Q, din)
        z = x_c @ p["in_z"]
        conv_out, tail = _conv_chunk(xz, tail, p["conv_w"], p["conv_b"])
        xa = F.silu(conv_out)
        ys = []
        for t in costs.trips(chunk):
            h, y = _chunk_step(p, h, xa[:, t], split)
            ys.append(y)
        ys = torch.stack(costs.fill(ys, chunk), dim=1)        # (B, Q, din)
        outs.append(_out(p, ys * F.silu(z), split))           # (B, Q, D)
    return torch.cat(costs.fill(outs, L // chunk), dim=1), \
        {"conv": tail, "ssm": h}


def _out(p, y, split):
    """The row-parallel output projection: summed over the split."""
    out = y @ p["out"]
    return out if split is None else reduce_from(out, *split)
