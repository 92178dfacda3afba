"""Attention, PyTorch port of ``src/repro/models/attention.py``: RoPE and
M-RoPE, blockwise attention for prefill, single-query decode attention
over the KV cache, and the cache update.

``blockwise_attention`` keeps its JAX signature and goes through
``kernels/flash_attention/ops.attention``: on the card the hand-written
kernel, on the CPU its plain version.  ``decode_attention`` goes through
``kernels/decode_attention/ops.attention``: on the card two hand-written
kernels that read the cache in place over the live positions only (the
JAX package computes it in plain ``jnp``, outside any Pallas kernel), on
the CPU its plain version over the whole padded cache.  On a mesh whose
rules split the cache's sequence (``kv_seq``),
``sharded_decode_attention`` is its flash-decoding form, where the JAX
package's reductions over a sharded sequence become GSPMD's psums; on
the card it runs the same two kernels around its all-reduces.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import all_reduce_axes
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


# ---------------------------------------------------------------- RoPE -----

def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., L) -> angles (..., L, head_dim//2), f32."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    return positions[..., None].float() * torch.pow(float(theta), exps)


def apply_rotary(x, angles):
    """x (B, H, L, D); angles broadcastable to (B, 1, L, D//2).  The
    products are f32 (bf16 x promotes against the f32 angles, as in
    JAX), cast back to x's dtype at the end."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = torch.cos(angles), torch.sin(angles)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Standard RoPE.  positions: (L,) or (B, L)."""
    ang = rope_angles(positions, x.shape[-1], theta)
    if ang.dim() == 2:          # (L, half)
        ang = ang[None, None]
    else:                       # (B, L, half)
        ang = ang[:, None]
    return apply_rotary(x, ang)


def mrope_position_ids(seq_len: int, vision_prefix: int, grid_w: int = 32,
                       device="cpu"):
    """Qwen2-VL M-RoPE position ids (3, L): temporal/height/width.

    The vision prefix lives on a (1, P//grid_w, grid_w) grid; at text
    positions all three streams advance together, continuing after the
    prefix grid's largest id.
    """
    return mrope_ids_at(torch.arange(seq_len, device=device), vision_prefix,
                        grid_w)


def mrope_ids_at(idx, vision_prefix: int, grid_w: int = 32):
    """``mrope_position_ids`` at the positions ``idx`` (L,) only: (3, L)."""
    in_vis = idx < vision_prefix
    text = idx - vision_prefix + grid_w
    t = torch.where(in_vis, torch.zeros_like(idx), text)
    h = torch.where(in_vis, idx // grid_w, text)
    w = torch.where(in_vis, idx % grid_w, text)
    return torch.stack([t, h, w])          # (3, L)


def apply_mrope(x, pos3, theta: float, sections=(1, 1, 1)):
    """M-RoPE: frequency bands split across the (t, h, w) position streams.

    pos3: (3, L).  ``sections`` is the relative band split over
    head_dim//2.  The model calls it with the default (1, 1, 1), as the
    JAX package does (Qwen2-VL's own split is 16/24/24 at head_dim 128).
    """
    half = x.shape[-1] // 2
    total = sum(sections)
    band = torch.zeros((half,), dtype=torch.long, device=x.device)
    freq_idx = torch.arange(half, device=x.device)
    acc = 0
    for s in sections[:-1]:
        acc += s * half // total
        band = band + (freq_idx >= acc).long()
    ang = rope_angles(pos3, x.shape[-1], theta)            # (3, L, half)
    ang = torch.gather(ang.permute(1, 2, 0), -1,
                       band[None, :, None].expand(ang.shape[1], half, 1))
    return apply_rotary(x, ang[..., 0][None, None])         # (L, half)


# -------------------------------------------- blockwise (flash) attention --

def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_offset: int = 0,
                        chunk: int = 512):
    """Online-softmax attention.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D), Hq % Hkv == 0.
    window > 0 restricts to kv_pos in (q_pos - window, q_pos] (sliding).
    ``chunk`` is the JAX scan's kv block; the kernel picks its own tiles,
    so it is accepted and not used.
    """
    del chunk
    return flash_ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window,
                               q_offset=q_offset, kv_offset=kv_offset)


# ------------------------------------------------------- decode attention --

def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token attention over the KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); pos: current position (int).
    Scores are f32 (JAX's ``preferred_element_type``); the probabilities
    are rounded to the cache dtype before the value sum, which is taken
    in f32, as in the JAX package.  On the card only the positions in
    ``(pos - window, pos]`` (``[0, pos]`` without a window) are read.
    """
    return decode_ops.attention(q, k_cache, v_cache, pos, window=window)


def sharded_decode_attention(q, k_cache, v_cache, pos, *, offset: int,
                             mesh, axes: tuple[str, ...]):
    """``decode_attention`` over a cache whose sequence is split over the
    mesh ``axes`` (flash-decoding): this rank holds positions
    ``[offset, offset + S_loc)`` of every kv head, and ``q`` (B, Hq, 1,
    D) is whole.  The rank takes the softmax of its scores under the
    global mask; the maximum is taken over ``axes`` and each rank's
    denominator, rescaled to it, summed over them; each rank's
    probabilities, rescaled by its share of that sum and rounded to the
    cache dtype as ``decode_attention`` rounds them, weight its values,
    and the partial outputs are summed over ``axes``.  Three
    all-reduces: the max, the denominators, the values.  Over one rank
    the share is exactly 1, so the arithmetic is ``decode_attention``'s
    to the bit.  On the card the rank's live positions, ``[offset,
    offset + S_loc)`` up to ``pos``, go through ``decode_attention``'s
    two kernels (``_sharded_live``), so there too one rank gives its
    bits."""
    if q.device.type not in ("cpu", "meta"):
        return _sharded_live(q, k_cache, v_cache,
                             min(pos - offset + 1, k_cache.shape[2]), mesh,
                             axes)
    B, Hq, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) \
        * (1.0 / math.sqrt(D))
    s = s.masked_fill(torch.arange(offset, offset + S, device=q.device)
                      > pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    top = s.amax(dim=-1, keepdim=True)
    m = all_reduce_axes(top.clone(), mesh, axes, op=dist.ReduceOp.MAX)
    mine = torch.exp(s - top).sum(dim=-1, keepdim=True) * torch.exp(top - m)
    p = p * (mine / all_reduce_axes(mine.clone(), mesh, axes))
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = all_reduce_axes(out.contiguous(), mesh, axes)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _sharded_live(q, k_cache, v_cache, live: int, mesh, axes):
    """``sharded_decode_attention``'s arithmetic over this rank's first
    ``live`` positions (none when ``live <= 0``: the rank then adds
    nothing, and still takes part in the three all-reduces)."""
    B, Hq, _, D = q.shape
    q = q.contiguous()
    if live > 0:
        s = decode_ops.scores(q, k_cache, 0, live - 1)
        top = s.amax(dim=-1, keepdim=True)
    else:
        s = torch.empty((B, Hq, 0), device=q.device)
        top = torch.full((B, Hq, 1), NEG_INF, device=q.device)
    p = torch.softmax(s, dim=-1)
    m = all_reduce_axes(top.clone(), mesh, axes, op=dist.ReduceOp.MAX)
    mine = torch.exp(s - top).sum(dim=-1, keepdim=True) * torch.exp(top - m)
    p = p * (mine / all_reduce_axes(mine.clone(), mesh, axes))
    out = decode_ops.values(p, v_cache, 0, torch.float32)
    return all_reduce_axes(out, mesh, axes).to(q.dtype)


def kv_update(cache, new, pos: int, *, offset: int = 0):
    """Write the new token's K or V (B, Hkv, 1, D) at ``pos`` of the
    cache (B, Hkv, S, D).  Unlike the JAX package, which rewrites the
    whole cache with ``jnp.where`` to stay partition-friendly on a
    sharded sequence axis, the port writes the one slot in place and
    returns the same tensor.  A rank's slice of a sequence-sharded cache
    starts at ``offset``: only the rank that holds ``pos`` writes, at its
    local index."""
    if offset <= pos < offset + cache.shape[2]:
        at = pos - offset
        cache[:, :, at:at + 1].copy_(new)
    return cache
