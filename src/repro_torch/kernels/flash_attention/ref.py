"""Plain PyTorch prefill attention: the naive full-matrix softmax.

A twin of ``src/repro/kernels/flash_attention/ref.py`` with the query
and key position offsets that ``blockwise_attention`` takes.  It is the
CPU path of ``ops.attention`` and the yardstick the CUDA kernel is held
against on the card.  Scores and softmax are f32 whatever the inputs'
dtype; the output is cast to q's dtype.  ``attention_bwd_ref`` is its
gradient, block by block: the backward of the kernel's autograd
``ops.FlashAttention``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, kv_offset: int = 0):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D).  Returns (B, Hq, Lq, D)."""
    B, Hq, Lq, D = q.shape
    _, Hkv, Lkv, _ = k.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Lq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Lq, device=q.device)[:, None]
    k_pos = kv_offset + torch.arange(Lkv, device=q.device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def _visible(qp: int, Lkv: int, causal: bool, window: int,
             kv_offset: int) -> tuple[int, int]:
    """The key indices [lo, hi) the query at position ``qp`` sees."""
    hi = min(Lkv, max(0, qp + 1 - kv_offset)) if causal else Lkv
    lo = min(Lkv, max(0, qp - window + 1 - kv_offset)) if window else 0
    return lo, hi


def attention_bwd_ref(q, k, v, do, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_offset: int = 0,
                      block: int = 512):
    """The gradient of ``attention_ref`` with respect to (q, k, v) for the
    output gradient ``do`` (B, Hq, Lq, D): (dq, dk, dv) in the inputs'
    dtypes.

    It recomputes attention ``block`` query rows at a time, in f32, and
    takes autograd's gradient of ``attention_ref`` over that slice alone,
    adding into f32 dk and dv.  No step holds the (B, H, Lq, Lkv) score
    matrix: a slice's scores span only the keys its rows can see (the
    causal and window bounds), or all keys where a row sees none (where
    ``attention_ref`` averages every value)."""
    Lq, Lkv = q.shape[2], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    with torch.enable_grad():
        for i0 in range(0, Lq, block):
            i1 = min(i0 + block, Lq)
            (lo, hi0), (lo1, hi) = (_visible(q_offset + i, Lkv, **kw)
                                    for i in (i0, i1 - 1))
            if hi0 <= lo or hi <= lo1:          # a row that sees no key
                lo, hi = 0, Lkv
            qb, kb, vb = (t.detach().float().requires_grad_() for t in (
                q[:, :, i0:i1], k[:, :, lo:hi], v[:, :, lo:hi]))
            out = attention_ref(qb, kb, vb, causal=causal, window=window,
                                q_offset=q_offset + i0,
                                kv_offset=kv_offset + lo)
            gq, gk, gv = torch.autograd.grad(
                out, (qb, kb, vb), do[:, :, i0:i1].float())
            dq[:, :, i0:i1] = gq
            dk[:, :, lo:hi] += gk
            dv[:, :, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)
