"""Plain PyTorch prefill attention: the naive full-matrix softmax.

A twin of ``src/repro/kernels/flash_attention/ref.py`` with the query
and key position offsets that ``blockwise_attention`` takes.  It is the
CPU path of ``ops.attention`` and the yardstick the CUDA kernel is held
against on the card.  Scores and softmax are f32 whatever the inputs'
dtype; the output is cast to q's dtype.
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
