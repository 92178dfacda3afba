"""Plain PyTorch paged decode attention: gather the pages into a
contiguous cache, then plain masked softmax attention.

A twin of ``src/repro/kernels/paged_attention/ref.py``; the CPU path of
``ops.attention`` and the yardstick the CUDA kernel is held against on
the card.  Page ids are taken as JAX's indexing takes them in the
reference: a negative id counts from the end, then every id is clamped
into ``[0, P)``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def page_ids(page_table, n_pages: int):
    """The physical page each table entry reads, as int64."""
    t = page_table.long()
    return torch.where(t < 0, t + n_pages, t).clamp(0, n_pages - 1)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens):
    """q: (B, Hq, D); pages: (P, page, Hkv, D); page_table: (B, NP);
    seq_lens: (B,).  Returns (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    NP = page_table.shape[1]
    group = Hq // Hkv
    ids = page_ids(page_table, P)
    k = k_pages[ids].reshape(B, NP * page, Hkv, D)
    v = v_pages[ids].reshape(B, NP * page, Hkv, D)
    qg = q.reshape(B, Hkv, group, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(NP * page, device=q.device)
    mask = pos[None] < seq_lens.to(q.device).long()[:, None]       # (B, S)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)
