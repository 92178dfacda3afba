"""Plain PyTorch decode attention over the engine's contiguous KV cache.

``decode_attention_ref`` is the port's decode attention as the JAX
package computes it (``src/repro/models/attention.py``): f32 scores over
the whole padded cache, the positions outside ``(pos - window, pos]``
masked after they are read, the probabilities rounded to the cache dtype
before an f32 value sum.  It is the CPU path of ``ops.attention``, what a
``meta`` trace counts, and the yardstick the kernels are held against on
the card.  ``decode_scores_ref`` and ``decode_values_ref`` are the plain
versions of the two kernels' passes, over the live positions only.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, pos, *, window: int = 0):
    """Single-token attention over the KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); pos: current position (int).
    Scores are f32 (JAX's ``preferred_element_type``); the probabilities
    are rounded to the cache dtype before the value sum, which is taken
    in f32, as in the JAX package.
    """
    B, Hq, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) * scale
    kv_pos = torch.arange(S, device=q.device)
    mask = kv_pos <= pos
    if window:
        mask = mask & (kv_pos > pos - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def decode_scores_ref(q, k_cache, lo: int, hi: int):
    """The scores pass: q (B, Hq, 1, D), k_cache (B, Hkv, S, D) -> the f32
    scores q . K / sqrt(D) of positions ``lo .. hi``, (B, Hq, hi - lo + 1)."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    k = k_cache[:, :, lo:hi + 1].float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k) * (1.0 / math.sqrt(D))
    return s.reshape(B, Hq, -1)


def decode_values_ref(p, v_cache, lo: int, out_dtype):
    """The value pass: p (B, Hq, n) f32 over positions ``lo .. lo + n -
    1``, v_cache (B, Hkv, S, D) -> sum_i round(p[..., i]) V[lo + i], each
    probability rounded to the cache dtype, summed in f32; (B, Hq, 1, D)
    in ``out_dtype``."""
    B, Hq, n = p.shape
    _, Hkv, _, D = v_cache.shape
    pg = p.reshape(B, Hkv, Hq // Hkv, n).to(v_cache.dtype).float()
    out = torch.einsum("bhgk,bhkd->bhgd", pg,
                       v_cache[:, :, lo:lo + n].float())
    return out.reshape(B, Hq, 1, D).to(out_dtype)
