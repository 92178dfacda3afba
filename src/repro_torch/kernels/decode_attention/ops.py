"""Decode attention, chosen by the tensor's device alone.  A CPU or
``meta`` tensor takes today's plain version over the whole padded cache
(``ref.decode_attention_ref``): the CPU tests and the dry-run's cost
trace read it.  Any other tensor goes to the two CUDA kernels over the
live positions only (``live_attention``), which launch or raise; there
is no fallback.  ``scores`` and ``values`` dispatch each pass the same
way, so the composition runs on the CPU through the passes' plain
versions."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import (
    decode_scores,
    decode_values,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    decode_scores_ref,
    decode_values_ref,
)


def _plain(t) -> bool:
    return t.device.type in ("cpu", "meta")


def scores(q, k_cache, lo: int, hi: int):
    """f32 scores (B, Hq, hi - lo + 1) of positions ``lo .. hi``."""
    fn = decode_scores_ref if _plain(q) else decode_scores
    return fn(q, k_cache, lo, hi)


def values(p, v_cache, lo: int, out_dtype):
    """sum_i round(p[..., i]) V[lo + i] as (B, Hq, 1, D) in ``out_dtype``."""
    fn = decode_values_ref if _plain(p) else decode_values
    return fn(p, v_cache, lo, out_dtype)


def live_bounds(pos: int, window: int) -> tuple[int, int]:
    """The live positions ``[lo, hi]`` of a query at ``pos``: ``(pos -
    window, pos]`` with a window, else ``[0, pos]``."""
    return (max(pos - window + 1, 0) if window else 0), pos


def live_attention(q, k_cache, v_cache, lo: int, hi: int):
    """Attention of q (B, Hq, 1, D) over positions ``lo .. hi`` of the
    caches: the scores pass, the softmax over those scores alone, the
    value pass; the output in q's dtype."""
    q = q.contiguous()
    p = torch.softmax(scores(q, k_cache, lo, hi), dim=-1)
    return values(p, v_cache, lo, q.dtype)


def attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """q: (B, Hq, 1, D); caches: (B, Hkv, S, D); the query at ``pos``
    sees ``(pos - window, pos]`` (``[0, pos]`` without a window)."""
    if _plain(q):
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    return live_attention(q, k_cache, v_cache, *live_bounds(pos, window))
