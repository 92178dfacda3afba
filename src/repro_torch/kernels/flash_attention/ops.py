"""Prefill attention, chosen by the tensor's device alone: a CPU tensor
takes the plain version (``ref.py``); any other tensor goes to the CUDA
kernel, which launches or raises.  There is no fallback."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, kv_offset: int = 0):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D) -> (B, Hq, Lq, D).
    Keys at ``kv_offset + j`` are visible to the query at ``q_offset + i``
    when ``k_pos <= q_pos`` (causal) and ``k_pos > q_pos - window``
    (window > 0)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    return flash_attention(q, k, v, **kw)
