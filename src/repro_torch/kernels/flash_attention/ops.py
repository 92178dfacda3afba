"""Prefill attention, chosen by the tensor's device alone: a CPU tensor
takes the plain version (``ref.py``), which autograd differentiates; any
other tensor goes to the CUDA kernel, which launches or raises.  Where
a gradient is wanted, the kernel runs under ``FlashAttention``, whose
backward is the hand-written backward kernel (``flash_attention_bwd``),
from the softmax statistics the forward kept: the JAX
package has no backward kernel (XLA differentiates its ``jnp`` scan),
and this is the counterpart of that compiled gradient.  There is no
fallback.  A ``meta`` tensor, which holds no data (the dry-run's cost
trace), takes the plain versions in the kernels' place, under
``FlashAttention`` too: its products are the full-matrix
``4 B Hq Lq Lkv D`` FLOPs the JAX package's dry-run counts forward, and
``attention_bwd_ref``'s backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_ref,
)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward under autograd.  It saves q, k, v and the rows'
    softmax statistics; the backward kernel rebuilds the softmax tile by
    tile from them.  On ``meta`` it saves q, k and v for
    ``attention_bwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_offset):
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      kv_offset=kv_offset)
        if q.device.type == "meta":
            ctx.save_for_backward(q, k, v)
            return attention_ref(q, k, v, **ctx.kw)
        out, stats = flash_attention(q, k, v, return_stats=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        if do.device.type == "meta":
            dq, dk, dv = attention_bwd_ref(*ctx.saved_tensors, do, **ctx.kw)
        else:
            q, k, v, stats = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), stats,
                                             **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, **kw):
    if q.device.type == "meta":
        return attention_ref(q, k, v, **kw)
    return flash_attention(q, k, v, **kw)


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    kv_offset)
    return _forward(q, k, v, **kw)
