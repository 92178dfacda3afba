"""Paged decode attention, chosen by the tensor's device alone: a CPU
tensor takes the plain version (``ref.py``); any other tensor goes to
the CUDA kernel, which launches or raises.  There is no fallback.  A
``meta`` tensor, which holds no data (a cost trace), takes the plain
version too."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def attention(q, k_pages, v_pages, page_table, seq_lens):
    """q: (B, Hq, D); pages: (P, page, Hkv, D); page_table: (B, NP);
    seq_lens: (B,) -> (B, Hq, D).  Positions ``>= seq_lens[b]`` are
    masked."""
    if q.device.type in ("cpu", "meta"):
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
    return paged_attention(q, k_pages, v_pages, page_table, seq_lens)
