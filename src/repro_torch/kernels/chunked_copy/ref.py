"""Plain PyTorch versions of the slab gather/scatter.

The CPU path of ``ops.gather``/``ops.scatter`` and the yardstick the
CUDA kernels are held against on the card.  ``idx`` is an int64 tensor
on ``src``'s device.
"""
from __future__ import annotations


def gather_chunks_ref(src, idx):
    """out[i] = src[idx[i]]."""
    return src.index_select(0, idx)


def scatter_chunks_ref(dst, src, idx):
    """dst[idx[i]] = src[i], in place (the reference's donated update);
    ids must be unique.  Returns ``dst``."""
    dst[idx] = src
    return dst
