"""W8A16 weight-only quantization for decode serving, PyTorch port.

Decode is weight-streaming-bound: every step reads all (active) weights
once to produce one token per sequence.  Storing weights as int8 with a
per-output-channel f32 scale halves the HBM term.  Activations stay
bf16.

Only large >=2-D weight leaves quantize (norm scales, biases and the
embedding table stay bf16: the embedding is read by gather, not
streamed).  Scales are per-last-dim channel so dequantization broadcasts
correctly for every weight layout in the model zoo.  ``q`` and ``s`` are
bit-equal to ``src/repro/serving/wquant.py``'s: the same f32 max-abs
over all leading axes, ``/ 127``, ``max(s, 1e-12)``, round half to even,
and the same skip rule.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.param import PSpec, tree_map

MIN_QUANT_SIZE = 1 << 16          # small leaves stay bf16


def _quantizable(p) -> bool:
    shape = p.shape
    n = int(np.prod(shape))
    return len(shape) >= 2 and n >= MIN_QUANT_SIZE


def quant_pspecs(pspec_tree, *, skip_embed: bool = True):
    """PSpec tree of the quantized representation."""
    def conv(p):
        if not _quantizable(p) or (skip_embed and p.logical
                                   and "vocab" in p.logical):
            return p
        return {
            "q": PSpec(p.shape, p.logical, torch.int8, "zeros"),
            "s": PSpec((p.shape[-1],), (p.logical[-1],), torch.float32,
                       "ones"),
        }
    return tree_map(conv, pspec_tree)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def _map_with_path(f, tree, prefix: str = ""):
    """``f(path, leaf)`` over a tree of dicts and lists; the path's parts
    joined by / as ``jax.tree_util`` keys name them."""
    if isinstance(tree, dict) and not _is_qleaf(tree):
        return {k: _map_with_path(f, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(f, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return f(prefix[:-1], tree)


def quantize_tree(params, *, skip_embed: bool = True,
                  min_size: int = MIN_QUANT_SIZE):
    """bf16/f32 param tree -> mixed tree with {"q": int8, "s": f32}."""
    def conv(name, x):
        if x.ndim < 2 or x.numel() < min_size or \
                (skip_embed and "embed" in name.split("/")[-1]):
            return x
        xf = x.float()
        s = xf.abs().amax(dim=tuple(range(x.ndim - 1))) / 127.0
        s = torch.clamp_min(s, 1e-12)
        q = torch.round(xf / s).to(torch.int8)
        return {"q": q, "s": s}

    return _map_with_path(conv, params)


def dequant_tree(qparams, dtype=torch.bfloat16):
    """Inverse of quantize_tree."""
    def conv(_name, x):
        if _is_qleaf(x):
            return (x["q"].float() * x["s"]).to(dtype)
        return x
    return _map_with_path(conv, qparams)
