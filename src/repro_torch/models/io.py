"""Model inputs per (arch, shape), PyTorch port of
``src/repro/models/io.py``: the spec of every step input (tokens, and
the stubbed modality inputs: Whisper's encoder ``frames``, Qwen2-VL's
``vision_embeds``), shape-only stand-ins, and real synthetic arrays of
the same shapes.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import param as PM
from repro_torch.models.param import PSpec


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """PSpec tree for the step inputs (excluding params / caches)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {
            "token": PSpec((B, 1), ("batch", None), torch.int32, "zeros"),
            "pos": PSpec((), (), torch.int32, "zeros"),
        }
    if cfg.family == "encdec":
        return {
            "frames": PSpec((B, S // 2, cfg.d_model),
                            ("batch", "seq", None), torch.bfloat16),
            "tokens": PSpec((B, S // 2), ("batch", "seq"), torch.int32,
                            "zeros"),
        }
    specs = {"tokens": PSpec((B, S), ("batch", "seq"), torch.int32, "zeros")}
    if cfg.vision_prefix:
        specs["vision_embeds"] = PSpec(
            (B, cfg.vision_prefix, cfg.d_model),
            ("batch", "seq", None), torch.bfloat16)
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """The step inputs as ``meta`` tensors: shapes and dtypes, no data."""
    return PM.abstract(batch_pspecs(cfg, shape))


def synthetic_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int | tuple = 0,
                    device="cuda"):
    """Real tensors matching ``batch_pspecs`` on ``device``: token ids
    uniform in [0, vocab), embeddings standard normal.  Each input draws
    from numpy's generator seeded with (seed, crc32(name)), so one input
    does not depend on which others the shape has; ``seed`` is an int or
    a tuple of ints (the data pipeline passes (seed, step)).  The draws
    are not the JAX package's (it folds the name into a JAX key)."""
    words = list(seed) if isinstance(seed, tuple) else [seed]
    out = {}
    for name, p in batch_pspecs(cfg, shape).items():
        rng = np.random.default_rng([*words, zlib.crc32(name.encode())])
        if p.dtype == torch.int32 and p.shape:
            a = rng.integers(0, cfg.vocab_size, p.shape, dtype=np.int32)
        elif p.dtype == torch.int32:
            a = np.zeros(p.shape, np.int32)
        else:
            a = rng.standard_normal(p.shape, dtype=np.float32)
        out[name] = torch.from_numpy(a).to(device=device, dtype=p.dtype)
    return out
