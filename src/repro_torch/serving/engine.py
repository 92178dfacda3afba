"""Serving engine, PyTorch port of ``src/repro/serving/engine.py``:
prefill -> cache extension -> greedy decode.

The prefill->decode cache handoff is the paper's gFunc-to-gFunc data
pass; ``extend_caches`` performs the logical resize (pad to the decode
cache length).  One card, no mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.blocks import block_pattern, kind_meta, layout_for

_ATTN_MIXERS = {"attn", "attn_global", "attn_local", "dec_attn"}


def _pad_seq(leaf, to_len: int):
    S = leaf.shape[-2]
    if S >= to_len:
        return leaf
    return F.pad(leaf, (0, 0, 0, to_len - S))


def extend_caches(cfg: ArchConfig, caches, to_len: int):
    """Pad full-attention k/v caches along kv_seq to ``to_len``.

    Window (circular) caches and recurrent states are fixed-size; cross
    (ck/cv) caches keep the encoder length.
    """
    layout = layout_for(cfg, block_pattern(cfg))

    def pad_run(kind: str, run_cache):
        meta = kind_meta(cfg, kind)
        if meta["mixer"] not in _ATTN_MIXERS or meta["window"]:
            return run_cache
        out = dict(run_cache)
        for key in ("k", "v"):
            out[key] = _pad_seq(run_cache[key], to_len)
        return out

    return {
        "units": [pad_run(k, c) for (k, _), c in zip(layout.runs, caches["units"])],
        "rest": [pad_run(k, c) for (k, _), c in
                 zip(layout.rest_runs, caches["rest"])],
    }


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine: CUDA is not available; pass "
                           "device='cpu' to run the plain versions")
    return device


class Engine:
    """Single-model engine: greedy decode over a prefix batch, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, params, *,
                 device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.params = params
        self.ctx = M.build_ctx(cfg, shape)

    def prefill(self, batch):
        """(last-position logits (B, V) f32, caches).  ``batch`` holds
        ``tokens`` and, where the architecture takes them, ``frames`` or
        ``vision_embeds``; each goes to the engine's device."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        return M.prefill(self.cfg, self.ctx, self.params, batch)

    def decode(self, caches, tok, pos: int):
        """One decode step; the caches are updated in place."""
        return M.decode_step(self.cfg, self.ctx, self.params, caches, tok,
                             pos)

    def generate(self, batch, max_new_tokens: int, cache_len: int | None = None):
        """Greedy generation.  Returns (tokens (B, max_new), final_caches)."""
        prompt_len = batch["tokens"].shape[1]
        cache_len = cache_len or (prompt_len + max_new_tokens)
        logits, caches = self.prefill(batch)
        caches = extend_caches(self.cfg, caches, cache_len)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out = [tok]
        pos = prompt_len
        for _ in range(max_new_tokens - 1):
            logits, caches = self.decode(caches, tok, pos)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
            pos += 1
        return torch.cat(out, dim=1), caches
