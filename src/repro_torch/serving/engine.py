"""Serving engine, PyTorch port of ``src/repro/serving/engine.py``:
prefill -> cache extension -> greedy decode.

The prefill->decode cache handoff is the paper's gFunc-to-gFunc data
pass: prefill emits head-sharded K/V and decode wants them sharded by
sequence (``kv_seq``, the flash-decoding layout).  On a mesh the
prefill's K/V change hands through ``resharding.tube_reshard``
(``blocks._to_cache``) and ``extend_caches`` pads the sequence-sharded
caches to the decode length.  Without a mesh it is one device and the
same code with no collectives.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.mesh import (
    coordinate, gather_dim, local_slice, mesh_axis_size, spec_for)
from repro_torch.distributed.resharding import tube_reshard
from repro_torch.models import model as M
from repro_torch.models.blocks import (
    KV_LOGICAL, block_pattern, kind_meta, layout_for)
from repro_torch.spans import span

_ATTN_MIXERS = {"attn", "attn_global", "attn_local", "dec_attn"}


def _pad_seq(leaf, to_len: int):
    S = leaf.shape[-2]
    if S >= to_len:
        return leaf
    return F.pad(leaf, (0, 0, 0, to_len - S))


def _pad_sharded(ctx, leaf, from_len: int, to_len: int):
    """A stacked K/V leaf (lead, B_loc, Hkv, S_loc, D), this rank's slice
    of a cache of ``from_len`` positions, as its slice of the cache
    padded to ``to_len``."""
    lead = leaf.dim() - 4
    logical = ("layers", "stack")[:lead] + KV_LOGICAL

    def spec(S):
        B = leaf.shape[lead] * mesh_axis_size(ctx.mesh, ctx.batch_axes)
        return spec_for((*leaf.shape[:lead], B, leaf.shape[lead + 1], S,
                         leaf.shape[-1]), logical, ctx.rules, ctx.mesh)
    src, dst = spec(from_len), spec(to_len)
    whole = tuple(p if i == lead else None for i, p in enumerate(src))
    full = tube_reshard(leaf, src, whole, ctx.mesh)
    return tube_reshard(_pad_seq(full, to_len), whole, dst,
                        ctx.mesh).contiguous()


def extend_caches(cfg: ArchConfig, caches, to_len: int, *, ctx=None,
                  from_len: int | None = None):
    """Pad full-attention k/v caches along kv_seq to ``to_len``.

    Window (circular) caches and recurrent states are fixed-size; cross
    (ck/cv) caches keep the encoder length.

    On a mesh (``ctx``, with the prefill's length ``from_len``), each
    rank holds ``[r L / n, (r + 1) L / n)`` of a sequence split n ways;
    padded, it must hold ``[r T / n, (r + 1) T / n)``, and ``spec_for``
    may split at T what it replicated at L.  Almost every position moves
    to another rank, so the move is a gather and a slice, both through
    ``tube_reshard``: the sequence gathered whole over its axes, padded,
    and cut to the rank's part under the spec at ``to_len``.  It runs
    once a request, before the first decode step.
    """
    layout = layout_for(cfg, block_pattern(cfg))
    mesh = ctx is not None and ctx.mesh is not None
    if mesh and from_len is None:
        raise ValueError("extend_caches on a mesh needs the prefill length")

    def pad_run(kind: str, run_cache):
        meta = kind_meta(cfg, kind)
        if meta["mixer"] not in _ATTN_MIXERS or meta["window"]:
            return run_cache
        out = dict(run_cache)
        for key in ("k", "v"):
            out[key] = (_pad_sharded(ctx, run_cache[key], from_len, to_len)
                        if mesh else _pad_seq(run_cache[key], to_len))
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
    ``device`` (``cuda`` unless the caller asks for the CPU).

    With a ``mesh`` (a ``DeviceMesh`` whose shape ``make_rules``
    accepts), ``params`` are the rank's slices under the shape's serving
    rules (``param.shard_local``), every rank calls ``generate`` with the
    same global batch, serves its rows of it (all of them where the
    rules replicate the batch) and gets the global tokens back; the
    caches it returns are its slices."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, params, *,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.params = params
        self.mesh = mesh
        self.ctx = M.build_ctx(cfg, shape, mesh)

    def _rows(self, batch):
        """``batch`` on the engine's device, cut to this rank's rows."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        if self.mesh is None:
            return batch
        B = batch["tokens"].shape[0]
        if B != self.shape.global_batch:
            raise ValueError(f"a batch of {B} on a mesh built for "
                             f"{self.shape.global_batch}")
        coord = coordinate(self.mesh)
        out = {}
        for k, a in batch.items():
            spec = spec_for(tuple(a.shape), ("batch",) + (None,) * (a.dim() - 1),
                            self.ctx.rules, self.mesh)
            out[k] = a[local_slice(tuple(a.shape), spec, self.mesh, coord)]
        return out

    def prefill(self, batch):
        """(last-position logits (B, V) f32, caches) of this rank's rows.
        ``batch`` holds ``tokens`` and, where the architecture takes
        them, ``frames`` or ``vision_embeds``; each goes to the engine's
        device."""
        with span("ft:engine.prefill"):
            return M.prefill(self.cfg, self.ctx, self.params,
                             self._rows(batch))

    def decode(self, caches, tok, pos: int, ctx=None):
        """One decode step; the caches are updated in place.  On a mesh,
        ``ctx`` is ``model.decode_ctx``'s."""
        with span("ft:engine.decode"):
            return M.decode_step(self.cfg, ctx or self.ctx, self.params,
                                 caches, tok, pos)

    def generate(self, batch, max_new_tokens: int, cache_len: int | None = None):
        """Greedy generation.  Returns (tokens (B, max_new), final_caches)."""
        prompt_len = batch["tokens"].shape[1]
        cache_len = cache_len or (prompt_len + max_new_tokens)
        logits, caches = self.prefill(batch)
        caches = extend_caches(self.cfg, caches, cache_len, ctx=self.ctx,
                               from_len=prompt_len)
        ctx = M.decode_ctx(self.cfg, self.ctx, prompt_len=prompt_len,
                           cache_len=cache_len,
                           enc_len=batch["frames"].shape[1]
                           if "frames" in batch else 0)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out = [tok]
        pos = prompt_len
        for _ in range(max_new_tokens - 1):
            logits, caches = self.decode(caches, tok, pos, ctx)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
            pos += 1
        tokens = torch.cat(out, dim=1)
        if self.ctx.batch_axes:
            tokens = gather_dim(tokens, self.mesh, self.ctx.batch_axes, 0)
        return tokens, caches
