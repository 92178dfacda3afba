"""Model facade, PyTorch port of ``src/repro/models/model.py``: param
specs, the stacked-block loop, prefill and decode entry points.

The parameter and cache trees keep the JAX package's layout: stacked
``(n_units, run_len, ...)`` leaves under ``{"units": [...], "rest":
[...]}``, so weights carry over with a plain tree map
(``param.from_numpy``).  ``apply_stack`` is a Python loop over those
leaves where the JAX package scans.  ``loss_fn`` waits for the training
slice (ROADMAP.md §1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models import param as PM
from repro_torch.models.blocks import (
    ModelCtx,
    StackLayout,
    _norm,
    _norm_specs,
    apply_block,
    block_cache_shapes,
    block_pattern,
    block_specs,
    enc_pattern,
    layout_for,
    pending,
    stack_layout,
)
from repro_torch.models.param import PSpec, stack


def build_ctx(cfg: ArchConfig, shape: ShapeSpec | None = None) -> ModelCtx:
    del shape                   # the mesh rules that read it wait
    return ModelCtx(cfg=cfg)


# -------------------------------------------------------------- specs ------

def _stack_specs(cfg: ArchConfig, layout: StackLayout):
    units = [
        stack(stack(block_specs(cfg, k), rl, "stack"), layout.n_units, "layers")
        for k, rl in layout.runs
    ]
    rest = [stack(block_specs(cfg, k), rl, "stack") for k, rl in layout.rest_runs]
    return {"units": units, "rest": rest}


def stack_layout_enc(cfg: ArchConfig) -> StackLayout:
    return stack_layout(enc_pattern(cfg), 1)


def model_specs(cfg: ArchConfig):
    specs = {
        "embed": L.embedding_specs(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "ln_f": _norm_specs(cfg),
        "blocks": _stack_specs(cfg, layout_for(cfg, block_pattern(cfg))),
    }
    if cfg.enc_layers:
        specs["enc_blocks"] = _stack_specs(cfg, stack_layout_enc(cfg))
        specs["enc_ln_f"] = _norm_specs(cfg)
    return specs


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random weights from ``seed``, generated on ``device``."""
    return PM.initialize(model_specs(cfg), seed, device)


# ----------------------------------------------------- cache pspecs --------

def _cache_pspecs_for_kind(cfg, kind, batch, cache_len, enc_len):
    shapes = block_cache_shapes(cfg, kind, batch, cache_len, enc_len)
    return {
        k: PSpec(shp, logical, dtype, "zeros")
        for k, (shp, dtype, logical) in shapes.items()
    }


def cache_pspecs(cfg: ArchConfig, shape: ShapeSpec):
    """PSpec tree for the decode-time cache (matches blocks structure)."""
    if cfg.enc_layers:
        raise pending("enc_attn")
    B = shape.global_batch
    layout = layout_for(cfg, block_pattern(cfg))
    units = [
        stack(stack(_cache_pspecs_for_kind(cfg, k, B, shape.seq_len, 0),
                    rl, "stack"), layout.n_units, "layers")
        for k, rl in layout.runs
    ]
    rest = [
        stack(_cache_pspecs_for_kind(cfg, k, B, shape.seq_len, 0), rl, "stack")
        for k, rl in layout.rest_runs
    ]
    return {"units": units, "rest": rest}


def init_cache(cfg: ArchConfig, shape: ShapeSpec, device="cuda"):
    return PM.initialize(cache_pspecs(cfg, shape), 0, device)


# ----------------------------------------------------------- execution -----

def _layers(layout: StackLayout):
    """(kind, where) of every layer in execution order: each unit runs
    its runs in turn, then the rest.  ``where`` indexes the stacked
    trees: ("units", run, unit, i) or ("rest", run, i)."""
    for u in range(layout.n_units):
        for r, (kind, rl) in enumerate(layout.runs):
            for i in range(rl):
                yield kind, ("units", r, u, i)
    for r, (kind, rl) in enumerate(layout.rest_runs):
        for i in range(rl):
            yield kind, ("rest", r, i)


def _at(tree, where):
    """The one layer's slice (views) of a stacked tree."""
    group, r, *idx = where
    return PM.tree_map(lambda a: a[tuple(idx)], tree[group][r])


def _stacked(layout: StackLayout, per_layer: dict):
    """Per-layer cache dicts, stacked back into the tree layout."""
    def run(wheres, lead):
        layers = [per_layer[w] for w in wheres]
        return {k: torch.stack([d[k] for d in layers])
                .reshape(*lead, *layers[0][k].shape) for k in layers[0]}
    n = layout.n_units
    return {
        "units": [run([("units", r, u, i) for u in range(n)
                       for i in range(rl)], (n, rl))
                  for r, (_, rl) in enumerate(layout.runs)],
        "rest": [run([("rest", r, i) for i in range(rl)], (rl,))
                 for r, (_, rl) in enumerate(layout.rest_runs)],
    }


def apply_stack(cfg, ctx, layout: StackLayout, bp, x, *, mode: str,
                caches=None, pos=0):
    """Run the block stack.  Returns (x, new_caches, aux).  Prefill
    returns fresh stacked caches; decode updates ``caches`` in place
    (``attention.kv_update``) and returns them."""
    aux = 0.0
    per_layer = {}
    for kind, where in _layers(layout):
        cache_in = _at(caches, where) if mode == "decode" else None
        x, nc, da = apply_block(cfg, ctx, kind, _at(bp, where), x, mode=mode,
                                cache=cache_in, pos=pos)
        aux = aux + da
        if mode == "prefill":
            per_layer[where] = nc
    if mode == "prefill":
        return x, _stacked(layout, per_layer), aux
    if mode == "decode":
        return x, caches, aux
    return x, None, aux


# ------------------------------------------------------------ embedding ----

def _embed_decoder_input(cfg, ctx, params, tokens):
    if cfg.family == "encdec":
        raise pending("enc_attn")
    if cfg.vision_prefix:
        raise pending("mrope")
    x = L.embed_lookup(tokens, params["embed"], scale_by_dim=cfg.tie_embeddings)
    return ctx.cons(x, ("batch", "seq", "act_embed"))


# ------------------------------------------------------------- entries -----

def prefill(cfg: ArchConfig, ctx: ModelCtx, params, batch):
    """Returns (last-position logits (B, V) f32, caches)."""
    tokens = batch["tokens"]
    x = _embed_decoder_input(cfg, ctx, params, tokens)
    layout = layout_for(cfg, block_pattern(cfg))
    x, caches, _ = apply_stack(cfg, ctx, layout, params["blocks"], x,
                               mode="prefill")
    x = _norm(cfg, x[:, -1:], params["ln_f"])
    logits = L.logits_out(x, params["embed"])[:, 0]
    return logits, caches


def decode_step(cfg: ArchConfig, ctx: ModelCtx, params, caches, token, pos):
    """One decode step.  token: (B, 1) int; pos: int position.  The
    caches are updated in place and returned."""
    x = _embed_decoder_input(cfg, ctx, params, token)
    layout = layout_for(cfg, block_pattern(cfg))
    x, new_caches, _ = apply_stack(cfg, ctx, layout, params["blocks"], x,
                                   mode="decode", caches=caches, pos=pos)
    x = _norm(cfg, x, params["ln_f"])
    logits = L.logits_out(x, params["embed"])[:, 0]
    return logits, new_caches
