"""Model facade, PyTorch port of ``src/repro/models/model.py``: param
specs, the stacked-block loop, prefill and decode entry points.

One code path for all ten architectures: decoder-only stacks, the
encoder-decoder (the encoder over precomputed ``frames``; its output
goes to every decoder block, and ``dec_attn`` blocks attend to it) and
the vision-language prefix (``vision_embeds`` spliced over the first
positions).  The parameter
and cache trees keep the JAX package's layout: stacked
``(n_units, run_len, ...)`` leaves under ``{"units": [...], "rest":
[...]}``, so weights carry over with a plain tree map
(``param.from_numpy``).  ``apply_stack`` is a Python loop over those
leaves where the JAX package scans.  ``loss_fn`` is the training loss:
in train mode each pattern unit is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), and
each stacked leaf is split into its layers once per forward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.mesh import data_axes, make_rules, mesh_axis_size
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
    stack_layout,
)
from repro_torch.models.param import PSpec, stack


#: logical axes the activation constraints (``ctx.cons``) name
_ACT_LOGICAL = ("seq", "act_embed", "vocab", "heads", "kv_seq")


def build_ctx(cfg: ArchConfig, shape: ShapeSpec | None = None,
              mesh=None) -> ModelCtx:
    """The context for one (arch, shape, mesh) cell, with the reference's
    rules.  Without a mesh: one device, no rules.

    On a mesh the port splits only the batch: rules that would shard a
    weight, a cache or an activation over a mesh axis of more than one
    member raise ``NotImplementedError`` (at world size > 1 that is every
    cell but the small-dense DP ones in training)."""
    if mesh is None:
        return ModelCtx(cfg=cfg)
    rules = make_rules(cfg, shape, mesh)
    da = data_axes(mesh)
    dp = mesh_axis_size(mesh, da)
    named = {n for _, p in PM.tree_leaves_with_paths(model_specs(cfg))
             for n in p.logical} | set(_ACT_LOGICAL)
    if not shape.is_training:
        named |= {n for _, p in PM.tree_leaves_with_paths(
            cache_pspecs(cfg, shape)) for n in p.logical}
    wide = sorted((n, rules[n]) for n in named - {None, "batch"}
                  if n in rules and mesh_axis_size(mesh, rules[n]) > 1)
    if wide:
        raise NotImplementedError(
            f"{cfg.name} {shape.name}: the rules shard {dict(wide)} over "
            "mesh axes of more than one member; weight sharding (TP, FSDP, "
            "expert parallelism) is the next slice (ROADMAP.md §1)")
    return ModelCtx(
        cfg=cfg,
        rules=rules,
        mesh=mesh,
        data_axes=da,
        fsdp=shape.is_training,
        batch_sharded=shape.global_batch % dp == 0,
    )


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
    """PSpec tree for the decode-time cache (matches blocks structure).
    An encoder-decoder splits the shape's length evenly between the
    decoder's cache and the encoder's output, as the JAX package does."""
    B = shape.global_batch
    if cfg.enc_layers:
        cache_len = enc_len = shape.seq_len // 2
    else:
        cache_len, enc_len = shape.seq_len, 0
    layout = layout_for(cfg, block_pattern(cfg))
    units = [
        stack(stack(_cache_pspecs_for_kind(cfg, k, B, cache_len, enc_len),
                    rl, "stack"), layout.n_units, "layers")
        for k, rl in layout.runs
    ]
    rest = [
        stack(_cache_pspecs_for_kind(cfg, k, B, cache_len, enc_len), rl,
              "stack")
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
    """Per-layer cache dicts, stacked back into the tree layout.  A run
    with no layer (``n_units == 0``: fewer layers than one period) gets
    leaves of length 0 in front, shaped like another layer's of its
    kind, as the JAX scan's empty output is."""
    like = {}
    for (group, r, *_), c in per_layer.items():
        runs = layout.runs if group == "units" else layout.rest_runs
        like.setdefault(runs[r][0], c)

    def run(kind, wheres, lead):
        if not wheres:
            return {k: t.new_empty((*lead, *t.shape))
                    for k, t in like[kind].items()}
        layers = [per_layer[w] for w in wheres]
        return {k: torch.stack([d[k] for d in layers])
                .reshape(*lead, *layers[0][k].shape) for k in layers[0]}
    n = layout.n_units
    return {
        "units": [run(kind, [("units", r, u, i) for u in range(n)
                             for i in range(rl)], (n, rl))
                  for r, (kind, rl) in enumerate(layout.runs)],
        "rest": [run(kind, [("rest", r, i) for i in range(rl)], (rl,))
                 for r, (kind, rl) in enumerate(layout.rest_runs)],
    }


def _unbind_layers(tree, lead: int, n: int) -> list:
    """A stacked tree as the list of its ``n`` layers' trees: every leaf
    flattened over its ``lead`` layer axes and unbound once, so that its
    backward is one stack, where a view per layer (``_at``) would write
    a zero tensor as large as the whole leaf for each layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, lead, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unbind_layers(v, lead, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(tree.flatten(0, lead - 1).unbind(0))


def _train_stack(cfg, ctx, layout: StackLayout, bp, x, enc_out):
    """Train mode: the layers in ``_layers`` order.  Each pattern unit is
    recomputed in the backward where autograd records (the reference's
    ``jax.checkpoint(unit_body)``), which bounds the activations kept at
    one (B, S, D) a unit; the ``rest`` runs outside the checkpoint, as
    the reference scans them."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    units = [_unbind_layers(t, 2, layout.n_units * rl)
             for t, (_, rl) in zip(bp["units"], layout.runs)]

    def unit(x, aux, u):
        for (kind, rl), layers in zip(layout.runs, units):
            for i in range(rl):
                x, _, da = apply_block(cfg, ctx, kind, layers[u * rl + i],
                                       x, mode="train", enc_out=enc_out)
                aux = aux + da
        return x, aux

    records = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for _, t in PM.tree_leaves_with_paths(bp)))
    for u in range(layout.n_units):
        if records:
            x, aux = checkpoint(unit, x, aux, u, use_reentrant=False)
        else:
            x, aux = unit(x, aux, u)
    for t, (kind, rl) in zip(bp["rest"], layout.rest_runs):
        for p in _unbind_layers(t, 1, rl):
            x, _, da = apply_block(cfg, ctx, kind, p, x, mode="train",
                                   enc_out=enc_out)
            aux = aux + da
    return x, None, aux


def apply_stack(cfg, ctx, layout: StackLayout, bp, x, *, mode: str,
                caches=None, pos=0, enc_out=None):
    """Run the block stack.  Returns (x, new_caches, aux).  Prefill
    returns fresh stacked caches; decode updates ``caches`` in place
    (attention through ``attention.kv_update``, the mLSTM's C and n and
    the Mamba ssm state by the mixer itself, the other, small recurrent
    state leaves copied into their slot) and returns them; train returns
    no caches (``_train_stack``)."""
    if mode == "train":
        return _train_stack(cfg, ctx, layout, bp, x, enc_out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = {}
    for kind, where in _layers(layout):
        cache_in = _at(caches, where) if mode == "decode" else None
        x, nc, da = apply_block(cfg, ctx, kind, _at(bp, where), x, mode=mode,
                                cache=cache_in, pos=pos, enc_out=enc_out)
        aux = aux + da
        if mode == "prefill":
            per_layer[where] = nc
        elif mode == "decode":
            for key, t in nc.items():
                if t is not cache_in[key]:
                    cache_in[key].copy_(t)
    if mode == "prefill":
        return x, _stacked(layout, per_layer), aux
    return x, caches, aux


# ------------------------------------------------------------ embedding ----

def _embed_decoder_input(cfg, ctx, params, tokens, *, pos_offset=0,
                         vision_embeds=None):
    x = L.embed_lookup(tokens, params["embed"], scale_by_dim=cfg.tie_embeddings)
    if cfg.family == "encdec":
        x = x + L.sinusoidal_positions(
            tokens.shape[1], cfg.d_model, pos_offset, x.device).to(x.dtype)
    if cfg.vision_prefix and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x[:, cfg.vision_prefix:]],
                      dim=1)
    return ctx.cons(x, ("batch", "seq", "act_embed"))


def _run_encoder(cfg, ctx, params, frames):
    x = frames + L.sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(frames.dtype)
    layout = stack_layout_enc(cfg)
    x, _, _ = apply_stack(cfg, ctx, layout, params["enc_blocks"], x,
                          mode="train")
    return _norm(cfg, x, params["enc_ln_f"])


# ------------------------------------------------------------- entries -----

def loss_fn(cfg: ArchConfig, ctx: ModelCtx, params, batch):
    """Mean next-token cross-entropy from f32 logits, by logsumexp, plus
    0.01 x the MoE balance loss.  Returns (loss, {"xent", "aux"})."""
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, ctx, params, batch["frames"])
    tokens = batch["tokens"]
    x = _embed_decoder_input(cfg, ctx, params, tokens,
                             vision_embeds=batch.get("vision_embeds"))
    layout = layout_for(cfg, block_pattern(cfg))
    x, _, aux = apply_stack(cfg, ctx, layout, params["blocks"], x,
                            mode="train", enc_out=enc_out)
    x = _norm(cfg, x, params["ln_f"])
    logits = L.logits_out(x, params["embed"])            # (B, S, V) f32
    logits = ctx.cons(logits, ("batch", "seq", "vocab"))

    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
    xent = (lse - ll).mean()
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


def prefill(cfg: ArchConfig, ctx: ModelCtx, params, batch):
    """Returns (last-position logits (B, V) f32, caches).  ``batch`` holds
    ``tokens``, and ``frames`` (encoder-decoder) or ``vision_embeds``
    (the vision prefix) where the architecture takes them."""
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, ctx, params, batch["frames"])
    x = _embed_decoder_input(cfg, ctx, params, batch["tokens"],
                             vision_embeds=batch.get("vision_embeds"))
    layout = layout_for(cfg, block_pattern(cfg))
    x, caches, _ = apply_stack(cfg, ctx, layout, params["blocks"], x,
                               mode="prefill", enc_out=enc_out)
    x = _norm(cfg, x[:, -1:], params["ln_f"])
    logits = L.logits_out(x, params["embed"])[:, 0]
    return logits, caches


def decode_step(cfg: ArchConfig, ctx: ModelCtx, params, caches, token, pos):
    """One decode step.  token: (B, 1) int; pos: int position.  The
    caches are updated in place and returned."""
    x = L.embed_lookup(token, params["embed"], scale_by_dim=cfg.tie_embeddings)
    if cfg.family == "encdec":
        x = x + L.sinusoid_at(pos, cfg.d_model,
                              x.device).to(x.dtype)[None, None]
    x = ctx.cons(x, ("batch", "seq", "act_embed"))
    layout = layout_for(cfg, block_pattern(cfg))
    x, new_caches, _ = apply_stack(cfg, ctx, layout, params["blocks"], x,
                                   mode="decode", caches=caches, pos=pos)
    x = _norm(cfg, x, params["ln_f"])
    logits = L.logits_out(x, params["embed"])[:, 0]
    return logits, new_caches
