"""Block assembly, PyTorch port of ``src/repro/models/blocks.py``: kind
keys, per-kind param/cache specs, apply dispatch.

A *kind* is "<mixer>/<ffn>", e.g. "attn/dense", "mamba/moe",
"mlstm/none".  ``block_pattern(cfg)`` names every layer's kind; patterns
are periodic, so the layer stack is stored as (n_units, run_len, ...)
stacked params, exactly as the JAX package stores it.  Every kind of the
ten architectures runs: the attention mixers (full, sliding-window with
circular cache slots, ``attn_global`` with its own RoPE theta, RoPE or
M-RoPE, with or without QKV bias, the encoder's non-causal ``enc_attn``
and ``dec_attn`` with cross-attention over the encoder output, which no
architecture's pattern names, as in the JAX package), Mamba, mLSTM and
sLSTM, each with a dense, MoE or no FFN.

On a mesh the attention is tensor-parallel over the axes its q heads
split on (``head_split``): ``copy_to`` on its input, the rank's heads
through the flash kernel, the row-parallel ``wo`` and ``reduce_from``;
where the kv heads stay whole while the q heads split (GQA heads that
do not divide the axes), each rank cuts the kv weights to the heads
its q heads read, ``h // (H / KV)``, and sums their gradient over the
axes.  FSDP's data axes are gathered first (``ModelCtx.gathered``).

Serving on a mesh keeps the cache in the reference's layout, every kv
head of the rank's rows with the sequence split over ``kv_seq``'s axes
(the flash-decoding layout): prefill runs the kernel on the rank's
heads and hands its K/V to that layout through
``resharding.tube_reshard`` (kv heads kept whole are computed whole, so
that hand-off is a slice); decode gathers q over the heads' axes,
writes the new K/V where its position lies and merges the ranks'
partial softmaxes (``attention.sharded_decode_attention``), then keeps
its own heads for the row-parallel ``wo``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, _pattern_period
from repro_torch.distributed.mesh import (
    Rules, axis_index, constrain, copy_to, entry_axes, gather_dim,
    gather_from, mesh_axis_size, reduce_from, spec_for)
from repro_torch.distributed.resharding import tube_reshard
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.param import PSpec
from repro_torch.spans import span


@dataclass
class ModelCtx:
    """The JAX context's fields.  ``mesh`` is a ``DeviceMesh`` or None
    (one device, no process group); ``cons`` is the reference's sharding
    constraint, which on a rank's local tensor is the identity
    (``distributed/mesh.py::constrain``).

    On a mesh, a weight in a block is the rank's slice under its spec:
    ``spec`` gives it from the weight's ``PSpec`` (global shape and
    logical axes), ``axes`` the mesh axes of one of its dims, and
    ``gathered`` makes it whole over the data axes (FSDP), leaving the
    model axes split.

    ``batch_axes`` are the axes the rows are split over (the shape's
    global batch under the ``batch`` rule).  ``kv_lens`` holds, for a
    decode on a mesh, the global sequence length of each kind of cache
    (``"full"``, ``"window"``, ``"cross"``; ``model.decode_ctx``): a
    rank's slice alone does not say which of ``kv_seq``'s axes split
    it."""
    cfg: ArchConfig
    rules: Rules | None = None
    mesh: Any = None
    data_axes: tuple[str, ...] = ()
    fsdp: bool = False
    batch_sharded: bool = True
    batch_axes: tuple[str, ...] = ()
    kv_lens: dict | None = None

    def cons(self, x, logical):
        if self.mesh is None:
            return x
        return constrain(x, logical, self.rules, self.mesh)

    def spec(self, ps: PSpec) -> tuple:
        if self.mesh is None:
            return (None,) * len(ps.shape)
        return spec_for(ps.shape, ps.logical, self.rules, self.mesh)

    def axes(self, ps: PSpec, dim: int) -> tuple[str, ...]:
        return entry_axes(self.spec(ps)[dim])

    def gathered(self, w, ps: PSpec):
        """``w`` whole over the data axes of every dim of its spec."""
        for dim, part in enumerate(self.spec(ps)):
            ax = entry_axes(part)
            if ax and set(ax) <= set(self.data_axes):
                w = gather_from(w, self.mesh, ax, dim)
            elif set(ax) & set(self.data_axes):
                raise NotImplementedError(f"{ps.logical}: dim {dim} splits "
                                          f"over data and model axes {ax}")
        return w

    def gathered_tree(self, p: dict, specs: dict) -> dict:
        return {k: self.gathered(v, specs[k]) for k, v in p.items()}


# ------------------------------------------------------------ patterns -----

def block_pattern(cfg: ArchConfig) -> list[str]:
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.mixer == "mamba_pattern":
            mixer = "attn" if i % cfg.attn_every == cfg.attn_offset else "mamba"
        elif cfg.mixer == "xlstm_pattern":
            mixer = "slstm" if i % cfg.slstm_every == 0 else "mlstm"
        elif cfg.local_global_ratio:
            mixer = (
                "attn_global"
                if i % (cfg.local_global_ratio + 1) == cfg.local_global_ratio
                else "attn_local"
            )
        else:
            mixer = "attn"
        if mixer in ("mlstm", "slstm"):
            ffn = "none"
        elif cfg.n_experts and i % cfg.moe_every == cfg.moe_offset % cfg.moe_every:
            ffn = "moe"
        else:
            ffn = "dense"
        kinds.append(f"{mixer}/{ffn}")
    return kinds


def enc_pattern(cfg: ArchConfig) -> list[str]:
    return ["enc_attn/dense"] * cfg.enc_layers


@dataclass(frozen=True)
class StackLayout:
    runs: tuple[tuple[str, int], ...]        # unit pattern as (kind, run_len)
    n_units: int
    rest_runs: tuple[tuple[str, int], ...]   # remainder layers (no unit dim)


def _group_runs(kinds: list[str]) -> tuple[tuple[str, int], ...]:
    runs: list[tuple[str, int]] = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return tuple(runs)


def stack_layout(kinds: list[str], period: int) -> StackLayout:
    n_units = len(kinds) // period
    unit = kinds[:period]
    for i, k in enumerate(kinds[: n_units * period]):
        assert k == unit[i % period], "pattern is not periodic"
    rest = kinds[n_units * period:]
    return StackLayout(_group_runs(unit), n_units, _group_runs(rest))


def layout_for(cfg: ArchConfig, kinds: list[str]) -> StackLayout:
    return stack_layout(kinds, _pattern_period(cfg))


# --------------------------------------------------------- kind metadata ---

def kind_meta(cfg: ArchConfig, kind: str) -> dict:
    mixer, ffn = kind.split("/")
    meta = {"mixer": mixer, "ffn": ffn, "causal": mixer != "enc_attn",
            "window": 0, "theta": cfg.rope_theta, "cross": mixer == "dec_attn"}
    if mixer == "attn_local":
        meta["window"] = cfg.window_size
    if mixer == "attn_global" and cfg.rope_theta_global:
        meta["theta"] = cfg.rope_theta_global
    return meta


# -------------------------------------------------------------- specs ------

def attn_specs(cfg: ArchConfig, cross: bool = False):
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    prefix = "c" if cross else ""
    s = {
        f"{prefix}wq": PSpec((D, H, hd), ("embed", "heads", None), fan_in=D),
        f"{prefix}wk": PSpec((D, Kv, hd), ("embed", "kv_heads", None),
                             fan_in=D),
        f"{prefix}wv": PSpec((D, Kv, hd), ("embed", "kv_heads", None),
                             fan_in=D),
        f"{prefix}wo": PSpec((H, hd, D), ("heads", None, "embed"),
                             fan_in=H * hd),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = PSpec((H, hd), ("heads", None), init="zeros")
        s["bk"] = PSpec((Kv, hd), ("kv_heads", None), init="zeros")
        s["bv"] = PSpec((Kv, hd), ("kv_heads", None), init="zeros")
    return s


def _norm_specs(cfg: ArchConfig):
    return L.layernorm_spec(cfg.d_model) if cfg.family == "encdec" \
        else L.rmsnorm_spec(cfg.d_model)


def _norm(cfg: ArchConfig, x, p):
    return L.layernorm(x, p, cfg.norm_eps) if cfg.family == "encdec" \
        else L.rmsnorm(x, p, cfg.norm_eps)


def _scale_residual_outputs(cfg: ArchConfig, s: dict) -> dict:
    """Depth-scaled init (GPT-2 / MiniCPM recipe): every projection that
    writes into the residual stream gets std *= 1/sqrt(2L)."""
    k = (2.0 * max(cfg.n_layers, 1)) ** -0.5
    OUT = {"wo", "cwo", "out", "ffn_down"}

    def walk(tree):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            elif name in OUT and v.init == "normal":
                out[name] = dataclasses.replace(v, scale=v.scale * k)
            else:
                out[name] = v
        return out
    return walk(s)


def block_specs(cfg: ArchConfig, kind: str):
    meta = kind_meta(cfg, kind)
    s: dict = {}
    mixer = meta["mixer"]
    if mixer in ("attn", "attn_local", "attn_global", "enc_attn", "dec_attn"):
        s["ln1"] = _norm_specs(cfg)
        s["attn"] = attn_specs(cfg)
        if meta["cross"]:
            s["ln_x"] = _norm_specs(cfg)
            s["xattn"] = attn_specs(cfg, cross=True)
    elif mixer == "mamba":
        s["ln1"] = _norm_specs(cfg)
        s["mamba"] = mamba_mod.mamba_specs(cfg)
    elif mixer == "mlstm":
        s["ln1"] = _norm_specs(cfg)
        s["mlstm"] = xlstm_mod.mlstm_specs(cfg)
    elif mixer == "slstm":
        s["ln1"] = _norm_specs(cfg)
        s["slstm"] = xlstm_mod.slstm_specs(cfg)
    else:
        raise ValueError(mixer)
    if meta["ffn"] == "dense":
        s["ln2"] = _norm_specs(cfg)
        s["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    elif meta["ffn"] == "moe":
        s["ln2"] = _norm_specs(cfg)
        s["moe"] = moe_mod.moe_specs(cfg)
    return _scale_residual_outputs(cfg, s)


def block_cache_shapes(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                       enc_len: int = 0):
    """(shape, dtype, logical) per cache leaf for decoding."""
    meta = kind_meta(cfg, kind)
    mixer = meta["mixer"]
    hd = cfg.resolved_head_dim
    Kv = cfg.n_kv_heads
    kv_logical = ("batch", None, "kv_seq", None)
    cd = cfg.cache_jdtype
    if mixer in ("attn", "attn_global", "dec_attn"):
        c = {
            "k": ((batch, Kv, cache_len, hd), cd, kv_logical),
            "v": ((batch, Kv, cache_len, hd), cd, kv_logical),
        }
        if meta["cross"]:
            c["ck"] = ((batch, Kv, enc_len, hd), cd, kv_logical)
            c["cv"] = ((batch, Kv, enc_len, hd), cd, kv_logical)
        return c
    if mixer == "attn_local":
        w = min(cfg.window_size, cache_len)
        return {
            "k": ((batch, Kv, w, hd), cd, kv_logical),
            "v": ((batch, Kv, w, hd), cd, kv_logical),
        }
    if mixer == "mamba":
        shapes = mamba_mod.mamba_state_shapes(cfg, batch)
        logical = {"conv": ("batch", None, "state_inner"),
                   "ssm": ("batch", "state_inner", None)}
        return {k: (v[0], v[1], logical[k]) for k, v in shapes.items()}
    if mixer == "mlstm":
        shapes = xlstm_mod.mlstm_state_shapes(cfg, batch)
        logical = {"C": ("batch", None, None, "head_v"),
                   "n": ("batch", None, None), "m": ("batch", None)}
        return {k: (v[0], v[1], logical[k]) for k, v in shapes.items()}
    if mixer == "slstm":
        shapes = xlstm_mod.slstm_state_shapes(cfg, batch)
        return {k: (v[0], v[1], ("batch", None, None))
                for k, v in shapes.items()}
    raise ValueError(mixer)


# -------------------------------------------------------------- apply ------

def _proj_qkv(cfg, p, x, prefix=""):
    q = torch.einsum("bld,dhk->bhlk", x, p[f"{prefix}wq"])
    k = torch.einsum("bld,dhk->bhlk", x, p[f"{prefix}wk"])
    v = torch.einsum("bld,dhk->bhlk", x, p[f"{prefix}wv"])
    if cfg.qkv_bias and not prefix:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return q, k, v


@dataclass(frozen=True)
class HeadSplit:
    """How one attention's heads split over the model axes: ``axes``
    those of the q heads (empty: attention replicated), and, where the kv
    heads are replicated while the q heads split (GQA heads that do not
    divide the axes), ``kv`` the kv heads this rank's q heads read,
    ``h // (H / KV)``, as a range or one head a q head."""
    axes: tuple[str, ...] = ()
    kv: tuple[int, ...] | None = None


def head_split(cfg, ctx: ModelCtx, specs: dict, prefix="") -> HeadSplit:
    H, KV = cfg.n_heads, cfg.n_kv_heads
    h_axes = ctx.axes(specs[f"{prefix}wq"], 1)
    if not h_axes or ctx.axes(specs[f"{prefix}wk"], 1) == h_axes:
        return HeadSplit(h_axes)
    n_loc = H // mesh_axis_size(ctx.mesh, h_axes)
    first = axis_index(ctx.mesh, h_axes) * n_loc
    reads = [(first + i) // (H // KV) for i in range(n_loc)]
    uniq = sorted(set(reads))
    if n_loc % len(uniq) == 0 and reads == [
            u for u in uniq for _ in range(n_loc // len(uniq))]:
        return HeadSplit(h_axes, tuple(uniq))
    return HeadSplit(h_axes, tuple(reads))


def tp_weights(ctx: ModelCtx, ap: dict, specs: dict, split: HeadSplit,
               prefix="", cut: bool = True):
    """One attention's weights for this rank: whole over the data axes;
    under a ``HeadSplit`` with ``kv`` and ``cut``, the replicated kv
    weights cut to the heads the rank reads, their gradient summed over
    the heads' axes (each rank's covers only its heads)."""
    w = ctx.gathered_tree(ap, specs)
    if split.kv is not None and cut:
        idx = list(split.kv)
        for n in (f"{prefix}wk", f"{prefix}wv"):
            w[n] = copy_to(w[n], ctx.mesh, split.axes)[:, idx]
        for n in ("bk", "bv"):
            if n in w and not prefix:
                w[n] = copy_to(w[n], ctx.mesh, split.axes)[idx]
    return w


def _rope(cfg, meta, q, k, positions):
    if cfg.rope == "rope":
        q = attn_mod.apply_rope(q, positions, meta["theta"])
        k = attn_mod.apply_rope(k, positions, meta["theta"])
    elif cfg.rope == "mrope":
        pos3 = _mrope_at(cfg, positions) if positions.dim() == 1 \
            else positions
        q = attn_mod.apply_mrope(q, pos3, meta["theta"])
        k = attn_mod.apply_mrope(k, pos3, meta["theta"])
    return q, k


def _mrope_at(cfg, idx):
    """(3, L) M-RoPE ids of positions ``idx`` (L,): the vision prefix on
    a 32-wide grid, text positions after it on all three streams."""
    return attn_mod.mrope_ids_at(idx, cfg.vision_prefix)


KV_LOGICAL = ("batch", None, "kv_seq", None)


def _kv_layout(ctx: ModelCtx, t, seq_len: int):
    """(spec, mesh axes of the sequence) of a K/V cache of global length
    ``seq_len`` whose rank slice has ``t``'s rows, heads and head dim
    (B_loc, Hkv, *, D), under the ``kv_seq`` rule."""
    B = t.shape[0] * mesh_axis_size(ctx.mesh, ctx.batch_axes)
    spec = spec_for((B, t.shape[1], seq_len, t.shape[3]), KV_LOGICAL,
                    ctx.rules, ctx.mesh)
    return spec, entry_axes(spec[2])


def _to_cache(cfg, ctx: ModelCtx, t, heads: tuple[str, ...]):
    """Prefill's K or V (the rank's rows; its heads split over ``heads``,
    or whole) as the rank's slice of the decode layout (every head, the
    sequence over ``kv_seq``'s axes), in the cache dtype."""
    t = t.to(cfg.cache_jdtype)
    if ctx.mesh is None:
        return t.contiguous()
    dst, _ = _kv_layout(ctx, t, t.shape[2])
    part = None if not heads else heads[0] if len(heads) == 1 else heads
    return tube_reshard(t, (dst[0], part, None, None), dst,
                        ctx.mesh).contiguous()


def _for_heads(split: HeadSplit, *ts):
    """Serving computes kv heads kept whole (``HeadSplit.kv``) whole, for
    the cache; the flash kernel reads the rank's."""
    if split.kv is None:
        return ts
    return tuple(t[:, list(split.kv)] for t in ts)


def _whole_heads(ctx: ModelCtx, split: HeadSplit, t):
    """``t`` (B, H_loc, ...) whole over the heads' axes."""
    if split.axes and split.kv is None:
        return gather_dim(t, ctx.mesh, split.axes, 1)
    return t


def _sharded_decode(ctx, split: HeadSplit, q, k, v, cache, pos, *,
                    kind: str):
    """Decode attention on a mesh: the new K/V (whole over the heads)
    written by the rank that holds ``pos`` (or its circular slot), q
    gathered over the heads' axes, the flash-decoding merge over the
    cache's sequence axes, and the rank's own heads of the output.  The
    cross caches (``kind="cross"``, no ``k``/``v``, no ``pos``) are read
    whole: every encoder position is visible."""
    if ctx.kv_lens is None:
        raise ValueError("decode on a mesh needs the caches' global lengths "
                         "(model.decode_ctx)")
    seq = ctx.kv_lens[kind]
    names = ("ck", "cv") if kind == "cross" else ("k", "v")
    _, axes = _kv_layout(ctx, cache[names[0]], seq)
    S_loc = cache[names[0]].shape[2]
    offset = axis_index(ctx.mesh, axes) * S_loc if axes else 0
    if k is not None:
        at = pos % seq if kind == "window" else pos
        for name, new in zip(names, (k, v)):
            attn_mod.kv_update(cache[name], _whole_heads(ctx, split, new)
                               .to(cache[name].dtype), at, offset=offset)
    eff = seq - 1 if pos is None else min(pos, seq - 1)
    qa = gather_dim(q, ctx.mesh, split.axes, 1) if split.axes else q
    out = attn_mod.sharded_decode_attention(
        qa, cache[names[0]], cache[names[1]], eff, offset=offset,
        mesh=ctx.mesh, axes=axes)
    if not split.axes:
        return out
    n_loc = q.shape[1]
    return out.narrow(1, axis_index(ctx.mesh, split.axes) * n_loc, n_loc)


def _attn_apply(cfg, ctx, meta, p, x, *, mode, cache, pos, enc_out):
    B, Lq, D = x.shape
    serving = mode != "train" and ctx.mesh is not None
    h = _norm(cfg, x, p["ln1"])
    specs = attn_specs(cfg)
    split = head_split(cfg, ctx, specs)
    ap = tp_weights(ctx, p["attn"], specs, split, cut=not serving)
    q, k, v = _proj_qkv(cfg, ap, copy_to(h, ctx.mesh, split.axes))
    q = ctx.cons(q, ("batch", "heads", "seq", None))
    new_cache = cache
    kv_heads = split.axes if split.kv is None else ()

    if mode in ("train", "prefill"):
        positions = torch.arange(Lq, device=x.device)
        q, k = _rope(cfg, meta, q, k, positions)
        kr, vr = _for_heads(split, k, v) if serving else (k, v)
        with span("ft:attn.core"):
            out = attn_mod.blockwise_attention(
                q, kr, vr, causal=meta["causal"], window=meta["window"])
        if mode == "prefill":
            if meta["window"]:
                # circular-slot arrangement: token p lives at slot p % W, so
                # the last W tokens are stored rotated by Lq % W
                w = min(meta["window"], Lq)
                kc = torch.roll(k[:, :, Lq - w:], Lq % w, dims=2)
                vc = torch.roll(v[:, :, Lq - w:], Lq % w, dims=2)
            else:
                kc, vc = k, v
            new_cache = {"k": _to_cache(cfg, ctx, kc, kv_heads),
                         "v": _to_cache(cfg, ctx, vc, kv_heads)}
    elif serving:  # decode over the sequence-sharded cache
        q, k = _rope(cfg, meta, q, k, torch.full((1,), pos, device=x.device))
        with span("ft:attn.core"):
            out = _sharded_decode(ctx, split, q, k, v, cache, pos,
                                  kind="window" if meta["window"] else "full")
        new_cache = cache
    else:  # decode: the cache is written in place (attention.kv_update)
        positions = torch.full((1,), pos, device=x.device)
        q, k = _rope(cfg, meta, q, k, positions)
        if meta["window"]:
            W = cache["k"].shape[2]
            slot = pos % W
            ck = attn_mod.kv_update(cache["k"], k, slot)
            cv = attn_mod.kv_update(cache["v"], v, slot)
            # circular window: once pos >= W every slot is live
            with span("ft:attn.core"):
                out = attn_mod.decode_attention(q, ck, cv, min(pos, W - 1))
        else:
            ck = attn_mod.kv_update(cache["k"], k, pos)
            cv = attn_mod.kv_update(cache["v"], v, pos)
            with span("ft:attn.core"):
                out = attn_mod.decode_attention(q, ck, cv, pos)
        new_cache = dict(cache, k=ck, v=cv)

    # the heads' partial sums of the row-parallel output projection
    y = torch.einsum("bhlk,hkd->bld", out, ap["wo"])
    x = x + reduce_from(y, ctx.mesh, split.axes)

    if meta["cross"]:
        h = _norm(cfg, x, p["ln_x"])
        xspecs = attn_specs(cfg, cross=True)
        xsplit = head_split(cfg, ctx, xspecs, "c")
        xp = tp_weights(ctx, p["xattn"], xspecs, xsplit, "c", cut=not serving)
        q = torch.einsum("bld,dhk->bhlk", copy_to(h, ctx.mesh, xsplit.axes),
                         xp["cwq"])
        if mode == "decode" and serving:
            with span("ft:attn.core"):
                out = _sharded_decode(ctx, xsplit, q, None, None, cache,
                                      None, kind="cross")
        elif mode == "decode":
            # every encoder position is visible
            S_enc = cache["ck"].shape[2]
            with span("ft:attn.core"):
                out = attn_mod.decode_attention(q, cache["ck"], cache["cv"],
                                                S_enc - 1)
        else:
            enc = copy_to(enc_out, ctx.mesh, xsplit.axes)
            ck = torch.einsum("bld,dhk->bhlk", enc, xp["cwk"])
            cv = torch.einsum("bld,dhk->bhlk", enc, xp["cwv"])
            if mode == "prefill":
                heads = xsplit.axes if xsplit.kv is None else ()
                new_cache = dict(new_cache, ck=_to_cache(cfg, ctx, ck, heads),
                                 cv=_to_cache(cfg, ctx, cv, heads))
            with span("ft:attn.core"):
                out = attn_mod.blockwise_attention(
                    q, *(_for_heads(xsplit, ck, cv) if serving else (ck, cv)),
                    causal=False)
        y = torch.einsum("bhlk,hkd->bld", out, xp["cwo"])
        x = x + reduce_from(y, ctx.mesh, xsplit.axes)
    return x, new_cache


_RECURRENT = {"mamba": mamba_mod.mamba_forward,
              "mlstm": xlstm_mod.mlstm_forward,
              "slstm": xlstm_mod.slstm_forward}


def apply_block(cfg, ctx: ModelCtx, kind: str, p, x, *, mode: str,
                cache=None, pos=0, enc_out=None):
    """Returns (x, new_cache, aux): aux is the MoE balance loss, a 0-d
    f32 tensor (0.0 where the FFN is not MoE).  A recurrent mixer's
    decode returns its new state, its large leaves written in place;
    attention writes its caches in place."""
    meta = kind_meta(cfg, kind)
    mixer = meta["mixer"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = cache if cache is not None else {}

    if mixer in _RECURRENT:
        h = _norm(cfg, x, p["ln1"])
        state = cache if mode == "decode" else None
        y, st = _RECURRENT[mixer](h, p[mixer], cfg, state=state, ctx=ctx)
        x = x + y
        new_cache = st if mode in ("prefill", "decode") else {}
    else:
        x, new_cache = _attn_apply(cfg, ctx, meta, p, x, mode=mode,
                                   cache=cache, pos=pos, enc_out=enc_out)

    if meta["ffn"] == "dense":
        h = _norm(cfg, x, p["ln2"])
        x = x + L.mlp(h, p["mlp"], cfg.mlp_type, ctx)
    elif meta["ffn"] == "moe":
        h = _norm(cfg, x, p["ln2"])
        y, aux_moe = moe_mod.moe_block(
            h, p["moe"], cfg, ctx.mesh, rules=ctx.rules,
            data_axes=ctx.data_axes, batch_sharded=ctx.batch_sharded,
            batch_axes=ctx.batch_axes)
        x = x + y
        aux = aux + aux_moe
    x = ctx.cons(x, ("batch", "seq", "act_embed"))
    if mode == "train":
        new_cache = {}
    return x, new_cache, aux
