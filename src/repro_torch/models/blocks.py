"""Block assembly, PyTorch port of ``src/repro/models/blocks.py``: kind
keys, per-kind param/cache specs, apply dispatch.

A *kind* is "<mixer>/<ffn>", e.g. "attn/dense", "attn_local/dense".
``block_pattern(cfg)`` names every layer's kind; patterns are periodic,
so the layer stack is stored as (n_units, run_len, ...) stacked params,
exactly as the JAX package stores it.  The port runs every attention
kind with a dense FFN: full, sliding-window (``attn_local``, with the
circular cache slots) and ``attn_global`` (its own RoPE theta), with or
without QKV bias.  Mamba, xLSTM, MoE, the encoder-decoder and M-RoPE
raise ``NotImplementedError`` naming their ROADMAP.md item; their
parameter specs are here so that every architecture's parameter tree
and count match the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig, _pattern_period
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.param import PSpec

_PENDING = {
    "mamba": "ROADMAP.md §1, model stack item 1 (models/mamba.py)",
    "mlstm": "ROADMAP.md §1, model stack item 1 (models/xlstm.py)",
    "slstm": "ROADMAP.md §1, model stack item 1 (models/xlstm.py)",
    "moe": "ROADMAP.md §1, model stack item 1 (models/moe.py)",
    "enc_attn": "ROADMAP.md §1, model stack item 1 (encoder-decoder)",
    "dec_attn": "ROADMAP.md §1, model stack item 1 (encoder-decoder)",
    "mrope": "ROADMAP.md §1, model stack item 1 (M-RoPE)",
}


def pending(what: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet: {_PENDING[what]}")


@dataclass
class ModelCtx:
    """What the JAX context carries, on one card (world size 1): no
    mesh, so ``cons`` (a sharding constraint there) is the identity.
    The logical-axis rules wait for the ``distributed/`` port."""
    cfg: ArchConfig

    def cons(self, x, logical):
        return x


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


# The parameter specs of the mixers and FFNs whose forward waits, copied
# from src/repro/models/{mamba,xlstm,moe}.py so that every architecture's
# tree (and count) is the JAX package's.

def _mamba_specs(cfg: ArchConfig):
    D, N = cfg.d_model, cfg.d_state
    din = cfg.d_inner
    dtr = max(D // 16, 1)
    return {
        "in_x": PSpec((D, din), ("embed", "state_inner")),
        "in_z": PSpec((D, din), ("embed", "state_inner")),
        "conv_w": PSpec((cfg.d_conv, din), ("conv", "state_inner"), scale=1.0),
        "conv_b": PSpec((din,), ("state_inner",), init="zeros"),
        "w_dt": PSpec((din, dtr), ("state_inner", None)),
        "dt_proj": PSpec((dtr, din), (None, "state_inner")),
        "dt_bias": PSpec((din,), ("state_inner",), torch.float32, "zeros"),
        "w_B": PSpec((din, N), ("state_inner", None)),
        "w_C": PSpec((din, N), ("state_inner", None)),
        "A_log": PSpec((din, N), ("state_inner", None), torch.float32,
                       "s4d_log"),
        "D_skip": PSpec((din,), ("state_inner",), torch.float32, "ones"),
        "out": PSpec((din, D), ("state_inner", "embed")),
    }


def _mlstm_specs(cfg: ArchConfig):
    D = cfg.d_model
    din = cfg.d_inner
    H = cfg.n_heads
    dh = din // H
    return {
        "up_x": PSpec((D, din), ("embed", "mlp")),
        "up_z": PSpec((D, H, dh), ("embed", None, "head_v"), fan_in=D),
        "wq": PSpec((din, H, dh), ("mlp", None, None), fan_in=din),
        "wk": PSpec((din, H, dh), ("mlp", None, None), fan_in=din),
        "wv": PSpec((din, H, dh), (None, None, "head_v"), fan_in=din),
        "w_i": PSpec((din, H), ("mlp", None)),
        "w_f": PSpec((din, H), ("mlp", None)),
        "b_i": PSpec((H,), (None,), torch.float32, "zeros"),
        "b_f": PSpec((H,), (None,), torch.float32, "ones"),
        "out": PSpec((H, dh, D), (None, "head_v", "embed"), fan_in=H * dh),
    }


def _slstm_specs(cfg: ArchConfig):
    D = cfg.d_model
    H = cfg.n_heads
    dh = D // H
    dff = cfg.expand * D
    return {
        "w_gates": PSpec((D, 4, H, dh), ("embed", None, None, None),
                         fan_in=D),
        "r_gates": PSpec((4, H, dh, dh), (None, None, None, None), scale=0.5),
        "b_gates": PSpec((4, H, dh), (None, None, None), torch.float32,
                         "zeros"),
        "ffn_up": PSpec((D, dff), ("embed", "mlp")),
        "ffn_gate": PSpec((D, dff), ("embed", "mlp")),
        "ffn_down": PSpec((dff, D), ("mlp", "embed")),
    }


def _moe_specs(cfg: ArchConfig):
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    names = (("wi_gate", "wi_up", "wo") if cfg.mlp_type == "gated_silu"
             else ("wi", "wo"))
    specs = {"router": PSpec((D, E), ("embed", "experts"))}
    for n in names:
        if n == "wo":
            specs[n] = PSpec((E, F, D), ("experts", "expert_mlp", "embed"),
                             fan_in=F)
        else:
            specs[n] = PSpec((E, D, F), ("experts", "embed", "expert_mlp"),
                             fan_in=D)
    return specs


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
        s["mamba"] = _mamba_specs(cfg)
    elif mixer == "mlstm":
        s["ln1"] = _norm_specs(cfg)
        s["mlstm"] = _mlstm_specs(cfg)
    elif mixer == "slstm":
        s["ln1"] = _norm_specs(cfg)
        s["slstm"] = _slstm_specs(cfg)
    else:
        raise ValueError(mixer)
    if meta["ffn"] == "dense":
        s["ln2"] = _norm_specs(cfg)
        s["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    elif meta["ffn"] == "moe":
        s["ln2"] = _norm_specs(cfg)
        s["moe"] = _moe_specs(cfg)
    return _scale_residual_outputs(cfg, s)


def _check_ported(cfg: ArchConfig, kind: str) -> dict:
    meta = kind_meta(cfg, kind)
    if meta["mixer"] in _PENDING:
        raise pending(meta["mixer"])
    if meta["ffn"] == "moe":
        raise pending("moe")
    if cfg.rope == "mrope":
        raise pending("mrope")
    return meta


def block_cache_shapes(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                       enc_len: int = 0):
    """(shape, dtype, logical) per cache leaf for decoding."""
    del enc_len                 # cross-attention caches wait with encdec
    mixer = _check_ported(cfg, kind)["mixer"]
    hd = cfg.resolved_head_dim
    Kv = cfg.n_kv_heads
    kv_logical = ("batch", None, "kv_seq", None)
    cd = cfg.cache_jdtype
    if mixer == "attn_local":
        cache_len = min(cfg.window_size, cache_len)
    return {
        "k": ((batch, Kv, cache_len, hd), cd, kv_logical),
        "v": ((batch, Kv, cache_len, hd), cd, kv_logical),
    }


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


def _rope(cfg, meta, q, k, positions):
    if cfg.rope == "rope":
        q = attn_mod.apply_rope(q, positions, meta["theta"])
        k = attn_mod.apply_rope(k, positions, meta["theta"])
    elif cfg.rope == "mrope":
        raise pending("mrope")
    return q, k


def _attn_apply(cfg, ctx, meta, p, x, *, mode, cache, pos):
    B, Lq, D = x.shape
    h = _norm(cfg, x, p["ln1"])
    ap = p["attn"]
    q, k, v = _proj_qkv(cfg, ap, h)
    q = ctx.cons(q, ("batch", "heads", "seq", None))
    new_cache = cache

    if mode in ("train", "prefill"):
        positions = torch.arange(Lq, device=x.device)
        q, k = _rope(cfg, meta, q, k, positions)
        out = attn_mod.blockwise_attention(
            q, k, v, causal=meta["causal"], window=meta["window"])
        if mode == "prefill":
            if meta["window"]:
                # circular-slot arrangement: token p lives at slot p % W, so
                # the last W tokens are stored rotated by Lq % W
                w = min(meta["window"], Lq)
                kc = torch.roll(k[:, :, Lq - w:], Lq % w, dims=2)
                vc = torch.roll(v[:, :, Lq - w:], Lq % w, dims=2)
            else:
                kc, vc = k, v
            new_cache = {
                "k": ctx.cons(kc.to(cfg.cache_jdtype).contiguous(),
                              ("batch", None, "kv_seq", None)),
                "v": ctx.cons(vc.to(cfg.cache_jdtype).contiguous(),
                              ("batch", None, "kv_seq", None)),
            }
    else:  # decode: the cache is written in place (attention.kv_update)
        positions = torch.full((1,), pos, device=x.device)
        q, k = _rope(cfg, meta, q, k, positions)
        if meta["window"]:
            W = cache["k"].shape[2]
            slot = pos % W
            ck = attn_mod.kv_update(cache["k"], k, slot)
            cv = attn_mod.kv_update(cache["v"], v, slot)
            # circular window: once pos >= W every slot is live
            out = attn_mod.decode_attention(q, ck, cv, min(pos, W - 1))
        else:
            ck = attn_mod.kv_update(cache["k"], k, pos)
            cv = attn_mod.kv_update(cache["v"], v, pos)
            out = attn_mod.decode_attention(q, ck, cv, pos)
        new_cache = dict(cache, k=ck, v=cv)

    y = torch.einsum("bhlk,hkd->bld", out, ap["wo"])
    return x + y, new_cache


def apply_block(cfg, ctx: ModelCtx, kind: str, p, x, *, mode: str,
                cache=None, pos=0):
    """Returns (x, new_cache, aux); aux (the MoE balance loss) is 0.0 on
    every ported kind."""
    meta = _check_ported(cfg, kind)
    x, new_cache = _attn_apply(cfg, ctx, meta, p, x, mode=mode, cache=cache,
                               pos=pos)
    if meta["ffn"] == "dense":
        h = _norm(cfg, x, p["ln2"])
        x = x + L.mlp(h, p["mlp"], cfg.mlp_type)
    x = ctx.cons(x, ("batch", "seq", "act_embed"))
    if mode == "train":
        new_cache = {}
    return x, new_cache, 0.0
