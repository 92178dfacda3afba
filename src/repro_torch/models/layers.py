"""Norms, MLP variants, embeddings, logits, PyTorch port of
``src/repro/models/layers.py``: same parameter specs, same math, same
dtypes at every step (f32 norms, f32 logits).

Given a model context on a mesh (``blocks.ModelCtx``), the MLP, the
embedding and the logits take each weight as the rank's slice: the MLP
column-parallel in, row-parallel out over the ``mlp`` axes; the
embedding vocab-parallel (each rank looks up the ids in its rows); the
logits the rank's vocab columns only (``model.loss_fn`` reduces them).
FSDP's data axes are gathered first (``ModelCtx.gathered``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import (
    axis_index, copy_to, mesh_axis_size, reduce_from)
from repro_torch.models.param import PSpec


# ------------------------------------------------------------- norms -------

def rmsnorm_spec(d: int):
    return {"scale": PSpec((d,), (None,), torch.float32, "ones")}


def rmsnorm(x, p, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def layernorm_spec(d: int):
    return {
        "scale": PSpec((d,), (None,), torch.float32, "ones"),
        "bias": PSpec((d,), (None,), torch.float32, "zeros"),
    }


def layernorm(x, p, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# -------------------------------------------------------------- MLPs -------

def mlp_specs(d_model: int, d_ff: int, mlp_type: str):
    if mlp_type == "gated_silu":
        return {
            "wi_gate": PSpec((d_model, d_ff), ("embed_mlp", "mlp")),
            "wi_up": PSpec((d_model, d_ff), ("embed_mlp", "mlp")),
            "wo": PSpec((d_ff, d_model), ("mlp", "embed_mlp")),
        }
    if mlp_type in ("squared_relu", "gelu"):
        return {
            "wi": PSpec((d_model, d_ff), ("embed_mlp", "mlp")),
            "wo": PSpec((d_ff, d_model), ("mlp", "embed_mlp")),
        }
    raise ValueError(mlp_type)


def mlp(x, p, mlp_type: str, ctx=None):
    axes, mesh = (), None
    if ctx is not None and ctx.mesh is not None:
        mesh = ctx.mesh
        specs = mlp_specs(ctx.cfg.d_model, ctx.cfg.d_ff, mlp_type)
        p = ctx.gathered_tree(p, specs)
        axes = ctx.axes(specs["wo"], 0)
        x = copy_to(x, mesh, axes)
    if mlp_type == "gated_silu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif mlp_type == "squared_relu":
        h = torch.relu(x @ p["wi"]).square()
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return reduce_from(h @ p["wo"], mesh, axes)


# -------------------------------------------------- embeddings / logits ----

def embedding_specs(vocab: int, d_model: int, tie: bool):
    specs = {"table": PSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}
    if not tie:
        specs["lm_head"] = PSpec((d_model, vocab), ("embed", "vocab"))
    return specs


def vocab_split(ctx):
    """(the model axes the vocab splits over, this rank's first row) of
    the embedding (or the head: same logical axes, same size); ((), 0)
    without a mesh or a split."""
    if ctx is None or ctx.mesh is None:
        return (), 0
    cfg = ctx.cfg
    table = embedding_specs(cfg.padded_vocab, cfg.d_model,
                            cfg.tie_embeddings)["table"]
    axes = ctx.axes(table, 0)
    if not axes:
        return (), 0
    n_loc = cfg.padded_vocab // mesh_axis_size(ctx.mesh, axes)
    return axes, axis_index(ctx.mesh, axes) * n_loc


def _embed_weight(p, name: str, ctx):
    """``p[name]`` whole over the data axes."""
    if ctx is None or ctx.mesh is None:
        return p[name]
    cfg = ctx.cfg
    return ctx.gathered(p[name], embedding_specs(
        cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings)[name])


def embed_lookup(ids, p, scale_by_dim: bool = False, ctx=None):
    axes, lo = vocab_split(ctx)
    table = _embed_weight(p, "table", ctx)
    if axes:
        # vocab-parallel: each rank looks up the ids in its rows, zeros
        # elsewhere, and the sum over the vocab axes puts every row in
        local = ids - lo
        mine = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)]
        x = reduce_from(torch.where(mine[..., None], x, 0), ctx.mesh, axes)
    else:
        x = table[ids]
    if scale_by_dim:
        # sqrt(d_model) rounded to the activation dtype first, as
        # jnp.sqrt(jnp.array(d, x.dtype)) is
        scale = torch.tensor(math.sqrt(table.shape[-1])).to(x.dtype)
        x = x * scale.item()
    return x


def logits_out(x, p, ctx=None):
    """f32 logits, as ``preferred_element_type=jnp.float32`` gives them:
    the products of the stored values, summed in f32.  On a mesh, the
    rank's vocab columns (``vocab_split``)."""
    axes, _ = vocab_split(ctx)
    if axes:
        x = copy_to(x, ctx.mesh, axes)
    if "lm_head" in p:
        return torch.einsum("bsd,dv->bsv", x.float(),
                            _embed_weight(p, "lm_head", ctx).float())
    return torch.einsum("bsd,vd->bsv", x.float(),
                        _embed_weight(p, "table", ctx).float())


def sinusoidal_positions(length: int, d_model: int, offset: int = 0,
                         device="cpu"):
    """Whisper-style fixed sinusoidal absolute embedding (computed, no
    params): (length, d_model) f32, sines then cosines."""
    half = d_model // 2
    step = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                    * step)
    pos = torch.arange(offset, offset + length, dtype=torch.float32,
                       device=device)[:, None]
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_at(pos: int, d_model: int, device="cpu"):
    """The sinusoidal embedding of one position: (d_model,) f32."""
    return sinusoidal_positions(1, d_model, pos, device)[0]
