"""Norms, MLP variants, embeddings, logits, PyTorch port of
``src/repro/models/layers.py``: same parameter specs, same math, same
dtypes at every step (f32 norms, f32 logits)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def mlp(x, p, mlp_type: str):
    if mlp_type == "gated_silu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    elif mlp_type == "squared_relu":
        h = torch.relu(x @ p["wi"]).square()
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ p["wo"]


# -------------------------------------------------- embeddings / logits ----

def embedding_specs(vocab: int, d_model: int, tie: bool):
    specs = {"table": PSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}
    if not tie:
        specs["lm_head"] = PSpec((d_model, vocab), ("embed", "vocab"))
    return specs


def embed_lookup(ids, p, scale_by_dim: bool = False):
    x = p["table"][ids]
    if scale_by_dim:
        # sqrt(d_model) rounded to the activation dtype first, as
        # jnp.sqrt(jnp.array(d, x.dtype)) is
        scale = torch.tensor(math.sqrt(p["table"].shape[-1])).to(x.dtype)
        x = x * scale.item()
    return x


def logits_out(x, p):
    """f32 logits, as ``preferred_element_type=jnp.float32`` gives them:
    the products of the stored values, summed in f32."""
    if "lm_head" in p:
        return torch.einsum("bsd,dv->bsv", x.float(), p["lm_head"].float())
    return torch.einsum("bsd,vd->bsv", x.float(), p["table"].float())


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
