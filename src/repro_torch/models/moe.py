"""Mixture-of-Experts FFN, PyTorch port of ``src/repro/models/moe.py`` on
one card (world size 1).

The JAX package runs ``moe_block``'s body inside a fully manual
``shard_map`` over the expert and data axes; on one card every axis has
size 1, so its ``all_gather``, ``pmean``, ``axis_index`` and ``psum``
vanish and every expert is local.  What is left is the body: an f32
softmax router, top-k with renormalised gates, the switch load-balance
loss, each assignment's rank within its expert by a one-hot cumsum,
capacity ``int(capacity_factor * T * k / E) + 1`` with the overflow
dropped, a scatter into an (E, cap, D) buffer, the expert FFNs as
batched products, and the gate-weighted combine, in x's dtype as in the
reference.

Returns (out, aux) where aux is the switch-style load-balance loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import PSpec


def _wnames(cfg: ArchConfig):
    return ("wi_gate", "wi_up", "wo") if cfg.mlp_type == "gated_silu" \
        else ("wi", "wo")


def moe_specs(cfg: ArchConfig):
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    specs = {"router": PSpec((D, E), ("embed", "experts"))}
    for n in _wnames(cfg):
        if n == "wo":
            specs[n] = PSpec((E, F_, D), ("experts", "expert_mlp", "embed"),
                             fan_in=F_)
        else:
            specs[n] = PSpec((E, D, F_), ("experts", "embed", "expert_mlp"),
                             fan_in=D)
    return specs


def _expert_ffn(x, wp, mlp_type: str):
    """x: (E, C, D); weights (E, D, F) / (E, F, D).  The non-gated
    experts use SiLU, as the reference's do."""
    if mlp_type == "gated_silu":
        h = F.silu(torch.bmm(x, wp["wi_gate"])) * torch.bmm(x, wp["wi_up"])
    else:
        h = F.silu(torch.bmm(x, wp["wi"]))
    return torch.bmm(h, wp["wo"])


def moe_block(x, p, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux f32 scalar)."""
    E, k = cfg.n_experts, cfg.top_k
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(T, D)

    probs = torch.softmax(flat.float() @ p["router"].float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # switch-style load-balance loss
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, gate_idx.reshape(-1),
                  torch.full((T * k,), 1.0 / (T * k), device=x.device))
    aux = E * torch.sum(me * ce)

    # rank of each assignment within its expert (one-hot cumsum)
    eid = gate_idx.reshape(-1)                                    # (T*k,)
    onehot = F.one_hot(eid, E).to(torch.int32)
    rank = torch.gather(torch.cumsum(onehot, dim=0), 1,
                        eid[:, None])[:, 0] - 1

    cap = int(cfg.capacity_factor * T * k / E) + 1
    keep = rank < cap
    slot = rank.clamp(0, cap - 1)

    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    src = torch.where(keep[:, None], flat[tok], 0)
    buf = torch.zeros((E, cap, D), dtype=x.dtype, device=x.device)
    buf.index_put_((eid, slot), src, accumulate=True)

    out_buf = _expert_ffn(buf, {n: p[n] for n in _wnames(cfg)}, cfg.mlp_type)

    gathered = torch.where(keep[:, None], out_buf[eid, slot], 0)
    weighted = gathered * gate_vals.reshape(-1)[:, None].to(gathered.dtype)
    out = torch.zeros((T, D), dtype=weighted.dtype, device=x.device)
    out.index_add_(0, tok, weighted)
    return out.reshape(B, S, D).to(x.dtype), aux
