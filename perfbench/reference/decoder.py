"""Plain PyTorch reference of the decoder the port serves: every layer's
equations written out in float32, with no kernel, cache or batching of
the program's.  It reads the benchmark's own weights (``weights.py``'s
layout) and the benchmark's tokens, and nothing the program made.

Per layer: RMSNorm, q/k/v projections, rotary embedding (the half-split
form, ``theta ** (-i / (D/2))``), causal softmax attention at
``1/sqrt(D)`` with each q head reading kv head ``h // (Hq / Hkv)``, the
output projection into the residual; RMSNorm, then the gated-SiLU MLP,
or, on the layers where ``i % moe_every == moe_offset % moe_every``
(every layer by default) of a model with experts, the mixture of
experts: an f32 softmax router, top-k with the gates
renormalised, each assignment's rank within its expert in token order,
a capacity of ``int(capacity_factor * T * k / E) + 1`` assignments per
expert over the T tokens of the batch with the overflow dropped, and
the gate-weighted sum of the kept experts' gated-SiLU outputs.  Each
FFN leaf is stacked over the layers of its kind only.  A tied
model scales its embedding by sqrt(d_model) and reads its logits off
the table.

``quant="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 first (the input per row, the weight per output
column, each scaled to the format's range), the rest as above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by its largest magnitude
    along ``dim``, back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in float32."""
    x = x.float()
    w = w.float()
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif quant is not None:
        raise ValueError(quant)
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, theta: float):
    """x (B, H, L, D) at positions 0..L-1."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    ang = torch.arange(x.shape[2], dtype=torch.float32,
                       device=x.device)[:, None] * torch.pow(float(theta), exps)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, *, q_block: int = 1024, budget: int = 1 << 28):
    """Causal softmax attention, q (B, Hq, L, D), k, v (B, Hkv, L, D),
    in blocks of rows and queries so that no score block passes
    ``budget`` elements."""
    B, Hq, L, D = q.shape
    group = Hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    qb = min(q_block, L)
    rows = max(1, budget // (Hq * qb * L))
    keys = torch.arange(L, device=q.device)
    for b in range(0, B, rows):
        for s in range(0, L, qb):
            e = min(s + qb, L)
            sc = q[b:b + rows, :, s:e] @ k[b:b + rows].transpose(-1, -2)
            sc = sc / math.sqrt(D)
            mask = keys[None, :] > torch.arange(s, e, device=q.device)[:, None]
            sc = sc.masked_fill(mask, float("-inf"))
            out[b:b + rows, :, s:e] = torch.softmax(sc, dim=-1) \
                @ v[b:b + rows]
    return out


def _gated(h, wg, wu, wd, quant):
    return mm(F.silu(mm(h, wg, quant)) * mm(h, wu, quant), wd, quant)


def dense_ffn(h, w, i, quant, block: int = 8192):
    """h (T, D) -> (T, D): the ``i``-th dense layer's MLP."""
    out = torch.empty_like(h)
    for s in range(0, h.shape[0], block):
        out[s:s + block] = _gated(h[s:s + block], w["wi_gate"][i],
                                  w["wi_up"][i], w["w_down"][i], quant)
    return out


def moe_ffn(h, w, i, arch, quant):
    """h (T, D) -> (T, D): the ``i``-th MoE layer's routed experts over
    all T tokens."""
    T = h.shape[0]
    E, k = arch["n_experts"], arch["top_k"]
    probs = torch.softmax(mm(h, w["router"][i], quant), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    eid = idx.reshape(-1)                       # token-major, then k
    rank = torch.cumsum(F.one_hot(eid, E), dim=0).gather(
        1, eid[:, None])[:, 0] - 1
    cap = int(arch.get("capacity_factor", 1.25) * T * k / E) + 1
    keep = rank < cap
    gate = gate.reshape(-1)
    out = torch.zeros_like(h)
    for e in range(E):
        sel = torch.nonzero((eid == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        tok = sel // k
        y = _gated(h[tok], w["we_gate"][i, e], w["we_up"][i, e],
                   w["we_down"][i, e], quant)
        out.index_add_(0, tok, y * gate[sel, None])
    return out


def logits_at(arch: dict, w: dict, tokens: torch.Tensor, positions,
              quant=None) -> torch.Tensor:
    """float32 logits over the padded vocabulary at ``positions`` of
    each row of ``tokens`` (B, L): (B, len(positions), V)."""
    B, L = tokens.shape
    D, H, Kv = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    eps, theta = arch.get("norm_eps", 1e-6), arch["rope_theta"]
    tied = arch.get("tie_embeddings", False)
    every = arch.get("moe_every", 1)
    n_moe = 0
    x = w["table"][tokens].float()
    if tied:
        x = x * math.sqrt(D)
    for i in range(arch["n_layers"]):
        h = rmsnorm(x, w["ln1"][i], eps)
        q = mm(h, w["wq"][i].reshape(D, H * hd), quant)
        kk = mm(h, w["wk"][i].reshape(D, Kv * hd), quant)
        vv = mm(h, w["wv"][i].reshape(D, Kv * hd), quant)
        q = rope(q.view(B, L, H, hd).transpose(1, 2), theta)
        kk = rope(kk.view(B, L, Kv, hd).transpose(1, 2), theta)
        vv = vv.view(B, L, Kv, hd).transpose(1, 2)
        o = attention(q, kk, vv).transpose(1, 2).reshape(B, L, H * hd)
        del q, kk, vv
        x = x + mm(o, w["wo"][i].reshape(H * hd, D), quant)
        del o
        h = rmsnorm(x, w["ln2"][i], eps).reshape(B * L, D)
        if arch.get("n_experts") and \
                i % every == arch.get("moe_offset", 0) % every:
            y = moe_ffn(h, w, n_moe, arch, quant)
            n_moe += 1
        else:
            y = dense_ffn(h, w, i - n_moe, quant)
        x = x + y.view(B, L, D)
        del h, y
    xl = rmsnorm(x[:, list(positions)], w["ln_f"], eps)
    head = w["table"].t() if tied else w["lm_head"]
    return mm(xl, head, quant)


def gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """By how much each served token's reference logit lies below the
    reference's best: ``ref_logits`` (N, V), ``served`` (N,) ids."""
    ref_logits = ref_logits.float()
    return ref_logits.amax(-1) - ref_logits.gather(
        1, served.long().to(ref_logits.device)[:, None])[:, 0]
