"""xLSTM blocks, PyTorch port of ``src/repro/models/xlstm.py``: mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, a true
recurrence).

mLSTM recurrence (per head, stabilised):
    C_t = f_t C_{t-1} + i_t k_t v_t^T        f_t = sigmoid(f~), i_t = exp(i~)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t^T C_t) / max(|q_t . n_t|, 1)

It runs in the reference's chunkwise form (intra-chunk quadratic plus
an inter-chunk carried state (C~, n~, m)) with the reference's chunk
sizes, 256 for mLSTM and 64 for sLSTM, so that the port reassociates
the sums as the reference does.  The ``lax.scan`` over chunks (and for
sLSTM over steps) becomes a Python loop; in training the model
checkpoints each pattern unit (``model.apply_stack``), not each chunk.
Decode is the Q = 1 case of the same chunk function.

On a mesh (``ctx``), the mLSTM is tensor-parallel as the reference's
specs lay it out: ``up_x`` is column-parallel over the ``mlp`` axes,
and ``wq``, ``wk``, ``w_i`` and ``w_f`` contract over the split
``d_inner`` (one ``reduce_from`` of the four partial sums a chunk, then
``copy_to`` into the work the ``head_v`` axes split); ``up_z``, ``wv``
and the C state's v dim split over ``head_v`` (``wv`` reads the
inner activations gathered over ``mlp``), so the chunk's products and
its state update stay on the rank, and ``out`` is row-parallel over
``head_v``.  The sLSTM's FFN is column-parallel in and row-parallel out
over ``mlp``; its recurrence is replicated.  FSDP's data axes are
gathered first (``ModelCtx.gathered``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import costs
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import copy_to, gather_from, reduce_from
from repro_torch.models.param import PSpec

NEG = -1e30


# ------------------------------------------------------------- mLSTM -------

def mlstm_specs(cfg: ArchConfig):
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


def mlstm_state_shapes(cfg: ArchConfig, batch: int):
    H = cfg.n_heads
    dh = cfg.d_inner // H
    return {
        "C": ((batch, H, dh, dh), torch.float32),
        "n": ((batch, H, dh), torch.float32),
        "m": ((batch, H), torch.float32),
    }


def _mlstm_chunk(q, k, v, a, b, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q, k, v: (B, H, Q, dh); a = logsigmoid(f~), b = i~ preacts: (B, H, Q)
    f32.  state: dict(C~ (B, H, dh, dh), n~ (B, H, dh), m (B, H)), f32;
    its C~ and n~ are updated in place and returned with the new m.
    """
    Q, dh = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf = q.float(), k.float(), v.float()
    la = torch.cumsum(a, dim=-1)                        # (B,H,Q) inclusive
    # log-weight of source j at target i: la_i - la_j + b_j  (j <= i)
    g = la[..., :, None] - la[..., None, :] + b[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    g = g.masked_fill(~mask, NEG)
    # carry contribution log-weight at target i: la_i + m_prev
    g_carry = la + state["m"][..., None]                # (B,H,Q)
    m_i = torch.maximum(g.amax(dim=-1), g_carry)        # (B,H,Q)

    w_intra = torch.exp(g - m_i[..., None])             # (B,H,Q,Q)
    w_carry = torch.exp(g_carry - m_i)                  # (B,H,Q)

    s = (qf @ kf.transpose(-1, -2)) * scale
    sw = s * w_intra
    q_s = qf * scale
    num = sw @ vf + w_carry[..., None] * (q_s @ state["C"])
    qn = sw.sum(dim=-1) + w_carry * (q_s @ state["n"][..., None])[..., 0]
    h = num / torch.maximum(qn.abs(), torch.exp(-m_i))[..., None]

    # ---- state update to the end of the chunk ----
    LA = la[..., -1]                                    # (B,H) total log-decay
    g_end = LA[..., None] - la + b                      # (B,H,Q) weight of j at end
    m_next = torch.maximum(LA + state["m"], g_end.amax(dim=-1))
    w_end = torch.exp(g_end - m_next[..., None])
    decay = torch.exp(LA + state["m"] - m_next)
    # C~ and n~ are updated in place (at decode they are the cache's
    # slot), with the reference's two roundings: decay * C, then + the sum;
    # where autograd records the chunk, as new tensors, since the backward
    # reads the old ones.
    # sum_j w_end[j] k_j v_j^T as one product: no (B, H, Q, dh, dh) term
    C, n = state["C"], state["n"]
    dC = (w_end[..., None] * kf).transpose(-1, -2) @ vf
    dn = (w_end[..., None, :] @ kf)[..., 0, :]
    if torch.is_grad_enabled() and (C.requires_grad or n.requires_grad
                                    or dC.requires_grad):
        C = C * decay[..., None, None] + dC
        n = n * decay[..., None] + dn
    else:
        C.mul_(decay[..., None, None]).add_(dC)
        n.mul_(decay[..., None]).add_(dn)
    return h, {"C": C, "n": n, "m": m_next}


def _tp_axes(ctx, specs: dict, mlp: str, head_v: str | None = None):
    """(mesh, the ``mlp`` axes of ``specs[mlp]``'s last dim, the
    ``head_v`` axes of ``specs[head_v]``'s) on a mesh, with FSDP's
    data axes of the weights gathered by the caller."""
    if ctx is None or ctx.mesh is None:
        return None, (), ()
    m = ctx.axes(specs[mlp], len(specs[mlp].shape) - 1)
    hv = () if head_v is None else ctx.axes(specs[head_v], 2)
    if head_v is not None and m and m != hv:
        raise NotImplementedError(
            f"xLSTM: mlp over {m} and head_v over {hv}: the gather of the "
            "inner activations would sum v's gradient over other axes")
    return ctx.mesh, m, hv


def mlstm_forward(x, p, cfg: ArchConfig, *, chunk: int = 256, state=None,
                  ctx=None):
    """x: (B, L, D) -> (y, state).  A given ``state`` has its C and n
    updated in place: at decode they are the cache's own tensors, 5.6 GB
    for xLSTM-1.3B at batch 8, so no step copies them.  With a ``ctx`` on
    a mesh, ``p`` holds the rank's slices and C its v columns (module
    docstring)."""
    B, L, D = x.shape
    H = cfg.n_heads
    specs = mlstm_specs(cfg)
    if ctx is not None and ctx.mesh is not None:
        p = ctx.gathered_tree(p, specs)
    mesh, m_axes, hv_axes = _tp_axes(ctx, specs, "up_x", "wv")
    dh, dv = p["wq"].shape[2], p["wv"].shape[2]

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = {"C": torch.zeros((B, H, dh, dv), **f32),
                 "n": torch.zeros((B, H, dh), **f32),
                 "m": torch.zeros((B, H), **f32)}

    def proj(x_c):
        xi = copy_to(x_c, mesh, m_axes) @ p["up_x"]          # (B,Q,din_loc)
        z = torch.einsum("bqd,dhe->bqhe", copy_to(x_c, mesh, hv_axes),
                         p["up_z"])
        parts = (torch.einsum("bqi,ihd->bhqd", xi, p["wq"]),
                 torch.einsum("bqi,ihd->bhqd", xi, p["wk"]),
                 torch.einsum("bqi,ih->bhq", xi, p["w_f"])[..., None],
                 torch.einsum("bqi,ih->bhq", xi, p["w_i"])[..., None])
        if m_axes:
            # the contractions over the split d_inner, summed in one
            whole = reduce_from(torch.cat(parts, dim=-1), mesh, m_axes)
            parts = whole.split([t.shape[-1] for t in parts], dim=-1)
        q, k, f_, i_ = parts
        # whole from here, entering the work the head_v axes split
        q, k, f_, i_ = (copy_to(t, mesh, hv_axes) for t in (
            q, k, f_[..., 0] + p["b_f"][None, :, None],
            i_[..., 0] + p["b_i"][None, :, None]))
        # wv reads every inner channel: xi gathered over the mlp axes
        v = torch.einsum("bqi,ihd->bhqd", gather_from(xi, mesh, m_axes, 2)
                         if m_axes else copy_to(xi, mesh, hv_axes), p["wv"])
        return q, k, v, F.logsigmoid(f_.float()), i_.float(), z

    def readout(h, z):
        """h: (B,H,Q,dh_v), z: (B,Q,H,dh_v) -> (B,Q,D), summed over the
        ``head_v`` axes."""
        y = h.to(z.dtype).permute(0, 2, 1, 3) * F.silu(z)
        return reduce_from(torch.einsum("bqhe,hed->bqd", y, p["out"]), mesh,
                           hv_axes)

    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {Q}")
    outs = []
    for x_c in costs.each(x.split(Q, dim=1)):
        q, k, v, a, b, z = proj(x_c)
        h, state = _mlstm_chunk(q, k, v, a, b, state)
        outs.append(readout(h, z))
    return torch.cat(costs.fill(outs, L // Q), dim=1), state


# ------------------------------------------------------------- sLSTM -------

def slstm_specs(cfg: ArchConfig):
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


def slstm_state_shapes(cfg: ArchConfig, batch: int):
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {k: ((batch, H, dh), torch.float32) for k in ("c", "n", "h", "m")}


def _recurrent_weights(p):
    """``r_gates`` (4, H, dh, dh) as f32 (H, dh, 4*dh): one head's four
    gate matrices side by side, so that a step is one batched product
    over heads that reads each weight once."""
    r = p["r_gates"].float()
    return r.permute(1, 2, 0, 3).reshape(r.shape[1], r.shape[2], -1)


def _slstm_step(p, st, gx_t, rt=None):
    """gx_t: (B, 4, H, dh) input-side gate preacts for one step.  ``rt``
    is ``_recurrent_weights(p)``, when the caller has made it once."""
    c, n, h, m = st["c"], st["n"], st["h"], st["m"]
    if rt is None:
        rt = _recurrent_weights(p)
    B, H, dh = h.shape
    # gr[b, g, h, e] = sum_d h[b, h, d] r_gates[g, h, d, e]
    gr = torch.bmm(h.transpose(0, 1), rt).view(H, B, 4, dh) \
        .permute(1, 2, 0, 3)                                  # (B,4,H,dh)
    g = gx_t.float() + gr + p["b_gates"]
    zt = torch.tanh(g[:, 0])
    it, ft, ot = g[:, 1], g[:, 2], torch.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    h = ot * c / n.clamp_min(1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_forward(x, p, cfg: ArchConfig, *, chunk: int = 64, state=None,
                  ctx=None):
    """x: (B, L, D) -> (y, state).  Strictly sequential recurrence; the
    reference's chunks of 64 only bound its backward memory, so the port
    steps through the sequence in one loop.  ``chunk`` is kept for the
    reference's signature and only checks that L is a multiple of it.
    With a ``ctx`` on a mesh, the FFN's weights are the rank's slices
    over ``mlp`` (module docstring)."""
    B, L, D = x.shape
    specs = slstm_specs(cfg)
    if ctx is not None and ctx.mesh is not None:
        p = ctx.gathered_tree(p, specs)
    mesh, m_axes, _ = _tp_axes(ctx, specs, "ffn_up")
    H = cfg.n_heads
    dh = D // H

    if state is None:
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = {"c": z, "n": z, "h": z, "m": z}
    if L > 1 and L % min(chunk, L):
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")

    gx = torch.einsum("bld,dghe->blghe", x, p["w_gates"])      # (B,L,4,H,dh)
    rt = _recurrent_weights(p)
    hs = []
    for t in costs.trips(L):
        state = _slstm_step(p, state, gx[:, t], rt)
        hs.append(state["h"])
    y = torch.stack(costs.fill(hs, L), dim=1).reshape(B, L, H * dh).to(x.dtype)
    # post-up-projection FFN (sLSTM block style)
    y = copy_to(y, mesh, m_axes)
    h2 = F.silu(y @ p["ffn_gate"]) * (y @ p["ffn_up"])
    return reduce_from(h2 @ p["ffn_down"], mesh, m_axes), state
