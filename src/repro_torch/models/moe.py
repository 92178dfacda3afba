"""Mixture-of-Experts FFN, PyTorch port of ``src/repro/models/moe.py``.

The JAX package runs ``moe_block``'s body inside a fully manual
``shard_map``; the port runs the same body on every rank, with the
collectives written where the reference's stand and where its
transposes put them (``check_vma=False``):

  * expert-sharded (the experts divide the model axes): each rank owns
    ``E / e_div`` experts, picked by ``axis_index``; every rank of a
    model group routes the same tokens, so dispatch is local and one
    ``reduce_from`` combines the experts' contributions;
  * ffn-sharded (Grok-1: experts that do not divide the model axes):
    every expert on every rank, each expert's ``d_ff`` split over
    ``model``; the same ``reduce_from`` sums the partial down-projections;
  * FSDP training: the weights' ``d_model`` dim split over the data axes,
    gathered in the body (``gather_from``, reduce-scattered backward).
  * 2-D serving: ``expert_mlp`` over the data axes as well (and
    ``model`` for Grok-1's fallback); the one ``reduce_from`` sums over
    experts and d_ff chunks alike.  The tokens a reduction sums over
    must be the same on every rank of it: where the rows are split over
    an axis that also splits the experts' d_ff (a prefill shape's batch
    over ``data``), the rank gathers the rows over that axis first and
    keeps its own after the sum.  The reference's ``shard_map`` splits
    the rows over the data axes wherever the global batch divides them
    (``batch_sharded``), also where the decode rules replicate the
    batch, and so sums different rows' partial outputs (ROADMAP.md §3);
    the port splits no rows the rules replicate.

The body's inputs take the reference's transpose: the tokens and the
router enter through ``copy_to``/``gather_from`` over the reduced axes,
so their gradients are summed over them, and the balance loss, which
every rank of a model group computes alike, passes each rank the share
``1 / |reduced axes|`` of its gradient.  Capacity comes from the rank's
own token count and ``aux`` is the mean of the per-shard losses over the
data axes, as in the reference.  Without a mesh every axis is empty and
the collectives vanish.

The body: an f32 softmax router, top-k with renormalised gates, the
switch load-balance loss, each assignment's rank within its expert by a
one-hot cumsum, capacity ``int(capacity_factor * T * k / E) + 1`` with
the overflow dropped, a scatter into an (E_loc, cap, D) buffer, the
expert FFNs as batched products, and the gate-weighted combine, in x's
dtype as in the reference.

Returns (out, aux) where aux is the switch-style load-balance loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.mesh import (
    all_reduce_axes, axis_index, copy_to, entry_axes, gather_from,
    local_chunk, mesh_axis_size, reduce_from, spec_axes, spec_for)
from repro_torch.models.param import PSpec
from repro_torch.spans import span


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


def moe_block(x, p, cfg: ArchConfig, mesh=None, *, rules=None,
              data_axes: tuple[str, ...] = (), batch_sharded: bool = True,
              batch_axes: tuple[str, ...] = ()):
    """x: (B, S, D), the rank's rows, split over ``batch_axes`` -> (out
    (B, S, D) in x's dtype, aux f32 scalar)."""
    with span("ft:moe"):
        E, k = cfg.n_experts, cfg.top_k
        specs = moe_specs(cfg)

        def spec(name):
            ps = specs[name]
            if mesh is None:
                return (None,) * len(ps.shape)
            return spec_for(ps.shape, ps.logical, rules, mesh)
        e_axes, d_axes, f_axes = map(entry_axes, spec(_wnames(cfg)[0]))
        red = tuple(dict.fromkeys(e_axes + f_axes))
        rows = tuple(a for a in batch_axes if a in red)
        x = gather_from(x, mesh, rows, 0)
        B, S, D = x.shape
        e_loc = E // (mesh_axis_size(mesh, e_axes) if e_axes else 1)

        # the body's inputs: the tokens, with their gradient summed over the
        # reduced axes; the router whole (P(None, None)), likewise; the
        # experts whole over d_model
        router = p["router"]
        for dim, part in enumerate(spec("router")):
            router = gather_from(router, mesh, entry_axes(part), dim)
        router = copy_to(router, mesh, tuple(
            a for a in red if a not in spec_axes(spec("router"))))
        wp = {n: gather_from(p[n], mesh, d_axes, 2 if n == "wo" else 1)
              for n in _wnames(cfg)}
        T = B * S
        flat = copy_to(x, mesh, red).reshape(T, D)

        probs = torch.softmax(flat.float() @ router.float(), dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # (T, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        # switch-style load-balance loss, averaged over the data shards
        me = probs.mean(dim=0)
        ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
        ce.index_add_(0, gate_idx.reshape(-1),
                      torch.full((T * k,), 1.0 / (T * k), device=x.device))
        aux = E * torch.sum(me * ce)
        if mesh is not None:
            aux = _shard_mean(aux, mesh, data_axes if batch_sharded else (),
                              mesh_axis_size(mesh, red))

        # rank of each assignment within its expert (one-hot cumsum)
        eid = gate_idx.reshape(-1)                                # (T*k,)
        with span("ft:moe.rank"):
            onehot = F.one_hot(eid, E).to(torch.int32)
            rank = torch.gather(torch.cumsum(onehot, dim=0), 1,
                                eid[:, None])[:, 0] - 1

        cap = int(cfg.capacity_factor * T * k / E) + 1
        keep = rank < cap
        le = eid
        if e_axes:
            keep = keep & (eid // e_loc == axis_index(mesh, e_axes))
            le = eid % e_loc
        slot = rank.clamp(0, cap - 1)

        tok = torch.arange(T, device=x.device).repeat_interleave(k)
        src = torch.where(keep[:, None], flat[tok], 0)
        buf = torch.zeros((e_loc, cap, D), dtype=x.dtype, device=x.device)
        buf.index_put_((le, slot), src, accumulate=True)

        out_buf = _expert_ffn(buf, wp, cfg.mlp_type)           # (E_loc,C,D)

        gathered = torch.where(keep[:, None], out_buf[le, slot], 0)
        weighted = gathered * gate_vals.reshape(-1)[:, None].to(gathered.dtype)
        # each token's k contributions added in the order of the reference's
        # scatter-add, with no atomics (the card's index_add_ adds in an order
        # that varies from run to run)
        weighted = weighted.view(T, k, D)
        out = weighted[:, 0]
        for j in range(1, k):
            out = out + weighted[:, j]
        out = reduce_from(out, mesh, red).reshape(B, S, D).to(x.dtype)
        return local_chunk(out, mesh, rows, 0), aux


def _shard_mean(aux, mesh, axes: tuple[str, ...], n_red: int):
    """The balance loss as the reference's body returns it: the value the
    mean of the shards' losses over ``axes``; the gradient, as its
    ``P()`` output transposes, the rank's ``1 / n_red`` share (each rank
    of a reduced group computes the same loss, and the tokens and the
    router sum their gradients over the group)."""
    val = aux.detach().clone()
    if axes:
        all_reduce_axes(val, mesh, axes).div_(
            torch.tensor(float(mesh_axis_size(mesh, axes)), device=val.device))
    share = aux / n_red
    return share + (val - share).detach()
