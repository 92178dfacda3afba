"""Multi-pod dry-run, PyTorch port of ``src/repro/launch/dryrun.py``:
every (arch x shape) cell on the production meshes, with the rule table,
the residency each device would hold and what one device's step costs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]
  ... [--no-costs]     # the rules and bytes alone, without the step trace

The 16x16 and 2x16x16 meshes are built over torch's ``fake`` process
group of 256 or 512 ranks in this one process, one after the other:
nothing is allocated and no collective moves a byte.  Each record holds
the cell's rules, parameter count, ``w8a16`` and optimizer-state dtype
choices, ``default_accum`` and ``analytic_device_bytes`` (params, opt,
caches, inputs), computed with the port's ``spec_for``, and, from
``step_costs``, rank 0's step traced on ``meta`` tensors (``trace_s``:
the trace's host seconds):

  * ``flops``: the matrix products' ``2 * prod(out) * contracted``,
    loop-aware (``costs.py``), forward, checkpoint recomputation and
    backward;
  * ``traffic_bytes``: an unfused HBM model: the operand and output
    bytes of every materializing aten op, plus every collective's output
    bytes;
  * ``collective_bytes``: output bytes by kind, one entry per
    collective the port calls: ``all-reduce`` for each step of
    ``mesh.all_reduce_axes`` (the tensor) and for ``compressed_psum_leaf``'s
    two (the f32 block scales, the int32 codes); ``all-gather`` for each
    step of ``gather_full`` and ``gather_dim`` (the gathered parts);
    ``reduce-scatter`` for each step of ``reduce_scatter_dim`` (the
    rank's chunk); ``all-to-all`` for ``resharding._all_to_all`` (the
    received chunks); ``collective-permute`` for each ring hop of
    ``resharding._ring`` (the received shard).

They mean what the reference's ``hlo_analysis`` fields mean, per device
and loop-aware, but count the port's program: the attention is the
plain full-matrix product on ``meta`` (the reference's ``jnp``
blockwise attention, ``4 B Hq Lq Lkv D`` forward), its backward the
plain ``attention_bwd_ref`` that ``meta`` keeps in place of the card's
``flash_attention_bwd`` kernel (its blockwise recompute and autograd:
the visible pairs' ``Q K^T`` and ``P V`` again, then four products); a
collective over several mesh axes is one
collective per axis (``mesh._steps``) where GSPMD makes one over all of
them; a sharded body's collectives stand where the port calls them.
The reference's ``xla_*_scan_once`` fields and XLA's memory analysis
stay out: there is no compiler.  The rules come from ``mesh.make_rules``
directly, the table ``build_ctx`` builds its context from.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import all_cells, get_arch, get_shape
from repro_torch.costs import CostCounter
from repro_torch.distributed.mesh import (
    local_shape, make_opt_rules, make_rules, spec_axes, spec_for,
    use_small_dense_dp)
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import io
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.training.optimizer import (
    OptConfig, init_opt_state, opt_pspecs, zero1_shardings)
from repro_torch.training.train_step import build_train_step, default_accum

DTYPE_NBYTES = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1,
                torch.int32: 4}


def analytic_device_bytes(pspec_tree, rules, mesh) -> int:
    """Exact per-device residency of a PSpec tree under the cell's rules."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0
    for p in PM.tree_leaves(pspec_tree):
        shards = 1
        for ax in spec_axes(spec_for(p.shape, p.logical, rules, mesh)):
            shards *= sizes[ax]
        nbytes = PM.count_params(p) * DTYPE_NBYTES[p.dtype]
        total += nbytes // shards
    return total


def opt_state_dtype(cfg) -> str:
    n = PM.count_params(M.model_specs(cfg))
    return "int8" if n > 50e9 else "f32"


def use_w8a16(cfg, shape, mesh) -> bool:
    """Weight-only int8 for big dense decode: the memory term is weight
    streaming; halving weight bytes beats 2D sharding, which pays
    batch-replication psums (``distributed/mesh.py``'s note)."""
    if shape.kind != "decode" or cfg.n_experts:
        return False
    n = PM.count_params(M.model_specs(cfg))
    model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    return 2 * n / model > 4e9


def _local_meta(pspecs, rules, mesh):
    """``meta`` tensors of the rank's slices of a spec tree (whole
    without a mesh)."""
    def leaf(p):
        shape = p.shape if mesh is None else local_shape(
            p.shape, spec_for(p.shape, p.logical, rules, mesh), mesh)
        return torch.empty(shape, dtype=p.dtype, device="meta")
    return PM.tree_map(leaf, pspecs)


def build_step(cfg, shape, mesh=None, *, accum: int | None = None):
    """(step, its arguments): the step ``lower_cell`` builds for the
    cell's kind, on ``meta`` tensors of rank 0's local shapes: ``train``
    the train step (``opt_state_dtype``, ``default_accum`` unless
    ``accum`` is given, ZeRO-1 where the cell is small-dense DP) over the
    global batch, which the step cuts to the rank's rows; ``prefill``
    ``M.prefill`` over the rank's rows; ``decode`` ``M.decode_step`` at
    the last position of a full cache, after ``wquant.dequant_tree`` for
    a ``w8a16`` cell.  ``mesh=None`` is one device."""
    ctx = M.build_ctx(cfg, shape, mesh)
    rules = ctx.rules
    raw = M.model_specs(cfg)
    if shape.kind == "train":
        oc = OptConfig(state_dtype=opt_state_dtype(cfg),
                       schedule=cfg.lr_schedule)
        zshd = opt_rules = None
        if mesh is not None:
            opt_rules = make_opt_rules(cfg, shape, mesh, rules)
            if use_small_dense_dp(cfg, shape, mesh):
                zshd = zero1_shardings(raw, oc.state_dtype, opt_rules, mesh)
        if accum is None:
            accum = default_accum(shape, mesh, cfg)
        step = build_train_step(cfg, ctx, oc, accum, zshd)
        params = PM.trainable(_local_meta(raw, rules, mesh))
        opt = init_opt_state(raw, oc.state_dtype, "meta", rules=opt_rules,
                             mesh=mesh)
        return step, (params, opt, io.input_specs(cfg, shape))
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return M.prefill(cfg, ctx, params, batch)
        return prefill_step, (_local_meta(raw, rules, mesh), _local_meta(
            io.batch_pspecs(cfg, shape), rules, mesh))
    w8 = mesh is not None and use_w8a16(cfg, shape, mesh)
    cache_len = shape.seq_len // 2 if cfg.enc_layers else shape.seq_len
    dctx = M.decode_ctx(cfg, ctx, prompt_len=cache_len, cache_len=cache_len,
                        enc_len=cache_len if cfg.enc_layers else 0)
    pos = cache_len - 1
    if w8:
        from repro_torch.serving.wquant import dequant_tree, quant_pspecs

        def serve_step_w8(qparams, caches, token):
            return M.decode_step(cfg, dctx, dequant_tree(qparams), caches,
                                 token, pos)
        step, pspecs = serve_step_w8, quant_pspecs(raw)
    else:
        def serve_step(params, caches, token):
            return M.decode_step(cfg, dctx, params, caches, token, pos)
        step, pspecs = serve_step, raw
    token = _local_meta(io.batch_pspecs(cfg, shape), rules, mesh)["token"]
    return step, (_local_meta(pspecs, rules, mesh), _local_meta(
        M.cache_pspecs(cfg, shape), rules, mesh), token)


def step_costs(cfg, shape, mesh=None, **kw) -> dict:
    """``flops``, ``traffic_bytes`` and ``collective_bytes`` of one step
    of rank 0 (``build_step``), traced on ``meta`` tensors under a
    ``CostCounter`` (module docstring).  Ranks do different work where
    the rules make them: rank 0 holds the first q heads and the kv heads
    they read where GQA heads do not divide the model axes, the first
    vocab rows (whose embedding lookups and target logits it takes), the
    first experts, and the first positions of a sequence-sharded cache;
    the counts are its work."""
    step, args = build_step(cfg, shape, mesh, **kw)
    with CostCounter() as c:
        step(*args)
    return c.totals()


def cell_record(arch: str, shape_name: str, mesh, costs: bool = True
                ) -> dict:
    """The record of one cell on ``mesh``; with ``costs``, rank 0's step
    traced (``step_costs``)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    rules = make_rules(cfg, shape, mesh)
    pspecs_raw = M.model_specs(cfg)
    pspecs = pspecs_raw
    w8 = use_w8a16(cfg, shape, mesh)
    if w8:
        from repro_torch.serving.wquant import quant_pspecs
        pspecs = quant_pspecs(pspecs_raw)
    ost = opt_state_dtype(cfg)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "kind": shape.kind,
        "rules": {k: list(v) for k, v in rules.items()},
        "params": PM.count_params(pspecs_raw),
        "w8a16": w8,
        "opt_state_dtype": ost,
        "accum": default_accum(shape, mesh, cfg),
        "analytic_device_bytes": {
            "params": analytic_device_bytes(pspecs, rules, mesh),
            "opt": (analytic_device_bytes(opt_pspecs(pspecs, ost), rules, mesh)
                    if shape.kind == "train" else 0),
            "caches": (analytic_device_bytes(M.cache_pspecs(cfg, shape),
                                             rules, mesh)
                       if shape.kind == "decode" else 0),
            "inputs": analytic_device_bytes(io.batch_pspecs(cfg, shape),
                                            rules, mesh),
        },
    }
    if costs:
        t0 = time.perf_counter()
        rec.update(step_costs(cfg, shape, mesh))
        rec["trace_s"] = time.perf_counter() - t0
    return rec


def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run(cells, multi_pods, costs: bool = True) -> list[dict]:
    """Records for ``cells`` on each mesh of ``multi_pods``; a cell that
    raises is recorded with its error."""
    records = []
    for mp in multi_pods:
        shape, _ = production_shape(mp)
        n = 1
        for s in shape:
            n *= s
        fake_world(n)
        try:
            mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
            for arch, sname in cells:
                try:
                    rec = cell_record(arch, sname, mesh, costs)
                    print(json.dumps(rec))
                except Exception as e:  # a failure here is a bug in our system
                    rec = {"arch": arch, "shape": sname,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}"}
                    print(json.dumps(rec), file=sys.stderr)
                records.append(rec)
        finally:
            dist.destroy_process_group()
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-costs", action="store_true",
                    help="leave out the step trace (flops, traffic, "
                         "collective bytes)")
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = run(cells, meshes, not args.no_costs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    bad = [r for r in records if "error" in r]
    print(f"\n{len(records) - len(bad)}/{len(records)} cells OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
