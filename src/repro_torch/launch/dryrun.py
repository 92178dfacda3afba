"""Multi-pod dry-run, PyTorch port of ``src/repro/launch/dryrun.py``:
every (arch x shape) cell on the production meshes, with the rule table
and the residency each device would hold.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]

The 16x16 and 2x16x16 meshes are built over torch's ``fake`` process
group of 256 or 512 ranks in this one process, one after the other:
nothing is allocated and no collective runs.  Each record holds the
cell's rules, parameter count, ``w8a16`` and optimizer-state dtype
choices, ``default_accum`` and ``analytic_device_bytes`` (params, opt,
caches, inputs), computed with the port's ``spec_for``.  The reference
also lowers and compiles each cell's step with XLA and records its
FLOPs, traffic, collective bytes and memory analysis; the port has no
compiler and leaves those fields out rather than estimating them.  The
rules come from ``mesh.make_rules`` directly, the table ``build_ctx``
builds its context from: a record needs no context.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import all_cells, get_arch, get_shape
from repro_torch.distributed.mesh import make_rules, spec_axes, spec_for
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import io
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.training.optimizer import opt_pspecs
from repro_torch.training.train_step import default_accum

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


def cell_record(arch: str, shape_name: str, mesh) -> dict:
    """The record of one cell on ``mesh``."""
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
    return {
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


def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run(cells, multi_pods) -> list[dict]:
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
                    rec = cell_record(arch, sname, mesh)
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
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = run(cells, meshes)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    bad = [r for r in records if "error" in r]
    print(f"\n{len(records) - len(bad)}/{len(records)} cells OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
