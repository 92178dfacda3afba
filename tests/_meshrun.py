"""The port's side of the multi-rank mesh tests: each scenario runs on
every rank of a gloo group on the CPU, started by ``launch`` through
``python -m torch.distributed.run --standalone``.

    torchrun --nproc-per-node N tests/_meshrun.py <scenario> <ref_dir> <out_dir>

Each rank writes what the tests read to ``<out_dir>`` (rank 0 alone
where the result is the same on every rank).  The reference's side of
the same scenarios is ``tests/_meshref.py``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def launch(nproc: int, scenario: str, ref_dir, out_dir,
           timeout: float = 120) -> None:
    """Run one scenario on ``nproc`` gloo ranks of this machine."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(Path(__file__)), scenario,
         str(ref_dir), str(out_dir)],
        env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"{scenario} on {nproc} ranks failed:\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-8000:]}")


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _keyed(prefix: str, tree) -> dict:
    from repro_torch.training.checkpoint import _leaves
    return {f"{prefix}__{k}": t.detach().numpy() for k, t in _leaves(tree)}


def _tree(pspecs, prefix: str, data):
    """The tree of ``pspecs``' structure from reference-keyed arrays."""
    from repro_torch.models import param as PM
    from repro_torch.training.checkpoint import _leaves
    return PM.tree_unflatten(pspecs, [data[f"{prefix}__{k}"]
                                      for k, _ in _leaves(pspecs)])


def dp_state(name, arch, mesh, init):
    """(cfg, shape, ctx, params, opt, moment shardings, checkpoint
    shardings) of one DP scenario on ``mesh``, from the reference's
    initial parameters."""
    from _meshref import DP_BATCH, DP_SEQ

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_opt_rules
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training import optimizer as O
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    shape = ShapeSpec("t", DP_SEQ, DP_BATCH, "train")
    ctx = M.build_ctx(cfg, shape, mesh)
    pspecs = M.model_specs(cfg)
    opt_rules = make_opt_rules(cfg, shape, mesh, ctx.rules)
    params = PM.trainable(PM.from_numpy(_tree(pspecs, "params", init), "cpu",
                                        PM.shard_local(pspecs, ctx.rules,
                                                       mesh)))
    opt = O.init_opt_state(pspecs, "f32", "cpu", rules=opt_rules, mesh=mesh)
    zshd = O.zero1_shardings(pspecs, "f32", opt_rules, mesh)
    tree_shd = {"params": PM.shardings(pspecs, ctx.rules, mesh),
                "opt": PM.shardings(O.opt_pspecs(pspecs, "f32"), opt_rules,
                                    mesh)}
    return cfg, shape, ctx, params, opt, zshd, tree_shd


# ------------------------------------------------------------ scenarios ---

def dp(ref_dir, out):
    """Each DP scenario's step on its mesh from the reference's initial
    parameters and the tests' batch; rank 0 writes the loss and the whole
    new state.  After the first scenario's step, every rank saves a
    checkpoint of it, then restores the reference's checkpoint on the
    same mesh."""
    import torch
    import torch.distributed as dist
    from _meshref import DP_SCENARIOS

    from repro_torch.models import param as PM
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import build_train_step, default_accum

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    batches = np.load(Path(out) / "batches.npz")
    for name, arch, mshape, axes in DP_SCENARIOS:
        mesh = _mesh(mshape, axes)
        init = np.load(Path(ref_dir) / f"dp_{name}.npz")
        cfg, shape, ctx, params, opt, zshd, tree_shd = dp_state(
            name, arch, mesh, init)
        local_moments = sum(t.numel() for t in PM.tree_leaves(opt["m"]))
        step = build_train_step(cfg, ctx, O.OptConfig(
            schedule=cfg.lr_schedule), default_accum(shape, mesh, cfg), zshd)
        batch = {k.split("/", 1)[1]: torch.from_numpy(batches[k])
                 for k in batches.files if k.startswith(f"{name}/")}
        params, opt, m = step(params, opt, batch)
        whole = CKPT.gathered({"params": params, "opt": opt}, tree_shd)
        if rank == 0:
            np.savez(Path(out) / f"dp_{name}.npz",
                     loss=m["loss"].numpy(), local_moments=local_moments,
                     **_keyed("new_params", whole["params"]),
                     **_keyed("new_opt", whole["opt"]))
        if name != DP_SCENARIOS[0][0]:
            continue
        CKPT.save(Path(out) / "ckpt", 1, {"params": params, "opt": opt},
                  shardings=tree_shd)
        *_, fresh, fresh_opt, _, _ = dp_state(name, arch, mesh, init)
        got, _ = CKPT.restore(Path(ref_dir) / "ref_ckpt", 1,
                              {"params": fresh, "opt": fresh_opt}, tree_shd)
        whole = CKPT.gathered(got, tree_shd)
        if rank == 0:
            np.savez(Path(out) / "ref_ckpt_restored.npz",
                     **_keyed("new_params", whole["params"]),
                     **_keyed("new_opt", whole["opt"]))
    dist.barrier()
    dist.destroy_process_group()


def restore_1x2(ref_dir, out):
    """The checkpoint the 4-rank ``dp`` run saved, restored on a (1, 2)
    mesh with that mesh's ZeRO-1 shardings; each rank writes what it
    holds."""
    import torch.distributed as dist
    from _meshref import DP_SCENARIOS

    from repro_torch.training import checkpoint as CKPT

    dist.init_process_group("gloo")
    name, arch, _, _ = DP_SCENARIOS[0]
    mesh = _mesh((1, 2), ("data", "model"))
    init = np.load(Path(ref_dir) / f"dp_{name}.npz")
    *_, params, opt, _, tree_shd = dp_state(name, arch, mesh, init)
    got, _ = CKPT.restore(Path(out) / "ckpt", 1,
                          {"params": params, "opt": opt}, tree_shd)
    np.savez(Path(out) / f"restore_1x2_rank{dist.get_rank()}.npz",
             coord=np.array(mesh.get_coordinate()),
             **_keyed("new_params", got["params"]),
             **_keyed("new_opt", got["opt"]))
    dist.barrier()
    dist.destroy_process_group()


def tp_state(name, arch, mshape, axes, gb, mesh, init):
    """(cfg, shape, ctx, params, opt, tree shardings) of one
    weight-sharding scenario on ``mesh``: the rank's slices of the tests'
    initial parameters, its slices of zero moments."""
    from _meshref import TP_SEQ

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_opt_rules
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training import optimizer as O
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    shape = ShapeSpec("t", TP_SEQ, gb, "train")
    ctx = M.build_ctx(cfg, shape, mesh)
    pspecs = M.model_specs(cfg)
    opt_rules = make_opt_rules(cfg, shape, mesh, ctx.rules)
    params = PM.trainable(PM.from_numpy(
        _tree(pspecs, f"{name}/params", init), "cpu",
        PM.shard_local(pspecs, ctx.rules, mesh)))
    opt = O.init_opt_state(pspecs, "f32", "cpu", rules=opt_rules, mesh=mesh)
    tree_shd = {"params": PM.shardings(pspecs, ctx.rules, mesh),
                "opt": PM.shardings(O.opt_pspecs(pspecs, "f32"), opt_rules,
                                    mesh)}
    return cfg, shape, ctx, params, opt, tree_shd


def tp(ref_dir, out):
    """Each weight-sharding scenario whose mesh spans this world: one step
    from the tests' weights and batch, the gradients read at
    ``adamw_update``; rank 0 writes the loss and the gathered gradients,
    parameters and moments.  After the first (2, 2) scenario, every rank
    saves a checkpoint of its new state, which is restored on a (1, 4)
    mesh under that mesh's rules and gathered."""
    import torch.distributed as dist
    from _meshref import TP_SCENARIOS, XATTN_MESH

    from repro_torch.models import param as PM
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS

    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    init = np.load(Path(out) / "tp_inputs.npz")
    update, seen = TS.adamw_update, []

    def with_grads(oc, params, grads, opt_state, *shardings):
        seen.append(grads)
        return update(oc, params, grads, opt_state, *shardings)
    TS.adamw_update = with_grads
    for name, arch, mshape, axes, gb in TP_SCENARIOS:
        if int(np.prod(mshape)) != world:
            continue
        mesh = _mesh(mshape, axes)
        cfg, shape, ctx, params, opt, tree_shd = tp_state(
            name, arch, mshape, axes, gb, mesh, init)
        step = TS.build_train_step(cfg, ctx, O.OptConfig(
            schedule=cfg.lr_schedule), TS.default_accum(shape, mesh, cfg))
        batch = {k.split("/")[-1]: torch_from(init[k]) for k in init.files
                 if k.startswith(f"{name}/batch/")}
        params, opt, m = step(params, opt, batch)
        whole = CKPT.gathered({"grads": seen.pop(), "params": params,
                               "opt": opt},
                              dict(tree_shd, grads=tree_shd["params"]))
        if rank == 0:
            np.savez(Path(out) / f"tp_{name}.npz", loss=m["loss"].numpy(),
                     **_keyed("grads", whole["grads"]),
                     **_keyed("new_params", whole["params"]),
                     **_keyed("new_opt", whole["opt"]))
        if name != "nemotron_2x2":
            continue
        CKPT.save(Path(out) / "tp_ckpt", 1, {"params": params, "opt": opt},
                  shardings=tree_shd)
        dist.barrier()
        mesh14 = _mesh((1, 4), axes)
        *_, fresh, fresh_opt, shd14 = tp_state(name, arch, (1, 4), axes, gb,
                                               mesh14, init)
        got, _ = CKPT.restore(Path(out) / "tp_ckpt", 1,
                              {"params": fresh, "opt": fresh_opt}, shd14)
        whole = CKPT.gathered(got, shd14)
        held = sum(t.numel() for t in PM.tree_leaves(got["params"]))
        if rank == 0:
            np.savez(Path(out) / "tp_ckpt_on_1x4.npz", held=held,
                     **_keyed("new_params", whole["params"]),
                     **_keyed("new_opt", whole["opt"]))
    if world == int(np.prod(XATTN_MESH)):
        xattn(init, out, rank)
    dist.barrier()
    dist.destroy_process_group()


def xattn(init, out, rank):
    """``_meshref.xattn`` on this rank: its rows, its slices of the block's
    weights; the gradients summed over ``data`` where no gather did, then
    gathered; rank 0 writes them."""
    import torch
    from _meshref import TP_SEQ, XATTN_MESH, XATTN_ROWS

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import (
        all_reduce_axes, coordinate, gather_dim, local_slice, spec_axes)
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.models import param as PM
    from repro_torch.training import checkpoint as CKPT

    cfg = dataclasses.replace(get_arch("whisper-medium").reduced(),
                              cache_dtype="f32")
    mesh = _mesh(XATTN_MESH, ("data", "model"))
    ctx = M.build_ctx(cfg, ShapeSpec("t", TP_SEQ, XATTN_ROWS, "train"),
                      mesh)
    specs = B.block_specs(cfg, "dec_attn/dense")
    p = PM.trainable(PM.from_numpy(_tree(specs, "xattn/params", init),
                                   "cpu", PM.shard_local(specs, ctx.rules,
                                                         mesh)))
    sl = local_slice(init["xattn/x"].shape, ("data", None, None), mesh,
                     coordinate(mesh))
    x, enc, w = (torch_from(init[f"xattn/{k}"][sl]) for k in
                 ("x", "enc", "w"))
    x.requires_grad_()
    enc.requires_grad_()
    y, _, _ = B.apply_block(cfg, ctx, "dec_attn/dense", p, x, mode="train",
                            enc_out=enc)
    leaves = PM.tree_leaves(p)
    *gp, gx, ge = torch.autograd.grad((y * w).sum(), leaves + [x, enc])
    shd = PM.shardings(specs, ctx.rules, mesh)
    for g, s in zip(gp, PM.tree_leaves(shd)):
        if "data" not in spec_axes(s.spec):
            all_reduce_axes(g, mesh, ("data",))
    whole = CKPT.gathered(PM.tree_unflatten(p, gp), shd)
    gx, ge = (gather_dim(t, mesh, ("data",), 0) for t in (gx, ge))
    if rank == 0:
        np.savez(Path(out) / "xattn.npz", x=gx.numpy(), enc=ge.numpy(),
                 **_keyed("grads", whole))


def torch_from(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def compression(ref_dir, out):
    """Each rank's leaves through ``cross_pod_grad_sync``: the same leaves
    on every rank of a pod-only (4,) mesh, each rank's own leaves on (4,)
    and on a (2, 1, 2) (pod, data, model) mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compression import cross_pod_grad_sync

    dist.init_process_group("gloo")
    r = dist.get_rank()
    data = np.load(Path(out) / "grads.npz")
    names = sorted({k.split("/")[1] for k in data.files})

    def leaves(kind, rank):
        return {n: torch.from_numpy(data[f"{kind}/{n}"][rank]) for n in names}

    res = {}
    mesh4 = _mesh((4,), ("pod",))
    mesh212 = _mesh((2, 1, 2), ("pod", "data", "model"))
    for tag, mesh, rank in (("same", mesh4, 0), ("each", mesh4, r),
                            ("pod", mesh212, r)):
        red, err = cross_pod_grad_sync(leaves("g", rank), leaves("e", rank),
                                       mesh)
        for n in names:
            res[f"{tag}_red/{n}"] = red[n].numpy()
            res[f"{tag}_err/{n}"] = err[n].numpy()
    np.savez(Path(out) / f"compression_rank{r}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def resharding(ref_dir, out):
    """Both permutes of each rank's shard of the tests' 16 x 3 tensor
    (sharded over ``model`` on a 2x2 mesh), and ``tube_reshard`` of a
    16 x 4 tensor from its rows to its columns; each rank writes its
    shards."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.mesh import local_slice
    from repro_torch.distributed.resharding import (
        multipath_permute, single_path_permute, tube_reshard)

    dist.init_process_group("gloo")
    mesh = _mesh((2, 2), ("data", "model"))
    coord = tuple(mesh.get_coordinate())
    data = np.load(Path(out) / "x.npz")
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    xb = x[local_slice(tuple(x.shape), ("model", None), mesh, coord)]
    res = {"single": single_path_permute(xb, mesh)}
    for frac in (0.25, 0.5):
        res[f"multi_{frac}"] = multipath_permute(xb, mesh, detour_frac=frac)
    yb = y[local_slice(tuple(y.shape), ("model", None), mesh, coord)]
    res["tube"] = tube_reshard(yb, ("model", None), (None, "model"), mesh)
    np.savez(Path(out) / f"resharding_rank{dist.get_rank()}.npz",
             coord=np.array(coord), **{k: v.numpy() for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    {"dp": dp, "restore_1x2": restore_1x2, "tp": tp,
     "compression": compression,
     "resharding": resharding}[sys.argv[1]](sys.argv[2], sys.argv[3])
