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
    {"dp": dp, "restore_1x2": restore_1x2, "compression": compression,
     "resharding": resharding}[sys.argv[1]](sys.argv[2], sys.argv[3])
