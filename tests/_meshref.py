"""The JAX package's side of the mesh tests, run as a subprocess on host
CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``,
set by ``run``), because a process fixes its device count when JAX
first starts and ``repro.launch.dryrun`` sets it to 512 when imported.

    python tests/_meshref.py <scenario> <input.npz> <out_dir>

Each scenario writes ``<out_dir>/<scenario>.json`` or ``.npz``; the
tests compare them with the port (``tests/_meshrun.py`` under
``torchrun``, or in-process).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: the data-parallel scenarios: (name, arch, mesh shape, axis names)
DP_SCENARIOS = (("minicpm_2x2", "minicpm-2b", (2, 2), ("data", "model")),
                ("minicpm_pod", "minicpm-2b", (2, 1, 2),
                 ("pod", "data", "model")),
                ("whisper_2x2", "whisper-medium", (2, 2), ("data", "model")))
DP_SEQ, DP_BATCH = 32, 4

#: the weight-sharding scenarios: (name, arch, mesh shape, axis names,
#: global batch), one train step each at TP_SEQ tokens a row.  None is a
#: small-dense DP cell: each is MoE or has a batch that does not fill
#: its mesh.
TP_SCENARIOS = (
    ("nemotron_2x2", "nemotron-4-15b", (2, 2), ("data", "model"), 2),
    ("qwen72_1x4", "qwen2-72b", (1, 4), ("data", "model"), 2),
    ("dbrx_2x2", "dbrx-132b", (2, 2), ("data", "model"), 4),
    ("grok_1x8", "grok-1-314b", (1, 8), ("data", "model"), 2),
    ("jamba_2x2", "jamba-1.5-large-398b", (2, 2), ("data", "model"), 4),
    ("whisper_2x2", "whisper-medium", (2, 2), ("data", "model"), 2),
)
TP_SEQ = 32
#: the scenarios whose MoE semantics on a mesh (capacity from the local
#: tokens, ``aux`` a mean of per-shard losses) differ from one device's
TP_MOE = ("dbrx_2x2", "grok_1x8", "jamba_2x2")

#: local_slice cases: (mesh shape, axis names, global shape, spec)
SLICE_CASES = (
    ((2, 2), ("data", "model"), (8, 12), (("data", "model"), None)),
    ((2, 2), ("data", "model"), (8, 12), ("model", "data")),
    ((2, 2), ("data", "model"), (8, 12), (None, ("data", "model"))),
    ((2, 2), ("data", "model"), (8, 12), (("model", "data"), None)),
    ((2, 2), ("data", "model"), (8, 12), ("data", None)),
    ((2, 1, 2), ("pod", "data", "model"), (8, 4, 6),
     (("pod", "data", "model"), None, None)),
    ((2, 1, 2), ("pod", "data", "model"), (8, 4, 6),
     (("pod", "model"), None, "data")),
    ((2, 1, 2), ("pod", "data", "model"), (8, 4, 6), ("model", "pod", None)),
)


def run(scenario: str, inputs: str, out_dir: str, *, devices: int,
        timeout: float = 120) -> None:
    """Run one scenario in a fresh interpreter on ``devices`` host CPU
    devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, str(Path(__file__)), scenario,
                          inputs, out_dir], env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"{scenario} failed:\n{res.stdout}\n{res.stderr}")


def _mesh(shape, axes, n=None):
    import jax
    n = n or int(np.prod(shape))
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _keyed(prefix: str, tree) -> dict:
    """{reference checkpoint key: numpy array} of a tree's leaves."""
    import jax
    from repro.training.checkpoint import _leaf_key
    return {f"{prefix}__{_leaf_key(p)}": np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ scenarios ---

def mesh_facts(inputs, out):
    """Dry-run fields of every cell on both production meshes, degraded
    mesh shapes, and ``devices_indices_map`` of the local_slice cases."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import all_cells, get_arch, get_shape
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_degraded_mesh, make_production_mesh
    from repro.models import io
    from repro.models import model as M
    from repro.models import param as PM
    from repro.training.optimizer import opt_pspecs
    from repro.training.train_step import default_accum

    cells = []
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch, sname in all_cells():
            cfg, shape = get_arch(arch), get_shape(sname)
            rules = M.build_ctx(cfg, shape, mesh).rules
            raw = M.model_specs(cfg)
            w8 = D.use_w8a16(cfg, shape, mesh)
            specs = raw
            if w8:
                from repro.serving.wquant import quant_pspecs
                specs = quant_pspecs(raw)
            ost = D.opt_state_dtype(cfg)
            adb = D.analytic_device_bytes
            cells.append({
                "arch": arch, "shape": sname,
                "mesh": "2x16x16" if mp else "16x16",
                "params": PM.count_params(raw), "w8a16": w8,
                "opt_state_dtype": ost,
                "accum": default_accum(shape, mesh, cfg),
                "analytic_device_bytes": {
                    "params": adb(specs, rules, mesh),
                    "opt": (adb(opt_pspecs(specs, ost), rules, mesh)
                            if shape.kind == "train" else 0),
                    "caches": (adb(M.cache_pspecs(cfg, shape), rules, mesh)
                               if shape.kind == "decode" else 0),
                    "inputs": adb(io.batch_pspecs(cfg, shape), rules, mesh)}})
    degraded = [[mp, h, list(make_degraded_mesh(h, multi_pod=mp).devices.shape)]
                for mp in (False, True) for h in (0, 1, 3, 16)]
    slices = []
    for mshape, axes, shape, spec in SLICE_CASES:
        mesh = _mesh(mshape, axes)
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        per = []
        for d, sl in idx.items():
            coord = [int(i) for i in np.argwhere(mesh.devices == d)[0]]
            per.append([coord, [list(s.indices(n))[:2]
                                for s, n in zip(sl, shape)]])
        slices.append(sorted(per))
    (Path(out) / "mesh_facts.json").write_text(json.dumps(
        {"cells": cells, "degraded": degraded, "slices": slices,
         "jax": jax.__version__}))


def dp(inputs, out):
    """One jitted train step per DP scenario on its mesh, in f32, with
    the shardings ``dryrun.lower_cell`` gives (``make_opt_rules`` on the
    moments); the initial parameters, the loss, the new parameters and
    moments; a checkpoint of the first scenario's new state."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.distributed.mesh import make_opt_rules
    from repro.models import io
    from repro.models import model as M
    from repro.models import param as PM
    from repro.training import checkpoint as C
    from repro.training import optimizer as O
    from repro.training import train_step as TS

    batches = np.load(inputs)
    for name, arch, mshape, axes in DP_SCENARIOS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        mesh = _mesh(mshape, axes)
        shape = ShapeSpec("t", DP_SEQ, DP_BATCH, "train")
        ctx = M.build_ctx(cfg, shape, mesh)
        params = jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
            jax.jit(lambda k: M.init_params(cfg, k))(jax.random.key(0)))
        pspecs = M.model_specs(cfg)
        ospecs = O.opt_pspecs(pspecs, "f32")
        p_shd = PM.shardings(pspecs, ctx.rules, mesh)
        o_shd = PM.shardings(ospecs, make_opt_rules(cfg, shape, mesh,
                                                    ctx.rules), mesh)
        bspecs = io.batch_pspecs(cfg, shape)
        b_shd = PM.shardings(bspecs, ctx.rules, mesh)
        batch = {k: jnp.asarray(batches[f"{name}/{k}"]) for k in bspecs}
        opt = PM.initialize(ospecs, jax.random.key(1))
        step = TS.build_train_step(cfg, ctx, O.OptConfig(
            schedule=cfg.lr_schedule), TS.default_accum(shape, mesh, cfg))
        init = _keyed("params", params)
        with jax.set_mesh(mesh):
            newp, newo, m = jax.jit(
                step, in_shardings=(p_shd, o_shd, b_shd),
                out_shardings=(p_shd, o_shd, None))(params, opt, batch)
        np.savez(Path(out) / f"dp_{name}.npz", loss=np.asarray(m["loss"]),
                 **init, **_keyed("new_params", newp),
                 **_keyed("new_opt", newo))
        if name == DP_SCENARIOS[0][0]:
            C.save(Path(out) / "ref_ckpt", 1, {"params": newp, "opt": newo})


def _from_keyed(tree, prefix: str, data):
    """The tree of ``tree``'s structure from reference-keyed arrays."""
    import jax
    import jax.numpy as jnp
    from repro.training.checkpoint import _leaf_key
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data[f"{prefix}__{_leaf_key(p)}"]) for p, _ in leaves])


def tp(inputs, out):
    """One jitted train step per weight-sharding scenario on its mesh, in
    f32, from the weights and batch the tests made, with the shardings
    ``dryrun.lower_cell`` gives; the loss, the gradients the step hands
    to ``adamw_update``, the new parameters and moments.  The same step
    without sharding, on a 1x1 mesh with one row a microbatch (the dense
    scenarios), or, for the MoE scenarios, the gradient without a mesh of
    the same function: the mean over the batch rows of one row's gradient
    on a 1x1 mesh (every (microbatch, data shard) of the step holds one
    row, and a shard's capacity and balance loss are its own)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.distributed.mesh import make_opt_rules, use_small_dense_dp
    from repro.models import io
    from repro.models import model as M
    from repro.models import param as PM
    from repro.training import optimizer as O
    from repro.training import train_step as TS

    update = TS.adamw_update

    def with_grads(oc, params, grads, opt_state):
        p, o, m = update(oc, params, grads, opt_state)
        return p, o, dict(m, grads=grads)
    TS.adamw_update = with_grads
    data = np.load(inputs)
    for name, arch, mshape, axes, gb in TP_SCENARIOS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        mesh = _mesh(mshape, axes)
        shape = ShapeSpec("t", TP_SEQ, gb, "train")
        assert not use_small_dense_dp(cfg, shape, mesh), name
        ctx = M.build_ctx(cfg, shape, mesh)
        pspecs = M.model_specs(cfg)
        params = _from_keyed(pspecs, f"{name}/params", data)
        ospecs = O.opt_pspecs(pspecs, "f32")
        p_shd = PM.shardings(pspecs, ctx.rules, mesh)
        o_shd = PM.shardings(ospecs, make_opt_rules(cfg, shape, mesh,
                                                    ctx.rules), mesh)
        bspecs = io.batch_pspecs(cfg, shape)
        b_shd = PM.shardings(bspecs, ctx.rules, mesh)
        batch = {k: jnp.asarray(data[f"{name}/batch/{k}"]) for k in bspecs}
        opt = PM.initialize(ospecs, jax.random.key(1))
        step = TS.build_train_step(cfg, ctx, O.OptConfig(
            schedule=cfg.lr_schedule), TS.default_accum(shape, mesh, cfg))
        with jax.set_mesh(mesh):
            newp, newo, m = jax.jit(
                step, in_shardings=(p_shd, o_shd, b_shd),
                out_shardings=(p_shd, o_shd, None))(params, opt, batch)
        res = {"loss": np.asarray(m["loss"]), **_keyed("grads", m["grads"]),
               **_keyed("new_params", newp), **_keyed("new_opt", newo)}
        one = _mesh((1, 1), ("data", "model"))
        if name not in TP_MOE:
            step1 = TS.build_train_step(cfg, M.build_ctx(cfg, shape, one),
                                        O.OptConfig(schedule=cfg.lr_schedule),
                                        gb)
            with jax.set_mesh(one):
                p1, o1, m1 = jax.jit(step1)(params, opt, batch)
            res.update({**_keyed("unsharded_grads", m1["grads"]),
                        **_keyed("unsharded_new_params", p1),
                        **_keyed("unsharded_new_opt", o1)})
        else:
            ctx1 = M.build_ctx(cfg, ShapeSpec("t", TP_SEQ, 1, "train"), one)
            grad = jax.jit(jax.grad(
                lambda p_, b_: M.loss_fn(cfg, ctx1, p_, b_)[0]))
            with jax.set_mesh(one):
                rows = [grad(params, {k: v[r:r + 1] for k, v in
                                      batch.items()}) for r in range(gb)]
            res.update(_keyed("unsharded_grads", jax.tree.map(
                lambda *g: sum(g) / gb, *rows)))
        np.savez(Path(out) / f"tp_{name}.npz", **res)
    xattn(data, out)


#: the cross-attention block (``dec_attn``, which no architecture's
#: pattern names) on Whisper-medium reduced: its mesh and batch rows
XATTN_MESH, XATTN_ROWS = (2, 2), 2


def xattn(data, out):
    """The gradient of ``sum(apply_block(dec_attn) * w)`` with respect to
    the block's weights, its input and the encoder output, on the
    (2, 2) mesh with the training rules, the rows split over ``data``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import blocks as B
    from repro.models import model as M
    from repro.models import param as PM

    cfg = dataclasses.replace(get_arch("whisper-medium").reduced(),
                              cache_dtype="f32")
    mesh = _mesh(XATTN_MESH, ("data", "model"))
    ctx = M.build_ctx(cfg, ShapeSpec("t", TP_SEQ, XATTN_ROWS, "train"),
                      mesh)
    specs = B.block_specs(cfg, "dec_attn/dense")
    params = _from_keyed(specs, "xattn/params", data)
    w = data["xattn/w"]

    def f(p, x, enc):
        y, _, _ = B.apply_block(cfg, ctx, "dec_attn/dense", p, x,
                                mode="train", enc_out=enc)
        return (y * w).sum()
    rows = NamedSharding(mesh, P("data", None, None))
    with jax.set_mesh(mesh):
        gp, gx, ge = jax.jit(jax.grad(f, argnums=(0, 1, 2)), in_shardings=(
            PM.shardings(specs, ctx.rules, mesh), rows, rows))(
            params, data["xattn/x"], data["xattn/enc"])
    np.savez(Path(out) / "xattn.npz", x=np.asarray(gx), enc=np.asarray(ge),
             **_keyed("grads", gp))


def compression(inputs, out):
    """The reference's int8 cross-pod sync: (a) ``cross_pod_grad_sync`` on
    a pod-only (4,) mesh (its inputs are replicated, so every pod sends
    the same leaves); (b) ``compressed_psum_leaf`` under a shard_map with
    per-pod leaves on (4,); (c) on a (2, 1, 2) (pod, data, model) mesh,
    ``cross_pod_grad_sync``'s error, and per model column the (b) sum
    over a (2,) pod mesh of the two pods' leaves."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed import compression as C

    data = np.load(inputs)
    names = sorted({k.split("/")[1] for k in data})
    g = {n: data[f"g/{n}"] for n in names}        # (4, *shape) per rank
    e = {n: data[f"e/{n}"] for n in names}
    res = {}
    mesh4 = _mesh((4,), ("pod",))
    red, err = C.cross_pod_grad_sync({n: jnp.asarray(g[n][0]) for n in names},
                                     {n: jnp.asarray(e[n][0]) for n in names},
                                     mesh4)
    for n in names:
        res[f"same_red/{n}"], res[f"same_err/{n}"] = (np.asarray(red[n]),
                                                      np.asarray(err[n]))

    def per_pod(mesh, gs, es):
        def body(gb, eb):
            r, ne = C.compressed_psum_leaf(gb[0], eb[0], "pod")
            return r[None], ne[None]
        return jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                             out_specs=(P("pod"), P("pod")),
                             check_vma=False)(jnp.asarray(gs), jnp.asarray(es))

    for n in names:
        r, ne = per_pod(mesh4, g[n], e[n])
        res[f"each_red/{n}"], res[f"each_err/{n}"] = np.asarray(r), np.asarray(ne)
    mesh2 = _mesh((2,), ("pod",))
    for n in names:
        # rank r of a (2, 1, 2) mesh sits at pod r // 2, model r % 2
        reds, errs = np.empty_like(g[n]), np.empty_like(g[n])
        for col in (0, 1):
            rk = [col, 2 + col]
            r, ne = per_pod(mesh2, g[n][rk], e[n][rk])
            reds[rk], errs[rk] = np.asarray(r), np.asarray(ne)
        res[f"pod_red/{n}"], res[f"pod_err/{n}"] = reds, errs
    mesh212 = _mesh((2, 1, 2), ("pod", "data", "model"))
    try:
        C.cross_pod_grad_sync({n: jnp.asarray(g[n][0]) for n in names},
                              {n: jnp.asarray(e[n][0]) for n in names},
                              mesh212)
        raised = ""
    except Exception as exc:        # the fault under test
        raised = f"{type(exc).__name__}: {exc}"
    np.savez(Path(out) / "compression.npz", raised=np.array(raised), **res)


def resharding(inputs, out):
    """Both permutes of a 16 x 3 tensor sharded over ``model`` on a 2x2
    mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.distributed import resharding as R

    mesh = _mesh((2, 2), ("data", "model"))
    x = jax.device_put(np.load(inputs)["x"],
                       NamedSharding(mesh, P("model", None)))
    res = {"single": np.asarray(R.single_path_permute(x, mesh))}
    for frac in (0.25, 0.5):
        res[f"multi_{frac}"] = np.asarray(
            R.multipath_permute(x, mesh, detour_frac=frac))
    np.savez(Path(out) / "resharding.npz", **res)


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    {"mesh_facts": mesh_facts, "dp": dp, "tp": tp, "compression": compression,
     "resharding": resharding}[sys.argv[1]](sys.argv[2], sys.argv[3])
