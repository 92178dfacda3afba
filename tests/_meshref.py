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

#: the serving scenarios: (name, arch, mesh shape, global batch, prompt
#: tokens), each served through ``Engine.generate`` on its (data, model)
#: mesh under the decode rules: SERVE_NEW tokens, caches of SERVE_CACHE
SERVE_SCENARIOS = (
    ("qwen72_1x4", "qwen2-72b", (1, 4), 2, 16),
    ("nemotron_2x2", "nemotron-4-15b", (2, 2), 2, 16),
    ("dbrx_2x2", "dbrx-132b", (2, 2), 4, 16),
    ("grok_1x8", "grok-1-314b", (1, 8), 4, 12),
    ("gemma3_2x2", "gemma3-27b", (2, 2), 2, 16),
    ("jamba_2x2", "jamba-1.5-large-398b", (2, 2), 4, 16),
    ("xlstm_1x4", "xlstm-1.3b", (1, 4), 2, 16),
)
SERVE_NEW, SERVE_CACHE = 8, 32
#: the scenarios where the reference's MoE ``shard_map`` splits rows the
#: decode rules replicate and sums different rows' partial outputs
#: (ROADMAP.md §3): the reference also runs them on a 1x1 mesh
SERVE_REF_FAULT = ("dbrx_2x2", "jamba_2x2")
#: the training step of the serving scenario whose arch had no training
#: body on a mesh before (xLSTM's head_v): a TP_SCENARIOS-like entry
SERVE_TRAIN = ("xlstm_1x4", "xlstm-1.3b", (1, 4), ("data", "model"), 2)
#: the cross-attention block served alone (no config builds ``dec_attn``):
#: Whisper-medium reduced on (2, 2), 2 rows, prompt, encoder and cache
#: lengths
XSERVE = ((2, 2), 2, 16, 16, 32)

#: the dry-run's cost cells: (name, arch reduced, kind, tokens a row,
#: global batch), each lowered and compiled on a (2, 2) (data, model)
#: mesh as ``repro.launch.dryrun.lower_cell`` does, its HLO read by the
#: loop-aware ``hlo_analysis.analyze``.  512 tokens: the reference's
#: attention runs in 512-key chunks, so no chunk is padding.
DRY_CELLS = (
    ("minicpm_train", "minicpm-2b", "train", 512, 4),
    ("dbrx_train", "dbrx-132b", "train", 512, 2),
    ("jamba_train", "jamba-1.5-large-398b", "train", 512, 2),
    ("minicpm_prefill", "minicpm-2b", "prefill", 512, 2),
    ("qwen72_decode", "qwen2-72b", "decode", 512, 2),
)

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


#: ``tube_reshard`` handoffs of a 16 x 4 tensor on a (2, 2) mesh, as the
#: serving rules produce them: (source spec, destination spec)
TUBE_CASES = (
    (("model", None), ("data", None)),
    (("model", None), (None, ("data", "model"))),
    ((None, "model"), (("data", "model"), None)),
    ((None, None), (None, "model")),
    (("model", None), ("model", None)),
    (("data", "model"), (None, None)),
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
    data = np.load(inputs)
    for name, arch, mshape, axes, gb in TP_SCENARIOS:
        np.savez(Path(out) / f"tp_{name}.npz",
                 **_tp_cell(name, arch, mshape, axes, gb, data))
    xattn(data, out)


def _tp_cell(name, arch, mshape, axes, gb, data) -> dict:
    """One weight-sharding scenario's jitted step (``tp``): the loss, the
    gradients, the new state, and the same without sharding."""
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
    try:
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
    finally:
        TS.adamw_update = update
    return res


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


def serve(inputs, out):
    """Each serving scenario through the reference's ``Engine.generate``
    on its mesh of host devices, from the weights and prompts the tests
    made, in f32 (caches too): the tokens, the prefill's and every decode
    step's logits, and the final caches; the fault scenarios again on a
    1x1 mesh.  Then ``moe_block`` alone under DBRX's decode rules (the
    fault's cause), the cross-attention block served alone, and
    ``SERVE_TRAIN``'s step."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import model as M
    from repro.serving.engine import Engine

    data = np.load(inputs)
    for name, arch, mshape, B, _ in SERVE_SCENARIOS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
        params = _from_keyed(M.model_specs(cfg), f"{name}/params", data)
        toks = jnp.asarray(data[f"{name}/tokens"])
        res = {}
        meshes = [("", mshape)] + ([("one_", (1, 1))]
                                   if name in SERVE_REF_FAULT else [])
        for tag, ms in meshes:
            eng = Engine(cfg, ShapeSpec("serve", SERVE_CACHE, B, "decode"),
                         _mesh(ms, ("data", "model")), params)
            logits = []
            for fn in ("_prefill", "_decode"):
                def rec(*a, _f=getattr(eng, fn)):
                    lg, c = _f(*a)
                    logits.append(np.asarray(lg))
                    return lg, c
                setattr(eng, fn, rec)
            tokens, caches = eng.generate({"tokens": toks}, SERVE_NEW,
                                          SERVE_CACHE)
            res.update({f"{tag}tokens": np.asarray(tokens),
                        **{f"{tag}logits_{i}": lg
                           for i, lg in enumerate(logits)},
                        **_keyed(f"{tag}caches", caches)})
        np.savez(Path(out) / f"serve_{name}.npz", **res)
    moe_rows(data, out)
    xserve(data, out)
    np.savez(Path(out) / "serve_train.npz", **_tp_cell(*SERVE_TRAIN, data))


def moe_rows(data, out):
    """The reference's ``moe_block`` under DBRX's decode rules on (2, 2)
    (experts over ``model``, ``expert_mlp`` over ``data``, the batch
    replicated), with ``batch_sharded`` as ``build_ctx`` sets it (True:
    4 rows divide the data axis) and False, and on a 1x1 mesh."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import model as M
    from repro.models import moe
    from repro.models import param as PM

    cfg = dataclasses.replace(get_arch("dbrx-132b").reduced(),
                              cache_dtype="f32")
    x = jnp.asarray(data["moe_rows/x"])
    p = _from_keyed(moe.moe_specs(cfg), "moe_rows/params", data)
    res = {}
    for tag, ms, sharded in (("split", (2, 2), True),
                             ("whole", (2, 2), False), ("one", (1, 1), True)):
        mesh = _mesh(ms, ("data", "model"))
        ctx = M.build_ctx(cfg, ShapeSpec("s", SERVE_CACHE, x.shape[0],
                                         "decode"), mesh)
        p_shd = PM.shardings(moe.moe_specs(cfg), ctx.rules, mesh)
        with jax.set_mesh(mesh):
            y, _ = jax.jit(lambda p_, x_: moe.moe_block(
                x_, p_, cfg, mesh, rules=ctx.rules, data_axes=ctx.data_axes,
                batch_sharded=sharded), in_shardings=(p_shd, None))(p, x)
        res[tag] = np.asarray(y)
        res[f"{tag}_batch_sharded"] = np.asarray(ctx.batch_sharded)
    np.savez(Path(out) / "moe_rows.npz", **res)


def xserve(data, out):
    """The ``dec_attn`` block served alone on XSERVE's mesh under the
    decode rules: its prefill over the prompt and the encoder output,
    the self-attention caches padded to the cache length, one decode
    step; both outputs and the caches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.models import blocks as B
    from repro.models import model as M
    from repro.serving.engine import _pad_seq

    mshape, rows, L, _, T = XSERVE
    cfg = dataclasses.replace(get_arch("whisper-medium").reduced(),
                              cache_dtype="f32")
    mesh = _mesh(mshape, ("data", "model"))
    ctx = M.build_ctx(cfg, ShapeSpec("s", T, rows, "decode"), mesh)
    kind = "dec_attn/dense"
    params = _from_keyed(B.block_specs(cfg, kind), "xserve/params", data)
    x, enc, xt = (jnp.asarray(data[f"xserve/{k}"]) for k in ("x", "enc",
                                                               "xt"))
    with jax.set_mesh(mesh):
        y, c, _ = jax.jit(lambda p, x_, e: B.apply_block(
            cfg, ctx, kind, p, x_, mode="prefill", enc_out=e))(params, x, enc)
        c = dict(c, k=_pad_seq(c["k"], T), v=_pad_seq(c["v"], T))
        yd, c, _ = jax.jit(lambda p, c_, t: B.apply_block(
            cfg, ctx, kind, p, t, mode="decode", cache=c_, pos=L))(
            params, c, xt)
    np.savez(Path(out) / "xserve.npz", y=np.asarray(y), y_decode=np.asarray(yd),
             **{f"cache__{k}": np.asarray(v) for k, v in c.items()})


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


def dry_costs(inputs, out):
    """Each of DRY_CELLS lowered and compiled as ``lower_cell`` does
    (``build_step``, ``jax.jit(...).lower(...).compile()``, the loop-aware
    ``analyze`` of its HLO) on a (2, 2) mesh of host devices: per-device
    flops, traffic and collective bytes."""
    import jax

    jax.devices()                    # the device count is fixed from here
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.distributed.mesh import make_opt_rules
    from repro.launch import dryrun as D
    from repro.launch.hlo_analysis import analyze
    from repro.models import io
    from repro.models import model as M
    from repro.models import param as PM
    from repro.training.optimizer import opt_pspecs

    res = {}
    mesh = _mesh((2, 2), ("data", "model"))
    for name, arch, kind, seq, gb in DRY_CELLS:
        cfg, shape = get_arch(arch).reduced(), ShapeSpec(name, seq, gb, kind)
        ctx = M.build_ctx(cfg, shape, mesh)
        pspecs = M.model_specs(cfg)
        p_abs = PM.abstract(pspecs)
        p_shd = PM.shardings(pspecs, ctx.rules, mesh)
        bspecs = io.batch_pspecs(cfg, shape)
        b_abs = PM.abstract(bspecs)
        b_shd = PM.shardings(bspecs, ctx.rules, mesh)
        step = D.build_step(cfg, shape, ctx, mesh)
        with mesh:
            if kind == "train":
                ospecs = opt_pspecs(pspecs, D.opt_state_dtype(cfg))
                o_shd = PM.shardings(ospecs, make_opt_rules(
                    cfg, shape, mesh, ctx.rules), mesh)
                lowered = jax.jit(step, in_shardings=(p_shd, o_shd, b_shd),
                                  out_shardings=(p_shd, o_shd, None),
                                  donate_argnums=(0, 1)).lower(
                    p_abs, PM.abstract(ospecs), b_abs)
            elif kind == "prefill":
                c_shd = PM.shardings(M.cache_pspecs(cfg, shape), ctx.rules,
                                     mesh)
                lowered = jax.jit(step, in_shardings=(p_shd, b_shd),
                                  out_shardings=(None, c_shd)).lower(
                    p_abs, b_abs)
            else:
                cspecs = M.cache_pspecs(cfg, shape)
                c_shd = PM.shardings(cspecs, ctx.rules, mesh)
                lowered = jax.jit(step, in_shardings=(p_shd, c_shd, b_shd),
                                  out_shardings=(None, c_shd),
                                  donate_argnums=(1,)).lower(
                    p_abs, PM.abstract(cspecs), b_abs)
            res[name] = analyze(lowered.compile().as_text())
    (Path(out) / "dry_costs.json").write_text(json.dumps(res))


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
    {"mesh_facts": mesh_facts, "dp": dp, "tp": tp, "serve": serve,
     "compression": compression, "dry_costs": dry_costs,
     "resharding": resharding}[sys.argv[1]](sys.argv[2], sys.argv[3])
