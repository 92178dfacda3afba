"""The port's data-parallel ZeRO-1 train step on 4 gloo ranks, and its
checkpoints across meshes, on the CPU.

One step of reduced MiniCPM-2B (batch 4 x 32 on a 2x2 mesh and on a
(2, 1, 2) (pod, data, model) mesh) and of reduced Whisper-medium (2x2),
in f32, from the reference's initial parameters and the same batch:

- against the reference's jitted step on the same mesh, with
  ``make_opt_rules`` shardings on the moments as ``dryrun.lower_cell``
  sets them: the loss within 1e-5, every parameter and moment leaf
  within relnorm 1e-4;
- against the port at world size 1 (no mesh, one row per microbatch):
  the loss within 1e-6 relative, every leaf within relnorm 1e-5;
- each rank holds only its ZeRO-1 shards of the moments.

The 4-rank run saves a checkpoint; it is restored at world size 1 and
on a (1, 2) mesh (2 ranks), and a checkpoint the reference wrote is
restored on the port's 2x2 mesh, every leaf equal.  The ranks run under
``torch.distributed.run`` (``tests/_meshrun.py``), the reference in a
subprocess on 4 host devices (``tests/_meshref.py``).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _meshref as MR  # noqa: E402
from _meshrun import _keyed, _tree, launch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed.mesh import (  # noqa: E402
    local_slice, make_opt_rules, make_rules)
from repro_torch.models import io  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    build_train_step, default_accum)

NAMES = [s[0] for s in MR.DP_SCENARIOS]
ARCH = {s[0]: s[1] for s in MR.DP_SCENARIOS}
MESH = {s[0]: (s[2], s[3]) for s in MR.DP_SCENARIOS}


def _stub(shape, axes, coord=None):
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(axes),
                           get_coordinate=lambda: list(coord))


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")


def _shape():
    return ShapeSpec("t", MR.DP_SEQ, MR.DP_BATCH, "train")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    ref, out = d / "ref", d / "port"
    ref.mkdir()
    out.mkdir()
    batches = {}
    for name in NAMES:
        cfg = _cfg(ARCH[name])
        for k, v in io.synthetic_batch(cfg, _shape(), 1, "cpu").items():
            batches[f"{name}/{k}"] = (v.float() if v.is_floating_point()
                                      else v).numpy()
    np.savez(out / "batches.npz", **batches)
    MR.run("dp", str(out / "batches.npz"), str(ref), devices=4)
    launch(4, "dp", ref, out)
    launch(2, "restore_1x2", ref, out)
    return ref, out


def _relnorm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def _worst(got, want, prefixes=("new_params", "new_opt")):
    keys = [k for k in want.files if k.startswith(prefixes)]
    assert keys and sorted(keys) == sorted(
        k for k in got.files if k.startswith(prefixes))
    errs = {k: _relnorm(got[k], want[k]) for k in keys}
    return max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_reference(runs, name):
    ref, out = runs
    want, got = np.load(ref / f"dp_{name}.npz"), np.load(out / f"dp_{name}.npz")
    assert abs(float(got["loss"]) - float(want["loss"])) < 1e-5
    key, err = _worst(got, want)
    assert err < 1e-4, (key, err)


def _world_size_1(ref, name):
    """The port's step without a mesh from the same weights and batch."""
    cfg, shape = _cfg(ARCH[name]), _shape()
    pspecs = M.model_specs(cfg)
    init = np.load(ref / f"dp_{name}.npz")
    params = PM.trainable(PM.from_numpy(_tree(pspecs, "params", init), "cpu"))
    opt = O.init_opt_state(pspecs, "f32", "cpu")
    step = build_train_step(cfg, M.build_ctx(cfg), O.OptConfig(
        schedule=cfg.lr_schedule), default_accum(shape, None, cfg))
    return step(params, opt, _batch(ref.parent / "port", name))


def _batch(out, name):
    data = np.load(out / "batches.npz")
    return {k.split("/", 1)[1]: torch.from_numpy(data[k])
            for k in data.files if k.startswith(f"{name}/")}


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_world_size_1(runs, name):
    ref, out = runs
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, opt, m = _world_size_1(ref, name)
    finally:
        torch.set_num_threads(n)
    got = np.load(out / f"dp_{name}.npz")
    loss = float(m["loss"])
    assert abs(float(got["loss"]) - loss) <= 1e-6 * abs(loss)
    one = {**_keyed("new_params", params), **_keyed("new_opt", opt)}
    errs = {k: _relnorm(got[k], v) for k, v in one.items()}
    key, err = max(errs.items(), key=lambda kv: kv[1])
    assert err < 1e-5, (key, err)


@pytest.mark.parametrize("name", NAMES)
def test_zero1_rank_holds_its_moment_shards(runs, name):
    """Rank 0's moments are its ``local_slice``s under the optimizer
    rules: fewer than half of all moments (the rules split the MLP
    leaves over ``model`` only: ``embed_mlp`` stays replicated in the
    reference's ``make_opt_rules``)."""
    _, out = runs
    cfg, shape = _cfg(ARCH[name]), _shape()
    mesh = _stub(*MESH[name])
    opt_rules = make_opt_rules(cfg, shape, mesh, make_rules(cfg, shape, mesh))
    pspecs = M.model_specs(cfg)
    local = O.init_opt_state(pspecs, "f32", "meta", rules=opt_rules,
                             mesh=mesh)
    held = sum(t.numel() for t in PM.tree_leaves(local["m"]))
    total = PM.count_params(pspecs)
    assert int(np.load(out / f"dp_{name}.npz")["local_moments"]) == held
    assert total / 4 <= held < total / 2


def _whole_tree(cfg):
    pspecs = M.model_specs(cfg)
    return {"params": PM.initialize(pspecs, 0, "cpu"),
            "opt": O.init_opt_state(pspecs, "f32", "cpu")}


def test_checkpoint_from_4_ranks_restores_at_world_size_1(runs):
    _, out = runs
    name = NAMES[0]
    got, _ = CKPT.restore(out / "ckpt", 1, _whole_tree(_cfg(ARCH[name])))
    want = np.load(out / f"dp_{name}.npz")
    flat = {**_keyed("new_params", got["params"]),
            **_keyed("new_opt", got["opt"])}
    assert sorted(flat) == sorted(k for k in want.files
                                  if k.startswith("new_"))
    assert [k for k, v in flat.items()
            if not np.array_equal(v, want[k])] == []


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_from_4_ranks_restores_on_1x2(runs, rank):
    """Each of 2 ranks holds its ``local_slice`` of every saved leaf
    under the (1, 2) mesh's own rules: its half of the moments."""
    _, out = runs
    name = NAMES[0]
    held = np.load(out / f"restore_1x2_rank{rank}.npz")
    mesh = _stub((1, 2), ("data", "model"), held["coord"])
    cfg, shape = _cfg(ARCH[name]), _shape()
    rules = make_rules(cfg, shape, mesh)
    pspecs = M.model_specs(cfg)
    shd = {"params": PM.shardings(pspecs, rules, mesh),
           "opt": PM.shardings(O.opt_pspecs(pspecs, "f32"),
                               make_opt_rules(cfg, shape, mesh, rules), mesh)}
    whole = np.load(out / f"dp_{name}.npz")
    bad, halves = [], 0
    for part in ("params", "opt"):
        for k, s in CKPT._leaves(shd[part]):
            key, coord = f"new_{part}__{k}", tuple(held["coord"])
            want = whole[key][local_slice(whole[key].shape, s.spec, mesh,
                                          coord)]
            bad += [key] if not np.array_equal(held[key], want) else []
            halves += held[key].size * 2 == whole[key].size
    assert bad == [] and halves > 0


def test_reference_checkpoint_restores_on_2x2(runs):
    ref, out = runs
    want = np.load(ref / f"dp_{NAMES[0]}.npz")
    got = np.load(out / "ref_ckpt_restored.npz")
    keys = [k for k in want.files if k.startswith(("new_params", "new_opt"))]
    assert sorted(keys) == sorted(got.files)
    assert [k for k in keys if not np.array_equal(got[k], want[k])] == []
