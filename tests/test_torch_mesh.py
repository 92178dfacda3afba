"""The port's mesh layer (``distributed/mesh.py``, ``launch/mesh.py``,
``launch/dryrun.py``, ``models/model.py::build_ctx``) against the JAX
package's, on the CPU.

- ``make_rules``, ``make_opt_rules``, ``use_small_dense_dp``,
  ``default_accum`` and ``spec_for`` of every parameter, optimizer-state,
  cache and input leaf, for every (arch, shape) of ``all_cells()`` on
  both production mesh shapes, equal to the reference's (the rules read
  only the mesh's axis names and sizes, so both packages get stubs);
- the dry-run's records (parameter count, ``w8a16``, optimizer-state
  dtype, accum, ``analytic_device_bytes``) equal to the byte to the
  reference's, which runs on 512 host devices in a subprocess
  (``tests/_meshref.py``), the port's on ``fake`` process groups of 256
  and 512 ranks;
- ``local_slice`` against ``NamedSharding.devices_indices_map`` on 4
  host devices, (data, model) and (pod, data, model);
- ``degraded_mesh_shape`` against ``make_degraded_mesh(h).devices.shape``;
- ``build_ctx`` refuses rules that shard weights over an axis of more
  than one member (DBRX reduced on 2x2), and the mesh factories start a
  group of one or say what is missing.
"""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _meshref as MR  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.distributed import mesh as JMESH  # noqa: E402
from repro.models import io as JIO  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.param import is_pspec  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402

from repro_torch.configs import ARCHS, all_cells, get_arch, get_shape  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import mesh as MESH  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import io  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import default_accum  # noqa: E402

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _stubs(shape, axes):
    """(the reference's mesh stub, the port's)."""
    return (SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes),
            SimpleNamespace(shape=shape, mesh_dim_names=axes))


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_pspec)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_specs_match_reference(arch):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jspecs, specs = JM.model_specs(jcfg), M.model_specs(cfg)
    checked = 0
    for (jm, m) in (_stubs(*s) for s in MESHES):
        for a, sname in all_cells():
            if a != arch:
                continue
            jshape, shape = jget_shape(sname), get_shape(sname)
            jr, r = JMESH.make_rules(jcfg, jshape, jm), MESH.make_rules(
                cfg, shape, m)
            assert r == jr
            assert MESH.use_small_dense_dp(cfg, shape, m) == \
                JMESH.use_small_dense_dp(jcfg, jshape, jm)
            jor, orules = JMESH.make_opt_rules(jcfg, jshape, jm, jr), \
                MESH.make_opt_rules(cfg, shape, m, r)
            assert orules == jor
            assert default_accum(shape, m, cfg) == JTS.default_accum(
                jshape, jm, jcfg)
            ost = DRY.opt_state_dtype(cfg)
            trees = [(jspecs, specs), (JO.opt_pspecs(jspecs, ost),
                                       O.opt_pspecs(specs, ost)),
                     (JIO.batch_pspecs(jcfg, jshape),
                      io.batch_pspecs(cfg, shape))]
            if shape.kind == "decode":
                trees.append((JM.cache_pspecs(jcfg, jshape),
                              M.cache_pspecs(cfg, shape)))
            for jt, t in trees:
                jl, tl = _jleaves(jt), PM.tree_leaves(t)
                assert [p.shape for p in jl] == [tuple(p.shape) for p in tl]
                for rules, jrules in ((r, jr), (orules, jor)):
                    got = [MESH.spec_for(p.shape, p.logical, rules, m)
                           for p in tl]
                    want = [tuple(JMESH.spec_for(p.shape, p.logical, jrules,
                                                 jm)) for p in jl]
                    assert got == want
                    checked += len(got)
    assert checked > 0


@pytest.fixture(scope="module")
def facts(tmp_path_factory):
    import json
    out = tmp_path_factory.mktemp("mesh")
    MR.run("mesh_facts", "-", str(out), devices=512)
    return json.loads((out / "mesh_facts.json").read_text())


@pytest.fixture(scope="module")
def port_records():
    assert not dist.is_initialized()
    return DRY.run(all_cells(), [False, True], costs=False)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dryrun_records_match_reference(facts, port_records, arch):
    want = [c for c in facts["cells"] if c["arch"] == arch]
    got = [{k: r[k] for k in want[0]} for r in port_records
           if r["arch"] == arch]
    assert len(want) == len(got) > 0
    assert got == want


def test_dryrun_cli_reports_every_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert DRY.main(["--all", "--both-meshes", "--no-costs", "--out",
                     str(out)]) == 0
    assert f"{2 * len(all_cells())}/{2 * len(all_cells())} cells OK" in \
        capsys.readouterr().out
    assert not dist.is_initialized()


@pytest.mark.parametrize("case", range(len(MR.SLICE_CASES)))
def test_local_slice_follows_jax_device_order(facts, case):
    mshape, axes, shape, spec = MR.SLICE_CASES[case]
    m = SimpleNamespace(shape=mshape, mesh_dim_names=axes)
    got = sorted([list(c), [[s.start, s.stop] for s in MESH.local_slice(
        shape, spec, m, c)]] for c, _ in facts["slices"][case])
    assert got == facts["slices"][case]
    assert len(got) == 4


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("hosts", [0, 1, 3, 16])
def test_degraded_mesh_shape_matches_reference(facts, multi_pod, hosts):
    want = next(s for mp, h, s in facts["degraded"]
                if mp == multi_pod and h == hosts)
    shape, axes = LM.degraded_mesh_shape(hosts, multi_pod=multi_pod)
    assert list(shape) == want
    assert len(axes) == len(shape) and axes[-1] == "model"


def test_degraded_mesh_refuses_too_many_failures():
    with pytest.raises(ValueError, match="not enough"):
        LM.degraded_mesh_shape(64)
    assert LM.degraded_mesh_shape(2, chips_per_host=8)[0] == (15, 16)


def test_build_ctx_refuses_weight_sharding():
    """No cell is refused: a serving cell builds with the serving rules
    (``kv_seq`` over ``model``, the rows over ``data``), xLSTM's
    ``head_v`` trains; DBRX's training rules (experts, FSDP ``embed``)
    build; the small-dense MiniCPM cell on the same mesh splits only the
    batch (``tests/test_torch_tp.py`` walks every cell)."""
    m = SimpleNamespace(shape=(2, 2), mesh_dim_names=("data", "model"))
    shape = ShapeSpec("t", 32, 4, "train")
    serve = M.build_ctx(get_arch("minicpm-2b").reduced(),
                        ShapeSpec("s", 32, 4, "decode"), m)
    assert serve.rules["kv_seq"] == ("model",) and not serve.fsdp
    assert serve.batch_axes == ("data",) and serve.rules["embed"] == ()
    xl = M.build_ctx(get_arch("xlstm-1.3b").reduced(),
                     ShapeSpec("t", 32, 2, "train"), m)
    assert xl.rules["head_v"] == ("model",) and xl.fsdp
    moe = M.build_ctx(get_arch("dbrx-132b").reduced(), shape, m)
    assert moe.rules["experts"] == ("model",) and moe.fsdp
    assert moe.rules["embed"] == ("data",) and moe.batch_sharded
    ctx = M.build_ctx(get_arch("minicpm-2b").reduced(), shape, m)
    assert ctx.rules["batch"] == ("data", "model") and ctx.fsdp
    assert ctx.data_axes == ("data",) and ctx.batch_sharded
    one = SimpleNamespace(shape=(1, 1), mesh_dim_names=("data", "model"))
    assert M.build_ctx(get_arch("dbrx-132b").reduced(), shape, one).mesh \
        is one


def test_smoke_mesh_starts_a_group_of_one():
    assert not dist.is_initialized()
    try:
        mesh = LM.make_smoke_mesh("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(mesh.get_coordinate()) == (0, 0)
        x = torch.ones(3)
        MESH.all_reduce_axes(x, mesh, ("data", "model"))
        assert x.tolist() == [1.0, 1.0, 1.0]
    finally:
        dist.destroy_process_group()


def test_production_mesh_names_what_is_missing(monkeypatch):
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        LM.make_production_mesh(device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=512"):
        LM.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()


def test_zero1_int8_moments_keep_whole_blocks():
    """int8 moments shard with their parameter; a shard boundary inside a
    128-block of the last axis raises."""
    from repro_torch.models.param import PSpec
    m = SimpleNamespace(shape=(2, 2), mesh_dim_names=("data", "model"))
    rules = {"embed": ("data", "model"), "mlp": ("model",)}
    ok = {"w": PSpec((512, 1024), ("embed", "mlp"), torch.float32),
          "n": PSpec((300, 300), (None, None), torch.float32)}
    shd = O.zero1_shardings(ok, "int8", rules, m)
    assert shd["w"].spec == (("data", "model"), None)
    assert shd["n"].spec == (None, None)
    local = O.init_opt_state(ok, "int8", "meta", rules=rules, mesh=m)
    assert tuple(local["m"]["w"]["q"].shape) == (128, 1024)
    assert tuple(local["m"]["n"]["q"].shape) == (300, 384)
    split = {"w": PSpec((512, 384), (None, "mlp"), torch.float32)}
    with pytest.raises(ValueError, match="128-blocks"):
        O.zero1_shardings(split, "int8", rules, m)
    assert O.zero1_shardings(split, "f32", rules, m)["w"].spec == \
        (None, "model")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cached_mesh_plans_equal_uncached(multi_pod):
    """``coordinate``, ``_groups`` and ``axis_index`` read plans kept on
    the mesh; on the 16x16 and 2x16x16 fake meshes each equals the plan
    made from the mesh's rank table on every call, for every ordered
    tuple of axes."""
    import itertools

    assert not dist.is_initialized()
    shape, names = LM.production_shape(multi_pod)
    DRY.fake_world(math.prod(shape))
    try:
        mesh = LM.make_production_mesh(multi_pod=multi_pod,
                                       device_type="cpu")
        table = mesh.mesh

        def coord(r):
            return tuple(int(i) for i in (table == r).nonzero()[0])
        sizes = dict(zip(names, shape))
        for r in range(table.numel()):
            assert MESH.coordinate(mesh, r) == coord(r)
        for n in range(1, len(names) + 1):
            for axes in itertools.permutations(names, n):
                want = []
                for a in MESH._steps(mesh, axes):
                    step_axes = axes if a is None else (a,)
                    g = None if a is None else mesh.get_group(a)
                    ranks = (list(range(dist.get_world_size())) if a is None
                             else dist.get_process_group_ranks(g))
                    keys = []
                    for r in ranks:
                        at = dict(zip(names, coord(r)))
                        idx = 0
                        for b in step_axes:
                            idx = idx * sizes[b] + at[b]
                        keys.append(idx)
                    want.append((g, ranks, keys))
                assert MESH._groups(mesh, axes) == want
                assert MESH._groups(mesh, axes) is MESH._groups(mesh, axes)
                assert MESH.axis_index(mesh, axes) == 0     # rank 0
    finally:
        dist.destroy_process_group()
