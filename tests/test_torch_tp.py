"""The port's weight-sharding bodies on gloo ranks, on the CPU: tensor
parallelism over ``model`` (attention, MLP, vocab, Mamba's d_inner),
FSDP over the data axes and expert-parallel MoE, one train step each.

Six scenarios (``_meshref.TP_SCENARIOS``), reduced, in f32, from the
same weights (the port's seed-0 draw on the CPU) and batch:

- Nemotron-4-15B on (2, 2), batch 2: the batch does not fill the mesh,
  so the cell is TP+FSDP, not small-dense DP;
- Qwen2-72B on (1, 4): its 4 q heads split 4 ways, its 2 kv heads do
  not divide 4 and stay whole: a rank reads kv head ``h // 2``;
- DBRX on (2, 2): experts over ``model``, FSDP inside the MoE body;
- Grok-1 on (1, 8): 4 experts do not divide 8, so they are replicated
  and each expert's d_ff splits over ``model``;
- Jamba on (2, 2): Mamba's d_inner (``state_inner``) over ``model``;
- Whisper-medium on (2, 2), batch 2: the encoder-decoder (no decoder
  layer is ``dec_attn``, as in the reference: the cross-attention body
  is held by ``test_cross_attention_on_a_mesh``).

Each is held to the reference's jitted step on the same mesh of host
devices: the loss within 1e-5, every gathered gradient, parameter and
moment within relnorm 1e-4.  The MoE scenarios' reference is also held
to its own gradient without a mesh (the mean of one row's gradients,
since every microbatch shard holds one row); the dense ones' port to
the port without a mesh (loss within 1e-6 relative, leaves relnorm
1e-5).  Where the reference's own sharded step differs from its
unsharded one by more than a limit (one leaf: Qwen2-72B's new k bias,
ROADMAP.md §3), that leaf is held within the reference's difference.  A TP+FSDP checkpoint written on (2, 2) restores leaf-equal on
(1, 4) and on no mesh.  The ranks run under ``torch.distributed.run``
(``tests/_meshrun.py``: 4 ranks, then 8), the reference in one
subprocess on 8 host devices (``tests/_meshref.py``), all three at once.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _meshref as MR  # noqa: E402
from _meshrun import _keyed, _tree, launch  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import io  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    build_train_step, default_accum)

SCEN = {s[0]: s for s in MR.TP_SCENARIOS}
NAMES = list(SCEN)
DENSE = [n for n in NAMES if n not in MR.TP_MOE]


def _cfg(name):
    return dataclasses.replace(get_arch(SCEN[name][1]).reduced(),
                               cache_dtype="f32")


def _shape(name):
    return ShapeSpec("t", MR.TP_SEQ, SCEN[name][4], "train")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    ref, out = d / "ref", d / "port"
    ref.mkdir()
    out.mkdir()
    data = {}
    for name in NAMES:
        cfg = _cfg(name)
        host = PM.tree_map(lambda t: t.float(), M.init_params(cfg, 0, "cpu"))
        data.update(_keyed(f"{name}/params", host))
        for k, v in io.synthetic_batch(cfg, _shape(name), 1, "cpu").items():
            data[f"{name}/batch/{k}"] = (v.float() if v.is_floating_point()
                                         else v).numpy()
    cfg = _cfg("whisper_2x2")
    xspecs = B.block_specs(cfg, "dec_attn/dense")
    data.update(_keyed("xattn/params", PM.tree_map(
        lambda t: t.float(), PM.initialize(xspecs, 3, "cpu"))))
    rng = np.random.default_rng(3)
    for k in ("x", "enc", "w"):
        data[f"xattn/{k}"] = rng.standard_normal(
            (MR.XATTN_ROWS, MR.TP_SEQ, cfg.d_model), dtype=np.float32)
    np.savez(out / "tp_inputs.npz", **data)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(MR.run, "tp", str(out / "tp_inputs.npz"),
                            str(ref), devices=8, timeout=300),
                pool.submit(launch, 4, "tp", ref, out, timeout=300),
                pool.submit(launch, 8, "tp", ref, out, timeout=300)]
        for j in jobs:
            j.result()
    return ref, out


def _relnorm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def _self_err(ref) -> dict:
    """{key: relnorm} of the reference's sharded step against its own
    unsharded step (``unsharded_*``; the dense scenarios)."""
    return {k: _relnorm(ref[k], ref["unsharded_" + k]) for k in ref.files
            if "unsharded_" + k in ref.files}


def _over(got, want, limit: float, floor: dict) -> dict:
    """{key: relnorm} of every gradient, parameter and moment leaf over
    its limit: ``limit``, or where the reference's own sharded and
    unsharded steps differ by more (ROADMAP.md §3), that difference."""
    prefixes = ("grads", "new_params", "new_opt")
    keys = [k for k in want.files if k.startswith(prefixes)]
    assert keys and sorted(keys) == sorted(
        k for k in got.files if k.startswith(prefixes))
    errs = {k: _relnorm(got[k], want[k]) for k in keys}
    return {k: e for k, e in errs.items() if e >= max(limit, floor.get(k, 0))}


@pytest.mark.parametrize("name", NAMES)
def test_tp_step_matches_reference(runs, name):
    ref, out = runs
    want, got = np.load(ref / f"tp_{name}.npz"), np.load(out / f"tp_{name}.npz")
    assert abs(float(got["loss"]) - float(want["loss"])) < 1e-5
    assert _over(got, want, 1e-4, _self_err(want)) == {}


def test_reference_disagrees_with_itself_on_a_zero_gradient_bias(runs):
    """The one leaf where the reference's (1, 4) step and its 1x1 step
    differ by more than 1e-4: Qwen2-72B's new k bias (ROADMAP.md §3).
    Its gradient is 0 in theory in the low-frequency RoPE dims (a shift
    of every key's score by the same amount), so what is left there is
    roundoff, which Adam's first step (eps 1e-8) turns into updates of
    up to lr; the gradients themselves agree to 1e-5."""
    ref, _ = runs
    over = {}
    for name in DENSE:
        for k, e in _self_err(np.load(ref / f"tp_{name}.npz")).items():
            assert k.startswith("new_") or e < 1e-5, (name, k, e)
            if e >= 1e-4:
                over[f"{name}/{k}"] = e
    assert list(over) == ["qwen72_1x4/new_params__blocks__units__0__attn__bk"]


@pytest.mark.parametrize("name", MR.TP_MOE)
def test_reference_moe_step_matches_its_unsharded_gradient(runs, name):
    """The reference's ``shard_map`` transposes (``check_vma=False``) give
    the gradient of the mesh's own semantics: each leaf within relnorm
    1e-4 of the mean of one row's gradients without a mesh."""
    ref, _ = runs
    got = np.load(ref / f"tp_{name}.npz")
    keys = [k for k in got.files if k.startswith("grads__")]
    errs = {k: _relnorm(got[k], got["unsharded_" + k]) for k in keys}
    key, err = max(errs.items(), key=lambda kv: kv[1])
    assert keys and err < 1e-4, (key, err)


def _no_mesh(out, name):
    """The port's step without a mesh, one row per microbatch, from the
    same weights and batch."""
    cfg, shape = _cfg(name), _shape(name)
    pspecs = M.model_specs(cfg)
    data = np.load(out / "tp_inputs.npz")
    params = PM.trainable(PM.from_numpy(_tree(pspecs, f"{name}/params",
                                              data), "cpu"))
    opt = O.init_opt_state(pspecs, "f32", "cpu")
    batch = {k.split("/")[-1]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith(f"{name}/batch/")}
    step = build_train_step(cfg, M.build_ctx(cfg), O.OptConfig(
        schedule=cfg.lr_schedule), default_accum(shape, None, cfg))
    return step(params, opt, batch)


@pytest.mark.parametrize("name", DENSE)
def test_tp_step_matches_no_mesh(runs, name):
    _, out = runs
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, opt, m = _no_mesh(out, name)
    finally:
        torch.set_num_threads(n)
    got = np.load(out / f"tp_{name}.npz")
    loss = float(m["loss"])
    assert abs(float(got["loss"]) - loss) <= 1e-6 * abs(loss)
    one = {**_keyed("new_params", params), **_keyed("new_opt", opt)}
    floor = _self_err(np.load(runs[0] / f"tp_{name}.npz"))
    errs = {k: _relnorm(got[k], v) for k, v in one.items()}
    assert {k: e for k, e in errs.items()
            if e >= max(1e-5, floor.get(k, 0))} == {}


def test_cross_attention_on_a_mesh(runs):
    """Whisper's ``dec_attn`` block, TP over ``model`` and FSDP over
    ``data``: the gradients of its weights, its input and the encoder
    output within relnorm 1e-4 of the reference's on the same mesh."""
    ref, out = runs
    want, got = np.load(ref / "xattn.npz"), np.load(out / "xattn.npz")
    assert sorted(want.files) == sorted(got.files)
    assert any(k.endswith("cwk") for k in want.files)
    errs = {k: _relnorm(got[k], want[k]) for k in want.files}
    assert max(errs.values()) < 1e-4, errs


def test_tp_checkpoint_restores_on_1x4(runs):
    """Written on (2, 2) (FSDP over ``data``, TP over ``model``), read on
    (1, 4) under that mesh's rules: every leaf equal once gathered, and
    each rank holding a quarter of the model-split leaves."""
    _, out = runs
    want = np.load(out / "tp_nemotron_2x2.npz")
    got = np.load(out / "tp_ckpt_on_1x4.npz")
    keys = [k for k in want.files if k.startswith(("new_params", "new_opt"))]
    assert sorted(keys) == sorted(k for k in got.files if k != "held")
    assert [k for k in keys if not np.array_equal(got[k], want[k])] == []
    total = sum(want[k].size for k in keys if k.startswith("new_params"))
    assert total / 4 < int(got["held"]) < total / 2


def test_tp_checkpoint_restores_on_no_mesh(runs):
    _, out = runs
    cfg = _cfg("nemotron_2x2")
    pspecs = M.model_specs(cfg)
    target = {"params": PM.initialize(pspecs, 0, "cpu"),
              "opt": O.init_opt_state(pspecs, "f32", "cpu")}
    got, _ = CKPT.restore(out / "tp_ckpt", 1, target)
    want = np.load(out / "tp_nemotron_2x2.npz")
    flat = {**_keyed("new_params", got["params"]),
            **_keyed("new_opt", got["opt"])}
    assert [k for k, v in flat.items() if not np.array_equal(v, want[k])] \
        == []


def _stub(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=axes)


@pytest.mark.parametrize("mshape", [(2, 2), (16, 16), (2, 16, 16)])
def test_build_ctx_refuses_head_v_kv_seq_and_serving_only(mshape):
    """Nothing is refused any more: every arch, full and reduced, builds
    under every training and serving shape (``train_4k``,
    ``prefill_32k``, ``decode_32k``, ``long_500k`` and a small train
    shape), xLSTM's ``head_v`` and the decode cells' ``kv_seq`` too, with
    the reference's ``make_rules``."""
    from repro.distributed.mesh import make_rules as ref_rules
    mesh = _stub(mshape)
    ref_mesh = SimpleNamespace(shape=dict(zip(mesh.mesh_dim_names, mshape)),
                               axis_names=mesh.mesh_dim_names)
    shapes = [SHAPES[n] for n in ("train_4k", "prefill_32k", "decode_32k",
                                  "long_500k")] + [ShapeSpec("t", 64, 2,
                                                             "train")]
    for arch in ARCHS:
        for cfg in (get_arch(arch), get_arch(arch).reduced()):
            for shape in shapes:
                ctx = M.build_ctx(cfg, shape, mesh)
                assert ctx.mesh is mesh and ctx.fsdp == shape.is_training
                assert ctx.rules == ref_rules(cfg, shape, ref_mesh), (
                    arch, shape.name)
