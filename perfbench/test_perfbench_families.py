"""A configuration's ``reference`` chooses its model family: the weights
each family draws, the port's tree of views of them for any periodic
layout, the decoder with MoE on some layers only, and a family added by
its two files alone.  Small, on the CPU."""
import hashlib
import shutil

import pytest
import torch

import _testkit as K
import drivers
import harness
import system
import weights as W

CPU = torch.device("cpu")

#: sha256 (first 16 hex digits) of each leaf of each configuration cut to
#: ``_testkit``'s small size, drawn in float32 on the CPU from
#: ``SEEDS[0]``, as the harness drew them before the families: the table
#: of leaves, their order and the drawing rule give the same bits
DIGESTS = {
    "dbrx-132b-l4": {
        "table": "d82cf994c3471798", "lm_head": "33dc728446484564",
        "wq": "3abc243ac09f503d", "wk": "6e08b75fb6b3f207",
        "wv": "6f9bc831a18565a8", "wo": "e492357c38cd6b5b",
        "router": "6b79fadfa9cc0ef0", "we_gate": "5747754006d88ff1",
        "we_up": "819b82ea1f02f3b5", "we_down": "461a4f6bc435fe66",
        "ln1": "02722f124d0f1736", "ln2": "02722f124d0f1736",
        "ln_f": "2f20cd03c9cd392a"},
    "minicpm-2b": {
        "table": "d7147e4e8945f058", "wq": "545918170135b34f",
        "wk": "e5e1e69c27bdb5d6", "wv": "f86edcf56c390717",
        "wo": "6fb941345115fa50", "wi_gate": "ca3afeccef285605",
        "wi_up": "cdc2f9189467174a", "w_down": "ad03e5d5e6f4d930",
        "ln1": "02722f124d0f1736", "ln2": "02722f124d0f1736",
        "ln_f": "2f20cd03c9cd392a"},
}


def _draw(config: dict):
    fam = harness.family(config["reference"])
    arch = config["arch"]
    return fam, W.make(fam.leaves(arch), arch, config.get("init", {}),
                       K.SEEDS[0], CPU, torch.float32)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weights_are_drawn_as_before(name):
    _, w = _draw(K.small_config(name))
    got = {k: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]
           for k, t in w.items()}
    assert got == DIGESTS[name]


def _mixed(every: int, offset: int, n_layers: int) -> dict:
    """DBRX cut small, its experts on the layers where ``i % every ==
    offset`` and the dense MLP on the others; a capacity that drops no
    token, so that a decode step and the teacher-forced forward route
    alike."""
    cfg = K.small_config("dbrx-132b-l4")
    return dict(cfg, arch=dict(cfg["arch"], moe_every=every,
                               moe_offset=offset, n_layers=n_layers,
                               capacity_factor=8.0))


LAYOUTS = [(2, 1, 5), (4, 3, 8), (1, 0, 2)]


@pytest.mark.parametrize("every,offset,n_layers", LAYOUTS)
def test_port_leaves_are_views_of_the_drawn_ones(every, offset, n_layers):
    """Every leaf of the port's tree shares its drawn leaf's storage, and
    each layer's slice is that layer's row of the drawn leaf."""
    from repro_torch.models import param as PM
    from repro_torch.models.blocks import block_pattern, layout_for
    config = _mixed(every, offset, n_layers)
    fam, w = _draw(config)
    arch = config["arch"]
    cfg = system.arch_config(arch)
    params = system.program_params(cfg, w, fam, arch)
    drawn = {t.untyped_storage().data_ptr(): n for n, t in w.items()}
    for path, t in PM.tree_leaves_with_paths(params):
        assert t.untyped_storage().data_ptr() in drawn, path
    layout = layout_for(cfg, block_pattern(cfg))
    assert (len(layout.runs) > 1) == (every > 1)
    table = fam.leaves(arch)
    period = sum(rl for _, rl in layout.runs)
    for r, (kind, rl) in enumerate(layout.runs):
        start = sum(n for _, n in layout.runs[:r])
        names = dict(PM.tree_leaves_with_paths(fam.block(arch, kind)))
        got = dict(PM.tree_leaves_with_paths(params["blocks"]["units"][r]))
        for path, name in names.items():
            for u in range(layout.n_units):
                for i in range(rl):
                    layer = u * period + start + i
                    want = w[name][table[name].layers.index(layer)]
                    assert torch.equal(got[path][u, i], want), (path, layer)
    first = layout.n_units * period
    for r, (kind, rl) in enumerate(layout.rest_runs):
        names = dict(PM.tree_leaves_with_paths(fam.block(arch, kind)))
        got = dict(PM.tree_leaves_with_paths(params["blocks"]["rest"][r]))
        for path, name in names.items():
            for i in range(rl):
                want = w[name][table[name].layers.index(first + i)]
                assert torch.equal(got[path][i], want), path
        first += rl


@pytest.mark.parametrize("workload", ["dbrx-132b-l4.prefill",
                                      "minicpm-2b.decode"])
def test_period_two_decoder_is_correct(workload):
    """MoE on layers 1 and 3 of 5, the dense MLP on 0, 2 and 4 (a unit of
    two runs and a rest run in the port's layout), through the cell's
    driver and held to the cell's limits."""
    c = K.ctx(workload, seconds=0.5)
    c.config = _mixed(2, 1, 5)
    out = drivers.DRIVERS[c.traffic["driver"]](c)
    assert out.correct, out.compared
    assert out.records["compared"] > 0


def _copy_family(root, name: str):
    for kind in ("reference", "families"):
        (root / kind).mkdir()
        shutil.copy(K.HERE / kind / "decoder.py", root / kind / f"{name}.py")


def test_a_family_added_by_files_runs_a_cell(tmp_path, monkeypatch):
    """The decoder's two modules under another name, in another place,
    serve a small prefill cell ``correct``."""
    _copy_family(tmp_path, "copied")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    c = K.ctx("minicpm-2b.prefill", seconds=0.5)
    c.config = dict(c.config, reference="copied")
    out = drivers.prefill(c)
    assert out.correct, out.compared
    assert c.family.__file__ == str(tmp_path / "families" / "copied.py")
    assert c.reference.__file__ == str(tmp_path / "reference" / "copied.py")


def test_unknown_reference_names_the_missing_file():
    c = K.ctx("minicpm-2b.prefill", seconds=0.5)
    c.config = dict(c.config, reference="no_such_family")
    with pytest.raises(SystemExit, match="families/no_such_family.py"):
        drivers.prefill(c)
    with pytest.raises(SystemExit, match="reference/no_such_family.py"):
        harness.reference("no_such_family")
