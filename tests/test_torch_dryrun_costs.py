"""The dry-run's cost fields (``repro_torch.launch.dryrun.step_costs``):
one rank's step traced on ``meta`` tensors under ``costs.CostCounter``.

Closed forms, exact: a one-layer dense model, one MoE layer at its
capacity buffer and one Mamba layer count what a hand count gives, and
each loop counts as its trips would (a model of ``n`` units is one unit
plus ``n - 1`` increments; the loop-aware trace equals the trace that
runs every trip).

Against the reference: ``tests/_meshref.py``'s ``dry_costs`` lowers and
compiles reduced cells on a (2, 2) mesh of host devices as
``repro.launch.dryrun.lower_cell`` does and reads the HLO with the
loop-aware ``hlo_analysis.analyze``; the port traces the same cells on a
4-rank ``fake`` group.

FLOPs (``FLOP_TOL``, relative, 2%).  Forward-only cells agree.  In
training the port's attention backward (``ref.attention_bwd_ref``)
recomputes ``Q K^T`` and ``P V`` (``4 B Hq L^2 D`` a layer a
microbatch), which XLA's autodiff of the reference's scan keeps as
residuals: that term is taken off the port's count before comparing.
What is left over 1%:

  * Mamba (Jamba's train cell, -1.4%): the reference checkpoints each
    chunk's body (``jax.checkpoint`` inside the unit's), so XLA
    recomputes part of a chunk's products a second time in the backward;
    the port checkpoints the unit alone.  Without that decorator the
    reference counts 4.0092e9 against the port's 4.0238e9 (+0.4%).

Collective bytes (``COLL_FACTOR``: each kind both count within a factor
of 16 either way).  The two programs differ by construction:

  * XLA on the CPU carries bf16 activations in f32, so each activation
    collective of the reference moves twice the port's bytes;
  * GSPMD chooses its own collectives: it all-gathers weights and
    activations to replicate a product where the port reduces partial
    sums (the prefill cells' all-gathers, ``GSPMD_GATHERS``), and
    all-reduces weight gradients inside the backward's loops (Jamba's
    Mamba step: 31 MB of its 44 MB) where autograd sums them locally
    and the port all-reduces each leaf once;
  * the port splits a collective over several mesh axes into one per
    axis (``mesh._steps``) and hands prefill K/V to ``kv_seq`` by one
    ``all_to_all`` a tensor; the reference's slices add a
    ``collective-permute`` of a few hundred bytes.

Every kind the port counts is one the reference counts in the same cell.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading

import pytest

torch = pytest.importorskip("torch")

import _meshref as MR                                    # noqa: E402
import torch.distributed as dist                         # noqa: E402

from repro_torch import costs as C                       # noqa: E402
from repro_torch.configs import get_arch                 # noqa: E402
from repro_torch.configs.base import ShapeSpec           # noqa: E402
from repro_torch.launch import dryrun as DRY             # noqa: E402
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS  # noqa: E402
from repro_torch.models import mamba as MB               # noqa: E402
from repro_torch.models import param as PM               # noqa: E402

FLOP_TOL = 0.02
COLL_FACTOR = 16.0
#: the loop-aware trace's traffic against every trip's in a dense
#: model's training (``test_loop_aware_trace_equals_every_trip``)
TRAIN_TRAFFIC_TOL = 1e-5
#: (cell, kind) whose bytes differ by more than COLL_FACTOR, and why
GSPMD_GATHERS = {
    ("minicpm_prefill", "all-gather"):
        "GSPMD gathers the MLP's and attention's operands; the port "
        "gathers only the last position's logits over the vocab",
}


def _one_layer(arch: str, n_layers: int = 1):
    return dataclasses.replace(get_arch(arch).reduced(), n_layers=n_layers)


def _costs(cfg, kind, seq, batch, mesh=None, **kw):
    return DRY.step_costs(cfg, ShapeSpec("t", seq, batch, kind), mesh, **kw)


def _attn_weights(cfg) -> int:
    D, H, K, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    return D * H * hd + 2 * D * K * hd + H * hd * D


# ------------------------------------------------------------- closed forms --

def test_dense_layer_prefill_and_decode_closed_form():
    cfg = _one_layer("minicpm-2b")
    B, L, D, V = 2, 128, cfg.d_model, cfg.padded_vocab
    W = _attn_weights(cfg) + 3 * D * cfg.d_ff
    attn = 4 * B * cfg.n_heads * L * L * cfg.resolved_head_dim
    assert _costs(cfg, "prefill", L, B)["flops"] == \
        2 * B * L * W + attn + 2 * B * D * V
    # one token over the whole cache of L positions
    assert _costs(cfg, "decode", L, B)["flops"] == \
        2 * B * W + 4 * B * cfg.n_heads * L * cfg.resolved_head_dim \
        + 2 * B * D * V


@pytest.mark.parametrize("accum", [1, 2])
def test_dense_layer_train_closed_form(accum):
    """Forward, the unit's recomputation, and the backward (each product
    twice: the input's gradient and the weight's); the attention's
    backward recomputes it (``4A``) before its gradients (``8A``).  The
    recomputation stops once it has every tensor the backward saved
    (``torch.utils.checkpoint``'s early stop), before the unit's last
    product, the MLP's down projection, whose output nothing saves."""
    cfg = _one_layer("minicpm-2b")
    B, L, D, V = 4, 128, cfg.d_model, cfg.padded_vocab
    b = B // accum
    T = b * L
    W = _attn_weights(cfg) + 3 * D * cfg.d_ff
    A = b * cfg.n_heads * L * L * cfg.resolved_head_dim
    fwd = 2 * T * W + 4 * A
    recompute = fwd - 2 * T * cfg.d_ff * D
    per_mb = (fwd + 2 * T * D * V) + recompute + (4 * T * W + 4 * T * D * V
                                                  + 12 * A)
    assert _costs(cfg, "train", L, B, accum=accum)["flops"] == accum * per_mb


def test_moe_layer_at_its_capacity_buffer():
    cfg = _one_layer("dbrx-132b")
    B, L, D, V = 2, 64, cfg.d_model, cfg.padded_vocab
    T, E, k = B * L, cfg.n_experts, cfg.top_k
    cap = int(cfg.capacity_factor * T * k / E) + 1
    attn = 2 * T * _attn_weights(cfg) \
        + 4 * B * cfg.n_heads * L * L * cfg.resolved_head_dim
    moe = 2 * T * D * E + 3 * 2 * E * cap * D * cfg.d_ff
    assert _costs(cfg, "prefill", L, B)["flops"] == attn + moe + 2 * B * D * V


def _mamba_flops(cfg, B, L, din):
    dtr, N, D = max(cfg.d_model // 16, 1), cfg.d_state, cfg.d_model
    per_step = 2 * B * din * (2 * dtr + 3 * N)
    return 3 * 2 * B * L * D * din + L * per_step


def _mamba_costs(cfg, B, L, loops=True):
    p = PM.abstract(MB.mamba_specs(cfg))
    x = torch.empty((B, L, cfg.d_model), dtype=torch.bfloat16, device="meta")
    with C.CostCounter(loops) as c:
        MB.mamba_forward(x, p, cfg)
    return c.totals()


def test_mamba_layer_closed_form_and_chunks():
    """The mixer's FLOPs are linear in its chunks; its traffic is not
    quite (a chunk of more than one is a strided view, copied before its
    products), and the loop-aware trace counts it as every trip does."""
    cfg = _one_layer("jamba-1.5-large-398b")
    B, D, V = 2, cfg.d_model, cfg.padded_vocab
    one, two, three = (_mamba_costs(cfg, B, 64 * n) for n in (1, 2, 3))
    assert two["flops"] == _mamba_flops(cfg, B, 128, cfg.d_inner)
    assert three["flops"] - one["flops"] == 2 * (two["flops"] - one["flops"])
    assert three == _mamba_costs(cfg, B, 192, loops=False)
    # the whole one-layer model at two chunks: the mixer, the MLP, logits
    assert _costs(cfg, "prefill", 128, B)["flops"] == \
        _mamba_flops(cfg, B, 128, cfg.d_inner) \
        + 2 * B * 128 * 3 * D * cfg.d_ff + 2 * B * D * V


def _traced(cfg, kind, seq, batch, loops, **kw):
    step, args = DRY.build_step(cfg, ShapeSpec("t", seq, batch, kind), **kw)
    with C.CostCounter(loops=loops) as c:
        step(*args)
    return c.totals()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_units_add_one_increment_each(kind):
    """A model of 1, 2, 3 units (one layer each): FLOPs one unit's count
    plus an increment a unit; the loop-aware trace of 3 units (two traced,
    the second counted twice) equal to the trace of all three."""
    got = [_costs(_one_layer("minicpm-2b", n), kind, 64, 2)
           for n in (1, 2, 3)]
    assert got[2]["flops"] - got[0]["flops"] == \
        2 * (got[1]["flops"] - got[0]["flops"])
    assert got[1]["flops"] > got[0]["flops"] > 0
    full = _traced(_one_layer("minicpm-2b", 3), kind, 64, 2, False)
    assert got[2]["flops"] == full["flops"]
    assert math.isclose(got[2]["traffic_bytes"], full["traffic_bytes"],
                        rel_tol=TRAIN_TRAFFIC_TOL)


#: (arch cut to n layers, tokens, batch, accum): each loop at 3 or more
#: trips, small enough to run every trip
LOOPS = {"minicpm-2b": (4, 64, 4, 4),               # units, microbatches
         "jamba-1.5-large-398b": (1, 192, 1, 1),    # Mamba chunks, steps
         "xlstm-1.3b": (2, 64, 1, 1),               # the sLSTM's steps
         "whisper-medium": (3, 64, 2, 1)}           # encoder and decoder


@pytest.mark.parametrize("arch", sorted(LOOPS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_loop_aware_trace_equals_every_trip(arch, kind):
    """Two trips of each loop stand for all of them: FLOPs and collective
    bytes exactly, traffic exactly without a backward.  In a backward the
    autograd engine sums the gradients a tensor receives from several
    uses; where the uses are trips of a traced loop, the sums of the
    untraced trips are missing: a few 0-d sums in the dense models
    (``TRAIN_TRAFFIC_TOL``), and through a recurrence's step loop, where
    every step reads the chunk's activations, up to a fifth of the
    traffic (Jamba's and xLSTM's)."""
    n, seq, batch, accum = LOOPS[arch]
    cfg = _one_layer(arch, n)
    kw = {"accum": accum} if kind == "train" else {}
    fast, full = (_traced(cfg, kind, seq, batch, loops, **kw)
                  for loops in (True, False))
    assert fast["flops"] == full["flops"] > 0
    assert fast["collective_bytes"] == full["collective_bytes"]
    if kind != "train":
        assert fast["traffic_bytes"] == full["traffic_bytes"]
    elif arch in ("jamba-1.5-large-398b", "xlstm-1.3b"):
        assert 0.8 * full["traffic_bytes"] < fast["traffic_bytes"] \
            <= full["traffic_bytes"]
    else:
        assert math.isclose(fast["traffic_bytes"], full["traffic_bytes"],
                            rel_tol=TRAIN_TRAFFIC_TOL)


def test_flops_follow_torch_flop_counter():
    """The counter's rule is ``torch.utils.flop_counter``'s: a full trace
    of a train step (every trip) counts what ``FlopCounterMode`` counts."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_arch("dbrx-132b").reduced()
    step, args = DRY.build_step(cfg, ShapeSpec("t", 64, 2, "train"))
    with FlopCounterMode(display=False) as f:
        step(*args)
    assert _traced(cfg, "train", 64, 2, True)["flops"] == f.get_total_flops()


def test_traffic_of_one_matmul():
    x = torch.empty((8, 32), dtype=torch.bfloat16, device="meta")
    w = torch.empty((32, 16), dtype=torch.float32, device="meta")
    with C.CostCounter() as c:
        y = x.float() @ w
    assert y.shape == (8, 16)
    # the cast (read bf16, write f32), then the product (read both, write)
    assert c.traffic_bytes == (8 * 32 * 2 + 8 * 32 * 4) + \
        (8 * 32 * 4 + 32 * 16 * 4 + 8 * 16 * 4)
    assert c.flops == 2 * 8 * 16 * 32 and c.collective_bytes == {}


def test_no_counter_leaves_loops_as_they_are():
    assert list(C.trips(5)) == [0, 1, 2, 3, 4]
    assert C.each((1, 2, 3)) == [1, 2, 3]
    assert C.fill([1, 2], 2) == [1, 2]
    f = lambda: 1                                        # noqa: E731
    assert C.replay(f) is f and not C.counting()


def test_meta_attention_takes_the_plain_version():
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.paged_attention import ops as PO
    q = torch.empty((1, 4, 8, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 8, 16), device="meta")
    with C.CostCounter() as c:
        out = FO.attention(q, k, k)
    assert out.shape == q.shape and c.flops == 4 * 4 * 8 * 8 * 16
    pages = torch.empty((4, 8, 2, 16), device="meta")
    out = PO.attention(torch.empty((1, 4, 16), device="meta"), pages, pages,
                       torch.zeros((1, 2), dtype=torch.int32, device="meta"),
                       torch.zeros((1,), dtype=torch.int32, device="meta"))
    assert out.shape == (1, 4, 16)


# ------------------------------------------------------ production cells ----

@pytest.mark.parametrize("arch,shape", [("minicpm-2b", "train_4k"),
                                        ("qwen2-vl-2b", "prefill_32k"),
                                        ("qwen2-72b", "decode_32k")])
def test_dryrun_cli_costs_production_cells(tmp_path, capsys, arch, shape):
    """The CLI traces a production cell of each kind on both meshes (the
    decode cell is ``w8a16``): every cost field there and non-zero."""
    out = tmp_path / "dry.json"
    assert DRY.main(["--arch", arch, "--shape", shape, "--both-meshes",
                     "--out", str(out)]) == 0
    assert "2/2 cells OK" in capsys.readouterr().out
    assert not dist.is_initialized()
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        assert r["flops"] > 0 and r["traffic_bytes"] > 0
        assert r["collective_bytes"] and all(
            k in COLLECTIVE_KINDS and v > 0
            for k, v in r["collective_bytes"].items())
    assert recs[0]["w8a16"] == (shape == "decode_32k")


# --------------------------------------------------------- the reference ----

@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's compiles start with the module's first test, in a
    thread, and run while the closed forms do."""
    out = tmp_path_factory.mktemp("dry_costs")
    failed = []

    def run():
        try:
            MR.run("dry_costs", "-", str(out), devices=4, timeout=600)
        except Exception as e:                  # raised in ``reference``
            failed.append(e)
    t = threading.Thread(target=run)
    t.start()
    yield t, out, failed
    t.join()


@pytest.fixture(scope="module")
def reference(_reference_run):
    t, out, failed = _reference_run
    t.join()
    if failed:
        raise failed[0]
    return json.loads((out / "dry_costs.json").read_text())


@pytest.fixture(scope="module")
def port():
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    DRY.fake_world(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
        return {name: _costs(get_arch(arch).reduced(), kind, seq, gb, mesh)
                for name, arch, kind, seq, gb in MR.DRY_CELLS}
    finally:
        dist.destroy_process_group()


def _attention_recompute(name) -> int:
    """The port's extra ``4 B Hq L^2 D`` a layer a microbatch in training
    (``attention_bwd_ref``), at the rank's rows and heads on (2, 2)."""
    _, arch, kind, L, gb = next(c for c in MR.DRY_CELLS if c[0] == name)
    if kind != "train":
        return 0
    from repro_torch.models.blocks import block_pattern
    cfg = get_arch(arch).reduced()
    n_attn = sum(k.startswith("attn") for k in block_pattern(cfg))
    rows = gb // 2                               # the batch over data
    heads = cfg.n_heads
    if cfg.n_experts:                            # not small-dense: TP
        heads //= 2
    else:                                        # small-dense: every axis
        rows = gb // 4
    return n_attn * 4 * rows * heads * L * L * cfg.resolved_head_dim


@pytest.mark.parametrize("name", [c[0] for c in MR.DRY_CELLS])
def test_flops_match_reference(reference, port, name):
    want = reference[name]["flops"]
    got = port[name]["flops"] - _attention_recompute(name)
    assert math.isclose(got, want, rel_tol=FLOP_TOL), (got, want)


@pytest.mark.parametrize("name", [c[0] for c in MR.DRY_CELLS])
def test_collective_bytes_match_reference(reference, port, name):
    want, got = reference[name]["collective_bytes"], \
        port[name]["collective_bytes"]
    assert set(got) <= set(want) and got, (got, want)
    for kind, n in got.items():
        ratio = n / want[kind]
        if (name, kind) in GSPMD_GATHERS:
            assert ratio < 1 / COLL_FACTOR, (kind, n, want[kind])
        else:
            assert 1 / COLL_FACTOR < ratio < COLL_FACTOR, (kind, n,
                                                           want[kind])
