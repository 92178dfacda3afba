"""The benchmark's arithmetic against hand-worked values: the union of
busy intervals, percentiles over every sample, flash's bytes and
FLOPs, model FLOPs and a decode step's bytes (the decoder family's),
the PCIe bound, and each per-layer reader on a slice made by hand."""
import json
import types

import pytest

import harness
import tracing
import work

DECODER = harness.family("decoder")


def test_busy_union_merges_overlaps_and_skips_nested():
    iv = [(0, 10), (5, 10), (20, 5), (21, 2), (30, 0)]
    assert work.busy_union(iv) == 15 + 5
    assert work.busy_union([]) == 0


def test_percentile_interpolates_over_all_samples():
    xs = list(range(1, 11))                       # 1..10
    assert work.percentile(xs, 90) == pytest.approx(9.1)
    assert work.percentile(xs, 95) == pytest.approx(9.55)
    assert work.percentile(reversed(xs), 50) == pytest.approx(5.5)
    assert work.percentile([7.0], 95) == 7.0


def test_flash_work_counts_the_causal_pairs():
    # B=1, Hq=2, Hkv=1, L=4, D=8: pairs 1+2+3+4 = 10
    nbytes, flops = work.flash_work(1, 2, 1, 4, 4, 8, True, 0, 2)
    assert flops == 4 * 1 * 2 * 8 * 10
    assert nbytes == (2 * 1 * 2 * 4 * 8 + 2 * 1 * 1 * 4 * 8) * 2
    _, full = work.flash_work(1, 2, 1, 4, 4, 8, False, 0, 2)
    assert full == 4 * 2 * 8 * 16
    _, win = work.flash_work(1, 1, 1, 4, 4, 8, True, 2, 2)
    assert win == 4 * 8 * (1 + 2 + 2 + 2)


ARCH = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 4, "d_ff": 16, "vocab_size": 100, "tie_embeddings": True}


def _ctx(arch):
    return types.SimpleNamespace(arch=arch, config={"reference": "decoder",
                                                    "arch": arch})


def test_model_flops_and_bytes_by_hand():
    # attention: q, o 8x8 each, k, v 8x4 each: 64+64+32+32 = 192
    # MLP: 3 x 8 x 16 = 384
    assert DECODER.layer_params(ARCH, 0) == {"attn": 192, "ffn_active": 384,
                                         "ffn_stored": 384}
    # one batch of B=2, L=3: 2 layers x (2 x 576 x 6 tokens + causal
    # attention 4 x 4 x 2 heads x 6 pairs x 2 rows) + logits 2 x 8 x 100 x 2
    assert DECODER.prefill_flops(ARCH, 2, 3) == \
        2 * (2 * 576 * 6 + 4 * 4 * 2 * 6 * 2) + 2 * 2 * 8 * 100
    # one decode step of B=2 at pos 4: per token 2 x (2 x 576 + 4 x 2 x 4
    # x 5) + logits 2 x 8 x 100
    assert DECODER.decode_flops(ARCH, 2, 4) == \
        2 * (2 * (2 * 576 + 4 * 2 * 4 * 5) + 2 * 8 * 100)
    # weights 2 x 576 + the padded tied table 128 x 8, in bf16; K and V
    # of 5 positions of 2 sequences, 2 layers x 2 x 1 head x 4 x 2 bytes
    assert DECODER.decode_bytes(ARCH, 2, 4) == \
        (2 * 576 + 128 * 8) * 2 + 2 * 5 * 2 * 2 * 1 * 4 * 2
    moe = dict(ARCH, n_experts=4, top_k=2, tie_embeddings=False)
    assert DECODER.layer_params(moe, 1)["ffn_active"] == 8 * 4 + 2 * 384
    assert DECODER.layer_params(moe, 1)["ffn_stored"] == 8 * 4 + 4 * 384


def test_counts_go_layer_by_layer():
    """A period-2 decoder (MoE on layer 1 of 2) counts the dense MLP on
    layer 0 and the router and experts on layer 1."""
    mixed = dict(ARCH, n_experts=4, top_k=2, moe_every=2, moe_offset=1)
    assert [DECODER.is_moe(mixed, i) for i in range(2)] == [False, True]
    # per token: 2 x (192 + 384) on layer 0, 2 x (192 + 32 + 2 x 384) on 1
    assert DECODER.prefill_flops(mixed, 2, 3) == \
        2 * (192 + 384) * 6 + 2 * (192 + 32 + 768) * 6 \
        + 2 * 4 * 4 * 2 * 6 * 2 + 2 * 2 * 8 * 100
    assert DECODER.decode_flops(mixed, 2, 4) == \
        2 * (2 * (192 + 384) + 2 * (192 + 32 + 768) + 2 * 4 * 2 * 4 * 5
             + 2 * 8 * 100)
    # stored: 192 + 384 on layer 0, 192 + 32 + 4 x 384 on layer 1
    assert DECODER.decode_bytes(mixed, 2, 4) == \
        (192 + 384 + 192 + 32 + 4 * 384 + 128 * 8) * 2 \
        + 2 * 5 * 2 * 2 * 1 * 4 * 2


def test_pcie_and_roofline_bounds():
    assert work.pcie_bound_s(64e9) == pytest.approx(1.0)
    assert work.roofline_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.roofline_s(1.0, 989e12) == pytest.approx(1.0)


def _slice():
    # two prefill batches of B=1, L=4 on a 1 s slice, 0.5 s busy: two
    # flash launches of 0.01 s each and one other kernel
    dev = [("flash_bf16<64>", 0.10, 0.01), ("gemm", 0.12, 0.39),
           ("flash_bf16<64>", 0.60, 0.01), ("gemm", 0.605, 0.01)]
    return tracing.Slice(window_s=1.0, busy_s=0.5, device=dev,
                         items={0: (0.0, 0.5), 1: (0.5, 1.0)},
                         meta={0: {"B": 1, "L": 4}, 1: {"B": 1, "L": 4}})


def _read(name, ctx, out):
    return harness.reader(name)(ctx, out)


def test_readers_by_hand():
    arch = dict(ARCH, n_heads=2, n_kv_heads=1, head_dim=4)
    ctx = _ctx(arch)
    out = types.SimpleNamespace(slice=_slice(), records={})
    assert _read("idle_share.prefill", ctx, out) == pytest.approx(50.0)
    nbytes, flops = work.flash_work(1, 2, 1, 4, 4, 4, True, 0, 2)
    bound = work.roofline_s(nbytes, flops)
    assert _read("flash_roofline.prefill", ctx, out) == \
        pytest.approx(100 * 2 * bound / 0.02)
    assert _read("mfu.prefill", ctx, out) == pytest.approx(
        100 * 2 * DECODER.prefill_flops(arch, 1, 4) / work.PEAK_BF16_FLOPS)
    dec = types.SimpleNamespace(slice=tracing.Slice(
        window_s=0.2, busy_s=0.19, device=[], items={},
        meta={5: {"B": 2, "pos": 10}, 6: {"B": 2, "pos": 11}}), records={})
    assert _read("idle_share.decode", ctx, dec) == pytest.approx(5.0)
    assert _read("step_roofline.decode", ctx, dec) == pytest.approx(
        100 * (DECODER.decode_bytes(arch, 2, 10)
               + DECODER.decode_bytes(arch, 2, 11))
        / work.PEAK_HBM_BYTES_PER_S / 0.2)
    assert _read("mfu.decode", ctx, dec) == pytest.approx(
        100 * (DECODER.decode_flops(arch, 2, 10)
               + DECODER.decode_flops(arch, 2, 11))
        / work.PEAK_BF16_FLOPS / 0.2)
    rel = [{"cold_s": 0.5, "wall_s": 0.4, "bytes": 6.4e9, "traced": False},
           {"cold_s": 0.7, "wall_s": 0.6, "bytes": 6.4e9, "traced": False},
           {"cold_s": 9.0, "wall_s": 1.0, "bytes": 6.4e9, "traced": True}]
    sw = types.SimpleNamespace(slice=None, records={"reloads": rel})
    assert _read("reload_pcie_share.swap", ctx, sw) == pytest.approx(20.0)
    assert _read("policy_ms.swap", ctx, sw) == pytest.approx(100.0)
    assert _read("idle_share.swap", ctx, sw) is None


def test_idle_gaps_name_the_host_op_open_mid_gap():
    dev = [("k", 0.0, 10.0), ("k", 30.0, 10.0)]
    host = [(5.0, 30.0, "outer"), (12.0, 10.0, "aten::copy_")]
    assert tracing.gaps(dev, 0.0, 50.0) == [(10.0, 30.0), (40.0, 50.0)]
    got = dict(tracing.idle_by_host(tracing.gaps(dev, 0.0, 50.0), host))
    assert got == {"aten::copy_": 20e-6, "_no_host_op_": 10e-6}


def test_readers_return_nothing_without_a_slice():
    ctx = _ctx(ARCH)
    out = types.SimpleNamespace(slice=None, records={})
    for name in ("mfu.prefill", "flash_roofline.prefill", "idle_share.prefill",
                 "mfu.decode", "step_roofline.decode", "idle_share.decode",
                 "reload_pcie_share.swap", "policy_ms.swap"):
        assert _read(name, ctx, out) is None


def _trace(tmp_path):
    """A Chrome trace by hand: a slice range [0, 100) us holding items
    [0, 40) and [50, 100); kernels in both and one between them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.SLICE,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": tracing.ITEM + "3",
           "ts": 0, "dur": 40},
          {"ph": "X", "cat": "user_annotation", "name": tracing.ITEM + "4",
           "ts": 50, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "check", "ts": 42, "dur": 6},
          {"ph": "X", "cat": "gpu_memcpy", "name": "b", "ts": 60, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 30,
           "dur": 30}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_slice_by_items_and_whole(tmp_path):
    path = _trace(tmp_path)
    by_item = tracing.read(path, {}, per_item=True)
    assert by_item.window_s == pytest.approx(90e-6)
    assert by_item.busy_s == pytest.approx(50e-6)
    assert sorted(by_item.items) == [3, 4]
    whole = tracing.read(path, {}, per_item=False)
    assert whole.window_s == pytest.approx(100e-6)
    assert whole.busy_s == pytest.approx(56e-6)
    gaps = dict(whole.breakdown["idle_gaps"])
    # idle 0-10, 30-42, 48-60, 90-100; the copy is open mid 30-42, 48-60
    assert gaps["aten::copy_"] == pytest.approx(24e-6)
    assert gaps["_no_host_op_"] == pytest.approx(20e-6)
    assert whole.breakdown["device_ops"][0] == ["b", pytest.approx(30e-6)]
