"""The plan of the port's split-K paged attention, on the CPU.

``split_plan`` is checked at MiniCPM-2B's and Qwen2-72B's decode shapes
and at the test shapes.  The two passes of ``csrc/paged_attention.cu``
are modelled in plain torch below, from the kernel's plan: 64-position
tiles with an online softmax in base 2 inside each span of ``split_len``
positions, each span's (m, l, acc), then the merge in span order.  The
model is held against the JAX package's Pallas kernel (interpret mode)
and its jnp oracle at the edges the split must survive, with the
tolerances of ``tests/test_kernels.py``: 5e-5 (f32) and 3e-2 (bf16).
The kernel itself runs only on the card (``tests/test_torch_on_card.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_ref,
)

from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_attention.ref import page_ids  # noqa: E402
from repro_torch.models.param import from_numpy  # noqa: E402

TOL = {"f32": 5e-5, "bf16": 3e-2}
#: resident split-kernel blocks of the H100 SXM (132 SMs), by head dim:
#: the bf16 instances' blocks an SM as ``PK.describe`` reports them there
#: (chip_smoke.py phase 2 prints them)
H100_SLOTS = {16: 12 * 132, 32: 9 * 132, 64: 4 * 132, 128: 2 * 132}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
NEG_INF = -1e30

# (B, Hkv, NP, page, D): MiniCPM-2B's decode (8 pages of 128), Qwen2-72B's
# heads at a 4096-token cache, and the shapes of the tests and chip_smoke.py
PLAN_SHAPES = [(8, 36, 8, 128, 64), (8, 8, 32, 128, 128),
               (3, 4, 4, 128, 64), (2, 2, 3, 128, 128), (2, 2, 5, 8, 16),
               (4, 2, 32, 128, 64), (2, 2, 16, 128, 128), (3, 2, 40, 8, 64),
               (6, 2, 20, 8, 16), (1, 1, 0, 8, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_split_plan_covers_the_cache_in_whole_tiles(shape):
    B, Hkv, NP, page, D = shape
    slots = H100_SLOTS[D]
    split_len, n_splits = PK.split_plan(B, Hkv, NP, page, D, slots)
    cap, tiles = NP * page, max(-(-NP * page // PK.TILE), 1)
    assert split_len > 0 and split_len % PK.TILE == 0
    assert n_splits >= 1
    # the spans cover every position, and no span starts past the cache
    assert n_splits * split_len >= cap
    assert (n_splits - 1) * split_len < max(cap, 1)
    # no block reads under the floor unless one span holds the cache
    assert 2 * split_len * D * 2 >= PK.MIN_SPAN_BYTES or n_splits == 1
    # the blocks fill one wave of resident blocks and no more: at most the
    # wave, and over half of what the wave or the floor allows
    want = max(slots // (B * Hkv), 1)
    by_floor = -(-tiles // -(-PK.MIN_SPAN_BYTES // (2 * PK.TILE * D * 2)))
    assert n_splits <= want
    assert 2 * n_splits > min(want, by_floor)


def test_split_plan_at_the_timed_shapes():
    # MiniCPM-2B: 288 (kv head, sequence) pairs fill 528 slots: one span
    assert PK.split_plan(8, 36, 8, 128, 64, H100_SLOTS[64]) == (1024, 1)
    # Qwen2-72B's heads: 64 pairs, 264 slots: four spans of 1024
    assert PK.split_plan(8, 8, 32, 128, 128, H100_SLOTS[128]) == (1024, 4)
    # a card of 114 SMs with the same residency (228 slots): three spans
    # of 22 tiles, 192 blocks, still one wave
    assert PK.split_plan(8, 8, 32, 128, 128, 2 * 114) == (1408, 3)


def two_pass(q, k_pages, v_pages, page_table, seq_lens, split_len):
    """The kernel's arithmetic in plain torch (f32): pass 1 per span of
    ``split_len`` positions in 64-position tiles, pass 2 the merge."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    NP = page_table.shape[1]
    G, cap = Hq // Hkv, NP * page
    n_splits = max(-(-cap // split_len), 1)
    ids = page_ids(page_table, P)
    k = k_pages[ids].reshape(B, cap, Hkv, D).float()
    v = v_pages[ids].reshape(B, cap, Hkv, D).float()
    qs = q.float() * (math.log2(math.e) / math.sqrt(D))
    out = torch.empty((B, Hq, D))
    for b in range(B):
        blind = int(seq_lens[b]) <= 0
        n_read = cap if blind else min(int(seq_lens[b]), cap)
        kb = k[b].repeat_interleave(G, dim=1)           # (cap, Hq, D)
        vb = v[b].repeat_interleave(G, dim=1)
        parts = []
        for s in range(n_splits):
            s0, s1 = s * split_len, min((s + 1) * split_len, n_read)
            m = torch.full((Hq,), NEG_INF)
            ls, acc = torch.zeros(Hq), torch.zeros((Hq, D))
            for t0 in range(s0, s1, 64):
                rows = slice(t0, min(t0 + 64, s1))
                sc = torch.einsum("hd,shd->hs", qs[b], kb[rows])
                if blind:
                    sc = torch.full_like(sc, NEG_INF)
                m_new = torch.maximum(m, sc.max(dim=1).values)
                p = torch.exp2(sc - m_new[:, None])
                alpha = torch.exp2(m - m_new)
                ls = ls * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + torch.einsum("hs,shd->hd", p,
                                                          vb[rows])
                m = m_new
            parts.append((m, ls, acc))           # empty span: (-1e30, 0, 0)
        m_star = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        ls, acc = torch.zeros(Hq), torch.zeros((Hq, D))
        for m, l_s, a_s in parts:
            sc = torch.exp2(m - m_star)
            ls, acc = ls + l_s * sc, acc + a_s * sc[:, None]
        out[b] = acc / torch.clamp(ls, min=1e-30)[:, None]
    return out.to(q.dtype)


def _case(seed, dt, B, Hkv, G, D, page, NP, P):
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s, dtype=np.float32))
          .astype(JDT[dt]) for s in ((B, Hkv * G, D), (P, page, Hkv, D),
                                     (P, page, Hkv, D))]
    return js, [from_numpy(np.asarray(a), "cpu") for a in js], rng


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# page 8 (eight pages a tile), 20 pages a sequence = 160 positions; spans of
# 64 give three splits: 0-63, 64-127, 128-159
EDGE = dict(B=6, Hkv=2, G=2, D=16, page=8, NP=20, P=24)
EDGE_LENS = [0,          # no live position: the uniform average
             37,         # mid-page; the second and third spans are empty
             64,         # exactly at a span boundary
             128 + 8,    # in the last span, at a page boundary
             500,        # past NP * page: every page is read
             160]        # exactly NP * page


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("split_len", [64, 128, None])
def test_two_pass_model_matches_pallas_and_ref(split_len, dt):
    """Valid page ids, repeated: the model against the Pallas kernel in
    interpret mode and the jnp oracle, at each span length (None: the
    plan's own)."""
    (q, kp, vp), (tq, tkp, tvp), rng = _case(7, dt, **EDGE)
    pt = rng.integers(0, EDGE["P"], (EDGE["B"], EDGE["NP"]), dtype=np.int32)
    sl = np.array(EDGE_LENS, dtype=np.int32)
    if split_len is None:
        split_len = PK.split_plan(EDGE["B"], EDGE["Hkv"], EDGE["NP"],
                                  EDGE["page"], EDGE["D"],
                                  H100_SLOTS[EDGE["D"]])[0]
    port = two_pass(tq, tkp, tvp, torch.from_numpy(pt), torch.from_numpy(sl),
                    split_len)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    tol = TOL[dt]
    _close(port, paged_attention(q, kp, vp, jnp.asarray(pt), jnp.asarray(sl),
                                 interpret=True), tol)
    _close(port, paged_attention_ref(q, kp, vp, jnp.asarray(pt),
                                     jnp.asarray(sl)), tol)


@pytest.mark.parametrize("split_len", [64, 128])
def test_two_pass_model_reads_ids_as_jax_indexing_does(split_len):
    """Negative and too-large page ids: a negative id counts from the end,
    then every id is clamped, as JAX's indexing reads them in the Pallas
    kernel (interpret mode) and the jnp oracle."""
    (q, kp, vp), (tq, tkp, tvp), rng = _case(8, "f32", **EDGE)
    P = EDGE["P"]
    pt = rng.integers(-P, 2 * P, (EDGE["B"], EDGE["NP"]), dtype=np.int32)
    pt[:, 0] = [-1, -P, P, 2 * P - 1, -3, 5]
    sl = np.array(EDGE_LENS, dtype=np.int32)
    port = two_pass(tq, tkp, tvp, torch.from_numpy(pt), torch.from_numpy(sl),
                    split_len)
    _close(port, paged_attention(q, kp, vp, jnp.asarray(pt), jnp.asarray(sl),
                                 interpret=True), TOL["f32"])
    _close(port, paged_attention_ref(q, kp, vp, jnp.asarray(pt),
                                     jnp.asarray(sl)), TOL["f32"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_two_pass_model_with_many_spans_and_gqa(dt):
    """Group 8 at D = 128 over pages of 128, spans of 64 (four spans a
    page), ragged lengths, against the Pallas kernel."""
    shape = dict(B=3, Hkv=1, G=8, D=128, page=128, NP=3, P=5)
    (q, kp, vp), (tq, tkp, tvp), rng = _case(9, dt, **shape)
    pt = rng.integers(0, shape["P"], (3, 3), dtype=np.int32)
    sl = np.array([1, 200, 383], dtype=np.int32)
    port = two_pass(tq, tkp, tvp, torch.from_numpy(pt), torch.from_numpy(sl),
                    64)
    _close(port, paged_attention(q, kp, vp, jnp.asarray(pt), jnp.asarray(sl),
                                 interpret=True), TOL[dt])
