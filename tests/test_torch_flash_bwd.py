"""The plain versions of the flash backward kernel, on the CPU, in f32.

``csrc/flash_attention_bwd.cu`` cannot run here; what it computes can.
``ref.attention_stats_ref`` (the forward's softmax statistics) and
``ref.attention_bwd_from_stats_ref`` (the gradient rebuilt from them,
walking the kernels' tiles with their skip rule) are held to
``torch.logsumexp`` of the masked scores, to autograd of
``attention_ref`` and to ``jax.vjp`` of the reference's
``blockwise_attention`` on the same numpy inputs, within 1e-5, on
``_flashcases.BWD_CASES`` (causal, windowed, GQA, offsets, rows that see
no key) and at the training head dims.  The kernels' tile model is held
to the pairs the masks need: both kernels' walks, the key-major walk
against the query-major rule, and dQ's fixed order against the claim
order of the persistent grid.  The card holds the kernels to
``attention_bwd_from_stats_ref`` (``tests/test_torch_on_card.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _flashcases import BWD_CASES, WIDE_BWD_CASES  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402

from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF,
    attention_bwd_from_stats_ref,
    attention_ref,
    attention_stats_ref,
)

TOL = 1e-5
CASES = BWD_CASES + WIDE_BWD_CASES


def _inputs(case):
    """q, k, v, dO as f32 numpy normals drawn from the case's seed."""
    B, Hq, Hkv, Lq, Lkv, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    return [rng.standard_normal(s, dtype=np.float32) for s in (
        (B, Hq, Lq, D), (B, Hkv, Lkv, D), (B, Hkv, Lkv, D), (B, Hq, Lq, D))]


def _kw(case):
    return dict(zip(("causal", "window", "q_offset", "kv_offset"), case[6:]))


def _seen(case):
    """(Lq, Lkv) bool: the pairs each query sees."""
    Lq, Lkv = case[3], case[4]
    kw = _kw(case)
    qp = kw["q_offset"] + np.arange(Lq)[:, None]
    kp = kw["kv_offset"] + np.arange(Lkv)[None, :]
    seen = np.ones((Lq, Lkv), bool)
    if kw["causal"]:
        seen &= kp <= qp
    if kw["window"]:
        seen &= kp > qp - kw["window"]
    return seen


def _from_stats(q, k, v, do, kw):
    return attention_bwd_from_stats_ref(q, k, v, do,
                                        attention_stats_ref(q, k, **kw), **kw)


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_stats_ref_matches_logsumexp(case):
    """The statistics are torch.logsumexp of the scaled scores with the
    unseen ones at NEG_INF; a row that sees no key gets exactly NEG_INF
    there too (its log(Lkv) is below an ulp of 1e30)."""
    q, k, _, _ = (torch.from_numpy(a) for a in _inputs(case))
    B, Hq, Hkv, Lq, Lkv, D = case[:6]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.reshape(B, Hkv, Hq // Hkv, Lq, D),
                     k) / np.sqrt(D)
    seen = torch.from_numpy(_seen(case))
    want = torch.logsumexp(s.masked_fill(~seen, NEG_INF), -1).reshape(
        B, Hq, Lq)
    got = attention_stats_ref(q, k, **_kw(case))
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Lq)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    blind = ~seen.any(-1)
    assert bool((got[:, :, blind] == NEG_INF).all())
    assert bool((got[:, :, ~blind] > 0.5 * NEG_INF).all())
    assert int(blind.sum()) == {5: 30, 6: 25}.get(CASES.index(case), 0)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_from_stats_matches_autograd(case):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    kw = _kw(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    got = _from_stats(q, k, v, do, kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _max_err(g, w) < TOL


def _jax_grads(q, k, v, do, kw, chunk):
    fn = lambda q, k, v: blockwise_attention(q, k, v, chunk=chunk, **kw)  # noqa: E731
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_from_stats_matches_jax_vjp(case):
    """jax.vjp of the reference's blockwise attention, at its default
    chunk of 512 and at a chunk of Lkv (one chunk, no padding), against
    the port's gradient from the statistics.

    A row that sees no key differs at the padded chunk, in the reference
    (ROADMAP.md §3, "blockwise_attention's blind rows average its
    padding"): its K/V are padded with zeros up to the chunk, and a row
    whose every score is NEG_INF averages the padding too, so its output
    is sum(v) / 512 and each key's dv gets its dO / 512, where
    ``attention_ref``, its Pallas kernel's oracle and the port take 1 /
    Lkv.  Such rows have no score gradient in either, so dq and dk agree;
    dv agrees once each side's uniform term is taken out.  Without
    padding the two agree outright."""
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    B, Hq, Hkv, Lq, Lkv, D = case[:6]
    got = [t.numpy() for t in _from_stats(*(torch.from_numpy(a) for a in
                                            (q, k, v, do)), kw)]
    blind = ~_seen(case).any(-1)
    chunk = 512
    padded = -(-Lkv // chunk) * chunk
    out, want = _jax_grads(q, k, v, do, kw, chunk)
    do_blind = do[:, :, blind].reshape(B, Hkv, -1, D).sum(2)[:, :, None]
    if blind.any():
        assert padded != Lkv
        np.testing.assert_allclose(                 # the divergence itself
            out[:, :, blind],
            np.repeat(v.sum(2, keepdims=True) / padded, Hq // Hkv, 1)
            .repeat(int(blind.sum()), 2), atol=TOL, rtol=0)
    assert _max_err(got[0], want[0]) < TOL
    assert _max_err(got[1], want[1]) < TOL
    assert _max_err(got[2] - do_blind / Lkv, want[2] - do_blind / padded) \
        < TOL
    _, want = _jax_grads(q, k, v, do, kw, Lkv)
    for g, w in zip(got, want):
        assert _max_err(g, w) < TOL


TILE_CASES = [
    # (Lq, Lkv, causal, window, q_offset, kv_offset)
    (300, 300, True, 0, 0, 0),
    (200, 700, True, 0, 500, 0),
    (400, 400, True, 100, 0, 0),
    (300, 200, True, 0, 0, 130),      # rows 0-129 see nothing
    (300, 100, False, 40, 0, 0),      # rows 139- see nothing
    (130, 500, False, 0, 0, 0),
    (250, 260, True, 70, 33, 7),
    (64, 64, True, 1, 0, 0),
]


#: each kernel's (query rows, keys) a tile: the key-major kernel's, the
#: delta kernel's, the f32 kernels'
TILES = [(ref.BQ, ref.BK), (ref.DELTA_BQ, ref.DELTA_BK),
         (ref.F32_BQ, ref.F32_BK)]


@pytest.mark.parametrize("tiles", TILES, ids=str)
@pytest.mark.parametrize("case", TILE_CASES, ids=str)
def test_tile_walk_covers_every_pair_it_needs(case, tiles):
    """The kernels' (query tile, key tile) pairs hold every pair some row
    sees and, for a row that sees nothing, every key (its uniform
    average); key tiles stay inside Lkv; and a query tile visits no key
    tile before its first needed one or after its last."""
    Lq, Lkv, causal, window, qo, ko = case
    bq, bk = tiles
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    seen = _seen((1, 1, 1, Lq, Lkv, 16, causal, window, qo, ko))
    nqt, nkt = -(-Lq // bq), -(-Lkv // bk)
    need = np.zeros((nqt, nkt), bool)
    for qt in range(nqt):
        rows = seen[qt * bq:(qt + 1) * bq]
        blind = ~rows.any(-1)
        for kt in range(nkt):
            cols = rows[:, kt * bk:(kt + 1) * bk]
            need[qt, kt] = cols.any() or blind.any()
    visit = np.zeros_like(need)
    for qt in range(nqt):
        t_lo, t_hi = ref.key_tiles(qt, Lq, Lkv, bq=bq, bk=bk, **kw)
        assert 0 <= t_lo < t_hi <= nkt
        visit[qt, t_lo:t_hi] = True
    assert not (need & ~visit).any()
    # the rule is one key range a query tile: what it visits beyond the
    # need lies between needed tiles
    for qt in range(nqt):
        cols = np.flatnonzero(need[qt])
        assert (np.flatnonzero(visit[qt]) == np.arange(cols[0], cols[-1] + 1)
                ).all()


@pytest.mark.parametrize("case", TILE_CASES, ids=str)
def test_the_two_walks_visit_one_set_of_pairs(case):
    """The key-major kernel's walk (each key tile's query tiles, as its
    ``walk_of``/``next_tile`` find them) visits exactly the (query tile,
    key tile) pairs that the query-major rule (``key_tiles``) gives, each
    once, query tiles ascending; the items of key tiles no row sees visit
    nothing (they write zero dK and dV)."""
    Lq, Lkv, causal, window, qo, ko = case
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    nqt, nkt = -(-Lq // ref.BQ), -(-Lkv // ref.BK)
    by_query = {(qt, kt) for qt in range(nqt)
                for kt in range(*ref.key_tiles(qt, Lq, Lkv, **kw))}
    walks = {kt: ref.query_tiles(kt, Lq, Lkv, **kw) for kt in range(nkt)}
    for tiles in walks.values():
        assert tiles == sorted(set(tiles))
    assert {(qt, kt) for kt, tiles in walks.items() for qt in tiles} \
        == by_query


@pytest.mark.parametrize("heads", [(1, 1), (2, 3)], ids=str)
@pytest.mark.parametrize("case", TILE_CASES, ids=str)
def test_claim_order_puts_every_dq_predecessor_first(case, heads):
    """dQ's fixed order cannot deadlock the persistent grid: in the order
    the blocks claim items, the item that must add a query tile's part
    before an item (key tile kt - 1 of the same kv head, ``dq_order``) is
    claimed earlier and visits that tile too, and each chain starts at the
    first key tile that visits the tile.  Then a block that waits holds
    only items later than the ones it waits for, which run on blocks that
    have claimed them: a few blocks claiming in this order, each item's
    steps waiting for their predecessors, run to the end."""
    Lq, Lkv, causal, window, qo, ko = case
    B, Hkv = heads
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    items = ref.claim_order(B, Hkv, Lkv)
    assert len(items) == len(set(items)) == B * Hkv * -(-Lkv // ref.BK)
    place = {item: i for i, item in enumerate(items)}
    for kt, b, g in items:
        for qt in ref.query_tiles(kt, Lq, Lkv, **kw):
            order = ref.dq_order(qt, Lq, Lkv, **kw)
            chain = [t for t, w in order if w == 0]
            assert chain == [t for t, w in order if w == 1] == list(
                range(*ref.key_tiles(qt, Lq, Lkv, **kw)))
            if kt == chain[0]:
                continue
            assert place[(kt - 1, b, g)] < place[(kt, b, g)]
            assert qt in ref.query_tiles(kt - 1, Lq, Lkv, **kw)
    # a few blocks, each taking the next item when its last is done; a
    # step (item, query tile) waits until the item before it in the
    # chain has done that tile
    for blocks in (1, 2, 5):
        queue = list(items)
        done = set()
        running = [None] * blocks
        for _ in range(10 ** 5):
            for i in range(blocks):
                if running[i] is None and queue:
                    item = queue.pop(0)
                    running[i] = (item, ref.query_tiles(item[0], Lq, Lkv,
                                                        **kw))
            if all(r is None for r in running):
                break
            moved = False
            for i, r in enumerate(running):
                if r is None:
                    continue
                (kt, b, g), tiles = r
                if tiles:
                    qt = tiles[0]
                    first = ref.key_tiles(qt, Lq, Lkv, **kw)[0]
                    if kt > first and (kt - 1, b, g, qt) not in done:
                        continue
                    done.add((kt, b, g, qt))
                    tiles.pop(0)
                    moved = True
                if not tiles:
                    running[i] = None
                    moved = True
            assert moved, f"no block can move with {blocks} blocks"
        assert not queue and all(r is None for r in running)


def test_a_narrower_tile_walk_is_caught(monkeypatch):
    """The gradient from the statistics follows ``key_tiles``: a walk one
    key tile short on each query tile misses gradient that autograd
    finds, which is how a wrong skip rule shows on the CPU."""
    case = (1, 2, 2, 200, 200, 16, True, 0, 0, 0)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    kw = _kw(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    tiles = ref.key_tiles
    monkeypatch.setattr(ref, "key_tiles", lambda *a, **kw: (
        tiles(*a, **kw)[0], max(tiles(*a, **kw)[1] - 1, tiles(*a, **kw)[0] + 1)))
    got = _from_stats(q, k, v, do, kw)
    assert max(_max_err(g, w) for g, w in zip(got, want)) > 1e-2
