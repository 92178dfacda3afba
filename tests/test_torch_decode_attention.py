"""Decode attention over the live positions, on the CPU.

On the card ``decode_attention`` runs two kernels (``csrc/decode_attention.cu``):
the f32 scores of the live positions, a softmax over those scores alone,
then the value sum of the probabilities rounded to the cache dtype.  Here
the same composition (``ops.live_attention``, and the sequence-sharded
form ``attention._sharded_live``) runs through the passes' plain
versions, and is held to the plain decode attention over the whole
padded cache (``ref.decode_attention_ref``, the CPU path), which
``tests/test_torch_attention.py`` holds to the JAX package.  The span
plan is checked to cover the live range exactly once.  The kernels
themselves run only on the card (``tests/test_torch_on_card.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.models import attention as tattn  # noqa: E402

#: f32: only the softmax's order of summation differs; bf16: a probability
#: that rounds to the other neighbour moves its value's share by 2^-8
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
S = 96


def _inputs(seed, B, Hkv, G, D, dtype, S=S):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype) for shape in ((B, Hkv * G, 1, D), (B, Hkv, S, D),
                                        (B, Hkv, S, D)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, S // 2 + 1, S - 1])
@pytest.mark.parametrize("G", [1, 4, 6])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_live_passes_match_decode_attention(D, G, pos, dtype):
    """The two passes over ``[0, pos]`` against the masked attention over
    the whole padded cache, whose slots past ``pos`` hold other values."""
    q, k, v = _inputs(D + G + pos, 2, 2, G, D, dtype)
    got = ops.live_attention(q, k, v, *ops.live_bounds(pos, 0))
    want = decode_attention_ref(q, k, v, pos)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos,window", [(0, 8), (5, 8), (7, 8), (40, 8),
                                        (S - 1, 1), (S - 1, 33)])
def test_live_passes_match_a_sliding_window(pos, window, dtype):
    """``window > 0``: the live range is ``(pos - window, pos]``."""
    q, k, v = _inputs(pos + window, 2, 2, 4, 64, dtype)
    lo, hi = ops.live_bounds(pos, window)
    assert (lo, hi) == (max(pos - window + 1, 0), pos)
    torch.testing.assert_close(
        ops.live_attention(q, k, v, lo, hi).float(),
        decode_attention_ref(q, k, v, pos, window=window).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 3, 7, 8, 29])
def test_live_passes_match_a_circular_cache(pos, dtype):
    """A circular window cache of W slots is read at ``min(pos, W - 1)``,
    as the model calls it: every slot once ``pos >= W``."""
    W = 8
    q, k, v = _inputs(pos, 3, 2, 2, 32, dtype, S=W)
    at = min(pos, W - 1)
    torch.testing.assert_close(
        ops.live_attention(q, k, v, *ops.live_bounds(at, 0)).float(),
        decode_attention_ref(q, k, v, at).float(), atol=TOL[dtype],
        rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_live_passes_never_read_past_pos(dtype):
    """Slots past ``pos`` (a previous generation's) filled with NaN leave
    the output finite and equal to the clean cache's."""
    q, k, v = _inputs(3, 2, 2, 4, 64, dtype)
    pos = 40
    dirty_k, dirty_v = k.clone(), v.clone()
    dirty_k[:, :, pos + 1:] = float("nan")
    dirty_v[:, :, pos + 1:] = float("nan")
    got = ops.live_attention(q, dirty_k, dirty_v, 0, pos)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, ops.live_attention(q, k, v, 0, pos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("pos", [0, 50, S - 1])
def test_sharded_form_over_one_rank_is_bit_equal(monkeypatch, pos, G, dtype):
    """Over one rank each all-reduce returns its input, the share is
    exactly 1, and the sequence-sharded form built from the same two
    passes gives ``decode_attention``'s bits."""
    monkeypatch.setattr(tattn, "all_reduce_axes",
                        lambda t, mesh, axes, op=None: t)
    q, k, v = _inputs(pos + G, 2, 2, G, 64, dtype)
    got = tattn._sharded_live(q, k, v, min(pos + 1, S), None, ())
    want = ops.live_attention(q, k, v, *ops.live_bounds(pos, 0))
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def test_sharded_form_on_a_rank_past_pos_adds_nothing(monkeypatch):
    """A rank whose slice starts past ``pos`` has no live position: its
    maximum is -1e30, its denominator and its values are 0."""
    seen = []

    def reduce(t, mesh, axes, op=None):
        seen.append(t.clone())
        return t
    monkeypatch.setattr(tattn, "all_reduce_axes", reduce)
    q, k, v = _inputs(1, 2, 2, 2, 16, torch.bfloat16)
    out = tattn._sharded_live(q, k, v, 0, None, ())
    top, mine, vals = seen
    assert bool((top == tattn.NEG_INF).all())
    assert not mine.any() and not vals.any()
    assert out.shape == q.shape and out.dtype == q.dtype and not out.any()


def test_plain_path_is_taken_on_cpu_and_meta():
    """A CPU tensor runs the plain version over the whole padded cache;
    ``meta`` (the cost trace) does too and gives the output's shape."""
    q, k, v = _inputs(2, 2, 2, 3, 16, torch.bfloat16)
    assert torch.equal(tattn.decode_attention(q, k, v, 30, window=7),
                       decode_attention_ref(q, k, v, 30, window=7))
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    out = tattn.decode_attention(mq, mk, mv, 30)
    assert out.device.type == "meta" and out.shape == q.shape


# (blocks, D, itemsize, slots): the decode cell (B 32, 36 kv heads of 64,
# bf16), DBRX's 8 kv heads of 128 at B 8, a small batch and an f32 cache
PLANS = [(32 * 36, 64, 2, 10 * 132), (8 * 8, 128, 2, 8 * 132),
         (2, 64, 2, 16 * 132), (3 * 2, 16, 4, 12 * 132)]


def _live_lengths(blocks, D, itemsize, slots, S=4096):
    """1, S, and one either side of and on a span boundary."""
    span = DK.split_plan(blocks, S, D, itemsize, slots)[0]
    return sorted({1, span - 1, span, span + 1, S} - {0})


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_split_plan_covers_the_live_range_exactly_once(plan):
    blocks, D, itemsize, slots = plan
    for lo in (0, 37):
        for n in _live_lengths(*plan):
            span, n_spans = DK.split_plan(blocks, n, D, itemsize, slots)
            assert span > 0 and span % DK.TILE == 0 and n_spans >= 1
            hits = np.zeros(lo + n + span, dtype=int)
            for i in range(n_spans):
                a, b = lo + i * span, lo + min((i + 1) * span, n)
                assert a < b, (n, span, n_spans)     # no empty span
                hits[a:b] += 1
            assert (hits[lo:lo + n] == 1).all() and hits.sum() == n
            # at least the floor of bytes a block, unless one span holds
            # the live range; one wave of resident blocks at most
            assert span * D * itemsize >= DK.MIN_SPAN_BYTES or n_spans == 1
            assert blocks * n_spans <= max(slots, blocks)


@pytest.mark.parametrize("G,gb", [(1, 1), (2, 2), (3, 4), (4, 4), (6, 8),
                                  (8, 8), (16, 8)])
def test_group_block_holds_the_group_in_powers_of_two(G, gb):
    assert DK.group_block(G) == gb


def test_wrappers_reject_cpu_tensors_before_building():
    q, k, v = _inputs(0, 1, 2, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.decode_scores(q, k, 0, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.decode_values(torch.zeros((1, 4, 4)), v, 0, torch.bfloat16)
