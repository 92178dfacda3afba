"""The port's int8 gradient compression (``distributed/compression.py``)
against the JAX package's, on the CPU.

- ``quantize``'s codes and scales bit-equal to the reference's, on
  random leaves of 300, 128 and 1 elements (padded to a block of 128),
  blocks of zeros and codes on exact halves (rounded half to even);
  ``dequantize`` likewise;
- ``cross_pod_grad_sync`` on 4 gloo ranks of a pod-only (4,) mesh equal
  to the reference's bit for bit, reduced gradients and new error
  feedback: with the same leaves on every pod, as the reference's
  ``shard_map`` (replicated inputs) gives them, and with each pod's own
  leaves, against the reference's ``compressed_psum_leaf`` under a
  ``shard_map`` over ``pod``;
- on a (2, 1, 2) (pod, data, model) mesh, where the reference's
  ``cross_pod_grad_sync`` raises (ROADMAP.md §3), the port's sync over
  each model column's two pods equal to the reference's leaf sum over a
  (2,) pod mesh of the same leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _meshref as MR  # noqa: E402
from _meshrun import launch  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402

from repro_torch.distributed import compression as C  # noqa: E402

SHAPES = {"a": (300,), "b": (2, 64), "c": (1,), "d": (3, 5, 7)}


def _leaf(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "zeros":
        x[...] = 0
    elif kind == "halves":
        # the block's max is 127 so the scale is ~1, and codes fall on .5
        x = (rng.integers(-100, 100, shape) + 0.5).astype(np.float32)
        x.reshape(-1)[0] = 127.0
    return x


@pytest.mark.parametrize("shape", [(300,), (128,), (1,), (3, 5, 7)])
@pytest.mark.parametrize("kind", ["normal", "zeros", "halves"])
def test_quantize_bit_equal_to_reference(shape, kind):
    x = _leaf(kind, shape, 7)
    q, s, n = C.quantize(torch.from_numpy(x))
    jq, js, jn = JC.quantize(jnp.asarray(x))
    assert n == jn == x.size
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = C.dequantize(q, s, n, shape).numpy()
    assert back.tobytes() == np.asarray(JC.dequantize(jq, js, jn,
                                                      shape)).tobytes()


def test_init_error_feedback_is_f32_zeros():
    err = C.init_error_feedback({"w": torch.ones(3, 4, dtype=torch.bfloat16),
                                 "b": [torch.ones(5)]})
    assert err["w"].dtype == torch.float32 and err["w"].shape == (3, 4)
    assert not err["w"].any() and not err["b"][0].any()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    ref, out = d / "ref", d / "port"
    ref.mkdir()
    out.mkdir()
    data = {}
    for i, (n, shape) in enumerate(sorted(SHAPES.items())):
        data[f"g/{n}"] = np.stack([_leaf("normal", shape, 100 * i + r)
                                   for r in range(4)])
        data[f"e/{n}"] = 1e-3 * np.stack([_leaf("normal", shape, 1000 + r)
                                          for r in range(4)])
    np.savez(out / "grads.npz", **data)
    MR.run("compression", str(out / "grads.npz"), str(ref), devices=4)
    launch(4, "compression", ref, out)
    return (np.load(ref / "compression.npz"),
            [np.load(out / f"compression_rank{r}.npz") for r in range(4)])


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_sync_of_the_same_leaves_matches_reference(runs, leaf):
    ref, ranks = runs
    for got in ranks:
        assert _bits(got[f"same_red/{leaf}"]) == _bits(ref[f"same_red/{leaf}"])
        assert _bits(got[f"same_err/{leaf}"]) == _bits(ref[f"same_err/{leaf}"])


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_sync_of_each_pods_leaves_matches_reference(runs, leaf):
    ref, ranks = runs
    for r, got in enumerate(ranks):
        assert _bits(got[f"each_red/{leaf}"]) == _bits(ref[f"each_red/{leaf}"][r])
        assert _bits(got[f"each_err/{leaf}"]) == _bits(ref[f"each_err/{leaf}"][r])


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_sync_on_pod_data_model_mesh(runs, leaf):
    """The reference cannot run this mesh; the port sums each model
    column's two pods, as the reference does on a (2,) pod mesh."""
    ref, ranks = runs
    assert "ValueError" in str(ref["raised"])
    assert "manual" in str(ref["raised"])
    for r, got in enumerate(ranks):
        assert _bits(got[f"pod_red/{leaf}"]) == _bits(ref[f"pod_red/{leaf}"][r])
        assert _bits(got[f"pod_err/{leaf}"]) == _bits(ref[f"pod_err/{leaf}"][r])
    # the two model columns reduce different leaves
    assert _bits(ranks[0][f"pod_red/{leaf}"]) != _bits(ranks[1][f"pod_red/{leaf}"])
