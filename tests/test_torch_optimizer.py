"""The port's optimizer (``training/optimizer.py``) against the JAX
package's, on the CPU, on the same numpy inputs.

- ``quantize_blockwise`` bit-equal (codes and scales), with last dims
  that are and are not multiples of the 128-wide block, and
  ``dequantize_blockwise`` bit-equal on its output;
- ``lr_at`` within 1 ulp of the reference's (called eagerly, as the
  reference's own schedule test calls it) at every step of both
  schedules;
- ``adamw_update`` given the same gradients and state (the reference's,
  carried over by ``param.from_numpy``): parameters and moments within
  1e-6 of the reference at each of three steps, f32 and int8 moments
  (int8 codes equal but for +-1 where a value lands on a rounding tie);
- twins of ``tests/test_system.py``'s ``test_wsd_schedule_shape`` and
  ``test_int8_optimizer_state_tracks_f32``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.models import param as JPM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402

from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402

SHAPES = {"w": (300, 260), "blocks": {"norm": (64,), "ffn": (3, 40, 600)},
          "rest": [(5, 7)]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


def _ulps(a, b) -> int:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


def _specs(mk, tree=SHAPES):
    """``mk(shape)`` at every shape (a tuple) of SHAPES."""
    if isinstance(tree, dict):
        return {k: _specs(mk, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(mk, v) for v in tree]
    return mk(tree)


@pytest.mark.parametrize("shape", [(3, 300), (7, 128), (2, 5, 1000), (64,)])
def test_quantize_blockwise_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 10)).astype(
        np.float32)
    j = JO.quantize_blockwise(jnp.asarray(x))
    t = O.quantize_blockwise(torch.from_numpy(x))
    assert t["q"].dtype == torch.int8
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
    np.testing.assert_array_equal(
        O.dequantize_blockwise(t, shape[-1]).numpy(),
        np.asarray(JO.dequantize_blockwise(j, shape[-1])))


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
@pytest.mark.parametrize("total,warmup,stable", [(100, 10, 0.8),
                                                 (777, 33, 0.7)])
def test_lr_at_within_one_ulp(schedule, total, warmup, stable):
    oc = O.OptConfig(schedule=schedule, warmup_steps=warmup,
                     total_steps=total, stable_frac=stable)
    joc = JO.OptConfig(schedule=schedule, warmup_steps=warmup,
                       total_steps=total, stable_frac=stable)
    steps = range(total + 5)
    want = [float(JO.lr_at(joc, s)) for s in steps]
    got = [O.lr_at(oc, s) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    assert _ulps([g.item() for g in got], want) <= 1


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    rng = np.random.default_rng(7)
    params = _specs(lambda s: (rng.standard_normal(s) * 0.05)
                    .astype(np.float32))
    jspecs = _specs(lambda s: JPM.PSpec(s, (None,) * len(s), jnp.float32))
    tspecs = _specs(lambda s: PM.PSpec(s, (None,) * len(s), torch.float32))
    joc = JO.OptConfig(lr=1e-2, warmup_steps=2, state_dtype=state_dtype)
    oc = O.OptConfig(lr=1e-2, warmup_steps=2, state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JPM.initialize(JO.opt_pspecs(jspecs, state_dtype),
                         jax.random.key(1))
    assert [a.shape for a in PM.tree_leaves(O.init_opt_state(
        tspecs, state_dtype, "cpu"))] == [a.shape for a in
                                          jax.tree.leaves(jst)]
    for it in range(3):
        # each step from the reference's own state, so that a code
        # rounded the other way at a tie does not carry into the next
        tp = PM.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        tst = PM.from_numpy(jax.tree.map(np.asarray, jst), "cpu")
        # the first step's norm is over the clip, the others under it
        g = _specs(lambda s: (rng.standard_normal(s) * (3 if it == 0 else
                                                        1e-3))
                   .astype(np.float32))
        jp, jst, jm = JO.adamw_update(joc, jp, jax.tree.map(jnp.asarray, g),
                                      jst)
        tp2, tst2, tm = O.adamw_update(oc, tp, PM.from_numpy(g, "cpu"), tst)
        assert tp2 is tp and tst2 is tst            # updated in place
        assert _ulps(tm["lr"].item(), float(jm["lr"])) <= 1
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(PM.tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        for a, b in zip(PM.tree_leaves(tst), jax.tree.leaves(jst)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.int8:
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert int(tst["step"]) == 3


def test_wsd_schedule_shape():
    oc = O.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                     schedule="wsd", stable_frac=0.8)
    assert float(O.lr_at(oc, 0)) == 0.0
    assert abs(float(O.lr_at(oc, 10)) - 1.0) < 1e-6       # post-warmup peak
    assert abs(float(O.lr_at(oc, 50)) - 1.0) < 1e-6       # stable plateau
    assert float(O.lr_at(oc, 90)) < 0.5                    # decaying
    assert float(O.lr_at(oc, 100)) < 0.05


def test_int8_optimizer_state_tracks_f32():
    specs = {"w": PM.PSpec((512, 256), ("embed", "mlp"), torch.float32)}
    oc = O.OptConfig(lr=1e-2, weight_decay=0.0)
    out = {}
    for sd in ("f32", "int8"):
        params = PM.initialize(specs, 0, "cpu")
        g = PM.tree_map(lambda p: 0.01 * torch.ones_like(p), params)
        state = O.init_opt_state(specs, sd, "cpu")
        out[sd], _, _ = O.adamw_update(oc, params, g, state)
    assert isinstance(state["m"]["w"], dict)
    np.testing.assert_allclose(out["f32"]["w"].numpy(),
                               out["int8"]["w"].numpy(), atol=1e-4)


@pytest.mark.parametrize("scale", [3.0, 1e-3])
def test_clip_by_global_norm_matches_reference(scale):
    rng = np.random.default_rng(11)
    g = _specs(lambda s: (rng.standard_normal(s) * scale).astype(np.float32))
    jg, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = O.clip_by_global_norm(PM.from_numpy(g, "cpu"), 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for a, b in zip(PM.tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


def test_int8_moments_split_across_blocks_match_one_device(tmp_path):
    """int8 moments whose 128-blocks straddle the ranks that split their
    parameter's last dim (``_meshrun.INT8_SPLIT`` on 4 gloo ranks, (1, 4)):
    two updates leave each rank's parameters, codes and scales equal to
    its slices of the same updates on one device, bit for bit."""
    from types import SimpleNamespace

    import _meshrun as MRUN
    from repro_torch.distributed.mesh import local_slice

    MRUN.launch(4, "int8_split", tmp_path, tmp_path)
    specs, params, grads = MRUN.int8_split_state()
    opt = O.init_opt_state(specs, "int8", "cpu")
    oc = O.OptConfig(state_dtype="int8", warmup_steps=1)
    for g in grads:
        params, opt, _ = O.adamw_update(oc, params, g, opt)
    mesh = SimpleNamespace(shape=(1, 4), mesh_dim_names=("data", "model"))
    pshd = PM.shardings(specs, MRUN.INT8_SPLIT_RULES, mesh)
    mshd = PM.shardings(O.opt_pspecs(specs, "int8")["m"],
                        MRUN.INT8_SPLIT_RULES, mesh)
    assert [O._block_split(pshd[k], mshd[k], specs[k].shape[-1] // 4)
            is None for k in ("w", "r", "a")] == [False, False, True]
    for r in range(4):
        got = np.load(tmp_path / f"int8_split_rank{r}.npz")
        coord = tuple(got["coord"])

        def mine(t, spec):
            return t[local_slice(tuple(t.shape), spec, mesh, coord)].numpy()
        for k in specs:
            np.testing.assert_array_equal(got[f"p/{k}"],
                                          mine(params[k], pshd[k].spec))
            for m in ("m", "v"):
                for part in ("q", "scale"):
                    np.testing.assert_array_equal(
                        got[f"{m}/{k}/{part}"],
                        mine(opt[m][k][part], mshd[k][part].spec))
