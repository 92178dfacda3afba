"""The port's Mixture-of-Experts FFN (``models/moe.py``) against the JAX
package's, on the CPU, and the MoE architectures end to end.

``moe_block`` is held to the reference's ``shard_map`` body on the
smoke mesh (every axis of size 1), output and aux loss, for DBRX-132B
(top-4 of 16 experts, reduced to top-2 of 4) and Grok-1-314B (top-2 of
8, reduced to 2 of 4); with the reduced configs' capacity factor 8.0,
which drops nothing, and with 1.0, which drops assignments; and with
non-gated experts (the reference's SiLU branch).  Then both MoE archs
through ``prefill``, four ``decode_step``s and ``Engine.generate``.  In
f32 the two packages differ by summation order only: measured at most
4e-6 on logits of magnitude ~3.5; the bound is 1e-4, as for the dense
archs (``tests/test_torch_model.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.models import moe  # noqa: E402

ATOL = 1e-4
MOE = ["dbrx-132b", "grok-1-314b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return MP.make_pair(request.param)


def _moe_both(pair, mesh, capacity_factor, mlp_type=None):
    """One layer's moe_block through both packages on the same input;
    returns (out, aux, JAX out, JAX aux, kept assignments)."""
    over = {"capacity_factor": capacity_factor}
    if mlp_type:
        over["mlp_type"] = mlp_type
    jcfg = dataclasses.replace(pair.jcfg, **over)
    cfg = dataclasses.replace(pair.cfg, **over)
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, D), dtype=np.float32)
    w = {"router": rng.standard_normal((D, E), dtype=np.float32) / D ** .5}
    for n in moe._wnames(cfg):
        shp = (E, F_, D) if n == "wo" else (E, D, F_)
        w[n] = rng.standard_normal(shp, dtype=np.float32) / shp[1] ** .5
    jctx = JM.build_ctx(jcfg, JShape("t", 24, 2, "train"), mesh)
    with jax.set_mesh(mesh):
        jout, jaux = jax.jit(lambda x_, w_: jmoe.moe_block(
            x_, w_, jcfg, mesh, rules=jctx.rules, data_axes=jctx.data_axes,
            batch_sharded=jctx.batch_sharded))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    out, aux = moe.moe_block(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in w.items()},
                             cfg)
    # what the capacity keeps: each expert's first cap assignments
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, D)
                          @ torch.from_numpy(w["router"]), -1)
    counts = torch.bincount(torch.topk(probs, cfg.top_k)[1].reshape(-1),
                            minlength=E)
    cap = int(capacity_factor * 48 * cfg.top_k / E) + 1
    return out, aux, jout, jaux, int(counts.clamp(max=cap).sum())


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_block_matches_reference(pair, smoke_mesh, capacity_factor):
    out, aux, jout, jaux, kept = _moe_both(pair, smoke_mesh, capacity_factor)
    assert out.dtype == torch.float32 and tuple(out.shape) == jout.shape
    assert MP.max_err(out, jout) < ATOL
    assert abs(float(aux) - float(jaux)) < 1e-5
    total = 48 * pair.cfg.top_k
    if capacity_factor == 1.0:
        assert kept < total           # the capacity drops assignments
    else:
        assert kept == total


def test_moe_block_non_gated_experts(pair, smoke_mesh):
    out, aux, jout, jaux, _ = _moe_both(pair, smoke_mesh, 1.0, "gelu")
    assert MP.max_err(out, jout) < ATOL
    assert abs(float(aux) - float(jaux)) < 1e-5


def test_moe_block_keeps_bf16(pair):
    cfg = pair.cfg
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    p = {k: v.to(torch.bfloat16) for k, v in
         pair.params["blocks"]["units"][0]["moe"].items()}
    p = {k: v[0, 0] for k, v in p.items()}
    out, aux = moe.moe_block(x, p, cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(aux) > 0


def test_prefill_and_decode_logits_match(pair, smoke_mesh):
    errs, leaves, *_ = MP.path_errors(pair, smoke_mesh)
    assert max(e for e, _ in errs) < ATOL, (pair.arch, errs)
    for t, j in leaves:
        np.testing.assert_allclose(t.numpy(), MP.np32(j), atol=ATOL,
                                   rtol=ATOL)


def test_generate_tokens_equal(pair, smoke_mesh):
    out, jout = MP.generated(pair, smoke_mesh)
    np.testing.assert_array_equal(out, jout)
