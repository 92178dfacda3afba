"""The port's Mamba mixer (``models/mamba.py``) against the JAX
package's, on the CPU, and Jamba end to end.

``mamba_forward`` is held to the reference on the same weights and
input (Jamba-1.5-Large reduced: d_inner 128, d_state 8, d_conv 4): a
prefill of one chunk and of several (a chunk of 4 over 12 positions),
its carried (conv tail, ssm) state, then single-step decodes carrying
it.  Then Jamba reduced (8 layers: Mamba and attention mixers, MoE and
dense FFNs) through ``prefill``, four ``decode_step``s and
``Engine.generate``.  In f32 the two packages differ by summation order
only: measured at most 2e-5 on logits of magnitude ~3; the bound is
1e-4, as for the dense archs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402

from repro_torch.models import mamba  # noqa: E402

ATOL = 1e-4
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.fixture(scope="module")
def pair():
    return MP.make_pair(ARCH)


def _layer(pair):
    """The first Mamba layer's weights in both packages."""
    run = pair.params["blocks"]["units"][0]["mamba"]
    jrun = pair.jparams["blocks"]["units"][0]["mamba"]
    return ({k: v[0, 0] for k, v in run.items()},
            {k: v[0, 0] for k, v in jrun.items()})


@pytest.mark.parametrize("length,chunk", [(12, 64), (12, 4), (1, 64)])
def test_mamba_forward_matches_reference(pair, length, chunk):
    p, jp = _layer(pair)
    cfg, jcfg = pair.cfg, pair.jcfg
    x = np.random.default_rng(length + chunk).standard_normal(
        (2, length + 3, cfg.d_model), dtype=np.float32)
    fwd = jax.jit(lambda x_, st: jmamba.mamba_forward(x_, jp, jcfg,
                                                      chunk=chunk, state=st))
    jy, jst = fwd(jnp.asarray(x[:, :length]), None)
    y, st = mamba.mamba_forward(torch.from_numpy(x[:, :length]), p, cfg,
                                chunk=chunk)
    assert MP.max_err(y, jy) < ATOL
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == jst[k].shape
        assert MP.max_err(st[k], jst[k]) < ATOL, k
    # decode: one position at a time, carrying the state
    for t in range(length, length + 3):
        jy, jst = fwd(jnp.asarray(x[:, t:t + 1]), jst)
        y, st = mamba.mamba_forward(torch.from_numpy(x[:, t:t + 1]), p, cfg,
                                    state=st)
        assert MP.max_err(y, jy) < ATOL
        assert MP.max_err(st["ssm"], jst["ssm"]) < ATOL


def test_mamba_forward_rejects_a_ragged_length(pair):
    p, _ = _layer(pair)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba.mamba_forward(torch.zeros((1, 12, pair.cfg.d_model)), p,
                            pair.cfg, chunk=8)


def test_state_shapes_match_reference(pair):
    for batch in (1, 3):
        got = mamba.mamba_state_shapes(pair.cfg, batch)
        want = jmamba.mamba_state_shapes(pair.jcfg, batch)
        assert {k: (s, str(d).removeprefix("torch."))
                for k, (s, d) in got.items()} == \
            {k: (s, jnp.dtype(d).name) for k, (s, d) in want.items()}


def test_prefill_and_decode_logits_match(pair, smoke_mesh):
    errs, leaves, *_ = MP.path_errors(pair, smoke_mesh)
    assert max(e for e, _ in errs) < ATOL, errs
    for t, j in leaves:
        np.testing.assert_allclose(t.numpy(), MP.np32(j), atol=ATOL,
                                   rtol=ATOL)


def test_generate_tokens_equal(pair, smoke_mesh):
    out, jout = MP.generated(pair, smoke_mesh)
    np.testing.assert_array_equal(out, jout)
