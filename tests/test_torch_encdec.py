"""The port's encoder-decoder (Whisper-medium) against the JAX
package's, on the CPU.

The sinusoidal positions (``layers.sinusoidal_positions``,
``sinusoid_at``), the encoder over the stubbed ``frames``
(``model._run_encoder``: non-causal ``enc_attn`` blocks, then the final
LayerNorm) and the cross-attention block (``dec_attn``: self-attention,
then attention over the encoder output, whose ``ck``/``cv`` caches are
projected at prefill and read at every decode step) are held to the
reference; then Whisper reduced (2 + 2 layers) through ``prefill``,
four ``decode_step``s and ``Engine.generate``.

The reference's ``block_pattern`` names every decoder layer of Whisper
``attn/dense``: no layer is ``dec_attn``, so its decoder never reads
the encoder output (ROADMAP.md §3).  The port reproduces that; the
cross-attention block is tested on its own.  In f32 the packages
differ by summation order only: measured at most 1.4e-6 on logits of
magnitude ~3; the bound is 1e-4, as for the dense archs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param as JPM  # noqa: E402

from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402

ATOL = 1e-4
ARCH = "whisper-medium"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.fixture(scope="module")
def pair():
    return MP.make_pair(ARCH)


@pytest.mark.parametrize("length,d_model,offset", [
    (8, 64, 0), (5, 64, 12), (300, 1024, 0), (4, 10, 3)])
def test_sinusoids_match_reference(length, d_model, offset):
    """The angles pos * inv_freq differ by an f32 ulp of the largest
    angle (exp rounds differently in the two libraries), so the bound
    grows with the position: 4 ulps of it."""
    tol = 4 * np.finfo(np.float32).eps * max(1, offset + length)
    got = L.sinusoidal_positions(length, d_model, offset)
    want = JL.sinusoidal_positions(length, d_model, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert MP.max_err(got, want) < tol
    for pos in (offset, offset + length - 1):
        assert MP.max_err(L.sinusoid_at(pos, d_model),
                          JL.sinusoid_at(pos, d_model)) < tol
        assert MP.max_err(L.sinusoid_at(pos, d_model),
                          got[pos - offset]) == 0.0


def test_encoder_output_matches_reference(pair, smoke_mesh):
    jb, tb = MP.batches(pair.cfg, 16)
    jctx = JM.build_ctx(pair.jcfg, MP.JShape("t", 16, 2, "train"),
                        smoke_mesh)
    with jax.set_mesh(smoke_mesh):
        want = jax.jit(lambda p, f: JM._run_encoder(pair.jcfg, jctx, p, f))(
            pair.jparams, jb["frames"])
    got = M._run_encoder(pair.cfg, M.build_ctx(pair.cfg), pair.params,
                         tb["frames"])
    assert tuple(got.shape) == want.shape == (2, 8, pair.cfg.d_model)
    assert MP.max_err(got, want) < ATOL


def test_decoder_layers_are_self_attention(pair):
    """As in the reference: every decoder layer is attn/dense, and the
    decode caches hold no cross-attention leaves."""
    assert blocks.block_pattern(pair.cfg) == \
        jblocks.block_pattern(pair.jcfg) == ["attn/dense"] * 2
    assert blocks.enc_pattern(pair.cfg) == ["enc_attn/dense"] * 2
    tree = M.cache_pspecs(pair.cfg, MP.ShapeSpec("s", 40, 3, "decode"))
    assert {k for run in tree["units"] for k in run} == {"k", "v"}


@pytest.mark.parametrize("enc_len", [8, 5])
def test_cross_attention_block_matches_reference(pair, smoke_mesh, enc_len):
    """A dec_attn block alone: prefill over 6 positions with the encoder
    output, caches (k, v and the cross ck, cv at the encoder's length,
    as ``block_cache_shapes`` gives them), then three decode steps with
    k, v extended to 9 positions."""
    kind, Lq, S = "dec_attn/dense", 6, 9
    jcfg, cfg = pair.jcfg, pair.cfg
    jp = MP.f32(JPM.initialize(jblocks.block_specs(jcfg, kind),
                               jax.random.key(3)))
    p = PM.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert {"ln_x", "xattn"} <= set(p)
    rng = np.random.default_rng(enc_len)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, enc_len, cfg.d_model), dtype=np.float32)
    jctx = JM.build_ctx(jcfg, MP.JShape("t", S, 2, "decode"), smoke_mesh)
    ctx = M.build_ctx(cfg)

    def jblock(x_, c, pos, mode):
        return jblocks.apply_block(jcfg, jctx, kind, jp, x_, mode=mode,
                                   cache=c, pos=pos, enc_out=jnp.asarray(enc))

    with jax.set_mesh(smoke_mesh):
        jy, jc, _ = jblock(jnp.asarray(x[:, :Lq]), None, 0, "prefill")
    y, c, aux = blocks.apply_block(cfg, ctx, kind, p,
                                   torch.from_numpy(x[:, :Lq]),
                                   mode="prefill", enc_out=torch.from_numpy(enc))
    assert float(aux) == 0.0 and MP.max_err(y, jy) < ATOL
    shapes = blocks.block_cache_shapes(cfg, kind, 2, S, enc_len)
    assert tuple(c["ck"].shape) == shapes["ck"][0] == jc["ck"].shape
    for k in ("k", "v", "ck", "cv"):
        assert MP.max_err(c[k], jc[k]) < ATOL, k
    pad = ((0, 0), (0, 0), (0, S - Lq), (0, 0))
    jc = dict(jc, k=jnp.pad(jc["k"], pad), v=jnp.pad(jc["v"], pad))
    c = dict(c, k=torch.nn.functional.pad(c["k"], (0, 0, 0, S - Lq)),
             v=torch.nn.functional.pad(c["v"], (0, 0, 0, S - Lq)))
    for pos in range(Lq, S):
        with jax.set_mesh(smoke_mesh):
            jy, jc, _ = jblock(jnp.asarray(x[:, pos:pos + 1]), jc, pos,
                               "decode")
        y, c, _ = blocks.apply_block(cfg, ctx, kind, p,
                                     torch.from_numpy(x[:, pos:pos + 1]),
                                     mode="decode", cache=c, pos=pos)
        assert MP.max_err(y, jy) < ATOL, pos
    for k in ("k", "v", "ck", "cv"):
        assert MP.max_err(c[k], jc[k]) < ATOL, k


def test_prefill_and_decode_logits_match(pair, smoke_mesh):
    errs, leaves, lg, _ = MP.path_errors(pair, smoke_mesh, length=24)
    assert lg.shape == (2, pair.cfg.padded_vocab)
    assert max(e for e, _ in errs) < ATOL, errs
    for t, j in leaves:
        np.testing.assert_allclose(t.numpy(), MP.np32(j), atol=ATOL,
                                   rtol=ATOL)


def test_generate_tokens_equal(pair, smoke_mesh):
    out, jout = MP.generated(pair, smoke_mesh)
    np.testing.assert_array_equal(out, jout)
