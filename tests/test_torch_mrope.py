"""The port's M-RoPE (Qwen2-VL-2B) against the JAX package's, on the CPU.

``mrope_position_ids`` and ``apply_mrope`` (``models/attention.py``),
the per-position ids the blocks derive (``blocks._mrope_at``, prefill
and decode) and the ``vision_embeds`` splice in
``model._embed_decoder_input`` are held to the reference; then
Qwen2-VL-2B reduced (a 4-position vision prefix) through ``prefill``,
four ``decode_step``s and ``Engine.generate``.  The model calls
``apply_mrope`` with its default sections (1, 1, 1), as the reference
does; Qwen2-VL's own 16/24/24 is tested as a parameter.  In f32 the
packages differ by summation order only: measured at most 4e-6 on
logits of magnitude ~4; the bound is 1e-4, as for the dense archs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ATOL = 1e-4
ARCH = "qwen2-vl-2b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.fixture(scope="module")
def pair():
    return MP.make_pair(ARCH)


@pytest.mark.parametrize("seq_len,prefix,grid_w", [
    (12, 4, 32), (2048, 1024, 32), (40, 0, 32), (50, 24, 8)])
def test_position_ids_match_reference(seq_len, prefix, grid_w):
    got = attn.mrope_position_ids(seq_len, prefix, grid_w)
    want = np.asarray(jattn.mrope_position_ids(seq_len, prefix, grid_w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections", [(1, 1, 1), (16, 24, 24), (3, 1)])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(sections, head_dim):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 3, 40, head_dim), dtype=np.float32)
    pos3 = np.array(jattn.mrope_position_ids(40, 24, 8))
    got = attn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                           sections)
    want = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                             sections)
    assert got.dtype == torch.float32 and MP.max_err(got, want) < 1e-5


def test_block_position_ids_match_reference(pair):
    """Prefill positions 0..L-1 and one decode position, through the
    blocks' own derivation of the three streams."""
    for positions in (np.arange(12), np.array([9]), np.array([2])):
        got = blocks._mrope_at(pair.cfg, torch.from_numpy(positions))
        want = jax.vmap(lambda i: jblocks._mrope_at(pair.jcfg, i),
                        out_axes=1)(jnp.asarray(positions))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vision_embeds_splice_the_prefix(pair, smoke_mesh):
    jb, tb = MP.batches(pair.cfg, 12)
    jctx = JM.build_ctx(pair.jcfg, MP.JShape("t", 12, 2, "train"),
                        smoke_mesh)
    with jax.set_mesh(smoke_mesh):
        want = JM._embed_decoder_input(pair.jcfg, jctx, pair.jparams,
                                       jb["tokens"],
                                       vision_embeds=jb["vision_embeds"])
    got = M._embed_decoder_input(pair.cfg, M.build_ctx(pair.cfg),
                                 pair.params, tb["tokens"],
                                 vision_embeds=tb["vision_embeds"])
    P = pair.cfg.vision_prefix
    assert torch.equal(got[:, :P], tb["vision_embeds"])
    assert MP.max_err(got, want) == 0.0


def test_prefill_and_decode_logits_match(pair, smoke_mesh):
    errs, leaves, *_ = MP.path_errors(pair, smoke_mesh)
    assert max(e for e, _ in errs) < ATOL, errs
    for t, j in leaves:
        np.testing.assert_allclose(t.numpy(), MP.np32(j), atol=ATOL,
                                   rtol=ATOL)


def test_generate_tokens_equal(pair, smoke_mesh):
    out, jout = MP.generated(pair, smoke_mesh)
    np.testing.assert_array_equal(out, jout)
