"""The port's model inputs (``models/io.py``) against the JAX package's,
on the CPU: the input specs of every architecture at a train, prefill
and decode shape (Whisper's ``frames`` (B, S//2, d_model) beside its
tokens, Qwen2-VL's ``vision_embeds`` (B, vision_prefix, d_model)), the
shape-only stand-ins, and the synthetic batch.  The port draws with
numpy from (seed, crc32(name)), the reference from a JAX key: the draws
are not expected to be equal, so the family tests hand the port's
arrays to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import io as jio  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import io  # noqa: E402

KINDS = ("train", "prefill", "decode")


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_batch_pspecs_match_reference(arch):
    for kind in KINDS:
        got = io.batch_pspecs(ARCHS[arch], ShapeSpec("s", 64, 4, kind))
        want = jio.batch_pspecs(JARCHS[arch], JShape("s", 64, 4, kind))
        assert list(got) == list(want), (arch, kind)
        for name in got:
            g, w = got[name], want[name]
            assert (g.shape, g.logical, g.init, _dtype(g.dtype)) == \
                (w.shape, w.logical, w.init, _dtype(w.dtype)), (arch, name)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b",
                                  "minicpm-2b"])
def test_input_specs_are_shapes_without_data(arch):
    for kind in KINDS:
        got = io.input_specs(ARCHS[arch], ShapeSpec("s", 64, 4, kind))
        want = jio.input_specs(JARCHS[arch], JShape("s", 64, 4, kind))
        assert {k: (tuple(t.shape), _dtype(t.dtype), t.device.type)
                for k, t in got.items()} == \
            {k: (s.shape, _dtype(s.dtype), "meta") for k, s in want.items()}


def test_modality_inputs_have_their_shapes():
    whisper = io.batch_pspecs(ARCHS["whisper-medium"],
                              ShapeSpec("s", 3000, 8, "prefill"))
    assert whisper["frames"].shape == (8, 1500, 1024)
    assert whisper["tokens"].shape == (8, 1500)
    vlm = io.batch_pspecs(ARCHS["qwen2-vl-2b"],
                          ShapeSpec("s", 2048, 8, "prefill"))
    assert vlm["vision_embeds"].shape == (8, 1024, 1536)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b",
                                  "xlstm-1.3b"])
def test_synthetic_batch_is_seeded_and_in_range(arch):
    cfg = get_arch(arch).reduced()
    shape = ShapeSpec("s", 16, 3, "train")
    a = io.synthetic_batch(cfg, shape, 5, "cpu")
    b = io.synthetic_batch(cfg, shape, 5, "cpu")
    c = io.synthetic_batch(cfg, shape, 6, "cpu")
    specs = io.batch_pspecs(cfg, shape)
    assert list(a) == list(specs)
    for name, t in a.items():
        assert tuple(t.shape) == specs[name].shape
        assert t.dtype == specs[name].dtype and t.device.type == "cpu"
        assert torch.equal(t, b[name]) and not torch.equal(t, c[name])
    toks = a["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    for name in a:
        if a[name].is_floating_point():
            x = a[name].float()
            assert abs(float(x.mean())) < 0.2 and 0.8 < float(x.std()) < 1.2
    # each input draws from (seed, its name) alone: a decoder-only shape
    # of the same size draws the same tokens
    plain = io.synthetic_batch(get_arch("minicpm-2b").reduced(),
                               ShapeSpec("s", toks.shape[1], 3, "train"),
                               5, "cpu")
    assert torch.equal(plain["tokens"], toks)


def test_synthetic_decode_batch():
    cfg = get_arch("minicpm-2b").reduced()
    b = io.synthetic_batch(cfg, ShapeSpec("s", 16, 3, "decode"), 0, "cpu")
    assert tuple(b["token"].shape) == (3, 1) and b["pos"].shape == ()
    assert int(b["pos"]) == 0
    np.testing.assert_array_equal(
        b["token"].numpy(), io.synthetic_batch(
            cfg, ShapeSpec("s", 16, 3, "decode"), 0, "cpu")["token"].numpy())


def test_synthetic_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        io.synthetic_batch(get_arch("minicpm-2b").reduced(),
                           ShapeSpec("s", 16, 2, "train"))
