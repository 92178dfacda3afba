"""The port's model stack and serving engine against the JAX package's,
on the CPU.

For the reduced dense architectures (MiniCPM-2B; Qwen2-72B for GQA and
QKV bias; Nemotron-4-15B for the squared-ReLU MLP; Gemma3-27B for the
sliding window, its circular slot roll at L % W != 0, and the global
layers' RoPE theta) the JAX package's ``init_params`` builds the
weights, cast to f32 as ``tests/test_consistency.py`` does, and
``param.from_numpy`` carries them over.  The same numpy tokens then go
through both packages' ``prefill``, four ``decode_step``s and
``Engine.generate``.  In f32 the two differ only by summation order:
the measured gap is at most 3e-6 (logits of magnitude ~3), and the
bound, 1e-4, sits well under
``tests/test_consistency.py``'s TIGHT bound of 5e-3.  The other six
architectures have their own files (``tests/test_torch_{mrope,encdec,
moe,mamba,xlstm}.py``); here every architecture's parameter and cache
trees are held to the reference's, and so is a stack with fewer layers
than one pattern period (Gemma3-27B at 3 layers, period 6; Jamba at 5,
period 8), whose stacked unit leaves are empty.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param as JPM  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import extend_caches as jextend  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.serving.engine import Engine, extend_caches  # noqa: E402

import _modelpair as MP  # noqa: E402

DENSE = ["minicpm-2b", "qwen2-72b", "nemotron-4-15b", "gemma3-27b"]
ATOL = 1e-4
PROMPT, STEPS, BATCH = 12, 4, 2


def _f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.fixture(scope="module", params=DENSE)
def pair(request, smoke_mesh):
    """(arch, JAX cfg, port cfg, JAX f32 params, the port's copy)."""
    arch = request.param
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), cache_dtype="f32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), cache_dtype="f32")
    jparams = _f32(JM.init_params(jcfg, jax.random.key(0)))
    params = PM.from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jcfg, cfg, jparams, params


def _tokens(vocab, length, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, length), dtype=np.int32)


def _np(x):
    return np.asarray(x, np.float32)


def test_prefill_and_decode_logits_match(pair, smoke_mesh):
    arch, jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg.vocab_size, PROMPT + STEPS)
    shape = JShape("t", PROMPT + STEPS, BATCH, "decode")
    jctx = JM.build_ctx(jcfg, shape, smoke_mesh)
    ctx = M.build_ctx(cfg)
    with jax.set_mesh(smoke_mesh):
        jlg, jc = JM.prefill(jcfg, jctx, jparams,
                             {"tokens": jnp.asarray(toks[:, :PROMPT])})
        jc = jextend(jcfg, jc, PROMPT + STEPS)
    lg, c = M.prefill(cfg, ctx, params,
                      {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    assert lg.dtype == torch.float32 and tuple(lg.shape) == jlg.shape
    errs = [float(np.abs(lg.numpy() - _np(jlg)).max())]
    c = extend_caches(cfg, c, PROMPT + STEPS)
    for i in range(STEPS):
        pos = PROMPT + i
        with jax.set_mesh(smoke_mesh):
            jlg, jc = JM.decode_step(jcfg, jctx, jparams, jc,
                                     jnp.asarray(toks[:, pos:pos + 1]), pos)
        lg, c = M.decode_step(cfg, ctx, params, c,
                              torch.from_numpy(toks[:, pos:pos + 1]), pos)
        errs.append(float(np.abs(lg.numpy() - _np(jlg)).max()))
    assert max(errs) < ATOL, (arch, errs)
    # the caches the port carries equal the reference's, leaf by leaf
    jleaves = jax.tree.leaves(jc)
    leaves = [t for _, t in PM.tree_leaves_with_paths(c)]
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), _np(j), atol=ATOL, rtol=ATOL)


def test_generate_tokens_equal(pair, smoke_mesh):
    arch, jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg.vocab_size, 16, seed=2)
    jeng = JEngine(jcfg, JShape("serve", 24, BATCH, "decode"), smoke_mesh,
                   jparams)
    jout, _ = jeng.generate({"tokens": jnp.asarray(toks)}, max_new_tokens=8)
    eng = Engine(cfg, ShapeSpec("serve", 24, BATCH, "decode"), params,
                 device="cpu")
    out, caches = eng.generate({"tokens": torch.from_numpy(toks)},
                               max_new_tokens=8)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_tree_matches_reference(arch):
    """Every architecture: the same leaves, shapes and dtypes, and the
    same parameter count."""
    jspecs = JM.model_specs(JARCHS[arch])
    specs = M.model_specs(ARCHS[arch])
    assert PM.count_params(specs) == JPM.count_params(jspecs)
    jflat = jax.tree_util.tree_flatten_with_path(jspecs,
                                                 is_leaf=JPM.is_pspec)[0]
    flat = list(PM.tree_leaves_with_paths(specs))
    assert [p for p, _ in flat] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jflat]
    for (_, s), (_, j) in zip(flat, jflat):
        assert (s.shape, s.logical, s.init, s.scale, s.fan_in) == \
            (j.shape, j.logical, j.init, j.scale, j.fan_in)
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_cache_tree_matches_reference(arch):
    shape = ShapeSpec("serve", 40, 3, "decode")
    jtree = JM.cache_pspecs(JARCHS[arch], JShape("serve", 40, 3, "decode"))
    tree = M.cache_pspecs(ARCHS[arch], shape)
    jflat = jax.tree_util.tree_flatten(jtree, is_leaf=JPM.is_pspec)[0]
    flat = [s for _, s in PM.tree_leaves_with_paths(tree)]
    assert [(s.shape, s.logical, str(s.dtype).removeprefix("torch."))
            for s in flat] == \
        [(j.shape, j.logical, jnp.dtype(j.dtype).name) for j in jflat]
    small = M.init_cache(get_arch(arch).reduced(), shape, "cpu")
    specs = M.cache_pspecs(get_arch(arch).reduced(), shape)
    for (_, t), (_, s) in zip(PM.tree_leaves_with_paths(small),
                              PM.tree_leaves_with_paths(specs)):
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype
        assert not t.any()


@pytest.mark.parametrize("arch,n_layers", [("gemma3-27b", 3),
                                           ("jamba-1.5-large-398b", 5)])
def test_fewer_layers_than_one_period(arch, n_layers, smoke_mesh):
    """n_units == 0: every layer is in the rest, and the unit runs'
    prefill caches are the reference's (0, run_len, ...) leaves."""
    pair = MP.make_pair(arch, n_layers=n_layers)
    layout = M.layout_for(pair.cfg, M.block_pattern(pair.cfg))
    assert layout.n_units == 0 and layout.runs == layout.rest_runs
    errs, leaves, *_ = MP.path_errors(pair, smoke_mesh)
    assert max(e for e, _ in errs) < ATOL, errs
    assert any(t.shape[0] == 0 for t, _ in leaves)
    for t, j in leaves:
        np.testing.assert_allclose(t.numpy(), MP.np32(j), atol=ATOL,
                                   rtol=ATOL)
    out, jout = MP.generated(pair, smoke_mesh)
    np.testing.assert_array_equal(out, jout)


def test_initialize_is_seeded_and_shaped():
    cfg = get_arch("minicpm-2b").reduced()
    a = M.init_params(cfg, 3, "cpu")
    b = M.init_params(cfg, 3, "cpu")
    c = M.init_params(cfg, 4, "cpu")
    leaves = list(PM.tree_leaves_with_paths(a))
    specs = dict(PM.tree_leaves_with_paths(M.model_specs(cfg)))
    for (path, t), (_, u), (_, w) in zip(
            leaves, PM.tree_leaves_with_paths(b),
            PM.tree_leaves_with_paths(c)):
        assert tuple(t.shape) == specs[path].shape
        assert t.dtype == specs[path].dtype and t.device.type == "cpu"
        assert torch.equal(t, u)
        if specs[path].init == "normal":
            assert not torch.equal(t, w)
    # fan-in scaled: the stacked q projection (fan_in = d_model)
    wq = a["blocks"]["units"][0]["attn"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1


def test_from_numpy_carries_bf16_bits():
    x = jax.random.normal(jax.random.key(5), (3, 7)).astype(jnp.bfloat16)
    t = PM.from_numpy({"w": [np.asarray(x)]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_arch("minicpm-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, ShapeSpec("serve", 24, 2, "decode"), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "minicpm-2b"])


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "gemma3-27b: generated (2, 3) tokens" in out and "on cpu" in out
    serve.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                "--w8a16", "--batch", "2", "--prompt-len", "12",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "minicpm-2b: generated (2, 3) tokens" in out and "on cpu" in out
