"""The port's W8A16 weight quantization against the JAX package's, on
the CPU: ``q`` and ``s`` bit-equal on a reduced MiniCPM-2B tree, the
dequantized weights bit-equal, the quantized model's logits within the
f32 bound of ``tests/test_torch_model.py`` and its greedy tokens equal,
and ``launch/serve.py --w8a16`` printing the JAX launcher's tokens."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param as JPM  # noqa: E402
from repro.serving import wquant as JW  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.serving import wquant as W  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    cfg = jget_arch("minicpm-2b").reduced()
    jp = JM.init_params(cfg, jax.random.key(0))
    return jp, PM.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _flat(tree):
    return list(PM.tree_leaves_with_paths(tree))


def _jflat(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("min_size", [1024, JW.MIN_QUANT_SIZE])
def test_quantize_tree_bit_equal(trees, min_size):
    jp, tp = trees
    jq, tq = JW.quantize_tree(jp, min_size=min_size), \
        W.quantize_tree(tp, min_size=min_size)
    jl, tl = _jflat(jq), _flat(tq)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=path)
    n_q = sum(p.endswith("/q") for p, _ in tl)
    assert n_q == (8 if min_size == 1024 else 0)
    jd, td = JW.dequant_tree(jq), W.dequant_tree(tq)
    for (path, t), (_, j) in zip(_flat(td), _jflat(jd)):
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=path)


def test_quant_pspecs_match_reference():
    cfg = jget_arch("minicpm-2b")
    jspecs = JW.quant_pspecs(JM.model_specs(cfg))
    specs = W.quant_pspecs(M.model_specs(get_arch("minicpm-2b")))
    jflat = jax.tree_util.tree_flatten_with_path(jspecs,
                                                 is_leaf=JPM.is_pspec)[0]
    flat = _flat(specs)
    assert len(flat) == len(jflat)
    for (_, s), (_, j) in zip(flat, jflat):
        assert (s.shape, s.logical, s.init) == (j.shape, j.logical, j.init)
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
    assert any(s.dtype == torch.int8 for _, s in flat)


def test_w8a16_logits_and_tokens_match_reference(trees, smoke_mesh):
    """Quantized weights dequantized to f32 in both packages: prefill
    logits within ATOL, greedy tokens equal; and quantization moved the
    logits (the int8 rounding is there)."""
    jp, tp = trees
    jcfg = dataclasses.replace(jget_arch("minicpm-2b").reduced(),
                               cache_dtype="f32")
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                              cache_dtype="f32")
    jq = JW.dequant_tree(JW.quantize_tree(jp, min_size=1024), jnp.float32)
    tq = W.dequant_tree(W.quantize_tree(tp, min_size=1024), torch.float32)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jctx = JM.build_ctx(jcfg, JShape("t", 16, 2, "decode"), smoke_mesh)
    with jax.set_mesh(smoke_mesh):
        jlg, _ = JM.prefill(jcfg, jctx, jq, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks)}
    lg, _ = M.prefill(cfg, M.build_ctx(cfg), tq, batch)
    assert float(np.abs(lg.numpy() - np.asarray(jlg, np.float32)).max()) \
        < ATOL
    full = PM.tree_map(lambda t: t.float(), tp)
    lg_full, _ = M.prefill(cfg, M.build_ctx(cfg), full, batch)
    assert float((lg - lg_full).abs().max()) > 10 * ATOL
    jeng = JEngine(jcfg, JShape("serve", 24, 2, "decode"), smoke_mesh, jq)
    eng = Engine(cfg, ShapeSpec("serve", 24, 2, "decode"), tq, device="cpu")
    jout, _ = jeng.generate({"tokens": jnp.asarray(toks)}, max_new_tokens=8)
    out, _ = eng.generate({"tokens": torch.from_numpy(toks)},
                          max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _rows(fn, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return [ln.strip() for ln in buf.getvalue().splitlines()
            if ln.strip().startswith("[")]


def test_launcher_w8a16_tokens_equal_reference(monkeypatch, smoke_mesh):
    """``launch/serve.py --smoke --w8a16 --device cpu`` on the JAX
    launcher's weights (its ``init_params`` at key 0, carried over)
    prints the JAX launcher's greedy tokens."""
    monkeypatch.setattr(M, "init_params", lambda cfg, seed, device:
                        PM.from_numpy(jax.tree.map(np.asarray, JM.init_params(
                            cfg, jax.random.key(seed))), device))
    argv = ["--arch", "minicpm-2b", "--smoke", "--w8a16", "--batch", "2",
            "--prompt-len", "16", "--max-new", "8"]
    got = _rows(serve.main, argv + ["--device", "cpu"])
    assert len(got) == 2 and got == _rows(jserve.main, argv)
