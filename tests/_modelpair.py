"""The port's model stack beside the JAX package's, on the CPU: what the
family tests (``tests/test_torch_{io,mrope,encdec,moe,mamba,xlstm}.py``)
and ``tests/test_torch_model.py`` share.

A ``Pair`` holds one reduced architecture in both packages, in f32
(``cache_dtype="f32"``, the JAX ``init_params`` cast to f32 as
``tests/test_consistency.py`` does) with the port's weights carried
over by ``param.from_numpy``.  Inputs come from the port's
``io.synthetic_batch`` on the CPU, cast to f32, and go to both packages
as the same numpy arrays.  ``path_errors`` runs ``prefill``, the cache
extension and four ``decode_step``s through both; ``generated`` runs
``Engine.generate`` through both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeSpec as JShape
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import extend_caches as jextend

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import io
from repro_torch.models import model as M
from repro_torch.models import param as PM
from repro_torch.serving.engine import Engine, extend_caches

BATCH, STEPS = 2, 4


@dataclass
class Pair:
    arch: str
    jcfg: Any
    cfg: Any
    jparams: Any
    params: Any


def one_torch_thread():
    """Generator for a module fixture: torch on one intra-op thread while
    the module runs.  Beside JAX's own thread pool, torch's pool makes
    the tiny CPU ops here tens of times slower; the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def f32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def make_pair(arch: str, **overrides) -> Pair:
    """``arch`` reduced, with ``overrides`` on both packages' configs."""
    kw = dict(cache_dtype="f32", **overrides)
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
    jparams = f32(jax.jit(lambda k: JM.init_params(jcfg, k))(
        jax.random.key(0)))
    params = PM.from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return Pair(arch, jcfg, cfg, jparams, params)


def batches(cfg, length: int, seed: int = 1):
    """(JAX batch, port batch): the port's synthetic batch for a
    ``length``-position shape, in f32, as the same numpy arrays."""
    tb = io.synthetic_batch(cfg, ShapeSpec("t", length, BATCH, "train"),
                            seed, "cpu")
    tb = {k: v.float() if v.is_floating_point() else v for k, v in tb.items()}
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


def np32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def max_err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np32(a)
    return float(np.abs(a - np32(b)).max()) if a.size else 0.0


def relnorm(a, b) -> float:
    a, b = np32(a.detach().numpy()), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def cache_leaves(pair: Pair, caches, jcaches):
    """The two cache trees' leaves, in one order, shapes checked equal."""
    jl = jax.tree.leaves(jcaches)
    tl = [t for _, t in PM.tree_leaves_with_paths(caches)]
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl], pair.arch
    return list(zip(tl, jl))


def path_errors(pair: Pair, mesh, length: int = 16):
    """Prefill over all but the last STEPS tokens of a synthetic batch,
    the caches extended to the full length, then STEPS decode steps fed
    the batch's own tokens, through both packages.  Returns (the
    per-call (max abs, relnorm) of the logits, the final cache leaf
    pairs, the port's logits, the JAX logits) — the last two of the
    prefill."""
    jb, tb = batches(pair.cfg, length)
    toks = tb["tokens"]
    S = toks.shape[1]
    pre = S - STEPS
    jcfg, cfg = pair.jcfg, pair.cfg
    jctx = JM.build_ctx(jcfg, JShape("t", S, BATCH, "decode"), mesh)
    ctx = M.build_ctx(cfg)
    with jax.set_mesh(mesh):
        jpre = jax.jit(lambda p, b: JM.prefill(jcfg, jctx, p, b))
        jdec = jax.jit(lambda p, c, t, pos: JM.decode_step(
            jcfg, jctx, p, c, t, pos))
        jlg, jc = jpre(pair.jparams, dict(jb, tokens=jb["tokens"][:, :pre]))
        jc = jextend(jcfg, jc, S)
    lg, c = M.prefill(cfg, ctx, pair.params, dict(tb, tokens=toks[:, :pre]))
    assert lg.dtype == torch.float32 and tuple(lg.shape) == jlg.shape
    first = (lg, jlg)
    errs = [(max_err(lg, jlg), relnorm(lg, jlg))]
    c = extend_caches(cfg, c, S)
    for i in range(STEPS):
        pos = pre + i
        with jax.set_mesh(mesh):
            jlg, jc = jdec(pair.jparams, jc, jb["tokens"][:, pos:pos + 1],
                           pos)
        lg, c = M.decode_step(cfg, ctx, pair.params, c,
                              toks[:, pos:pos + 1], pos)
        errs.append((max_err(lg, jlg), relnorm(lg, jlg)))
    return errs, cache_leaves(pair, c, jc), *first


def generated(pair: Pair, mesh, length: int = 16, new: int = 8):
    """Greedy tokens of ``Engine.generate`` (JAX, port) on one batch."""
    jb, tb = batches(pair.cfg, length, seed=2)
    S = tb["tokens"].shape[1] + new
    jeng = JEngine(pair.jcfg, JShape("serve", S, BATCH, "decode"), mesh,
                   pair.jparams)
    jout, _ = jeng.generate(jb, max_new_tokens=new)
    eng = Engine(pair.cfg, ShapeSpec("serve", S, BATCH, "decode"),
                 pair.params, device="cpu")
    out, _ = eng.generate({k: v.numpy() for k, v in tb.items()},
                          max_new_tokens=new)
    assert out.dtype == torch.int32 and tuple(out.shape) == (BATCH, new)
    return out.numpy(), np.asarray(jout)
