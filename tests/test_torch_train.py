"""The port's training loss and its gradient pieces against the JAX
package, on the CPU, in f32.

- ``model.loss_fn`` for all ten reduced architectures on the same
  weights and batch: within 1e-5 of the reference (xent and aux too),
  and its backward runs through every mixer (attention, MoE, Mamba,
  mLSTM, sLSTM, the encoder) under the unit checkpoints;
- ``attention_bwd_ref`` (the flash kernel's autograd Function's
  backward on ``meta`` tensors) against autograd of ``attention_ref``
  on ``_flashcases.BWD_CASES``: causal, windowed,
  GQA, offsets (rows that see no key included) and a query length that
  is not a multiple of the block, within 1e-5;
- the Mamba and xLSTM mixers under grad: their recurrent state is
  updated out of place where autograd records, so the backward does
  not raise, and in place where it does not (decode's cache slot).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _modelpair as MP  # noqa: E402
from _flashcases import BWD_CASES  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_ref,
)
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

LOSS_TOL = 1e-5
SEQ = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_fn_matches_reference(arch, smoke_mesh):
    pair = MP.make_pair(arch)
    jb, tb = MP.batches(pair.cfg, SEQ)
    jctx = JM.build_ctx(pair.jcfg, JShape("t", SEQ, MP.BATCH, "train"),
                        smoke_mesh)
    with jax.set_mesh(smoke_mesh):
        jloss, jm = jax.jit(lambda p, b: JM.loss_fn(pair.jcfg, jctx, p, b))(
            pair.jparams, jb)
    params = PM.trainable(pair.params)
    loss, m = M.loss_fn(pair.cfg, M.build_ctx(pair.cfg), params, tb)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) < LOSS_TOL
    for k in ("xent", "aux"):
        assert abs(m[k].item() - float(jm[k])) < LOSS_TOL
    loss.backward()
    # a leaf the loss does not read has no grad: Whisper's encoder, which
    # no decoder layer attends to (ROADMAP.md §3)
    grads = [p.grad for p in PM.tree_leaves(params) if p.grad is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(g.abs().sum() > 0 for g in grads) > len(grads) // 2


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_attention_bwd_ref_matches_autograd(case):
    B, Hq, Hkv, Lq, Lkv, D, causal, window, qo, ko = case
    gen = torch.Generator().manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=gen) for shape in (
        (B, Hq, Lq, D), (B, Hkv, Lkv, D), (B, Hkv, Lkv, D)))
    do = torch.randn((B, Hq, Lq, D), generator=gen)
    kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    got = attention_bwd_ref(q, k, v, do, block=64, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g - w).abs().max().item() < 1e-5


@pytest.fixture(scope="module")
def mixers():
    """One Jamba Mamba layer's and one xLSTM mLSTM and sLSTM layer's
    weights (reduced, f32, the port's own init), marked for grad."""
    out = {}
    for arch, kinds in (("jamba-1.5-large-398b", ("mamba",)),
                        ("xlstm-1.3b", ("mlstm", "slstm"))):
        cfg = get_arch(arch).reduced()
        blocks = PM.trainable(PM.tree_map(
            lambda t: t.float(), M.init_params(cfg, 0, "cpu")))["blocks"]
        for run in blocks["units"]:
            for kind in kinds:
                if kind in run:
                    out[kind] = (cfg, {k: v[0, 0] for k, v in
                                       run[kind].items()})
    return out


@pytest.mark.parametrize("kind,length,chunk", [("mamba", 16, 4),
                                               ("mlstm", 16, 4),
                                               ("slstm", 16, 4)])
def test_recurrent_mixer_backward(mixers, kind, length, chunk):
    fwd = {"mamba": mamba.mamba_forward, "mlstm": xlstm.mlstm_forward,
           "slstm": xlstm.slstm_forward}[kind]
    cfg, p = mixers[kind]
    x = torch.randn((2, length, cfg.d_model),
                    generator=torch.Generator().manual_seed(length),
                    requires_grad=True)
    y, _ = fwd(x, p, cfg, chunk=chunk)
    (gx, *gp) = torch.autograd.grad(y.square().sum(), [x, *p.values()],
                                    allow_unused=True, materialize_grads=True)
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0
    assert all(torch.isfinite(g).all() for g in gp)
    # without grad the state is the caller's, updated in place
    with torch.no_grad():
        _, st = fwd(x[:, :chunk], p, cfg, chunk=chunk)
        big = {"mamba": ("ssm",), "mlstm": ("C", "n")}.get(kind, ())
        held = {k: st[k] for k in big}
        _, st2 = fwd(x[:, :1], p, cfg, state=st)
    assert all(st2[k] is held[k] for k in big)
