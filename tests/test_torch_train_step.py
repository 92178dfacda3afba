"""The port's train step (``training/train_step.py``) against the JAX
package's, on the CPU, in f32, for the six reduced architectures with
attention and dense FFNs only (the other four, with MoE, Mamba and
xLSTM mixers, are in ``test_torch_train_step_mixers.py``).

One ``build_train_step`` step with two interleaved microbatches from the
same weights, zero optimizer state and batch: the loss within 1e-5, the
accumulated gradient of every leaf within relnorm 1e-4 of the
reference's (xLSTM 1e-3, as its logits are held), the step count 1, and
every leaf the reference's update changes also changed.  The gradients
are the ones each package hands to its ``adamw_update``, read by a
wrapper patched over that name for the test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param as JPM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JTS  # noqa: E402

from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

SEQ, ACCUM = 32, 2
LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


def _with_grads(update):
    """``adamw_update`` that also returns the gradients it was given."""
    def wrapped(oc, params, grads, opt_state, *shardings):
        p, o, m = update(oc, params, grads, opt_state, *shardings)
        return p, o, dict(m, grads=grads)
    return wrapped


MIXER_ARCHS = ("dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
               "xlstm-1.3b")


def check_train_step(arch, smoke_mesh, monkeypatch):
    """One accum-2 step of ``arch`` through both packages, held as the
    module docstring says."""
    monkeypatch.setattr(JTS, "adamw_update", _with_grads(JO.adamw_update))
    monkeypatch.setattr(TS, "adamw_update", _with_grads(O.adamw_update))
    pair = MP.make_pair(arch)
    jb, tb = MP.batches(pair.cfg, SEQ)
    jctx = JM.build_ctx(pair.jcfg, JShape("t", SEQ, MP.BATCH, "train"),
                        smoke_mesh)
    jopt = JPM.initialize(JO.opt_pspecs(JM.model_specs(pair.jcfg)),
                          jax.random.key(1))
    jstep = JTS.build_train_step(
        pair.jcfg, jctx, JO.OptConfig(schedule=pair.jcfg.lr_schedule), ACCUM)
    with jax.set_mesh(smoke_mesh):
        jp, jo, jm = jax.jit(jstep)(pair.jparams, jopt, jb)

    params = PM.trainable(pair.params)
    before = [t.detach().clone() for t in PM.tree_leaves(params)]
    opt = O.init_opt_state(M.model_specs(pair.cfg), "f32", "cpu")
    step = TS.build_train_step(pair.cfg, M.build_ctx(pair.cfg),
                               O.OptConfig(schedule=pair.cfg.lr_schedule),
                               ACCUM)
    params, opt, m = step(params, opt, tb)

    assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
    assert int(opt["step"]) == int(jo["step"]) == 1
    tol = 1e-3 if arch == "xlstm-1.3b" else 1e-4
    names = [p for p, _ in PM.tree_leaves_with_paths(params)]
    grads = PM.tree_leaves(m["grads"])
    assert all(g.dtype == torch.float32 for g in grads)
    errs = {n: MP.relnorm(g, jg) for n, g, jg in
            zip(names, grads, jax.tree.leaves(jm["grads"]))}
    assert max(errs.values()) < tol, max(errs.items(), key=lambda kv: kv[1])
    jchanged = [not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                zip(jax.tree.leaves(pair.jparams), jax.tree.leaves(jp))]
    changed = [not torch.equal(a, b.detach()) for a, b in
               zip(before, PM.tree_leaves(params))]
    assert [n for n, j, c in zip(names, jchanged, changed) if j and not c] \
        == []


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(MIXER_ARCHS)))
def test_train_step_matches_reference(arch, smoke_mesh, monkeypatch):
    check_train_step(arch, smoke_mesh, monkeypatch)


@pytest.mark.parametrize("batch", [1, 4, 6])
def test_default_accum_matches_reference_on_one_device(batch, smoke_mesh):
    """At world size 1 (the smoke mesh: one device; in the port also no
    mesh) one batch row goes to each microbatch in both packages."""
    from types import SimpleNamespace

    from repro.configs.base import ShapeSpec as JS

    from repro_torch.configs.base import ShapeSpec
    assert smoke_mesh.size == 1
    jcfg = MP.jget_arch("minicpm-2b").reduced()
    want = JTS.default_accum(JS("t", 32, batch, "train"), smoke_mesh, jcfg)
    cfg = MP.get_arch("minicpm-2b").reduced()
    one = SimpleNamespace(shape=(1, 1), mesh_dim_names=("data", "model"))
    for mesh in (one, None):
        assert TS.default_accum(ShapeSpec("t", 32, batch, "train"), mesh,
                                cfg) == want
    assert want == batch
