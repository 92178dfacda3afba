"""The port's checkpoints, data pipeline, training loop and launcher, on
the CPU.

- a checkpoint written by the port is restored by the JAX package's
  ``checkpoint.restore`` and one written by the JAX package by the
  port's, leaf for leaf equal (bf16 parameters and int8 moments with
  their f32 scales and the int32 step included), with the same
  manifest keys;
- twins of ``tests/test_system.py``'s ``test_checkpoint_roundtrip_bitwise``,
  ``test_fault_recovery_resumes_from_checkpoint`` and
  ``test_pipeline_state_resumes_deterministically``, and the same resume
  contract for ``MarkovPipeline``;
- ``python -m repro_torch.launch.train --smoke --device cpu`` exits 0.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _modelpair as MP  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param as JPM  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import MarkovPipeline, Pipeline  # noqa: E402
from repro_torch.distributed.fault import FaultPolicy, NodeFailure  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import param as PM  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_loop import run_training  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-72b"
#: wide enough that the FFN leaves (2 x 64 x 512) take int8 moments
D_FF = 512


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


def _bits(a) -> np.ndarray:
    """A leaf's bytes as numpy sees them (bf16 as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaf_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def trees():
    """The same bf16 params and int8 optimizer state in both packages:
    the JAX package's, carried over by ``param.from_numpy``."""
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), d_ff=D_FF)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    jopt = JPM.initialize(JO.opt_pspecs(JM.model_specs(jcfg), "int8"),
                          jax.random.key(1))
    rng = np.random.default_rng(3)
    # non-zero moments and step, so that a swapped leaf shows
    jopt = jax.tree.map(lambda a: np.asarray(
        rng.integers(-127, 128, a.shape) if a.dtype == np.int8 else
        rng.uniform(0, 1, a.shape) if a.ndim else 7).astype(a.dtype), jopt)
    jtree = {"params": jparams, "opt": jopt}
    tree = PM.from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    _leaf_equal(PM.tree_leaves(tree), jax.tree.leaves(jtree))
    assert any(t.dtype == torch.bfloat16 for t in PM.tree_leaves(tree))
    assert any(t.dtype == torch.int8 for t in PM.tree_leaves(tree))
    assert tree["opt"]["step"].shape == () and int(tree["opt"]["step"]) == 7
    return jtree, tree


def _target(dtype_of_opt: str = "int8"):
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), d_ff=D_FF)
    return {"params": M.init_params(cfg, 1, "cpu"),
            "opt": O.init_opt_state(M.model_specs(cfg), dtype_of_opt, "cpu")}


def test_port_checkpoint_restored_by_reference(tmp_path, trees):
    jtree, tree = trees
    CKPT.save(tmp_path, 5, tree, extra={"pipeline": {"seed": 0, "step": 5}})
    target = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jtree)
    got, manifest = JC.restore(tmp_path, 5, target)
    assert manifest["step"] == 5
    assert JC.load_extra(tmp_path, 5) == {"pipeline": {"seed": 0, "step": 5}}
    _leaf_equal(jax.tree.leaves(got), jax.tree.leaves(jtree))


def test_reference_checkpoint_restored_by_port(tmp_path, trees):
    jtree, tree = trees
    JC.save(tmp_path / "ref", 5, jtree, extra={"k": 1})
    got, manifest = CKPT.restore(tmp_path / "ref", 5, _target())
    assert manifest["step"] == 5 and manifest["extra"] == {"k": 1}
    _leaf_equal(PM.tree_leaves(got), PM.tree_leaves(tree))
    CKPT.save(tmp_path / "port", 5, tree, extra={"k": 1})
    keys = [json.loads((tmp_path / d / "step_00000005" / "manifest.json")
                       .read_text())["leaves"] for d in ("ref", "port")]
    assert keys[0] == keys[1]
    assert sorted(p.name for p in (tmp_path / "ref" / "step_00000005")
                  .iterdir()) == sorted(
        p.name for p in (tmp_path / "port" / "step_00000005").iterdir())


def test_restore_checks_leaves_and_shapes(tmp_path, trees):
    CKPT.save(tmp_path, 1, trees[1])
    with pytest.raises(KeyError, match="missing leaf"):
        CKPT.restore(tmp_path, 1, _target("f32"))
    narrow = {"params": M.init_params(get_arch(ARCH).reduced(), 0, "cpu")}
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(tmp_path, 1, narrow)


def test_checkpoint_roundtrip_bitwise(tmp_path):
    cfg = get_arch(ARCH).reduced()
    params = M.init_params(cfg, 0, "cpu")
    CKPT.save(tmp_path, 3, {"params": params})
    restored, manifest = CKPT.restore(tmp_path, 3, {"params": params})
    assert manifest["step"] == 3
    _leaf_equal(PM.tree_leaves(restored), PM.tree_leaves({"params": params}))
    assert CKPT.latest_step(tmp_path) == 3


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    cfg = get_arch("minicpm-2b").reduced()
    shape = ShapeSpec("t", 32, 2, "train")
    fired = {"x": False}

    def injector(i):
        if i == 4 and not fired["x"]:
            fired["x"] = True
            return NodeFailure(2)
        return None

    state, losses, stats = run_training(
        cfg, shape, steps=6, accum=1, ckpt_dir=str(tmp_path),
        policy=FaultPolicy(checkpoint_every=2),
        failure_injector=injector, log_every=0, device="cpu")
    assert state.step == 6
    assert stats.restarts == 1
    assert stats.failed_hosts == [2]
    # the failure comes before step 4 runs, and the loop waits for the
    # write of step 4's checkpoint in flight: no step runs twice
    assert len(losses) == 6
    assert int(state.opt_state["step"]) == 6
    assert CKPT.latest_step(tmp_path) == 6


@pytest.mark.parametrize("cls", [Pipeline, MarkovPipeline])
def test_pipeline_state_resumes_deterministically(cls):
    cfg = get_arch("minicpm-2b").reduced()
    shape = ShapeSpec("t", 16, 2, "train")
    p1 = cls(cfg, shape, device="cpu")
    b0, b1 = p1.next_batch(), p1.next_batch()
    assert p1.state() == {"seed": 0, "step": 2}
    p2 = cls.from_state(cfg, shape, {"seed": 0, "step": 1}, device="cpu")
    b1b = p2.next_batch()
    assert b1.keys() == b1b.keys()
    for k in b1:
        assert torch.equal(b1[k], b1b[k])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    toks = b1["tokens"]
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (2, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    if cls is MarkovPipeline:
        # every token is one of its predecessor's successors
        succ = p1._succ
        assert all(int(b) in succ[int(a)] for row in toks.tolist()
                   for a, b in zip(row, row[1:]))


def test_train_launcher_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minicpm-2b", "--smoke", "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "done: step=3" in res.stdout and "on cpu" in res.stdout
