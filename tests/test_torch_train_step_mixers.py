"""The port's train step against the JAX package's, as in
``test_torch_train_step.py``, for the four reduced architectures with
MoE, Mamba or xLSTM mixers: DBRX-132B and Grok-1-314B (MoE),
Jamba-1.5-Large (Mamba, MoE and attention) and xLSTM-1.3B (mLSTM and
sLSTM, gradients within relnorm 1e-3).
"""
import pytest

pytest.importorskip("torch")

import _modelpair as MP  # noqa: E402
from test_torch_train_step import MIXER_ARCHS, check_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from MP.one_torch_thread()


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_train_step_matches_reference(arch, smoke_mesh, monkeypatch):
    check_train_step(arch, smoke_mesh, monkeypatch)
