"""A run with the timed path broken underneath comes out not correct:
each cell, small, on the CPU, held to its own limits, once for each
fault the cell can have.  (No cell spans chips, so none can leave out
an exchange between them.)"""
import pytest
import torch

import _testkit as K
from repro_torch.core import backend_torch
from repro_torch.models import attention
from repro_torch.serving.engine import Engine

SERVED = [c["name"] for c in K.cells() if c["traffic"] != "swap"]
SWAP = [c["name"] for c in K.cells() if c["traffic"] == "swap"]


def _moved(logits):
    """Each row's logits with another token put first."""
    out = torch.zeros_like(logits)
    out[torch.arange(len(logits)), (logits.argmax(-1) + 1)
        % logits.shape[-1]] = 1.0
    return out


def _entry(workload):
    """The entry the cell's window drives."""
    return "decode" if workload.endswith(".decode") else "prefill"


def _alter_token(monkeypatch, entry):
    inner = getattr(Engine, entry)

    def wrapped(self, *a, **kw):
        logits, caches = inner(self, *a, **kw)
        return _moved(logits), caches
    monkeypatch.setattr(Engine, entry, wrapped)


def _half_batch(monkeypatch, entry):
    """The first half of the rows served, its answers given to all."""
    p, d = Engine.prefill, Engine.decode

    def prefill(self, batch):
        toks = batch["tokens"]
        half = toks.shape[0] // 2
        logits, caches = p(self, {"tokens": toks[:half]})
        return logits.repeat(2, 1)[:toks.shape[0]], caches

    def decode(self, caches, tok, pos, ctx=None):
        logits, caches = d(self, caches, tok, pos, ctx)
        half = logits.shape[0] // 2
        return logits[:half].repeat(2, 1)[:logits.shape[0]], caches
    monkeypatch.setattr(Engine, entry,
                        prefill if entry == "prefill" else decode)


def _stale_cache(monkeypatch):
    """Decode steps that leave the cache as it was."""
    monkeypatch.setattr(attention, "kv_update",
                        lambda cache, new, pos, offset=0: cache)


FAULTS = {"token": _alter_token, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", SERVED)
def test_served_cell_catches(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch, _entry(workload))
    line = K.result_line(workload, seconds=0.5)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("workload", [w for w in SERVED
                                      if w.endswith(".decode")])
def test_decode_cell_catches_a_step_that_keeps_its_state(workload,
                                                         monkeypatch):
    _stale_cache(monkeypatch)
    line = K.result_line(workload, seconds=0.5)
    assert line["correct"] is False, line["compared"]


def _flip_a_byte(monkeypatch):
    inner = backend_torch.host_to_pool

    def flipped(src, pool, rows, **kw):
        out = inner(src, pool, rows, **kw)
        pool[rows[0], 7] ^= 1
        return out
    monkeypatch.setattr(backend_torch, "host_to_pool", flipped)


def _half_the_batches(monkeypatch):
    """A reload walks the first half of its rows, a row a batch."""
    def half(self, n):
        return [(s, s + 1) for s in range(n // 2)]
    monkeypatch.setattr(backend_torch.TorchBackend, "_batches", half)


def _reload_moves_nothing(monkeypatch):
    monkeypatch.setattr(backend_torch.TorchBackend, "_cut_through",
                        lambda self, plan, obj, rep, landed: None)


SWAP_FAULTS = {"byte": _flip_a_byte, "half_batch": _half_the_batches,
               "state_unchanged": _reload_moves_nothing}


@pytest.mark.parametrize("fault", sorted(SWAP_FAULTS))
@pytest.mark.parametrize("workload", SWAP)
def test_swap_cell_catches(workload, fault, monkeypatch):
    SWAP_FAULTS[fault](monkeypatch)
    line = K.result_line(workload, seconds=0.3)
    assert line["correct"] is False, (line["compared"], line["failed"])
