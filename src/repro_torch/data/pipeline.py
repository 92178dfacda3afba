"""Deterministic, restartable synthetic-token data pipeline, PyTorch port
of ``src/repro/data/pipeline.py``.

Checkpoint-resumable: the pipeline's whole random state is (seed, step),
both stored in the checkpoint manifest, so after a restart the stream
continues exactly where it left off.  Every draw comes from numpy
generators keyed by (seed, step) alone, through ``io.synthetic_batch``,
and the batch is moved to ``device`` whole.  The draws are not the JAX
package's (it folds the step into a JAX key), so the two packages give
different tokens for one (seed, step); what they share is the resume
contract.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.io import synthetic_batch

#: seed of ``MarkovPipeline``'s successor table, fixed for a given cfg
SUCCESSOR_SEED = 0xA11CE


@dataclass
class Pipeline:
    cfg: ArchConfig
    shape: ShapeSpec
    seed: int = 0
    step: int = 0
    device: str = "cuda"

    def next_batch(self):
        batch = synthetic_batch(self.cfg, self.shape, (self.seed, self.step),
                                self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, cfg, shape, state, device="cuda"):
        return cls(cfg, shape, seed=state["seed"], step=state["step"],
                   device=device)


@dataclass
class MarkovPipeline(Pipeline):
    """Learnable synthetic language: a sparse order-1 Markov chain.

    Each token has ``branch`` plausible successors (uniform over them),
    so the optimal cross-entropy is ln(branch), far below ln(vocab).  A
    model that learns the transition table drives the loss from about
    ln(vocab) toward ln(branch).  Same (seed, step) resume contract as
    ``Pipeline``.
    """

    branch: int = 8

    def __post_init__(self):
        v = self.cfg.vocab_size
        rng = np.random.default_rng(SUCCESSOR_SEED)
        # successor table: (vocab, branch) int32, fixed for a given cfg
        self._succ = rng.integers(0, v, (v, self.branch), dtype=np.int32)

    def next_batch(self):
        B, S = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng([self.seed, self.step])
        first = rng.integers(0, self.cfg.vocab_size, (B,), dtype=np.int32)
        picks = rng.integers(0, self.branch, (B, S), dtype=np.int32)
        tokens = np.empty((B, S), np.int32)
        tok = first
        for t in range(S):
            tok = self._succ[tok, picks[:, t]]
            tokens[:, t] = tok
        batch = synthetic_batch(self.cfg, self.shape, (self.seed, self.step),
                                self.device)
        # loss_fn's targets are the next tokens
        batch["tokens"] = torch.from_numpy(tokens).to(self.device)
        self.step += 1
        return batch
