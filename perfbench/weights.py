"""The benchmark's weights, made from ``--seed`` on the device: one
``torch.Generator`` and one call a stacked leaf, in the type they are
served in.  Which leaves a model has, their shapes and the layers each
is stacked over are its family's (``families/<reference>.py``'s
``leaves``); ``system.py`` hands the same tensors to the program in its
tree, and ``reference/`` reads them as they are.

Each matrix is normal with std ``gain/sqrt(fan_in)``; the projections
that write into the residual stream are scaled by
``1/sqrt(2 n_layers)``; norm scales are ones in float32.  The gains are
1 unless the configuration's ``init`` names them (a leaf's ``gain`` is
the key it reads there).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Leaf:
    """One weight of a family's table.  ``shape`` is one layer's (the
    whole model's where ``layers`` is None); a per-layer leaf is drawn
    stacked, ``(len(layers), *shape)``, over ``layers`` in that order."""
    shape: tuple
    fan_in: int = 0          # 0: a norm's scale, ones in float32
    resid: bool = False      # writes into the residual stream
    gain: str = ""           # the ``init`` key scaling its std
    layers: tuple | None = None

    @property
    def stacked(self) -> tuple:
        return self.shape if self.layers is None \
            else (len(self.layers), *self.shape)


def make(table: dict, arch: dict, init: dict, seed: int, device,
         dtype=torch.bfloat16) -> dict:
    """Every leaf of ``table`` ({name: Leaf}, in drawing order) drawn
    from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth = (2.0 * arch["n_layers"]) ** -0.5
    w = {}
    for name, leaf in table.items():
        if not leaf.fan_in:
            w[name] = torch.ones(leaf.stacked, dtype=torch.float32,
                                 device=device)
            continue
        std = init.get(leaf.gain, 1.0) * leaf.fan_in ** -0.5 \
            * (depth if leaf.resid else 1.0)
        w[name] = torch.randn(leaf.stacked, generator=gen, dtype=dtype,
                              device=device).mul_(std)
    return w
