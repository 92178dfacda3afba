"""The benchmark's weights, made from ``--seed`` on the device: one
``torch.Generator`` and one call a stacked leaf, in the type they are
served in.  Which leaves a model has, their shapes and the layers each
is stacked over are its family's (``families/<reference>.py``'s
``leaves``); ``system.py`` hands the same tensors to the program in its
tree, and ``reference/`` reads them as they are.

Each leaf names its draw rule (``RULES``); a leaf that names none is
``normal`` where it has a ``fan_in`` and ``ones`` in float32 where it
has not (a norm's scale).  ``normal`` draws std ``gain/sqrt(fan_in)``,
scaled by ``1/sqrt(2 n_layers)`` for the projections that write into
the residual stream; the gains are 1 unless the configuration's
``init`` names them (a leaf's ``gain`` is the key it reads there).
Only the random rules (``normal``, ``mamba_dt``) take values from the
generator, in table order, so a leaf of another rule shifts no other
leaf's bits.  A leaf is served in the served dtype unless it asks for
float32, as the port keeps a Mamba layer's ``A_log``, ``dt_bias`` and
``D_skip``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: Mamba's dt at initialisation: log-uniform in [DT_MIN, DT_MAX], floored
#: at DT_FLOOR (arXiv:2312.00752; its reference code's ``dt_init="random"``)
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def _s4d_log(shape: tuple, gen, device) -> torch.Tensor:
    """S4D-real's A = -(1..N) as ``A_log``: log(1..N) along the last axis,
    every row alike."""
    row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                 device=device))
    return row.expand(shape).contiguous()


def _mamba_dt(shape: tuple, gen, device) -> torch.Tensor:
    """Mamba's ``dt_bias``: a dt per channel drawn log-uniform in
    [DT_MIN, DT_MAX] and floored at DT_FLOOR, stored as its inverse
    softplus, so that ``softplus(dt_bias)`` is that dt."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    lo, hi = math.log(DT_MIN), math.log(DT_MAX)
    dt = torch.exp(u * (hi - lo) + lo).clamp_(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


#: the rules other than ``normal``: (shape, generator, device) -> float32
RULES = {
    "ones": lambda shape, gen, device: torch.ones(
        shape, dtype=torch.float32, device=device),
    "zeros": lambda shape, gen, device: torch.zeros(
        shape, dtype=torch.float32, device=device),
    "s4d_log": _s4d_log,
    "mamba_dt": _mamba_dt,
}


@dataclass(frozen=True)
class Leaf:
    """One weight of a family's table.  ``shape`` is one layer's (the
    whole model's where ``layers`` is None); a per-layer leaf is drawn
    stacked, ``(len(layers), *shape)``, over ``layers`` in that order."""
    shape: tuple
    fan_in: int = 0          # 0 and no rule: a norm's scale, ones in float32
    resid: bool = False      # writes into the residual stream
    gain: str = ""           # the ``init`` key scaling its std
    layers: tuple | None = None
    rule: str = ""           # "normal" or a key of RULES; "": by ``fan_in``
    float32: bool = False    # held in float32 whatever the served dtype

    @property
    def stacked(self) -> tuple:
        return self.shape if self.layers is None \
            else (len(self.layers), *self.shape)

    @property
    def drawn_as(self) -> tuple:
        """(rule, whether it is held in float32)."""
        if self.rule:
            return self.rule, self.float32
        return ("normal", self.float32) if self.fan_in else ("ones", True)


def make(table: dict, arch: dict, init: dict, seed: int, device,
         dtype=torch.bfloat16) -> dict:
    """Every leaf of ``table`` ({name: Leaf}, in drawing order) drawn
    from ``seed`` on ``device``, in ``dtype`` or float32 where a leaf
    asks for it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth = (2.0 * arch["n_layers"]) ** -0.5
    w = {}
    for name, leaf in table.items():
        rule, f32 = leaf.drawn_as
        want = torch.float32 if f32 else dtype
        if rule == "normal":
            if not leaf.fan_in:
                raise ValueError(f"{name}: a normal leaf needs its fan_in")
            std = init.get(leaf.gain, 1.0) * leaf.fan_in ** -0.5 \
                * (depth if leaf.resid else 1.0)
            w[name] = torch.randn(leaf.stacked, generator=gen, dtype=want,
                                  device=device).mul_(std)
        elif rule in RULES:
            w[name] = RULES[rule](leaf.stacked, gen, device).to(want)
        else:
            raise ValueError(f"{name}: no draw rule {rule!r}; "
                             f"normal or one of {sorted(RULES)}")
    return w
