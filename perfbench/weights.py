"""The benchmark's weights, made from ``--seed`` on the device: one
``torch.Generator`` and one call a stacked leaf, in the type they are
served in.  The layout is the benchmark's own (every layer's leaf
stacked on a first axis); ``system.py`` hands the same tensors to the
program in its tree, and ``reference/`` reads them as they are.

Each matrix is normal with std ``gain/sqrt(fan_in)``; the projections
that write into the residual stream (attention's and the FFN's output)
are scaled by ``1/sqrt(2 n_layers)``; the embedding table's fan-in is
its row count; norm scales are ones in float32.  The gains are 1 unless
the configuration's ``init`` names them (``table_gain``, ``qk_gain``).
"""
from __future__ import annotations

import torch

from work import head_dim, padded_vocab


def shapes(arch: dict) -> dict:
    """{leaf: (shape, fan_in, residual output?)} in drawing order."""
    L, D, H, Kv = arch["n_layers"], arch["d_model"], arch["n_heads"], \
        arch["n_kv_heads"]
    hd, F, V = head_dim(arch), arch["d_ff"], padded_vocab(arch)
    out = {"table": ((V, D), V, False)}
    if not arch.get("tie_embeddings"):
        out["lm_head"] = ((D, V), D, False)
    out.update({
        "wq": ((L, D, H, hd), D, False),
        "wk": ((L, D, Kv, hd), D, False),
        "wv": ((L, D, Kv, hd), D, False),
        "wo": ((L, H, hd, D), H * hd, True),
    })
    E = arch.get("n_experts", 0)
    if E:
        out.update({
            "router": ((L, D, E), D, False),
            "we_gate": ((L, E, D, F), D, False),
            "we_up": ((L, E, D, F), D, False),
            "we_down": ((L, E, F, D), F, True),
        })
    else:
        out.update({
            "wi_gate": ((L, D, F), D, False),
            "wi_up": ((L, D, F), D, False),
            "w_down": ((L, F, D), F, True),
        })
    return out


GAINS = {"table": "table_gain",
         "wq": "qk_gain", "wk": "qk_gain"}


def make(arch: dict, init: dict, seed: int, device,
         dtype=torch.bfloat16) -> dict:
    """Every weight of ``arch`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth = (2.0 * arch["n_layers"]) ** -0.5
    w = {}
    for name, (shape, fan_in, resid) in shapes(arch).items():
        std = init.get(GAINS.get(name), 1.0) * fan_in ** -0.5 \
            * (depth if resid else 1.0)
        w[name] = torch.randn(shape, generator=gen, dtype=dtype,
                              device=device).mul_(std)
    L, D = arch["n_layers"], arch["d_model"]
    for name, shape in (("ln1", (L, D)), ("ln2", (L, D)), ("ln_f", (D,))):
        w[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return w

