"""The decoder family: a RoPE decoder with attention on every layer and,
on each layer, the gated MLP or, where the port's ``block_pattern``
puts one (``i % moe_every == moe_offset % moe_every`` with
``n_experts``), the mixture of experts.  Its plain reference is
``reference/decoder.py``.

A family gives the harness these, each from the configuration's
``arch`` alone:

- ``leaves(arch)``: the weights, ``{name: weights.Leaf}`` in drawing
  order, each per-layer leaf stacked over the layers that have it;
- ``top(arch)`` and ``block(arch, kind)``: the port's parameter tree,
  for the model's top and for one layer of the port's block ``kind``,
  with a leaf's name where the port holds it (``system.program_params``
  hands the port views of the drawn leaves);
- ``couples_rows(arch)``: whether a row's result depends on the other
  rows of its batch, so that a comparison takes whole batches;
- the model's counts, layer by layer: ``layer_params``,
  ``attention_shape``, ``prefill_flops``, ``decode_flops``,
  ``kv_bytes_per_position`` and ``decode_bytes``.
"""
from __future__ import annotations

from weights import Leaf
from work import flash_work

ATTN = ("wq", "wk", "wv", "wo")
DENSE = {"wi_gate": "wi_gate", "wi_up": "wi_up", "wo": "w_down"}
MOE = {"router": "router", "wi_gate": "we_gate", "wi_up": "we_up",
       "wo": "we_down"}


def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def padded_vocab(arch: dict) -> int:
    return -(-arch["vocab_size"] // 128) * 128


def is_moe(arch: dict, i: int) -> bool:
    """Whether layer ``i`` routes its FFN over experts."""
    every = arch.get("moe_every", 1)
    return bool(arch.get("n_experts")) and \
        i % every == arch.get("moe_offset", 0) % every


def couples_rows(arch: dict) -> bool:
    """Whether a row's result depends on the other rows of its batch:
    the experts' capacity counts the batch's tokens."""
    return bool(arch.get("n_experts"))


def leaves(arch: dict) -> dict:
    L, D, H, Kv = arch["n_layers"], arch["d_model"], arch["n_heads"], \
        arch["n_kv_heads"]
    hd, F, V, E = head_dim(arch), arch["d_ff"], padded_vocab(arch), \
        arch.get("n_experts", 0)
    every = tuple(range(L))
    moe = tuple(i for i in every if is_moe(arch, i))
    dense = tuple(i for i in every if not is_moe(arch, i))
    out = {"table": Leaf((V, D), V, gain="table_gain")}
    if not arch.get("tie_embeddings"):
        out["lm_head"] = Leaf((D, V), D)
    out.update({
        "wq": Leaf((D, H, hd), D, gain="qk_gain", layers=every),
        "wk": Leaf((D, Kv, hd), D, gain="qk_gain", layers=every),
        "wv": Leaf((D, Kv, hd), D, layers=every),
        "wo": Leaf((H, hd, D), H * hd, resid=True, layers=every),
    })
    if moe:
        out.update({
            "router": Leaf((D, E), D, layers=moe),
            "we_gate": Leaf((E, D, F), D, layers=moe),
            "we_up": Leaf((E, D, F), D, layers=moe),
            "we_down": Leaf((E, F, D), F, resid=True, layers=moe),
        })
    if dense:
        out.update({
            "wi_gate": Leaf((D, F), D, layers=dense),
            "wi_up": Leaf((D, F), D, layers=dense),
            "w_down": Leaf((F, D), F, resid=True, layers=dense),
        })
    out.update({"ln1": Leaf((D,), layers=every),
                "ln2": Leaf((D,), layers=every),
                "ln_f": Leaf((D,))})
    return out


def top(arch: dict) -> dict:
    embed = {"table": "table"}
    if not arch.get("tie_embeddings"):
        embed["lm_head"] = "lm_head"
    return {"embed": embed, "ln_f": {"scale": "ln_f"}}


def block(arch: dict, kind: str) -> dict:
    mixer, ffn = kind.split("/")
    if mixer != "attn" or ffn not in ("dense", "moe"):
        raise ValueError(f"the decoder family has no block {kind!r}")
    return {"ln1": {"scale": "ln1"}, "attn": {n: n for n in ATTN},
            "ln2": {"scale": "ln2"},
            "moe" if ffn == "moe" else "mlp":
                dict(MOE if ffn == "moe" else DENSE)}


# ------------------------------------------------------------ counts --

def layer_params(arch: dict, i: int) -> dict:
    """Parameters of layer ``i``, by part: ``attn`` (q, k, v, o),
    ``ffn_active`` (those a token's FFN multiplies: the dense MLP, or
    the router and ``top_k`` experts), ``ffn_stored`` (all the FFN
    holds)."""
    D, H, Kv, hd = arch["d_model"], arch["n_heads"], arch["n_kv_heads"], \
        head_dim(arch)
    F = arch["d_ff"]
    attn = D * H * hd * 2 + D * Kv * hd * 2
    mats = 3 if arch.get("mlp_type", "gated_silu") == "gated_silu" else 2
    if is_moe(arch, i):
        E = arch["n_experts"]
        expert = mats * D * F
        return {"attn": attn, "ffn_active": D * E + arch["top_k"] * expert,
                "ffn_stored": D * E + E * expert}
    return {"attn": attn, "ffn_active": mats * D * F,
            "ffn_stored": mats * D * F}


def attention_shape(arch: dict) -> tuple:
    """(query heads, key/value heads, head dimension) of one attention
    call."""
    return arch["n_heads"], arch["n_kv_heads"], head_dim(arch)


def prefill_flops(arch: dict, B: int, L: int) -> float:
    """Model FLOPs of one prefill batch: 2 per active parameter per
    token in each layer, causal attention's 4*D per kept (query, key)
    pair and head, and the logits at the last position only."""
    Hq, Hkv, hd = attention_shape(arch)
    _, attn = flash_work(B, Hq, Hkv, L, L, hd, True, 0, 2)
    total = 0
    for i in range(arch["n_layers"]):
        p = layer_params(arch, i)
        total += 2 * (p["attn"] + p["ffn_active"]) * B * L + attn
    return total + 2 * B * arch["d_model"] * arch["vocab_size"]


def decode_flops(arch: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step at position ``pos``: each layer's
    active parameters and the logits for each of the B tokens, and
    attention over the positions <= pos."""
    attn = 4 * arch["n_heads"] * head_dim(arch) * (pos + 1)
    total = 0
    for i in range(arch["n_layers"]):
        p = layer_params(arch, i)
        total += 2 * (p["attn"] + p["ffn_active"]) + attn
    return B * (total + 2 * arch["d_model"] * arch["vocab_size"])


def kv_bytes_per_position(arch: dict, itemsize: int = 2) -> int:
    """K and V of one sequence position over every layer."""
    return arch["n_layers"] * 2 * arch["n_kv_heads"] * head_dim(arch) \
        * itemsize


def decode_bytes(arch: dict, B: int, pos: int, itemsize: int = 2) -> float:
    """Bytes a decode step needs, each read once in bf16: every layer's
    weights, the output head (the tied table, read whole), the B rows
    of the embedding an untied model looks up, and the K and V of the
    positions <= pos of every sequence."""
    weights = sum(p["attn"] + p["ffn_stored"] for p in
                  (layer_params(arch, i) for i in range(arch["n_layers"])))
    weights += padded_vocab(arch) * arch["d_model"]
    if not arch.get("tie_embeddings"):
        weights += B * arch["d_model"]
    return weights * itemsize \
        + B * (pos + 1) * kv_bytes_per_position(arch, itemsize)
