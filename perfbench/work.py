"""The benchmark's yardstick: the card's peaks, the work a call needs
(operations and bytes, from shapes alone), and the statistics of a
window.  Nothing here reads the program: later changes to the program
cannot move these numbers.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity), at the full 700 W power limit.
"""
from __future__ import annotations

import math

import numpy as np

#: bf16 tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES_PER_S = 3.35e12
#: PCIe 5.0 x16, one way: the host link's bound for a reload
PCIE5_BYTES_PER_S = 64e9


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every sample, linearly interpolated
    between the two closest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def busy_union(intervals) -> float:
    """Length of the union of ``[start, start + dur)`` intervals."""
    total, end = 0.0, -math.inf
    for ts, dur in sorted(intervals):
        if ts + dur <= end:
            continue
        total += ts + dur - max(ts, end)
        end = ts + dur
    return total


def flash_work(B, Hq, Hkv, Lq, Lkv, D, causal, window, itemsize):
    """(bytes, flops) one attention call needs: q, k, v read once and o
    written once; 4*D flops for each (query, key) pair the masks keep."""
    i = np.arange(Lq)
    hi = np.minimum(i, Lkv - 1) if causal else np.full(Lq, Lkv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Lq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = (2 * B * Hq * Lq * D + 2 * B * Hkv * Lkv * D) * itemsize
    return nbytes, 4 * B * Hq * D * pairs


def roofline_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


# ----------------------------------------------------------- the model --

def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def layer_params(arch: dict) -> dict:
    """Parameters of one decoder layer, by part: ``attn`` (q, k, v, o),
    ``ffn_active`` (those a token's FFN multiplies: the dense MLP, or the
    router and ``top_k`` experts), ``ffn_stored`` (all the FFN holds)."""
    D, H, Kv, hd = arch["d_model"], arch["n_heads"], arch["n_kv_heads"], \
        head_dim(arch)
    F = arch["d_ff"]
    attn = D * H * hd * 2 + D * Kv * hd * 2
    mats = 3 if arch.get("mlp_type", "gated_silu") == "gated_silu" else 2
    E = arch.get("n_experts", 0)
    if E:
        expert = mats * D * F
        return {"attn": attn, "ffn_active": D * E + arch["top_k"] * expert,
                "ffn_stored": D * E + E * expert}
    return {"attn": attn, "ffn_active": mats * D * F,
            "ffn_stored": mats * D * F}


def padded_vocab(arch: dict) -> int:
    return -(-arch["vocab_size"] // 128) * 128


def prefill_flops(arch: dict, B: int, L: int) -> float:
    """Model FLOPs of one prefill batch: 2 per active parameter per
    token in the layers, causal attention's 4*D per kept (query, key)
    pair and head, and the logits at the last position only."""
    p = layer_params(arch)
    per_token = 2 * (p["attn"] + p["ffn_active"])
    _, attn = flash_work(B, arch["n_heads"], arch["n_kv_heads"], L, L,
                         head_dim(arch), True, 0, 2)
    logits = 2 * B * arch["d_model"] * arch["vocab_size"]
    return arch["n_layers"] * (per_token * B * L + attn) + logits


def decode_flops(arch: dict, B: int, pos: int) -> float:
    """Model FLOPs of one decode step at position ``pos``: the layers'
    active parameters and the logits for each of the B tokens, and
    attention over the positions <= pos."""
    p = layer_params(arch)
    per_token = 2 * (p["attn"] + p["ffn_active"])
    attn = 4 * arch["n_heads"] * head_dim(arch) * (pos + 1)
    logits = 2 * arch["d_model"] * arch["vocab_size"]
    return B * (arch["n_layers"] * (per_token + attn) + logits)


def kv_bytes_per_position(arch: dict, itemsize: int = 2) -> int:
    """K and V of one sequence position over every layer."""
    return arch["n_layers"] * 2 * arch["n_kv_heads"] * head_dim(arch) \
        * itemsize


def decode_bytes(arch: dict, B: int, pos: int, itemsize: int = 2) -> float:
    """Bytes a decode step needs, each read once in bf16: the layers'
    weights, the output head (the tied table, read whole), the B rows
    of the embedding an untied model looks up, and the K and V of the
    positions <= pos of every sequence."""
    p = layer_params(arch)
    weights = arch["n_layers"] * (p["attn"] + p["ffn_stored"]) \
        + padded_vocab(arch) * arch["d_model"]
    if not arch.get("tie_embeddings"):
        weights += B * arch["d_model"]
    return weights * itemsize \
        + B * (pos + 1) * kv_bytes_per_position(arch, itemsize)


def pcie_bound_s(nbytes: int) -> float:
    """A reload's bound on the host link."""
    return nbytes / PCIE5_BYTES_PER_S
