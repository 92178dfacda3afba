"""The benchmark's yardstick: the card's peaks, the work a call needs
(operations and bytes, from shapes alone), and the statistics of a
window.  Nothing here reads the program: later changes to the program
cannot move these numbers.  A model's own counts (its parameters, the
FLOPs and bytes of a step) are its family's, in
``families/<reference>.py``.

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


def pcie_bound_s(nbytes: int) -> float:
    """A reload's bound on the host link."""
    return nbytes / PCIE5_BYTES_PER_S
