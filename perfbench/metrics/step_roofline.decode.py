"""The decode step's share of its bandwidth bound: the bytes a step
needs, read once in bf16 (every weight, and the K and V of the
positions <= pos; ``work.decode_bytes``), at the HBM bandwidth, over
the traced slice's mean step time.  %."""
from work import PEAK_HBM_BYTES_PER_S, decode_bytes


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    need = sum(decode_bytes(ctx.arch, m["B"], m["pos"])
               for m in s.meta.values()) / PEAK_HBM_BYTES_PER_S
    return 100.0 * need / s.window_s
