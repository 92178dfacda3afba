"""The decode step's share of its bandwidth bound: the bytes a step
needs, read once in bf16 (every weight, and the K and V of the
positions <= pos; the configuration's family's ``decode_bytes``), at
the HBM bandwidth, over the traced slice's mean step time.  %."""
import harness
from work import PEAK_HBM_BYTES_PER_S


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    fam = harness.family(ctx.config["reference"])
    need = sum(fam.decode_bytes(ctx.arch, m["B"], m["pos"])
               for m in s.meta.values()) / PEAK_HBM_BYTES_PER_S
    return 100.0 * need / s.window_s
