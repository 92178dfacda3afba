"""Model FLOPs of the traced slice's decode steps (the configuration's
family's ``decode_flops``: 2 per active parameter per token, the logits,
and attention over the positions <= pos) over the slice's wall time at
the bf16 peak.  %."""
import harness
from work import PEAK_BF16_FLOPS


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    fam = harness.family(ctx.config["reference"])
    flops = sum(fam.decode_flops(ctx.arch, m["B"], m["pos"])
                for m in s.meta.values())
    return 100.0 * flops / (s.window_s * PEAK_BF16_FLOPS)
