"""Model FLOPs of the traced slice's batches (the configuration's
family's ``prefill_flops``: 2 per active parameter per token, causal
attention, the logits at the last position) over the slice's wall time
at the bf16 peak.  %."""
import harness
from work import PEAK_BF16_FLOPS


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    fam = harness.family(ctx.config["reference"])
    flops = sum(fam.prefill_flops(ctx.arch, m["B"], m["L"])
                for m in s.meta.values())
    return 100.0 * flops / (s.window_s * PEAK_BF16_FLOPS)
