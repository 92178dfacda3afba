"""Model FLOPs of the traced slice's batches (``work.prefill_flops``:
2 per active parameter per token, causal attention, the logits at the
last position) over the slice's wall time at the bf16 peak.  %."""
from work import PEAK_BF16_FLOPS, prefill_flops


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    flops = sum(prefill_flops(ctx.arch, m["B"], m["L"])
                for m in s.meta.values())
    return 100.0 * flops / (s.window_s * PEAK_BF16_FLOPS)
