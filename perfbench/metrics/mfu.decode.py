"""Model FLOPs of the traced slice's decode steps (``work.decode_flops``:
2 per active parameter per token, the logits, and attention over the
positions <= pos) over the slice's wall time at the bf16 peak.  %."""
from work import PEAK_BF16_FLOPS, decode_flops


def read(ctx, out):
    s = out.slice
    if s is None or not s.meta:
        return None
    flops = sum(decode_flops(ctx.arch, m["B"], m["pos"])
                for m in s.meta.values())
    return 100.0 * flops / (s.window_s * PEAK_BF16_FLOPS)
