"""Share of the traced decode steps' device time that attention takes:
the busy union of the work launched inside the port's ``ft:attn.core``
ranges over that of all the work launched inside the traced steps
(``spans.py``).  %."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:attn.core") or sp.busy_s <= 0:
        return None
    return 100.0 * sp.device_s("ft:attn.core") / sp.busy_s
