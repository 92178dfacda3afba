"""Share of the traced batches' device time that ranking the MoE's
assignments within their experts takes: the busy union of the work
launched inside the port's ``ft:moe.rank`` ranges (the one-hot, cumsum
and gather) over that of all the work launched inside the traced
batches (``spans.py``).  %."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:moe.rank") or sp.busy_s <= 0:
        return None
    return 100.0 * sp.device_s("ft:moe.rank") / sp.busy_s
