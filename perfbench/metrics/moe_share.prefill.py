"""Share of the traced batches' device time that the MoE layers take:
the busy union of the work launched inside the port's ``ft:moe`` ranges
(router, rank, dispatch, expert products, combine) over that of all the
work launched inside the traced batches (``spans.py``).  %."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:moe") or sp.busy_s <= 0:
        return None
    return 100.0 * sp.device_s("ft:moe") / sp.busy_s
