"""Idle device time while the host is inside the port's decode step:
the traced steps' idle gaps whose middle lies inside an
``ft:engine.decode`` range, per traced step (``spans.py``).  ms."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:engine.decode"):
        return None
    return 1e3 * sp.idle_s("ft:engine.decode") / sp.n_items
