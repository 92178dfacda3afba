"""Host time the backend's walk blocks on its copies' events: the
port's ``ft:copy.wait`` ranges inside ``ft:backend.execute``, the mean
over the traced cold starts (``spans.py``).  ms."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:backend.execute") or not sp.n_items:
        return None
    return 1e3 * sp.host_s("ft:copy.wait", within="ft:backend.execute") \
        / sp.n_items
