"""Share of the backend's walk spent staging: host time in the port's
``ft:backend.stage`` ranges (the copies into a ring window) over host
time in its ``ft:backend.execute`` ranges (the whole walk), over the
traced cold starts (``spans.py``).  %."""
import spans


def read(ctx, out):
    sp = spans.read(ctx, out)
    if sp is None or not sp.has("ft:backend.execute"):
        return None
    walk = sp.host_s("ft:backend.execute")
    return 100.0 * sp.host_s("ft:backend.stage") / walk if walk > 0 else None
