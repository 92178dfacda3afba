"""Share of the traced slice's wall time in which no kernel, copy or
set ran on the device: 1 less the union of the trace's device intervals
over the slice's length.  %."""


def read(ctx, out):
    s = out.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
