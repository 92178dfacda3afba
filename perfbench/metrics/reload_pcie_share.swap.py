"""Share of the host link's bound in the reloads' wall time: each
checkpoint's bytes at 64 GB/s, over the backend's own wall time for the
reload (``ExecReport.wall_ms``), totalled over the window's cold starts
outside the traced slice.  %."""
from work import pcie_bound_s


def read(ctx, out):
    rs = [r for r in out.records.get("reloads", []) if not r["traced"]]
    if not rs:
        return None
    return 100.0 * sum(pcie_bound_s(r["bytes"]) for r in rs) \
        / sum(r["wall_s"] for r in rs)
