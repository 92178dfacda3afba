"""Host time of a cold start outside the backend's walk: the mean over
the window's cold starts outside the traced slice of the cold start's
wall time less its reload's ``ExecReport.wall_ms`` (the swap tier, the
facade's policy and the transfer engine's planning).  ms."""


def read(ctx, out):
    rs = [r for r in out.records.get("reloads", []) if not r["traced"]]
    if not rs:
        return None
    return 1e3 * sum(r["cold_s"] - r["wall_s"] for r in rs) / len(rs)
