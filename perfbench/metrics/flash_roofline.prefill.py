"""The flash-attention kernel's share of its roofline over the traced
slice: for each launch, max(bytes / HBM bandwidth, FLOPs / bf16 peak)
at its batch's shape (``work.flash_work``), summed, over the launches'
device time in the trace.  %."""
from work import flash_work, head_dim, roofline_s

KERNEL = "flash_bf16"


def read(ctx, out):
    s = out.slice
    if s is None:
        return None
    a = ctx.arch
    bound = took = 0.0
    for i, m in s.meta.items():
        launches = [e for e in s.device_in(i) if KERNEL in e[0]]
        nbytes, flops = flash_work(m["B"], a["n_heads"], a["n_kv_heads"],
                                   m["L"], m["L"], head_dim(a), True, 0, 2)
        bound += len(launches) * roofline_s(nbytes, flops)
        took += sum(e[2] for e in launches)
    if took <= 0:
        return None
    return 100.0 * bound / took
