"""The flash-attention kernel's share of its roofline over the traced
slice: for each launch, max(bytes / HBM bandwidth, FLOPs / bf16 peak)
at its batch's shape (``work.flash_work``, with the heads of the
configuration's family's ``attention_shape``), summed, over the
launches' device time in the trace.  %."""
import harness
from work import flash_work, roofline_s

KERNEL = "flash_bf16"


def read(ctx, out):
    s = out.slice
    if s is None:
        return None
    Hq, Hkv, hd = harness.family(ctx.config["reference"]).attention_shape(
        ctx.arch)
    bound = took = 0.0
    for i, m in s.meta.items():
        launches = [e for e in s.device_in(i) if KERNEL in e[0]]
        nbytes, flops = flash_work(m["B"], Hq, Hkv, m["L"], m["L"], hd,
                                   True, 0, 2)
        bound += len(launches) * roofline_s(nbytes, flops)
        took += sum(e[2] for e in launches)
    if took <= 0:
        return None
    return 100.0 * bound / took
