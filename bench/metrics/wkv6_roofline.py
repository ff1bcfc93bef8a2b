"""The wkv6 kernel's share of its roofline in a prefill: the least time
its launches could take (``bench/kernels.py`` from the cell's shapes,
``bench/peaks.py``) over the device time of the kernels named
``wkv6_kernel`` in the traced window, in %."""
from bench.peaks import bound_s

KERNEL = "wkv6_kernel"


def read(r):
    cfg, mix = r.ctx.cfg, r.ctx.cell.mix
    if mix["kind"] != "prefill":
        return None
    launches = r.ctx.work.kernel_launches(cfg, mix["batch"], mix["prompt"])
    seconds, count = r.trace.kernel_time((KERNEL,))
    if "wkv6" not in launches or count == 0:
        return None
    return 100.0 * bound_s(*launches["wkv6"])[0] * count / seconds
