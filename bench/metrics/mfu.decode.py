"""The decode step's work (``bench/work``, at the context the traced steps
reach) over the card's peak in the configuration's dtype times the step's
time in the traced window, in %."""
from bench.peaks import PEAK_OPS


def read(r):
    cfg, mix = r.ctx.cfg, r.ctx.cell.mix
    if mix["kind"] != "decode":
        return None
    flops = r.ctx.work.decode(cfg, mix["batch"], r.kind.position())["flops"]
    return 100.0 * flops / (PEAK_OPS[cfg["dtype"]] * r.step_s())
