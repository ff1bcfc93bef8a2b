"""The prefill step's work (``bench/work``) over the card's peak in the
configuration's dtype times the step's time in the traced window, in %."""
from bench.peaks import PEAK_OPS


def read(r):
    cfg, mix = r.ctx.cfg, r.ctx.cell.mix
    if mix["kind"] != "prefill":
        return None
    flops = r.ctx.work.prefill(cfg, mix["batch"], mix["prompt"])["flops"]
    return 100.0 * flops / (PEAK_OPS[cfg["dtype"]] * r.step_s())
