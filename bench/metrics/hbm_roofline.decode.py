"""The bytes a decode step needs (``bench/work``: the block and head
weights at the configuration's bf16, the cache read and written once) over
the card's memory bandwidth times the step's time in the traced window, in
%."""
from bench.peaks import PEAK_BYTES


def read(r):
    cfg, mix = r.ctx.cfg, r.ctx.cell.mix
    if mix["kind"] != "decode":
        return None
    nbytes = r.ctx.work.decode(cfg, mix["batch"], r.kind.position())["bytes"]
    return 100.0 * nbytes / (PEAK_BYTES * r.step_s())
