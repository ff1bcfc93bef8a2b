"""The share of a decode step's device time that the program's weight casts
take: the device time launched under its ``cast.weight`` spans over all
device time in the traced window (``bench/spans.py``), in %."""
from bench import spans


def read(r):
    if r.ctx.cell.mix["kind"] != "decode":
        return None
    s = spans.of_run(r)
    return None if s is None else 100.0 * s.inclusive("cast.weight") / s.device_s
